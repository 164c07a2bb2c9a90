"""Scene generator + IO tests.

Uses a reduced world box (the worm geometry is r0-relative and box-centered,
so the worm itself is identical; only pool/boundary shrink) to keep CI fast.
"""
import numpy as np
import pytest

pytestmark = pytest.mark.smoke

from sph_jax.config import SimParams
from sph_jax.constants import (
    BOUNDARY_PARTICLE,
    ELASTIC_PARTICLE,
    LIQUID_PARTICLE,
)
from sph_jax.scene import generate_liquid_box_scene, generate_worm_scene, io

H = 3.34


def small_worm_params():
    return SimParams(x_max=20 * H, y_max=12 * H, z_max=110 * H)


@pytest.fixture(scope="session")
def worm_scene():
    return generate_worm_scene(small_worm_params())


def test_worm_scene_structure(worm_scene):
    sc = worm_scene
    c = sc.counts
    assert c["elastic"] > 5000 and c["liquid"] > 5000 and c["boundary"] > 5000
    lay = sc.layout()
    # memory order: elastic, liquid, boundary (owHelper.cpp:739-928)
    assert lay.elastic_range[0] == 0
    assert lay.liquid_range[0] == lay.elastic_range[1]
    assert lay.boundary_range[0] == lay.liquid_range[1]
    assert lay.boundary_range[1] == sc.n_particles
    assert sc.muscle_model


def test_worm_membranes_valid(worm_scene):
    sc = worm_scene
    assert len(sc.tris) > 1000
    # membranes only over elastic particles
    assert sc.tris.min() >= 0
    assert sc.tris.max() < sc.counts["elastic"]
    pt = sc.particle_tris()
    # every triangle id appears in its vertices' lists (unless 7-cap hit)
    counts = np.bincount(sc.tris.ravel(), minlength=sc.n_particles)
    listed = (pt >= 0).sum(axis=1)
    assert (listed <= 7).all()
    assert (listed[: sc.counts["elastic"]]
            == np.minimum(counts[: sc.counts["elastic"]], 7)).all()


def test_worm_muscles_cover_all_96(worm_scene):
    m = worm_scene.spring_type.astype(np.int32)
    ids = set(np.unique(m[m > 0]).tolist())
    assert set(range(1, 97)) <= ids, sorted(set(range(1, 97)) - ids)
    # nothing beyond 96
    assert max(ids) <= 96


def test_worm_springs_valid(worm_scene):
    sc = worm_scene
    idx = sc.spring_idx
    valid = idx >= 0
    n_e = sc.counts["elastic"]
    lay = sc.layout()
    js = idx[valid]
    # springs go to elastic or boundary only (liquid skipped, owHelper.cpp:986)
    t = sc.ptype[js]
    assert ((t == ELASTIC_PARTICLE) | (t == BOUNDARY_PARTICLE)).all()
    # rest length = 0.95 * scale * current distance (owHelper.cpp:999)
    p = small_worm_params()
    r_idx, s_idx = np.nonzero(valid)
    i_ids = sc.spring_rows[r_idx]
    d = np.linalg.norm(sc.pos[i_ids] - sc.pos[idx[r_idx, s_idx]], axis=1)
    np.testing.assert_allclose(
        sc.spring_rest[valid], d * p.simulation_scale * 0.95, rtol=1e-4
    )
    # and within the connection cutoff
    assert (d <= p.r0 * np.sqrt(2.7) * (1 + 1e-5)).all()


def test_scene_io_roundtrip(tmp_path, worm_scene):
    sc = worm_scene
    io.save_scene(sc, str(tmp_path))
    back = io.load_scene(str(tmp_path))
    assert back.n_particles == sc.n_particles
    np.testing.assert_allclose(back.pos, sc.pos, atol=1e-4)
    np.testing.assert_array_equal(back.ptype, sc.ptype)
    np.testing.assert_array_equal(back.spring_idx, sc.spring_idx)
    np.testing.assert_allclose(back.spring_rest, sc.spring_rest, rtol=1e-5)
    # boundary normals round-trip through the velocity file
    np.testing.assert_allclose(back.normal, sc.normal, atol=1e-4)
    np.testing.assert_allclose(back.vel, sc.vel, atol=1e-4)


def test_trajectory_dump_roundtrip(tmp_path):
    sc = generate_liquid_box_scene(
        SimParams(x_max=8 * H, y_max=8 * H, z_max=8 * H), fill_fraction=0.5
    )
    d = io.TrajectoryDumper(str(tmp_path), sc)
    d.append(sc.pos)
    d.append(sc.pos + 0.5)
    n_e, n_l, frames = io.load_trajectory(str(tmp_path / "position_buffer.txt"))
    assert n_e == 0 and n_l == sc.counts["liquid"]
    assert frames.shape == (2, n_l, 4)
    moving = sc.ptype != BOUNDARY_PARTICLE
    np.testing.assert_allclose(frames[0, :, :3], sc.pos[moving], atol=1e-4)
    np.testing.assert_allclose(
        frames[1, :, :3], sc.pos[moving] + 0.5, atol=1e-4
    )


def test_liquid_box_scene():
    sc = generate_liquid_box_scene(
        SimParams(x_max=8 * H, y_max=8 * H, z_max=8 * H), fill_fraction=0.5
    )
    c = sc.counts
    assert c["elastic"] == 0 and c["springs"] == 0 and c["membranes"] == 0
    assert c["liquid"] > 0 and c["boundary"] > 0
    assert (sc.ptype[: c["liquid"]] == LIQUID_PARTICLE).all()
    # boundary normals are unit or the reference's 1/sqrt(2) edge cases
    nb = np.linalg.norm(sc.normal[c["liquid"]:], axis=1)
    assert (
        np.isclose(nb, 1.0, atol=1e-3) | np.isclose(nb, 0.7071, atol=1e-3)
    ).all()


def test_multi_worm_scene():
    """n worms = n x the single worm's elastic/spring/membrane counts,
    one shared pool, no cross-worm springs (SURVEY §7 step 6 stress
    config; the reference hard-codes one worm)."""
    from sph_jax.scene import (
        generate_multi_worm_params,
        generate_multi_worm_scene,
        generate_worm_scene,
    )

    H = 3.34
    base = SimParams(x_max=14 * H, y_max=12 * H, z_max=108 * H)
    s1 = generate_worm_scene(base)
    s2 = generate_multi_worm_scene(2, base)
    lay = s2.layout()
    assert lay.elastic_range == (0, 2 * s1.layout().n_elastic)
    assert (s2.spring_idx >= 0).sum() == 2 * (s1.spring_idx >= 0).sum()
    assert len(s2.tris) == 2 * len(s1.tris)
    # no spring crosses between lanes
    used = s2.spring_idx >= 0
    a = s2.pos[np.repeat(s2.spring_rows, s2.spring_idx.shape[1])[
        used.ravel()]]
    b = s2.pos[s2.spring_idx[used]]
    lane = base.x_max - base.x_min
    assert np.abs(a[:, 0] - b[:, 0]).max() < lane / 2
    wide = generate_multi_worm_params(2, base)
    assert wide.x_max == base.x_min + 2 * lane
