"""Validation against the reference's shipped scene data.

`/root/reference/configuration/` is the only ground truth the reference
ships (load path `owHelper.cpp:1431-1545`): the 49,153-particle worm
(position.txt/velocity.txt) and the 61,440-particle pure-liquid box
(positionPureLiquid.txt). The shipped elasticconnections.txt was stripped
from the repo (.MISSING_LARGE_BLOBS), so the worm loads without springs.
"""
import os

import numpy as np
import pytest

from sph_jax.config import SimParams
from sph_jax.core.step import diagnostics, multi_step
from sph_jax.scene.io import load_scene, load_scene_one_file
from sph_jax.constants import (
    BOUNDARY_PARTICLE,
    ELASTIC_PARTICLE,
    LIQUID_PARTICLE,
)

CONFIG_DIR = "/root/reference/configuration"

pytestmark = pytest.mark.skipif(
    not os.path.isdir(CONFIG_DIR), reason="reference data not available"
)


def _params_for(scene):
    """The shipped files predate the current owPhysicsConstant.h box
    (they span 36h x 24h x 54.5h; the header says 30h x 20h x 250h), so
    the world box is taken from the data extent — walls sit exactly on the
    box faces."""
    mx = scene.pos.max(axis=0)
    return SimParams(
        x_max=float(mx[0]), y_max=float(mx[1]), z_max=float(mx[2])
    )


def _counts(ptype):
    return {
        "boundary": int((ptype == BOUNDARY_PARTICLE).sum()),
        "elastic": int((ptype == ELASTIC_PARTICLE).sum()),
        "liquid": int((ptype == LIQUID_PARTICLE).sum()),
    }


def test_shipped_worm_counts_and_layout():
    scene = load_scene(CONFIG_DIR)
    c = _counts(scene.ptype)
    # measured from the shipped file; SURVEY §2.7 says 49,152 but that was
    # a `wc -l` undercount — the final row has no trailing newline and the
    # reference's own loader counts it (owHelper.cpp:1444-1446 accepts any
    # row with p_type >= 0), and the per-class breakdown sums to 49,153
    assert scene.n_particles == 49153
    assert c == {"boundary": 33074, "elastic": 7327, "liquid": 8752}
    params = _params_for(scene)
    assert (scene.pos >= 0).all()
    assert (scene.pos[:, 0] <= params.x_max).all()
    assert (scene.pos[:, 1] <= params.y_max).all()
    assert (scene.pos[:, 2] <= params.z_max).all()
    # boundary rows must carry unit-ish wall normals (owHelper.cpp:791-803)
    nb = scene.normal[scene.ptype == BOUNDARY_PARTICLE]
    ln = np.linalg.norm(nb, axis=1)
    assert (ln > 0.5).all() and (ln < 1.5).all()


def test_shipped_pure_liquid_counts():
    scene = load_scene(
        CONFIG_DIR,
        position_file="positionPureLiquid.txt",
        velocity_file="velocityPureLiquid.txt",
        muscle_model=False,
    )
    c = _counts(scene.ptype)
    assert scene.n_particles == 61440
    assert c == {"boundary": 32834, "elastic": 0, "liquid": 28606}


def test_shipped_pure_liquid_steps_stable():
    """Step the shipped pure-liquid box and assert the physics holds:
    finite state, particles inside the box, liquid density within a
    physical band of rho0 (SURVEY §4 golden-trajectory plan)."""
    scene = load_scene(
        CONFIG_DIR,
        position_file="positionPureLiquid.txt",
        velocity_file="velocityPureLiquid.txt",
        muscle_model=False,
    )
    params = _params_for(scene)
    state, springs, membranes = scene.device_state()
    layout = scene.layout()
    state = multi_step(state, springs, membranes, params, layout, 5)
    pos = np.asarray(state.pos)
    vel = np.asarray(state.vel)
    assert np.isfinite(pos).all() and np.isfinite(vel).all()
    assert (pos[:, 0] >= params.x_min - 1e-3).all()
    assert (pos[:, 0] <= params.x_max + 1e-3).all()
    assert (pos[:, 1] >= params.y_min - 1e-3).all()
    assert (pos[:, 1] <= params.y_max + 1e-3).all()
    assert (pos[:, 2] >= params.z_min - 1e-3).all()
    assert (pos[:, 2] <= params.z_max + 1e-3).all()
    rho = np.asarray(diagnostics(state, params)["rho"])
    liq = np.asarray(state.ptype) == LIQUID_PARTICLE
    med = float(np.median(rho[liq]))
    assert 0.5 * params.rho0 < med < 1.6 * params.rho0, med


def test_shipped_worm_steps_finite():
    """The shipped worm scene (no springs — the connections file was
    stripped upstream) must still step without blowup."""
    scene = load_scene(CONFIG_DIR)
    params = _params_for(scene)
    state, springs, membranes = scene.device_state()
    layout = scene.layout()
    state = multi_step(state, springs, membranes, params, layout, 3)
    pos = np.asarray(state.pos)
    assert np.isfinite(pos).all()
    assert (pos >= -1e-3).all()


def test_one_file_roundtrip(tmp_path):
    """Cover load_scene_one_file (owHelper.cpp:1547-1639) with a sectioned
    fixture built from the shipped worm scene."""
    scene = load_scene(CONFIG_DIR)
    # synthesize springs for a handful of elastic particles so the
    # ElasticConnection section is exercised
    el = np.nonzero(scene.ptype == ELASTIC_PARTICLE)[0][:4]
    conn_rows = []
    for a, b in zip(el[:-1], el[1:]):
        conn_rows.append((float(a), float(b) + 0.1, 0.001, 2.0))

    path = tmp_path / "configuration.txt"
    with open(path, "w") as fh:
        fh.write("Position\n")
        for p, c in zip(scene.pos, scene.color):
            fh.write(f"{p[0]:.9g}\t{p[1]:.9g}\t{p[2]:.9g}\t{c:.6g}\n")
        fh.write("Velocity\n")
        is_b = (scene.ptype == BOUNDARY_PARTICLE)[:, None]
        vel4 = np.where(is_b, scene.normal, scene.vel)
        for v, c in zip(vel4, scene.color):
            fh.write(f"{v[0]:.9g}\t{v[1]:.9g}\t{v[2]:.9g}\t{c:.6g}\n")
        fh.write("ElasticConnection\n")
        fh.write(f"{len(conn_rows)}\n")
        for row in conn_rows:
            fh.write("\t".join(f"{v:.9g}" for v in row) + "\n")

    loaded = load_scene_one_file(str(path))
    assert loaded.n_particles == scene.n_particles
    np.testing.assert_allclose(loaded.pos, scene.pos, atol=1e-5)
    np.testing.assert_array_equal(loaded.ptype, scene.ptype)
    np.testing.assert_allclose(loaded.normal, scene.normal, atol=1e-5)
    # the synthesized springs round-tripped
    assert len(loaded.spring_rows) == int(
        (scene.ptype == ELASTIC_PARTICLE).sum()
    )
    row0 = np.nonzero(loaded.spring_rows == el[0])[0][0]
    assert loaded.spring_idx[row0, 0] == el[1]
    assert abs(loaded.spring_rest[row0, 0] - 0.001) < 1e-6
