"""Fast (Pallas pair) engine vs exact engine — CPU interpret mode.

The fast engine interacts all pairs within radius h (no 32-neighbor cap);
on scenes where the cap never binds the two engines must agree to float32
round-off. The compiled kernels are checked against the same oracles on
the GPU by tests/test_gpu.py and chip_smoke.py.
"""
import numpy as np
import pytest
import jax.numpy as jnp

from sph_jax.config import SimParams
from sph_jax.constants import (
    BOUNDARY_PARTICLE,
    ELASTIC_PARTICLE,
    LIQUID_PARTICLE,
    MAX_NEIGHBORS,
)
from sph_jax.core.fast import compute_fast_config, make_fast_multi_step
from sph_jax.core.state import Springs
from sph_jax.core.step import multi_step
from sph_jax.scene import generate_liquid_box_scene
from sph_jax.scene.scene import Scene

H = 3.34


def sparse_blob_scene(params, n_side=7, spacing=1.25, seed=0):
    """Jittered lattice sparse enough that <32 neighbors fit in h."""
    rng = np.random.default_rng(seed)
    r0 = params.r0 * spacing
    ax = np.arange(n_side) * r0
    g = np.stack(np.meshgrid(ax, ax, ax, indexing="ij"), -1).reshape(-1, 3)
    pos = (2.0 + g + rng.uniform(-0.05, 0.05, g.shape) * r0).astype(np.float32)
    vel = rng.normal(scale=0.05, size=pos.shape).astype(np.float32)
    return Scene(pos=pos, vel=vel,
                 color=np.full(len(pos), 1.1, np.float32),
                 normal=np.zeros_like(pos))


def compare(scene, params, steps, atol):
    state, springs, membranes = scene.device_state()
    layout = scene.layout()
    ref = multi_step(state, springs, membranes, params, layout, steps)
    cfg = compute_fast_config(scene.pos, params)
    assert cfg.interpret  # CPU test
    fast = make_fast_multi_step(params, layout, cfg, steps)(
        state, springs, membranes
    )
    np.testing.assert_allclose(
        np.asarray(fast.pos), np.asarray(ref.pos), rtol=0, atol=atol
    )
    np.testing.assert_allclose(
        np.asarray(fast.vel), np.asarray(ref.vel), rtol=0, atol=atol * 10
    )
    assert int(fast.step) == steps
    return fast, ref


def test_fast_matches_exact_sparse_liquid():
    params = SimParams(x_max=8 * H, y_max=8 * H, z_max=8 * H)
    scene = sparse_blob_scene(params)
    compare(scene, params, 3, atol=5e-5)


def test_fast_matches_exact_box_with_boundary():
    params = SimParams(x_max=8 * H, y_max=8 * H, z_max=8 * H)
    scene = generate_liquid_box_scene(params, fill_fraction=0.5)
    compare(scene, params, 3, atol=5e-5)


def test_fast_compact_ccol_matches_exact():
    """ccol_c (narrow compact-pass tiles) changes tile partitioning of the
    boundary pass only — physics must still match the exact engine."""
    params = SimParams(x_max=8 * H, y_max=8 * H, z_max=8 * H)
    scene = generate_liquid_box_scene(params, fill_fraction=0.5)
    state, springs, membranes = scene.device_state()
    layout = scene.layout()
    ref = multi_step(state, springs, membranes, params, layout, 3)
    cfg = compute_fast_config(scene.pos, params, ccol=256, ccol_c=128)
    fast = make_fast_multi_step(params, layout, cfg, 3)(
        state, springs, membranes
    )
    np.testing.assert_allclose(
        np.asarray(fast.pos), np.asarray(ref.pos), rtol=0, atol=5e-5
    )


def test_fast_with_springs_and_muscle():
    params = SimParams(x_max=8 * H, y_max=8 * H, z_max=8 * H)
    scene = sparse_blob_scene(params, n_side=6)
    # mark the first 8 particles elastic, chained with a muscle spring
    scene.color[:8] = 2.2
    ne = 8
    idx = np.full((ne, MAX_NEIGHBORS), -1, np.int32)
    rest = np.zeros((ne, MAX_NEIGHBORS), np.float32)
    mus = np.zeros((ne, MAX_NEIGHBORS), np.int32)
    for a in range(ne):
        s = 0
        for b in (a - 1, a + 1):
            if 0 <= b < ne:
                idx[a, s] = b
                r = np.linalg.norm(scene.pos[a] - scene.pos[b])
                rest[a, s] = r * params.simulation_scale * 0.97
                mus[a, s] = 5
                s += 1
    scene.spring_rows = np.arange(ne, dtype=np.int32)
    scene.spring_idx = idx
    scene.spring_rest = rest
    scene.spring_type = mus.astype(np.float32)
    scene.muscle_model = True
    fast, ref = compare(scene, params, 3, atol=5e-5)
    # activation propagated identically
    np.testing.assert_allclose(
        np.asarray(fast.muscle_activation),
        np.asarray(ref.muscle_activation), atol=1e-7,
    )


def test_fast_membranes():
    """Liquid particle near a small elastic membrane patch."""
    params = SimParams(x_max=8 * H, y_max=8 * H, z_max=8 * H)
    r0 = params.r0
    # a 2-triangle elastic quad in the x-z plane at y=8, liquid just above
    quad = np.array([
        [8.0, 8.0, 8.0], [8.0 + r0, 8.0, 8.0],
        [8.0, 8.0, 8.0 + r0], [8.0 + r0, 8.0, 8.0 + r0],
    ], np.float32)
    liq = np.array([[8.0 + 0.5 * r0, 8.0 + 0.4 * r0, 8.0 + 0.5 * r0]],
                   np.float32)
    pos = np.concatenate([quad, liq])
    scene = Scene(
        pos=pos, vel=np.zeros_like(pos),
        color=np.array([2.1] * 4 + [1.1], np.float32),
        normal=np.zeros_like(pos),
        tris=np.array([[0, 1, 2], [1, 3, 2]], np.int32),
    )
    fast, ref = compare(scene, params, 2, atol=5e-5)
    # the membrane projection must actually fire (liquid pushed along +y)
    assert np.asarray(ref.pos)[4, 1] > pos[4, 1]


def test_fast_matches_exact_with_box_min_offset():
    """Nonzero box_min: fast-engine cell binning must subtract the box origin
    exactly like grid.cell_coords_of, or slab windows shift and clip."""
    off = np.array([-2 * H, 1.5 * H, -3 * H], np.float32)
    params = SimParams(
        x_min=float(off[0]), x_max=float(off[0]) + 8 * H,
        y_min=float(off[1]), y_max=float(off[1]) + 8 * H,
        z_min=float(off[2]), z_max=float(off[2]) + 8 * H,
    )
    scene = sparse_blob_scene(params)
    scene.pos += off  # same blob, shifted into the offset box
    compare(scene, params, 3, atol=5e-5)


def test_spring_pass_matches_gather_fallback():
    """The compact-slab spring pass vs the [Ne,32] gather fallback on a
    scene whose springs are all elastic-anchored (the generated test worm
    has boundary-anchored springs, so it exercises only the fallback —
    this gap once hid a spring-force precision bug)."""
    import dataclasses

    from sph_jax.core.state import make_state, Springs, empty_membranes
    from sph_jax.core.step import SceneLayout

    params = SimParams()
    r0 = params.r0
    pos, typ, nrm = [], [], []
    for k in range(24):  # elastic chain (elastic block first)
        pos.append([5.0 + 0.8 * r0 * k, 8.0, 5.0])
        typ.append(2); nrm.append([0, 0, 0])
    for ix in range(6):
        for iy in range(4):
            for iz in range(6):
                pos.append([2 + ix * r0, 3 + iy * r0, 2 + iz * r0])
                typ.append(1); nrm.append([0, 0, 0])
    for ix in range(12):
        for iz in range(12):
            pos.append([ix * r0, 0.2, iz * r0])
            typ.append(3); nrm.append([0, 1, 0])
    pos = np.array(pos, np.float32)
    state = make_state(pos, np.zeros_like(pos), np.array(typ, np.int32),
                       np.array(nrm, np.float32))
    idx = np.full((24, 32), -1, np.int32)
    rest = np.zeros((24, 32), np.float32)
    musc = np.zeros((24, 32), np.int32)
    for k in range(24):
        s = 0
        for j in (k - 1, k + 1):
            if 0 <= j < 24:
                idx[k, s] = j
                rest[k, s] = 0.8 * r0 * params.simulation_scale * 0.95
                musc[k, s] = (min(k, j) % 5) + 1
                s += 1
    import jax
    springs = jax.tree.map(jnp.asarray, Springs(
        row_ids=np.arange(24, dtype=np.int32), idx=idx, rest=rest,
        muscle=musc))
    membranes = empty_membranes(len(pos))
    act = np.zeros(100, np.float32)
    act[:5] = 0.7
    state = dataclasses.replace(state, muscle_activation=jnp.asarray(act))

    lay = SceneLayout(n_particles=len(pos), elastic_range=(0, 24),
                      muscle_model=False, springs_elastic_only=True)
    cfg = compute_fast_config(pos, params, block=128, ccol=128,
                              interpret=True)
    out = {}
    for name, l in [("pass", lay),
                    ("fb", dataclasses.replace(
                        lay, springs_elastic_only=False))]:
        out[name] = make_fast_multi_step(params, l, cfg, 2)(
            state, springs, membranes)
    np.testing.assert_allclose(
        np.asarray(out["pass"].vel), np.asarray(out["fb"].vel),
        rtol=0, atol=1e-6,
    )
    np.testing.assert_allclose(
        np.asarray(out["pass"].pos), np.asarray(out["fb"].pos),
        rtol=0, atol=1e-5,  # pos_dt (~2.5) amplifies f32 vel round-off
    )


def _stretched_sheet():
    """An elastic sheet in the x-z plane whose springs join particles three
    rows apart in z (2.7 h): every partner lies outside the +-1-pencil
    bands of its own row, at compact columns far beyond the band chunks."""
    import jax

    from sph_jax.core.state import make_state, Springs, empty_membranes
    from sph_jax.core.step import SceneLayout

    params = SimParams(x_max=12 * H, y_max=8 * H, z_max=20 * H)
    nxs, nzs, gap = 6, 16, 3
    ix, iz = np.meshgrid(np.arange(nxs), np.arange(nzs), indexing="ij")
    ix, iz = ix.ravel(), iz.ravel()
    pos = np.stack([2.0 + 0.9 * H * ix, np.full(ix.shape, 4.0),
                    2.0 + 0.9 * H * iz], 1).astype(np.float32)
    n = len(pos)
    state = make_state(pos, np.zeros_like(pos), np.full(n, 2, np.int32),
                       np.zeros_like(pos))
    idx = np.full((n, 2), -1, np.int32)
    rest = np.zeros((n, 2), np.float32)
    for k in range(n):
        s = 0
        for dz in (-gap, gap):
            if 0 <= iz[k] + dz < nzs:
                j = k + dz  # iz is the fast index of the ravelled grid
                idx[k, s] = j
                rest[k, s] = 0.95 * np.linalg.norm(pos[k] - pos[j]) \
                    * params.simulation_scale
                s += 1
    springs = jax.tree.map(jnp.asarray, Springs(
        row_ids=np.arange(n, dtype=np.int32), idx=idx, rest=rest,
        muscle=np.zeros((n, 2), np.int32)))
    lay = SceneLayout(n_particles=n, elastic_range=(0, n),
                      springs_elastic_only=True, spring_slots=2)
    return params, pos, state, springs, empty_membranes(n), lay


@pytest.mark.parametrize("engine", ["fast", "fastw", "halo"])
def test_spring_pass_counts_springs_beyond_window(engine):
    """Springs stretched past the pencil-band window still act: the compact
    spring pass (fast, fastw, or halo on 2 devices) against the fast
    engine's gather fallback, at the default 8 x 8 tiles."""
    import dataclasses

    from sph_jax.core.fastw import compute_fastw_config, make_fastw_multi_step
    from sph_jax.parallel import make_mesh, shard_state
    from sph_jax.parallel.halo import make_halo_fast_multi_step

    params, pos, state, springs, membranes, lay = _stretched_sheet()
    cfg = compute_fast_config(pos, params, interpret=True, block_multiple=2)
    ref = make_fast_multi_step(
        params, dataclasses.replace(lay, springs_elastic_only=False), cfg,
        2)(state, springs, membranes)
    if engine == "fast":
        out = make_fast_multi_step(params, lay, cfg, 2)(
            state, springs, membranes)
    elif engine == "fastw":
        wcfg = compute_fastw_config(pos, params, lay, interpret=True)
        out = make_fastw_multi_step(params, lay, wcfg, 2)(
            state, springs, membranes)
    else:
        mesh = make_mesh(2)
        out, diag = make_halo_fast_multi_step(
            mesh, params, lay, cfg, 2, halo_pad=len(pos) // 2)(
            shard_state(state, mesh), springs, membranes)
        assert int(diag["halo_overflow"]) == 0
    # the springs move the sheet: a dropped spring shows at this scale
    assert float(jnp.max(jnp.abs(ref.vel))) > 1e-3
    np.testing.assert_allclose(np.asarray(out.vel), np.asarray(ref.vel),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(np.asarray(out.pos), np.asarray(ref.pos),
                               rtol=0, atol=1e-5)


def test_stepper_matches_multi_step():
    """make_fast_stepper with one inner chunk per resort must reproduce
    make_fast_multi_step exactly (same resort cadence)."""
    from sph_jax.core.fast import make_fast_stepper

    params = SimParams(x_max=8 * H, y_max=8 * H, z_max=8 * H)
    scene = generate_liquid_box_scene(params, fill_fraction=0.5)
    state, springs, membranes = scene.device_state()
    layout = scene.layout()
    cfg = compute_fast_config(scene.pos, params, block=128, ccol=128,
                              interpret=True, resort_every=5)
    ref = make_fast_multi_step(params, layout, cfg, 10)(
        state, springs, membranes)

    sort, inner, unsort = make_fast_stepper(params, layout, cfg,
                                            inner_steps=5)
    out = state
    for _ in range(2):
        ctx, carry = sort(out, springs, membranes)
        carry = inner(ctx, carry)
        out = unsort(ctx, carry, out)
    np.testing.assert_allclose(np.asarray(out.pos), np.asarray(ref.pos),
                               rtol=0, atol=1e-6)
    assert int(out.step) == 10
