"""Wall-compact (fastw) engine vs exact and fast engines — CPU interpret.

fastw restructures WHERE pair contributions are computed (moving-only
carry, compact shell-wall passes, per-resort static wall-wall sums) but
not WHICH pairs contribute: every moving-moving and moving-wall pair
within h is covered (see core/fastw.py module docstring), so it must
match the exact engine at the fast engine's tolerance and the fast
engine itself to f32 reassociation noise.
"""
import numpy as np
import pytest

from sph_jax.config import SimParams
from sph_jax.constants import MAX_NEIGHBORS
from sph_jax.core.fast import compute_fast_config, make_fast_multi_step
from sph_jax.core.fastw import (
    compute_fastw_config,
    make_fastw_multi_step,
    measure_shell_cap,
)
from sph_jax.core.step import multi_step
from sph_jax.scene import generate_liquid_box_scene
from sph_jax.scene.scene import Scene

from test_fast_engine import sparse_blob_scene

H = 3.34


def compare_w(scene, params, steps, atol, **cfg_kw):
    state, springs, membranes = scene.device_state()
    layout = scene.layout()
    ref = multi_step(state, springs, membranes, params, layout, steps)
    cfg = compute_fastw_config(scene.pos, params, layout,
                               ptype=scene.ptype, **cfg_kw)
    assert cfg.interpret  # CPU test
    out, diag = make_fastw_multi_step(params, layout, cfg, steps,
                                      return_diag=True)(
        state, springs, membranes
    )
    assert int(diag["shell_overflow"]) == 0
    np.testing.assert_allclose(
        np.asarray(out.pos), np.asarray(ref.pos), rtol=0, atol=atol
    )
    np.testing.assert_allclose(
        np.asarray(out.vel), np.asarray(ref.vel), rtol=0, atol=atol * 10
    )
    assert int(out.step) == steps
    return out, ref


def test_fastw_matches_exact_sparse_liquid():
    # no boundary particles at all: the shell machinery is skipped
    params = SimParams(x_max=8 * H, y_max=8 * H, z_max=8 * H)
    scene = sparse_blob_scene(params)
    compare_w(scene, params, 3, atol=5e-5)


def test_fastw_matches_exact_box_with_boundary():
    params = SimParams(x_max=8 * H, y_max=8 * H, z_max=8 * H)
    scene = generate_liquid_box_scene(params, fill_fraction=0.5)
    compare_w(scene, params, 3, atol=5e-5)


def test_fastw_matches_fast_with_stale_windows():
    """fastw vs fast at resort_every=2: both engines stale their windows
    identically (fastw's shell is a superset of every in-reach wall), so
    outputs differ only by f32 reassociation of the split column passes."""
    params = SimParams(x_max=8 * H, y_max=8 * H, z_max=8 * H)
    scene = generate_liquid_box_scene(params, fill_fraction=0.5)
    state, springs, membranes = scene.device_state()
    layout = scene.layout()
    cfg_f = compute_fast_config(scene.pos, params, resort_every=2)
    fast = make_fast_multi_step(params, layout, cfg_f, 4)(
        state, springs, membranes)
    cfg_w = compute_fastw_config(scene.pos, params, layout,
                                 ptype=scene.ptype, resort_every=2)
    out = make_fastw_multi_step(params, layout, cfg_w, 4)(
        state, springs, membranes)
    np.testing.assert_allclose(
        np.asarray(out.pos), np.asarray(fast.pos), rtol=0, atol=1e-5
    )
    # walls never move: bitwise identical in both engines
    b0, b1 = layout.boundary_range
    np.testing.assert_array_equal(
        np.asarray(out.pos)[b0:b1], np.asarray(scene.pos)[b0:b1]
    )


def test_fastw_with_springs_and_muscle():
    params = SimParams(x_max=8 * H, y_max=8 * H, z_max=8 * H)
    scene = sparse_blob_scene(params, n_side=6)
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
    out, ref = compare_w(scene, params, 3, atol=5e-5)
    np.testing.assert_allclose(
        np.asarray(out.muscle_activation),
        np.asarray(ref.muscle_activation), atol=1e-7,
    )


def test_fastw_membranes():
    params = SimParams(x_max=8 * H, y_max=8 * H, z_max=8 * H)
    r0 = params.r0
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
    out, ref = compare_w(scene, params, 2, atol=5e-5)
    assert np.asarray(ref.pos)[4, 1] > pos[4, 1]


def test_fastw_matches_exact_with_box_min_offset():
    off = np.array([-2 * H, 1.5 * H, -3 * H], np.float32)
    params = SimParams(
        x_min=float(off[0]), x_max=float(off[0]) + 8 * H,
        y_min=float(off[1]), y_max=float(off[1]) + 8 * H,
        z_min=float(off[2]), z_max=float(off[2]) + 8 * H,
    )
    scene = sparse_blob_scene(params)
    scene.pos += off
    compare_w(scene, params, 3, atol=5e-5)


def test_fastw_simulator_wiring():
    """engine="fastw" through the Simulator facade: steps advance, the
    overflow accumulators read-and-reset through check_overflow, and the
    result tracks the exact engine at engine tolerance."""
    from sph_jax.runtime import Simulator

    params = SimParams(x_max=8 * H, y_max=8 * H, z_max=8 * H)
    scene = generate_liquid_box_scene(params, fill_fraction=0.5)
    state, springs, membranes = scene.device_state()
    ref = multi_step(state, springs, membranes, params, scene.layout(), 3)
    sim = Simulator(scene, params, engine="fastw",
                    fast_config=dict(resort_every=3))
    sim.step(3)
    assert sim.step_count == 3
    ovf = sim.check_overflow()
    assert ovf["shell_overflow"] == 0
    assert ovf["window_drift_h"] >= 0.0
    np.testing.assert_allclose(
        sim.get_position(), np.asarray(ref.pos), rtol=0, atol=5e-5
    )


def test_fastw_wall_static_hoist_matches_in_jit():
    """The wall-static hoist (precomputed wall sort + f64 mutual
    density sums) must reproduce the in-jit wall path: the only
    difference is summation order/precision of the static wall-wall
    sums, so positions agree to f32 noise."""
    from sph_jax.core.fastw import precompute_wall_static

    params = SimParams(x_max=8 * H, y_max=8 * H, z_max=8 * H)
    scene = generate_liquid_box_scene(params, fill_fraction=0.5)
    state, springs, membranes = scene.device_state()
    layout = scene.layout()
    cfg = compute_fastw_config(scene.pos, params, layout,
                               ptype=scene.ptype, resort_every=2)
    base = make_fastw_multi_step(params, layout, cfg, 4)(
        state, springs, membranes)
    ws = precompute_wall_static(scene.pos, scene.normal, params, layout,
                                cfg)
    assert ws is not None
    assert int(np.asarray(ws["ww"]).shape[0]) == cfg.n_wall
    out = make_fastw_multi_step(params, layout, cfg, 4, wall_static=ws)(
        state, springs, membranes)
    np.testing.assert_allclose(
        np.asarray(out.pos), np.asarray(base.pos), rtol=0, atol=1e-5
    )


def test_auto_engine_resolution():
    """engine="auto": exact on the CPU (interpreted kernels); on the GPU,
    fastw wherever springs are elastic-only, fast otherwise; any other
    platform is an error."""
    import dataclasses

    from sph_jax.core.step import SceneLayout
    from sph_jax.runtime.simulator import resolve_auto_engine

    worm_like = SceneLayout(n_particles=100, boundary_range=(56, 100))
    assert resolve_auto_engine("cpu", worm_like) == "exact"
    assert resolve_auto_engine("gpu", worm_like) == "fastw"
    dam_like = SceneLayout(n_particles=100, boundary_range=(89, 100))
    assert resolve_auto_engine("gpu", dam_like) == "fastw"
    no_walls = SceneLayout(n_particles=100)
    assert resolve_auto_engine("gpu", no_walls) == "fastw"
    anchored = dataclasses.replace(worm_like, springs_elastic_only=False)
    assert resolve_auto_engine("gpu", anchored) == "fast"
    with pytest.raises(ValueError):
        resolve_auto_engine("metal", worm_like)


def test_fastw_shell_overflow_is_counted():
    """A deliberately undersized shell capacity must be COUNTED (the
    Simulator surfaces it loudly), not silently truncated into wrong
    physics with no signal."""
    import dataclasses

    params = SimParams(x_max=8 * H, y_max=8 * H, z_max=8 * H)
    scene = generate_liquid_box_scene(params, fill_fraction=0.5)
    state, springs, membranes = scene.device_state()
    layout = scene.layout()
    cfg = compute_fastw_config(scene.pos, params, layout,
                               ptype=scene.ptype, block=128)
    n_sh = measure_shell_cap(scene.pos, scene.ptype, params, cfg.dims,
                             dilate=cfg.dilate)
    if n_sh <= cfg.block:
        pytest.skip("scene's shell too small to undersize")
    # largest block multiple strictly below the measured population
    cfg = dataclasses.replace(
        cfg, n_blocks_s=max(1, (n_sh - 1) // cfg.block))
    assert n_sh > cfg.shell_cap
    _, diag = make_fastw_multi_step(params, layout, cfg, 1,
                                    return_diag=True)(
        state, springs, membranes)
    assert int(diag["shell_overflow"]) > 0


@pytest.mark.parametrize("wall_static", [False, True])
def test_stale_window_misses(wall_static):
    """checks.stale_window_misses: the window tables cover every pair
    within h at their own sort (all counts 0), and jittering the moving
    rows by 0.6 h makes pairs close in from beyond the windows, which it
    counts."""
    import jax.numpy as jnp

    from sph_jax import checks
    from sph_jax.constants import BOUNDARY_PARTICLE
    from sph_jax.core.fastw import make_fastw_stepper, precompute_wall_static

    params = SimParams(x_max=8 * H, y_max=8 * H, z_max=8 * H)
    scene = generate_liquid_box_scene(params, fill_fraction=0.5)
    # the lattice starts > h from the walls: jitter it into their reach
    rng = np.random.default_rng(0)
    mov = scene.ptype != BOUNDARY_PARTICLE
    scene.pos[mov] += rng.uniform(-0.6, 0.6, (mov.sum(), 3)) * params.h
    state, springs, membranes = scene.device_state()
    layout = scene.layout()
    cfg = compute_fastw_config(scene.pos, params, layout, ptype=scene.ptype)
    ws = precompute_wall_static(scene.pos, scene.normal, params, layout,
                                cfg) if wall_static else None
    sort, _, _ = make_fastw_stepper(params, layout, cfg, wall_static=ws)
    ctx, carry, _ = sort(state, springs, membranes)
    fresh = checks.stale_window_misses(ctx, carry, cfg, params)
    assert fresh["mm_pairs"] > 0 and fresh["ms_pairs"] > 0
    assert fresh["mm_missed"] == fresh["ms_missed"] == 0
    assert fresh["sm_missed"] == 0
    assert fresh["moving_max_share"] == fresh["shell_max_share"] == 0.0

    n = cfg.n_mov
    moved = tuple(
        c.at[:n].add(jnp.asarray(rng.uniform(-0.6, 0.6, n) * params.h,
                                 jnp.float32))
        for c in carry[:3]) + tuple(carry[3:])
    stale = checks.stale_window_misses(ctx, moved, cfg, params)
    assert stale["mm_missed"] > 0
    assert 0.0 < stale["moving_max_share"] <= 1.0
