"""Halo-exchange sharded fast engine vs single-chip fast engine.

The halo path (parallel/halo.py) exchanges only fixed-capacity edge bands
via ppermute between resorts; trajectories must match the single-chip fast
engine to f32 round-off, and the halo_overflow diagnostic must be zero
(windows fully covered by the halo band).
"""
import numpy as np
import jax
import pytest

from sph_jax.config import SimParams
from sph_jax.core.fast import compute_fast_config, make_fast_multi_step
from sph_jax.parallel import make_mesh, pad_scene_to_devices, shard_state
from sph_jax.parallel.halo import make_halo_fast_multi_step
from sph_jax.scene import generate_liquid_box_scene, generate_worm_scene

H = 3.34


@pytest.fixture(scope="module")
def n_dev():
    n = len(jax.devices())
    if n < 2:
        pytest.skip("needs multiple (virtual) devices")
    return n


def _run_both(scene, params, n_dev, steps, halo_pad, block=256,
              resort_every=10):
    scene = pad_scene_to_devices(scene, n_dev * block)
    state, springs, membranes = scene.device_state()
    layout = scene.layout()
    cfg = compute_fast_config(
        scene.pos, params, block=block, resort_every=resort_every,
    )

    ref = make_fast_multi_step(params, layout, cfg, steps)(
        state, springs, membranes
    )

    mesh = make_mesh(n_dev)
    run = make_halo_fast_multi_step(
        mesh, params, layout, cfg, steps, halo_pad=halo_pad
    )
    out, diag = run(shard_state(state, mesh), springs, membranes)
    assert float(diag["window_drift"]) >= 0.0
    return ref, out, int(diag["halo_overflow"])


def test_halo_matches_fast_box(n_dev):
    # z-elongated box: slabs are meaningful (a z cell-row holds ~190
    # particles, well under the 512-row halo band)
    params = SimParams(x_max=6 * H, y_max=6 * H, z_max=60 * H)
    scene = generate_liquid_box_scene(params, fill_fraction=0.5)
    ref, out, overflow = _run_both(
        scene, params, n_dev, steps=5, halo_pad=512, block=128
    )
    assert overflow == 0, "halo band too small for the box scene"
    np.testing.assert_allclose(
        np.asarray(out.pos), np.asarray(ref.pos), rtol=0, atol=2e-5
    )
    np.testing.assert_allclose(
        np.asarray(out.vel), np.asarray(ref.vel), rtol=0, atol=2e-5
    )
    assert int(out.step) == 5


def test_halo_matches_fast_worm(n_dev):
    """Full physics (springs + muscles + membranes) under halo sharding,
    across a resort boundary (steps > resort_every)."""
    params = SimParams(x_max=20 * H, y_max=12 * H, z_max=110 * H)
    scene = generate_worm_scene(params)
    ref, out, overflow = _run_both(
        scene, params, n_dev, steps=3, halo_pad=2048, block=128,
        resort_every=2,
    )
    assert overflow == 0, "halo band too small for the worm scene"
    np.testing.assert_allclose(
        np.asarray(out.pos), np.asarray(ref.pos), rtol=0, atol=5e-5
    )
    assert int(out.step) == 3


def test_simulator_halo_engine(n_dev):
    """Simulator(engine='halo') pads the scene to the device grid, steps,
    and surfaces the halo_overflow diagnostic."""
    from sph_jax.runtime import Simulator

    params = SimParams(x_max=6 * H, y_max=6 * H, z_max=60 * H)
    scene = generate_liquid_box_scene(params, fill_fraction=0.5)
    sim = Simulator(scene, params, engine="halo")
    assert sim.scene.n_particles % n_dev == 0
    sim.step(2)
    assert sim.step_count == 2
    pos = sim.get_position()
    assert np.isfinite(pos).all()
    out = sim.check_overflow()
    assert out["halo_overflow"] == 0


def test_simulator_halo_distributed(n_dev):
    """Simulator(engine='halo', distributed_resort=True) steps and
    surfaces the resort_overflow diagnostic."""
    from sph_jax.runtime import Simulator

    params = SimParams(x_max=6 * H, y_max=6 * H, z_max=60 * H)
    scene = generate_liquid_box_scene(params, fill_fraction=0.5)
    sim = Simulator(scene, params, engine="halo", distributed_resort=True)
    sim.step(2)
    assert sim.step_count == 2
    assert np.isfinite(sim.get_position()).all()
    out = sim.check_overflow()
    assert out["halo_overflow"] == 0
    assert out["resort_overflow"] == 0


def test_distributed_resort_matches_replicated(n_dev):
    """The O(cells) distributed resort (histogram ranks + neighbor-only
    migration, halo.py) vs the replicated all-gather resort,
    crossing MULTIPLE resort boundaries. Intra-cell order differs (stable
    w.r.t. previous sorted order vs original ids), so agreement is to f32
    round-off, not bitwise."""
    params = SimParams(x_max=6 * H, y_max=6 * H, z_max=60 * H)
    scene = generate_liquid_box_scene(params, fill_fraction=0.5)
    block = 128
    scene = pad_scene_to_devices(scene, n_dev * block)
    state, springs, membranes = scene.device_state()
    layout = scene.layout()
    cfg = compute_fast_config(
        scene.pos, params, block=block, resort_every=3
    )
    mesh = make_mesh(n_dev)
    outs = {}
    for dist in (False, True):
        run = make_halo_fast_multi_step(
            mesh, params, layout, cfg, n_steps=8, halo_pad=512,
            distributed_resort=dist,
        )
        out, diag = run(shard_state(state, mesh), springs, membranes)
        assert int(diag["halo_overflow"]) == 0
        if dist:
            assert int(diag["resort_overflow"]) == 0
        outs[dist] = out
    err = float(np.abs(np.asarray(outs[True].pos)
                       - np.asarray(outs[False].pos)).max())
    assert err <= 5e-5, err
    assert int(outs[True].step) == 8


def test_distributed_resort_worm(n_dev):
    """Full physics (springs + muscles + membranes) under the distributed
    resort, crossing a resort boundary."""
    params = SimParams(x_max=20 * H, y_max=12 * H, z_max=110 * H)
    scene = generate_worm_scene(params)
    scene = pad_scene_to_devices(scene, n_dev * 128)
    state, springs, membranes = scene.device_state()
    layout = scene.layout()
    cfg = compute_fast_config(
        scene.pos, params, block=128, resort_every=2
    )
    mesh = make_mesh(n_dev)
    run = make_halo_fast_multi_step(
        mesh, params, layout, cfg, n_steps=3, halo_pad=2048,
        distributed_resort=True,
    )
    out, diag = run(shard_state(state, mesh), springs, membranes)
    assert int(diag["halo_overflow"]) == 0
    assert int(diag["resort_overflow"]) == 0
    ref = make_fast_multi_step(params, layout, cfg, 3)(
        state, springs, membranes)
    err = float(np.abs(np.asarray(out.pos) - np.asarray(ref.pos)).max())
    assert err <= 5e-5, err


def test_halo_session_matches_multi_step(n_dev):
    """The session API (begin -> k x step -> finish) must reproduce the
    one-call distributed runner exactly: same sweeps, same arithmetic,
    only the jit boundaries differ."""
    from sph_jax.parallel import make_halo_session

    params = SimParams(x_max=6 * H, y_max=6 * H, z_max=60 * H)
    scene = generate_liquid_box_scene(params, fill_fraction=0.5)
    block = 128
    scene = pad_scene_to_devices(scene, n_dev * block)
    state, springs, membranes = scene.device_state()
    layout = scene.layout()
    cfg = compute_fast_config(
        scene.pos, params, block=block, resort_every=3
    )
    mesh = make_mesh(n_dev)
    state_s = shard_state(state, mesh)

    run = make_halo_fast_multi_step(
        mesh, params, layout, cfg, n_steps=6, halo_pad=512,
        distributed_resort=True,
    )
    ref, _ = run(state_s, springs, membranes)

    begin, step, finish = make_halo_session(
        mesh, params, layout, cfg, halo_pad=512)
    sess = begin(state_s, membranes)
    for _ in range(2):  # 2 x resort_every = 6 steps
        sess, diag = step(sess, springs, membranes)
        assert int(diag["halo_overflow"]) == 0
        assert int(diag["resort_overflow"]) == 0
    out = finish(sess, state_s)
    assert int(out.step) == 6
    np.testing.assert_array_equal(np.asarray(out.pos),
                                  np.asarray(ref.pos))
    np.testing.assert_array_equal(np.asarray(out.vel),
                                  np.asarray(ref.vel))


def test_measure_halo_pad():
    """Scene-measured halo band: covers the densest two z-rows with
    margin, ALIGN-rounded, and at least ALIGN."""
    from sph_jax.parallel import measure_halo_pad
    from sph_jax.core.fast import compute_fast_config
    from sph_jax.ops.pair_kernels import ALIGN

    params = SimParams()
    rng = np.random.default_rng(3)
    pos = rng.uniform(
        [params.x_min, params.y_min, params.z_min],
        [params.x_max, params.y_max, params.z_max],
        (4096, 3),
    ).astype(np.float32)
    cfg = compute_fast_config(pos, params)
    pad = measure_halo_pad(pos, params, cfg)
    assert pad % ALIGN == 0
    cell = params.h
    nz = cfg.dims[2]
    zrow = np.clip((pos[:, 2] - params.z_min) / cell, 0, nz - 1).astype(int)
    counts = np.bincount(zrow, minlength=nz)
    two = int((counts[:-1] + counts[1:]).max())
    assert pad >= two + cfg.ccol  # covers the densest pair of rows


@pytest.mark.slow
def test_halo_multi_worm():
    """Two worms, one widened pool, stepped by the halo engine on 8
    virtual devices — matches the single-chip fast engine across a
    resort boundary (SURVEY §7 step 7 at multi-worm scale)."""
    import dataclasses

    from sph_jax.scene import (
        generate_multi_worm_params, generate_multi_worm_scene)

    H = 3.34
    base = SimParams(x_max=14 * H, y_max=12 * H, z_max=108 * H)
    scene = generate_multi_worm_scene(2, base)
    wide = generate_multi_worm_params(2, base)
    ndev = 8
    mesh = make_mesh(ndev)
    block = 128
    scene = pad_scene_to_devices(scene, ndev * block)
    state, springs, membranes = scene.device_state()
    layout = scene.layout()
    cfg = dataclasses.replace(
        compute_fast_config(scene.pos, wide, block=block),
        resort_every=2,
    )
    halo = make_halo_fast_multi_step(
        mesh, wide, layout, cfg, n_steps=3, halo_pad=2048
    )
    out, diag = halo(shard_state(state, mesh), springs, membranes)
    assert int(diag["halo_overflow"]) == 0
    ref = make_fast_multi_step(wide, layout, cfg, 3)(
        state, springs, membranes)
    err = float(np.abs(np.asarray(out.pos) - np.asarray(ref.pos)).max())
    assert err <= 5e-5, err


def test_migration_overflow_detected(n_dev):
    """The distributed resort must COUNT dropped rows:
    bulk-advect the whole box by ~a cell per step so the first resort
    migrates far more rows than a deliberately tiny mig_cap can carry —
    diag["resort_overflow"] must come back nonzero (physics sanity is
    irrelevant here; only the loss accounting is under test)."""
    import dataclasses

    params = SimParams(x_max=6 * H, y_max=6 * H, z_max=60 * H)
    scene = generate_liquid_box_scene(params, fill_fraction=0.5)
    block = 128
    scene = pad_scene_to_devices(scene, n_dev * block)
    state, springs, membranes = scene.device_state()
    # ~one cell of z-advection per step: every slab's boundary region
    # crosses a rank boundary at the first resort
    pos_dt = params.time_step * params.simulation_scale_inv
    vz = H / pos_dt
    state = dataclasses.replace(
        state, vel=state.vel + np.array([0, 0, vz], np.float32))
    layout = scene.layout()
    cfg = compute_fast_config(
        scene.pos, params, block=block, resort_every=2)
    mesh = make_mesh(n_dev)
    # under uniform advection ranks shift only by the STATIC (wall)
    # population being overtaken (~2 wall-rows ~ 100 rows/device here),
    # so the cap must sit well under that to provoke the overflow
    run = make_halo_fast_multi_step(
        mesh, params, layout, cfg, n_steps=4, halo_pad=512,
        distributed_resort=True, mig_cap=8,
    )
    _, diag = run(shard_state(state, mesh), springs, membranes)
    assert int(diag["resort_overflow"]) > 0


def test_particle_loss_is_loud(n_dev, caplog):
    """Dropped particles must produce an ERROR at the Simulator run site,
    not only a pollable diagnostic."""
    import logging

    import jax.numpy as jnp

    from sph_jax.runtime import Simulator

    params = SimParams(x_max=6 * H, y_max=6 * H, z_max=60 * H)
    scene = generate_liquid_box_scene(params, fill_fraction=0.5)
    sim = Simulator(scene, params, engine="halo", distributed_resort=True)
    # seed the lazy accumulator the halo run wrapper max-accumulates into:
    # equivalent to a chunk having reported this overflow
    sim._resort_overflow = jnp.asarray(7)
    with caplog.at_level(logging.ERROR, logger="sph_jax"):
        sim.step(1)
    assert any(
        r.levelno == logging.ERROR and "DROPPED" in r.getMessage()
        for r in caplog.records
    ), caplog.records
    # check_overflow still reports (and resets) the same accumulator
    assert sim.check_overflow()["resort_overflow"] >= 7
