"""Correctness checks shared by the GPU tests, ``bench.py`` and
``chip_smoke.py``.

Each check builds its engines on the default JAX backend, so on a GPU the
pair kernels are the compiled Triton kernels and on the CPU they run in
Pallas interpret mode. Tolerances are stated beside each check with the
reason for them.
"""
from __future__ import annotations

import contextlib
import dataclasses
import subprocess
from unittest import mock

import numpy as np
import jax
import jax.numpy as jnp

from .config import SimParams
from .ops import pair_kernels as pk

# Max norm-wise relative error of a compiled pass against the plain
# reference on the same inputs: max_i |k_i - r_i| / max_i |r_i| over each
# output. Both builds run the same f32 pair arithmetic and differ only in
# reduction order and FMA contraction, so each row sum of ccol terms may
# differ by a few f32 ulps per term. The density sums are positive (no
# cancellation): 1e-5. The force sums add signed terms whose total can be
# far smaller than its largest term: 1e-4.
PASS_TOLERANCE = {"density_pass": 1e-5, "rho_star_pass": 1e-5}
FORCE_TOLERANCE = 1e-4


def pass_tolerance(name: str) -> float:
    return PASS_TOLERANCE.get(name, FORCE_TOLERANCE)


def card_line() -> str:
    """Each card's name and power limit as nvidia-smi gives them (a card
    may be capped below its maximum and then runs slower under load, so
    every timing is printed beside this line)."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


@contextlib.contextmanager
def plain_passes():
    """Build pair passes as the plain-XLA reference instead of the kernel
    while active (measurement and oracle use; no engine selects it)."""
    with mock.patch.object(pk, "build_pass", pk.reference_pass):
        yield


@contextlib.contextmanager
def checked_passes(errors: dict):
    """Build pair passes that also run the plain reference on every call
    and record, per pass name, the max relative error seen into
    ``errors`` (through a host callback, so it works inside jit/scan)."""
    kernel_build = pk.build_pass

    def record(name, err):
        errors[name] = max(errors.get(name, 0.0), float(err))

    def build(prep_fn, tile_fn, **kw):
        kern = kernel_build(prep_fn, tile_fn, **kw)
        ref = pk.reference_pass(prep_fn, tile_fn, **kw)
        name = kw.get("name", "pair_pass")

        def call(tables, own_pack, slab_pack):
            out = kern(tables, own_pack, slab_pack)
            exp = ref(tables, own_pack, slab_pack)
            err = jnp.max(jnp.stack([
                jnp.max(jnp.abs(o - e)) / jnp.maximum(jnp.max(jnp.abs(e)),
                                                      1e-30)
                for o, e in zip(out, exp)
            ]))
            jax.debug.callback(lambda e: record(name, e), err)
            return out

        return call

    with mock.patch.object(pk, "build_pass", build):
        yield


def pass_errors(run):
    """Max relative error of every pair pass that ``run()`` builds and
    calls, kernel vs plain reference on the same inputs:
    {pass name: error}. ``run`` must build its engine inside the call."""
    errors = {}
    with checked_passes(errors), jax.default_matmul_precision("highest"):
        jax.block_until_ready(run())
    jax.effects_barrier()
    return errors


def box_scene(params: SimParams | None = None):
    """The ~2.7k-particle free-fall box of :func:`box_gate` (no walls)."""
    from .scene.scene import Scene

    h = (params or SimParams()).h
    p = SimParams(x_max=10 * h, y_max=10 * h, z_max=10 * h,
                  cell_capacity=96)
    rng = np.random.default_rng(7)
    # 1.25x spacing keeps every particle under the exact engine's
    # 32-neighbor cap — fast (all-pairs) and exact agree only there
    r0 = p.r0 * 1.25
    ax = np.arange(14) * r0
    g = np.stack(np.meshgrid(ax, ax, ax, indexing="ij"), -1).reshape(-1, 3)
    pos = (2.0 + g + rng.uniform(-0.05, 0.05, g.shape) * r0).astype(
        np.float32)
    vel = rng.normal(scale=0.05, size=pos.shape).astype(np.float32)
    scene = Scene(pos=pos, vel=vel,
                  color=np.full(len(pos), 1.1, np.float32),
                  normal=np.zeros_like(pos))
    return scene, p


BOX_FRESH_TOL = 1e-4
BOX_STALE_TOL = 5e-3


def box_gate(engine: str = "fast", steps: int = 10) -> dict:
    """``engine`` (fast or fastw) vs the exact engine on the free-fall box,
    both compiled on the default backend, ``steps`` steps.

    Fresh windows (resort_every=1): the exact engine rebuilds neighbor
    lists per step, so only this arm is comparable at round-off —
    max |dpos| <= 1e-4 catches precision bugs (a 1e-3 operand rounding in
    the spring or pressure sums lands orders of magnitude beyond).
    Stale windows (resort_every=3): exercises the cached window tables;
    pairs entering reach between resorts are missed by design, which on
    this box stays well under 5e-3, while a window-table bug lands far
    beyond it."""
    from .core.fast import compute_fast_config, make_fast_multi_step
    from .core.fastw import (compute_fastw_config, make_fastw_multi_step,
                             precompute_wall_static)
    from .core.step import multi_step

    scene, p = box_scene()
    state, springs, membranes = scene.device_state()
    layout = scene.layout()
    ref = multi_step(state, springs, membranes, p, layout, steps)

    def build(r_every):
        if engine == "fastw":
            cfg = dataclasses.replace(
                compute_fastw_config(scene.pos, p, layout,
                                     ptype=scene.ptype),
                resort_every=r_every)
            return make_fastw_multi_step(
                p, layout, cfg, steps,
                wall_static=precompute_wall_static(
                    scene.pos, scene.normal, p, layout, cfg))
        cfg = dataclasses.replace(compute_fast_config(scene.pos, p),
                                  resort_every=r_every)
        return make_fast_multi_step(p, layout, cfg, steps)

    def dev(r_every):
        out = build(r_every)(state, springs, membranes)
        return float(jnp.max(jnp.abs(out.pos - ref.pos)))

    d1, d3 = dev(1), dev(3)
    ok = bool(np.isfinite(d1) and d1 <= BOX_FRESH_TOL
              and np.isfinite(d3) and d3 <= BOX_STALE_TOL)
    return dict(engine=engine, n=scene.n_particles, steps=steps,
                fresh=d1, stale=d3, ok=ok)


def _tile_cover(tables, ccol: int, block: int, own, col):
    """Whether column ``col`` lies in the tiles of own row ``own``'s block
    (host-side, over arrays of pairs) for a pass's chunk tables."""
    aln, _, _, s0, cnt, _ = (np.asarray(t) for t in tables)
    nb = cnt.shape[0]
    nsub = np.diff(np.concatenate([s0.reshape(nb, 3), cnt[:, None]], 1),
                   axis=1)
    b = own // block
    a = aln.reshape(nb, 3)[b]
    e = a + nsub[b] * ccol
    return ((col[:, None] >= a) & (col[:, None] < e)).any(axis=1)


def stale_window_misses(ctx, carry, cfg, params: SimParams) -> dict:
    """Pairs within h at the positions of a fastw sorted-space ``carry``
    that the window tables of ``ctx`` (built at the period's sort) leave
    out, for the moving x moving, moving x shell and shell x moving
    passes; and the largest share of a row's density sum (the t^3 pair
    sum, self excluded) that those pairs carry. At the sort itself every
    count is 0; between resorts pairs that close in from beyond the
    windows are missed by design (a q ~ 1 term each)."""
    from scipy.spatial import cKDTree

    h2 = float(params.h) ** 2
    n_mov, blk = cfg.n_mov, cfg.block
    m = np.stack([np.asarray(c)[:n_mov] for c in carry[:3]], 1).astype(
        np.float64)
    tree_m = cKDTree(m)
    p = tree_m.query_pairs(params.h, output_type="ndarray")
    i = np.concatenate([p[:, 0], p[:, 1]])
    j = np.concatenate([p[:, 1], p[:, 0]])
    w = np.maximum(h2 - np.sum((m[i] - m[j]) ** 2, axis=1), 0.0) ** 3
    cov = _tile_cover(ctx["tables_m"], cfg.ccol, blk, i, j)
    tot = np.bincount(i, w, n_mov)
    miss = np.bincount(i[~cov], w[~cov], n_mov)
    res = dict(mm_pairs=int(len(i)), mm_missed=int((~cov).sum()))
    if "shell_static" in ctx:
        sh = ctx["shell_static"]
        n_sh = int((np.asarray(sh[6]) > 0).sum())  # real rows: a prefix
        s = np.stack([np.asarray(a)[:n_sh] for a in sh[:3]], 1).astype(
            np.float64)
        d = tree_m.sparse_distance_matrix(cKDTree(s), params.h,
                                          output_type="ndarray")
        im, js = d["i"], d["j"]
        w2 = np.maximum(h2 - d["v"] ** 2, 0.0) ** 3
        cov_ms = _tile_cover(ctx["tables_ms"], cfg.ccol_compact, blk, im,
                             js)
        cov_sm = _tile_cover(ctx["tables_sm"], cfg.ccol, blk, js, im)
        tot += np.bincount(im, w2, n_mov)
        miss += np.bincount(im[~cov_ms], w2[~cov_ms], n_mov)
        tot_s = (np.bincount(js, w2, n_sh)
                 + np.asarray(ctx["ww_const"])[:n_sh])
        miss_s = np.bincount(js[~cov_sm], w2[~cov_sm], n_sh)
        res.update(
            ms_pairs=int(len(im)), ms_missed=int((~cov_ms).sum()),
            sm_missed=int((~cov_sm).sum()),
            shell_max_share=float(
                (miss_s / np.maximum(tot_s, 1e-30)).max(initial=0.0)))
    res["moving_max_share"] = float(
        (miss / np.maximum(tot, 1e-30)).max(initial=0.0))
    return res


def worm_integrity(scene, params: SimParams, state) -> dict:
    """Invariants of a worm run: finite state, max spring strain < 0.5,
    mean liquid density within [0.5, 2.0] x rho0."""
    from .core.step import diagnostics

    pos = np.asarray(state.pos)
    ok = bool(np.isfinite(pos).all())
    strain = 0.0
    if len(scene.spring_rows):
        idx = scene.spring_idx
        used = idx >= 0
        a = pos[np.repeat(scene.spring_rows, idx.shape[1])[used.ravel()]]
        b = pos[idx[used]]
        r = np.linalg.norm(a - b, axis=1) * params.simulation_scale
        rest = scene.spring_rest[used]
        strain = float(np.max(np.abs(r - rest) / np.maximum(rest, 1e-9)))
        ok = ok and strain < 0.5
    rho = np.asarray(diagnostics(state, params)["rho"])
    lq0, lq1 = scene.layout().liquid_range
    mean_rho = float(rho[lq0:lq1].mean() if lq1 > lq0 else rho.mean())
    ratio = mean_rho / params.rho0
    ok = ok and 0.5 <= ratio <= 2.0
    return dict(step=int(state.step), strain=strain, rho_ratio=ratio,
                ok=bool(ok))


def small_worm():
    """A cut-down worm-in-pool scene (~73k particles: full elastic body,
    springs, muscles and membranes in a narrower, shorter pool) that
    exercises all seven pair passes."""
    from .scene import generate_worm_scene

    h = SimParams().h
    params = SimParams(x_max=16 * h, y_max=14 * h, z_max=150 * h)
    return generate_worm_scene(params), params


PASS_NAMES = ("density_pass", "viscsurf_pass", "rho_star_pass",
              "paccel_pass", "spring_pass", "boundary_pass",
              "membrane_pass")


def fast_pass_errors(scene, params, steps: int = 1) -> dict:
    """Kernel-vs-reference error of each of the fast engine's passes over
    ``steps`` steps of ``scene``."""
    from .core.fast import compute_fast_config, make_fast_multi_step

    state, springs, membranes = scene.device_state()
    cfg = compute_fast_config(scene.pos, params)
    return pass_errors(lambda: make_fast_multi_step(
        params, scene.layout(), cfg, steps)(state, springs, membranes))


def check_passes_small_worm() -> dict:
    errors = fast_pass_errors(*small_worm())
    ok = (set(errors) == set(PASS_NAMES)
          and all(e <= pass_tolerance(k) for k, e in errors.items()))
    return dict(errors=errors, ok=bool(ok))


def check_auto_engine_compiled() -> dict:
    """Simulator(engine="auto") on the small worm: picks a pair-kernel
    engine, compiles its passes (no interpret mode) and steps finitely."""
    from .runtime import Simulator

    scene, params = small_worm()
    sim = Simulator(scene, params, engine="auto", async_io=False)
    sim.step(30)
    finite = bool(np.isfinite(sim.get_position()).all())
    cfg = getattr(sim, "_fast_cfg", None)
    interpret = cfg.interpret if cfg is not None else None
    ok = sim.engine in ("fast", "fastw") and interpret is False and finite
    return dict(engine=sim.engine, interpret=interpret, finite=finite,
                ok=bool(ok))


# The checks the GPU tests run (tests/test_gpu.py) — chip_smoke.py calls
# the same functions directly.
GPU_CHECKS = {
    "passes_small_worm": check_passes_small_worm,
    "box_gate_fast": lambda: box_gate("fast"),
    "box_gate_fastw": lambda: box_gate("fastw"),
    "auto_engine_compiled": check_auto_engine_compiled,
}


# Max |dpos| of a multi-device path against its one-device oracle. Both
# run the same pair physics; only the order of the f32 sums differs (slab-
# local vs global tile partitions, sharded vs whole-array reductions), and
# the PCISPH loop amplifies that round-off over the steps. The worm's z
# coordinates reach ~835 sim units, where one f32 ulp is 6.1e-5, so the
# bound is ~8 ulps there — 3e-4 of the particle spacing r0.
MULTI_DEVICE_TOL = 5e-4


def multi_device_check(scene, params: SimParams, n_dev: int,
                       steps: int = 4, resort_every: int = 2) -> dict:
    """The paths that span devices, each against its one-device oracle:
    the halo engine with the replicated and the distributed resort over
    ``steps`` steps across resort boundaries, vs the one-device fast
    engine; and the all-gather sharded exact step vs the exact engine.
    Also records which devices hold shards of each result."""
    from .core.fast import compute_fast_config, make_fast_multi_step
    from .core.grid import measured_cell_capacity
    from .core.step import multi_step
    from .parallel import (make_halo_fast_multi_step, make_mesh,
                           make_sharded_step, measure_halo_pad,
                           measure_migration_pad, pad_scene_to_devices,
                           shard_state)

    mesh = make_mesh(n_dev)
    block = compute_fast_config(scene.pos[:1], params).block
    scene = pad_scene_to_devices(scene, n_dev * block)
    cfg = dataclasses.replace(
        compute_fast_config(scene.pos, params, block_multiple=n_dev),
        resort_every=resort_every)
    state, springs, membranes = scene.device_state()
    layout = scene.layout()
    per_dev = cfg.n_blocks // n_dev * cfg.block
    halo_pad = min(measure_halo_pad(scene.pos, params, cfg), per_dev)
    mig_cap = min(measure_migration_pad(scene.pos, params, cfg), per_dev)

    def holders(x):
        return sorted(s.device.id for s in x.addressable_shards
                      if s.data.shape[0] > 0)

    ref = make_fast_multi_step(params, layout, cfg, steps)(
        state, springs, membranes)
    res = dict(n=scene.n_particles, n_dev=n_dev, steps=steps,
               resort_every=resort_every)
    ok = True
    for dist in (False, True):
        run = make_halo_fast_multi_step(
            mesh, params, layout, cfg, steps, halo_pad=halo_pad,
            distributed_resort=dist, mig_cap=mig_cap if dist else None)
        out, diag = run(shard_state(state, mesh), springs, membranes)
        err = float(jnp.max(jnp.abs(out.pos - ref.pos)))
        ovf = {k: int(v) for k, v in diag.items() if k.endswith("overflow")}
        shards = holders(out.pos)
        arm_ok = (np.isfinite(err) and err <= MULTI_DEVICE_TOL
                  and not any(ovf.values()) and len(shards) == n_dev)
        res["halo_distributed" if dist else "halo_replicated"] = dict(
            max_dpos=err, overflow=ovf, shard_devices=shards,
            ok=bool(arm_ok))
        ok = ok and arm_ok

    cap = measured_cell_capacity(scene.pos, params)
    xp = dataclasses.replace(params,
                             cell_capacity=max(params.cell_capacity, cap))
    exact = multi_step(state, springs, membranes, xp, layout, 2)
    sh = make_sharded_step(mesh, xp, layout, n_steps=2)(
        shard_state(state, mesh), springs, membranes)
    err = float(jnp.max(jnp.abs(sh.pos - exact.pos)))
    shards = holders(sh.pos)
    arm_ok = (np.isfinite(err) and err <= MULTI_DEVICE_TOL
              and len(shards) == n_dev)
    res["sharded_exact"] = dict(max_dpos=err, shard_devices=shards,
                                ok=bool(arm_ok))
    res["ok"] = bool(ok and arm_ok)
    return res
