#!/usr/bin/env python3
"""Smoke run of sph_jax on the GPU, in one process.

    python chip_smoke.py          # one card: phases 1-5
    python chip_smoke.py --four   # four cards: only the paths that span
                                  # devices, each against its oracle

Phases (one card):
  1. the card, from JAX and from nvidia-smi; the pair kernels compile
     (no interpret mode);
  2. every pair pass of the fast and fastw engines at the full worm's
     widths against the plain-XLA reference on the same inputs;
  3. the box gate: fast and fastw against the exact engine;
  4. the full worm through Simulator(engine="auto") for 510 steps, the
     integrity gate and the overflow counters, and ms/step of (a) the
     engine with the Triton passes, (b) the same engine with the plain
     passes, (c) the exact engine;
  5. the checks of the tests marked ``gpu`` (sph_jax.checks.GPU_CHECKS).

No CPU fallback: with no GPU, with the package missing, or when any phase
fails, it exits non-zero and prints no result line. The last line of
stdout is the JSON result.
"""
import argparse
import contextlib
import json
import os
import sys
import time

WORM_STEPS = 510


def log(msg):
    print(msg, flush=True)


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(ok, msg):
    if not ok:
        fail(msg)


def timed_sim(scene, params, engine, warm_steps, steps, plain=False):
    """Compile seconds and ms/step of ``steps`` steps after a warm-up of
    ``warm_steps``, every window ending in jax.block_until_ready."""
    import jax

    from sph_jax import checks
    from sph_jax.runtime import Simulator

    sim = Simulator(scene, params, engine=engine, async_io=False)
    with checks.plain_passes() if plain else contextlib.nullcontext():
        t0 = time.perf_counter()
        sim.step(warm_steps)
        jax.block_until_ready(sim.state)
        compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sim.step(steps)
    jax.block_until_ready(sim.state)
    ms = (time.perf_counter() - t0) / steps * 1e3
    return sim, compile_s, ms


def one_card():
    import jax

    from sph_jax import checks
    from sph_jax.config import SimParams
    from sph_jax.core.fast import compute_fast_config, make_fast_multi_step
    from sph_jax.core.fastw import (compute_fastw_config,
                                    make_fastw_multi_step,
                                    precompute_wall_static)
    from sph_jax.ops import pair_kernels as pk
    from sph_jax.runtime.simulator import resolve_auto_engine
    from sph_jax.scene import generate_worm_scene

    params = SimParams()
    scene = generate_worm_scene(params)
    layout = scene.layout()
    state, springs, membranes = scene.device_state()
    fcfg = compute_fast_config(scene.pos, params)
    wcfg = compute_fastw_config(scene.pos, params, layout,
                                ptype=scene.ptype)
    check(not pk.default_interpret() and not fcfg.interpret
          and not wcfg.interpret, "pair kernels would run interpreted")
    log(f"phase 1: interpret={fcfg.interpret}; worm {scene.n_particles} "
        f"particles {scene.counts}; fast block={fcfg.block} "
        f"ccol={fcfg.ccol} warps={pk.NUM_WARPS}")

    # -- phase 2: every pass at the full worm's widths -------------------
    wall_static = precompute_wall_static(scene.pos, scene.normal, params,
                                         layout, wcfg)
    runs = {
        "fast": lambda: make_fast_multi_step(params, layout, fcfg, 1)(
            state, springs, membranes),
        "fastw": lambda: make_fastw_multi_step(
            params, layout, wcfg, 1, wall_static=wall_static)(
            state, springs, membranes),
    }
    for engine, run in runs.items():
        t0 = time.perf_counter()
        errors = checks.pass_errors(run)
        log(f"phase 2: {engine} passes compiled and checked in "
            f"{time.perf_counter() - t0:.1f} s")
        if engine == "fast":
            check(set(errors) == set(checks.PASS_NAMES),
                  f"fast engine ran passes {sorted(errors)}")
        for name, err in sorted(errors.items()):
            tol = checks.pass_tolerance(name)
            log(f"phase 2: {engine} {name}: max rel err {err:.3e} vs plain "
                f"reference (tol {tol:.0e}: f32 reduction order)")
            check(err <= tol, f"{engine} {name} error {err:.3e} > {tol}")
    auto = resolve_auto_engine(jax.default_backend(), layout)
    step = make_fastw_multi_step(params, layout, wcfg, wcfg.resort_every,
                                 wall_static=wall_static) \
        if auto == "fastw" else make_fast_multi_step(params, layout, fcfg,
                                                     fcfg.resort_every)
    mem = step.lower(state, springs, membranes).compile().memory_analysis()
    log(f"phase 2: memory_analysis of the {auto} {wcfg.resort_every}-step "
        f"graph: {mem}")

    # -- phase 3: box gate ------------------------------------------------
    for engine in ("fast", "fastw"):
        res = checks.box_gate(engine)
        log(f"phase 3: box gate {engine} vs exact ({res['n']} particles, "
            f"{res['steps']} steps): fresh max|dpos| {res['fresh']:.3e} "
            f"(tol {checks.BOX_FRESH_TOL:.0e}), stale {res['stale']:.3e} "
            f"(tol {checks.BOX_STALE_TOL:.0e})")
        check(res["ok"], f"box gate {engine}: {res}")

    # -- phase 4: full worm through Simulator(engine="auto") ---------------
    chunk = wcfg.resort_every
    sim, comp_a, ms_a = timed_sim(scene, params, "auto", chunk,
                                  WORM_STEPS - chunk)
    check(sim.engine == auto, f"auto engine {sim.engine} != {auto}")
    integ = checks.worm_integrity(scene, params, sim.state)
    ovf = sim.check_overflow()
    log(f"phase 4: (a) {sim.engine} with Triton passes: compile "
        f"{comp_a:.1f} s, {ms_a:.4f} ms/step over {WORM_STEPS - chunk} "
        f"steps")
    log(f"phase 4: integrity at step {integ['step']}: max strain "
        f"{integ['strain']:.4f} (<0.5), liquid rho/rho0 "
        f"{integ['rho_ratio']:.4f} (in [0.5, 2]); overflow {ovf}")
    check(integ["ok"] and integ["step"] >= WORM_STEPS,
          f"worm integrity {integ}")
    check(all(v == 0 for k, v in ovf.items() if k.endswith("overflow")),
          f"overflow {ovf}")
    _, comp_b, ms_b = timed_sim(scene, params, auto, chunk, 2 * chunk,
                                plain=True)
    log(f"phase 4: (b) {auto} with plain-XLA passes: compile {comp_b:.1f} "
        f"s, {ms_b:.4f} ms/step over {2 * chunk} steps")
    # the exact engine compiles one graph per step count: warm up on the
    # same count that is timed
    _, comp_c, ms_c = timed_sim(scene, params, "exact", 10, 10)
    log(f"phase 4: (c) exact: compile {comp_c:.1f} s, {ms_c:.4f} ms/step "
        f"over 10 steps")

    # -- phase 5: the checks of the gpu-marked tests ----------------------
    for name, fn in checks.GPU_CHECKS.items():
        res = fn()
        log(f"phase 5: {name}: {res}")
        check(res["ok"], f"gpu check {name}")


def four_cards():
    import jax

    from sph_jax import checks
    from sph_jax.scene import (generate_multi_worm_params,
                               generate_multi_worm_scene)

    check(len(jax.devices()) >= 4, f"--four needs 4 GPUs, JAX sees "
          f"{len(jax.devices())}")
    scene = generate_multi_worm_scene(2)
    params = generate_multi_worm_params(2)
    t0 = time.perf_counter()
    res = checks.multi_device_check(scene, params, 4)
    log(f"four: multi-worm {scene.n_particles} particles on 4 devices, "
        f"{res['steps']} steps, resort every {res['resort_every']} "
        f"(tol {checks.MULTI_DEVICE_TOL:.0e} sim units), "
        f"{time.perf_counter() - t0:.1f} s")
    for arm in ("halo_replicated", "halo_distributed", "sharded_exact"):
        log(f"four: {arm}: {res[arm]}")
    check(res["ok"], "multi-device check")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card paths")
    args = ap.parse_args()

    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        fail(f"no GPU (JAX platform {devs[0].platform!r})")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from sph_jax.checks import card_line
    from sph_jax.runtime.cache import enable_compile_cache

    cache = enable_compile_cache()
    card = card_line()
    log(f"phase 1: JAX devices {devs}; compile cache {cache}")
    t0 = time.perf_counter()
    if args.four:
        four_cards()
    else:
        one_card()
    log(f"done in {time.perf_counter() - t0:.1f} s")
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)


if __name__ == "__main__":
    main()
