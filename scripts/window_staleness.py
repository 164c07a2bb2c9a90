"""Stale windows on the full worm: what the cached window tables miss
between resorts, and what that does to the trajectory. Run on a GPU:

    python scripts/window_staleness.py [--steps 510] [--periods 30,10]
                                       [--out FILE]

1. Missed pairs. The fastw engine re-sorts every ``resort_every`` steps and
   keeps its window tables for the period. For each resort period in
   ``--periods`` and each period of the first ``--steps`` steps this steps
   to the period's last step (the stalest windows) and counts, with
   checks.stale_window_misses, the pairs within h that the tables leave
   out and the largest share of a row's density sum they carry. It does
   so for the default 8 x 8 tiles and for 64 x 64 tiles built from the
   same period-start state.
2. Trajectories. ``--steps`` steps through Simulator for fastw at 8 x 8
   with resort_every 1 (fresh windows every step) and each of
   ``--periods``, fastw at 64 x 64 with the first of ``--periods``, and
   fast at 8 x 8 with resort_every 1 (fresh windows, another summation
   order: the round-off control). Each is compared with the fresh fastw
   run: max |dpos| and max |drho|/rho0 per particle.

Every result line names the card and its power limit; exits non-zero with
no GPU. One JSON line per result goes to ``--out``.
"""
import argparse
import json
import os
import sys
import time

import jax
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from sph_jax import checks
from sph_jax.config import SimParams
from sph_jax.core.fastw import (compute_fastw_config, make_fastw_stepper,
                                precompute_wall_static)
from sph_jax.core.step import diagnostics
from sph_jax.runtime import Simulator
from sph_jax.runtime.cache import enable_compile_cache
from sph_jax.scene import generate_worm_scene


def emit(out, card, rec):
    rec = dict(rec, card=card)
    print(json.dumps(rec), flush=True)
    if out:
        with open(out, "a") as f:
            f.write(json.dumps(rec) + "\n")


def missed_pairs(scene, params, steps, period, out, card):
    layout = scene.layout()
    state, springs, membranes = scene.device_state()
    cfgs = {
        "8x8": compute_fastw_config(scene.pos, params, layout,
                                    ptype=scene.ptype, resort_every=period),
        "64x64": compute_fastw_config(scene.pos, params, layout,
                                      ptype=scene.ptype, block=64, ccol=64,
                                      resort_every=period),
    }
    ws = {k: precompute_wall_static(scene.pos, scene.normal, params, layout,
                                    c) for k, c in cfgs.items()}
    steppers = {k: make_fastw_stepper(params, layout, c, inner_steps=1,
                                      wall_static=ws[k])
                for k, c in cfgs.items()}
    sort, inner, unsort = steppers["8x8"]
    for p0 in range(0, steps, period):
        ctx, carry, _ = sort(state, springs, membranes)
        ctxs = {"8x8": ctx, "64x64": steppers["64x64"][0](
            state, springs, membranes)[0]}
        for _ in range(period - 1):
            carry = inner(ctx, carry)
        # the sorted order depends on cells only, so the 8 x 8 carry's
        # rows are the 64 x 64 tables' rows too
        for k, c in ctxs.items():
            t0 = time.perf_counter()
            res = checks.stale_window_misses(c, carry, cfgs[k], params)
            emit(out, card, dict(arm="missed_pairs", tiles=k,
                                 resort_every=period, period_start=p0, stale_steps=period - 1,
                                 host_s=time.perf_counter() - t0, **res))
        carry = inner(ctx, carry)
        state = unsort(ctx, carry, state)


def trajectories(scene, params, steps, periods, out, card):
    arms = {"fastw 8x8 re1": ("fastw", dict(resort_every=1))}
    for r in periods:
        arms[f"fastw 8x8 re{r}"] = ("fastw", dict(resort_every=r))
    arms[f"fastw 64x64 re{periods[0]}"] = (
        "fastw", dict(resort_every=periods[0], block=64, ccol=64))
    arms["fast 8x8 re1"] = ("fast", dict(resort_every=1))
    ends = {}
    for name, (engine, fc) in arms.items():
        sim = Simulator(scene, params, engine=engine, fast_config=fc,
                        async_io=False)
        # the longest resort period compiles every graph the run uses
        warm = max(periods)
        sim.step(warm)
        jax.block_until_ready(sim.state)
        t0 = time.perf_counter()
        sim.step(steps - warm)
        jax.block_until_ready(sim.state)
        ms = (time.perf_counter() - t0) / (steps - warm) * 1e3
        pos = np.asarray(sim.state.pos)
        rho = np.asarray(diagnostics(sim.state, params)["rho"])
        ends[name] = (pos, rho)
        emit(out, card, dict(arm="trajectory", run=name, steps=steps,
                             ms_per_step=ms,
                             window_drift_h=sim.check_overflow()
                             ["window_drift_h"]))
    ref_pos, ref_rho = ends["fastw 8x8 re1"]
    for name, (pos, rho) in ends.items():
        emit(out, card, dict(
            arm="vs_fresh", run=name, steps=steps,
            max_dpos=float(np.abs(pos - ref_pos).max()),
            max_drho_rel=float(np.abs(rho - ref_rho).max() / params.rho0),
            mean_drho_rel=float(np.abs(rho - ref_rho).mean() / params.rho0),
        ))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=510)
    ap.add_argument("--periods", default="30,10",
                    help="resort periods to study, comma-separated")
    ap.add_argument("--out", default=None,
                    help="append one JSON line per result to this file")
    args = ap.parse_args()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"window_staleness.py: no GPU (JAX platform "
              f"{dev.platform!r})", file=sys.stderr)
        return 1
    enable_compile_cache()
    card = f"{checks.card_line()}; JAX {dev.device_kind}"
    params = SimParams()
    scene = generate_worm_scene(params)
    periods = [int(p) for p in args.periods.split(",")]
    for period in periods:
        missed_pairs(scene, params, args.steps, period, args.out, card)
    trajectories(scene, params, args.steps, periods, args.out, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
