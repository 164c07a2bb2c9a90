"""Worm-scene throughput on one GPU: PCISPH particle-steps per second.

    python bench.py [--engine auto|fast|fastw|exact] [--steps N]

Runs the full worm-in-pool scene (231,811 particles) through
``Simulator``, prints the card's name and power limit, the compile time
and ms/step (every timed window ends in ``jax.block_until_ready``), runs
the box gate and the worm integrity gate, and prints one JSON line last.
Exits non-zero when JAX finds no GPU or a gate fails.
"""
import argparse
import json
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--engine", default="auto",
                    choices=["auto", "fast", "fastw", "exact"])
    ap.add_argument("--steps", type=int, default=510,
                    help="steps after warm-up (the integrity gate needs "
                         ">= 500)")
    args = ap.parse_args()

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench.py: no GPU (JAX platform {dev.platform!r})",
              file=sys.stderr)
        return 1

    from sph_jax import checks
    from sph_jax.config import SimParams
    from sph_jax.runtime import Simulator
    from sph_jax.runtime.cache import enable_compile_cache
    from sph_jax.scene import generate_worm_scene

    enable_compile_cache()
    print(f"# card: {checks.card_line()}", flush=True)
    params = SimParams()
    scene = generate_worm_scene(params)
    sim = Simulator(scene, params, engine=args.engine, async_io=False)
    chunk = getattr(sim, "_fast_chunk", 5)

    t0 = time.perf_counter()
    sim.step(chunk)
    jax.block_until_ready(sim.state)
    compile_s = time.perf_counter() - t0

    steps = max(chunk, args.steps // chunk * chunk)
    t0 = time.perf_counter()
    sim.step(steps)
    jax.block_until_ready(sim.state)
    wall = time.perf_counter() - t0
    ms = wall / steps * 1e3

    integ = checks.worm_integrity(scene, params, sim.state)
    ovf = sim.check_overflow()
    gates = [integ["ok"], all(v == 0 for k, v in ovf.items()
                              if k.endswith("overflow"))]
    if sim.engine in ("fast", "fastw"):
        box = checks.box_gate(sim.engine)
        print(f"# box gate {box}", flush=True)
        gates.append(box["ok"])
    print(f"# worm ({sim.engine}): {scene.n_particles} particles, compile "
          f"{compile_s:.1f} s, {steps} steps in {wall:.3f} s = {ms:.4f} "
          f"ms/step; integrity {integ}; overflow {ovf}", flush=True)
    print(json.dumps({
        "metric": "pcisph_particle_steps_per_sec_worm",
        "value": scene.n_particles * steps / wall,
        "unit": "particle-steps/s",
        "ms_per_step": ms,
        "compile_s": compile_s,
        "engine": sim.engine,
        "gates_ok": bool(all(gates)),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))
    return 0 if all(gates) else 1


if __name__ == "__main__":
    sys.exit(main())
