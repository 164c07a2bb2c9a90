"""At-scale throughput: multi-worm and ~1M-particle dam-break on the
fast and fastw engines (SURVEY §7 step 6-7 stress configs). Run on a GPU:

    python scripts/bench_scale.py [n_worms] [fill] [engine]

engine: "fastw" (default; needs elastic-only spring anchors), "fast", or
"both". Every timed window ends in jax.block_until_ready, and every result
line names the card and its power limit. Exits non-zero when JAX finds no
GPU (on the CPU the pair kernels would only run interpreted).
"""
import os
import sys
import time

import jax
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from sph_jax.checks import card_line
from sph_jax.config import SimParams
from sph_jax.core.fast import compute_fast_config, make_fast_multi_step
from sph_jax.core.fastw import (
    compute_fastw_config,
    make_fastw_multi_step,
    precompute_wall_static,
)
from sph_jax.scene import (
    generate_liquid_box_scene,
    generate_multi_worm_params,
    generate_multi_worm_scene,
)

CHUNK = 30


def measure(name, scene, params, card, engine="fastw", chunk=CHUNK,
            rounds=4):
    state, springs, membranes = scene.device_state()
    layout = scene.layout()
    if engine == "fastw":
        cfg = compute_fastw_config(scene.pos, params, layout,
                                   ptype=scene.ptype)
        ws = precompute_wall_static(scene.pos, scene.normal, params,
                                    layout, cfg)
        run = make_fastw_multi_step(params, layout, cfg, chunk,
                                    wall_static=ws)
    else:
        cfg = compute_fast_config(scene.pos, params)
        run = make_fast_multi_step(params, layout, cfg, chunk)
    n = scene.n_particles
    t0 = time.time()
    state = jax.block_until_ready(run(state, springs, membranes))
    compile_s = time.time() - t0
    t0 = time.time()
    for _ in range(rounds):
        state = run(state, springs, membranes)
    jax.block_until_ready(state)
    wall = time.time() - t0
    steps = rounds * chunk
    ms = wall / steps * 1e3
    pps = n * steps / wall
    pos = np.asarray(state.pos)[: n]
    ok = bool(np.isfinite(pos).all())
    print(f"{name} [{engine}]: {n} particles, {ms:.3f} ms/step, "
          f"{pps/1e6:.2f}M particle-steps/s, compile {compile_s:.0f}s, "
          f"finite={ok} [{card}]", flush=True)
    return pps


def main():
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench_scale.py: no GPU (JAX platform {dev.platform!r})",
              file=sys.stderr)
        return 1
    card = f"{card_line()}; JAX {dev.device_kind}"
    n_worms = int(sys.argv[1]) if len(sys.argv) > 1 else 2
    fill = float(sys.argv[2]) if len(sys.argv) > 2 else 0.8
    engine = sys.argv[3] if len(sys.argv) > 3 else "fastw"
    engines = ("fast", "fastw") if engine == "both" else (engine,)

    base = SimParams()
    t0 = time.time()
    mscene = generate_multi_worm_scene(n_worms, base)
    wide = generate_multi_worm_params(n_worms, base)
    print(f"{n_worms}-worm scene: {mscene.counts} "
          f"(build {time.time()-t0:.0f}s)", flush=True)
    for eng in engines:
        measure(f"{n_worms}-worm", mscene, wide, card, engine=eng)

    t0 = time.time()
    dscene = generate_liquid_box_scene(base, fill_fraction=fill)
    print(f"dam-break fill={fill}: {dscene.counts} "
          f"(build {time.time()-t0:.0f}s)", flush=True)
    for eng in engines:
        measure("dam-break", dscene, base, card, engine=eng)
    return 0


if __name__ == "__main__":
    sys.exit(main())
