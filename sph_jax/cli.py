"""Command-line interface.

The reference's three flags (`/root/reference/src/main.cpp:19-29`) map to:

* (default graphics run)  -> ``run --render-every K`` (headless PNGs)
* ``-no_g``               -> ``run`` (headless is the default here)
* ``-l_to``               -> ``run --dump DIR``
* ``-l_from``             -> ``replay --buffers DIR --render DIR``

plus new subcommands the reference has no equivalent for: ``info``,
``checkpoint`` restore (``run --restore``), and scene generation to disk
(``genscene``).
"""
from __future__ import annotations

import argparse
import json
import sys
import time


def _make_params(args):
    from .config import SimParams

    kw = {}
    if getattr(args, "box", None):
        bx, by, bz = (float(v) for v in args.box.split(","))
        h = 3.34
        kw.update(x_max=bx * h, y_max=by * h, z_max=bz * h)
    if getattr(args, "dt", None):
        kw["time_step"] = args.dt
    return SimParams(**kw)


def _make_scene(args, params):
    from .scene import (
        generate_liquid_box_scene,
        generate_worm_scene,
        io,
    )

    if args.scene == "worm":
        return generate_worm_scene(params)
    if args.scene == "box":
        return generate_liquid_box_scene(
            params, fill_fraction=getattr(args, "fill", 0.15)
        )
    return io.load_scene(args.scene)  # a config directory


def cmd_run(args) -> int:
    from .runtime import Simulator

    params = _make_params(args)
    t0 = time.time()
    scene = _make_scene(args, params)
    print(f"scene: {scene.counts} ({time.time() - t0:.1f}s)")

    fck = {k: v for k, v in (
        ("ccol", args.ccol), ("ccol_c", args.ccol_c),
        ("resort_every", args.resort_every),
    ) if v is not None}
    sim = Simulator(
        scene, params,
        dump_dir=args.dump, dump_interval=args.dump_every,
        log=print if args.verbose else None,
        engine=args.engine,
        adaptive_resort=args.adaptive_resort,
        fast_config=fck or None,
    )
    if args.restore:
        sim.restore(args.restore)
        print(f"restored from {args.restore} at step {sim.step_count}")

    chunk = max(1, args.report_every)
    done = 0
    while done < args.steps:
        n = min(chunk, args.steps - done)
        ms = sim.step_blocking(n)
        done += n
        print(f"[[ step {sim.step_count} ]]  {ms / n:8.3f} ms/step "
              f"({1e3 / (ms / n):.1f} steps/s)")
        if args.render_every and sim.step_count % args.render_every == 0:
            from .viz import render_frame

            out = f"{args.render_dir}/step_{sim.step_count:06d}.png"
            render_frame(
                sim.get_position(), scene.ptype, out,
                springs=(scene.spring_rows, scene.spring_idx,
                         scene.spring_type),
                tris=scene.tris,
                activation=sim.get_muscle_activation(),
                hud=True, counts=scene.counts, step=sim.step_count,
                time_step=params.time_step,
            )
            print(f"rendered {out}")
    if args.checkpoint:
        sim.save(args.checkpoint)
        print(f"checkpoint -> {args.checkpoint}")
    sim.flush()  # drain the async trajectory stream before exit
    return 0


def cmd_replay(args) -> int:
    from .viz import frames_to_gif, render_trajectory

    paths = render_trajectory(
        f"{args.buffers}/position_buffer.txt", args.render,
        every=args.every,
    )
    print(f"rendered {len(paths)} frames -> {args.render}")
    if args.gif:
        print(f"gif -> {frames_to_gif(paths, args.gif, fps=args.fps)}")
    return 0


def cmd_info(args) -> int:
    params = _make_params(args)
    scene = _make_scene(args, params)
    info = dict(scene.counts)
    info["n_particles"] = scene.n_particles
    info["grid_dims"] = params.grid_dims
    info["delta"] = params.delta
    print(json.dumps(info, indent=2, default=str))
    return 0


def cmd_genscene(args) -> int:
    from .scene import io

    params = _make_params(args)
    scene = _make_scene(args, params)
    io.save_scene(scene, args.out)
    print(f"wrote {scene.n_particles} particles -> {args.out}")
    return 0


def main(argv=None) -> int:
    from .runtime.cache import enable_compile_cache

    enable_compile_cache()
    ap = argparse.ArgumentParser(
        prog="sph_jax",
        description="PCISPH (Electrofluid) framework on JAX",
    )
    sub = ap.add_subparsers(dest="cmd", required=True)

    def add_scene_args(p):
        p.add_argument("--scene", default="worm",
                       help="worm | box | path to a config directory")
        p.add_argument("--box", default=None,
                       help="world box in h units, e.g. '30,20,250'")
        p.add_argument("--dt", type=float, default=None)
        p.add_argument("--fill", type=float, default=0.15,
                       help="liquid fill fraction for the box scene")

    p = sub.add_parser("run", help="simulate")
    add_scene_args(p)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--dump", default=None, help="dump buffers dir (-l_to)")
    p.add_argument("--dump-every", type=int, default=10)
    p.add_argument("--report-every", type=int, default=100)
    p.add_argument("--render-every", type=int, default=0)
    p.add_argument("--render-dir", default="frames")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--restore", default=None)
    p.add_argument("--engine", default="auto",
                   choices=["auto", "exact", "fast", "fastw", "halo"],
                   help="exact = reference 32-cap neighbor lists; "
                        "fast = blocked pair-kernel engine; fastw = "
                        "wall-compact fast engine (static walls leave "
                        "the hot carry; auto picks it on wall-heavy "
                        "scenes); halo = fast engine sharded over all "
                        "devices (z-slab halo exchange)")
    p.add_argument("--adaptive-resort", action="store_true",
                   help="fast/halo engines: shorten the resort period "
                        "while the in-scan window-drift bound exceeds "
                        "0.25 h (see Simulator.adaptive_resort)")
    p.add_argument("--ccol", type=int, default=None,
                   help="fast engines: main pair-pass tile width (power "
                        "of two, multiple of 32)")
    p.add_argument("--ccol-c", type=int, default=None,
                   help="fast/fastw engines: compact-pass (boundary/"
                        "spring/membrane) tile width")
    p.add_argument("--resort-every", type=int, default=None,
                   help="fast/halo engines: steps between spatial "
                        "resorts (default 10)")
    p.add_argument("-v", "--verbose", action="store_true")
    p.set_defaults(fn=cmd_run)

    p = sub.add_parser("replay", help="render a dumped trajectory (-l_from)")
    p.add_argument("--buffers", default="buffers")
    p.add_argument("--render", default="frames")
    p.add_argument("--every", type=int, default=1)
    p.add_argument("--gif", default=None, metavar="PATH",
                   help="also assemble the frames into an animated GIF "
                   "(headless counterpart of the reference's video "
                   "recording, README.md:89-119)")
    p.add_argument("--fps", type=float, default=10.0)
    p.set_defaults(fn=cmd_replay)

    p = sub.add_parser("info", help="print scene statistics")
    add_scene_args(p)
    p.set_defaults(fn=cmd_info)

    p = sub.add_parser("genscene", help="generate a scene to config files")
    add_scene_args(p)
    p.add_argument("--out", required=True)
    p.set_defaults(fn=cmd_genscene)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
