"""Device mesh construction and scene padding for SPMD runs.

The reference has no multi-device story at all (single OpenCL queue,
`/root/reference/src/owOpenCLSolver.cpp:95-211`); here scaling is a
first-class component: a 1-D ``jax.sharding.Mesh`` over the particle axis.
The halo engine's communication is a neighbor chain over sorted z-slabs,
so the device order is the only layout choice (devices joined all to all
need nothing more).
"""
from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh

from ..constants import BOUNDARY_PARTICLE
from ..scene.scene import Scene

PARTICLE_AXIS = "p"


def make_mesh(n_devices: int | None = None) -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (PARTICLE_AXIS,))


def pad_scene_to_devices(scene: Scene, n_devices: int) -> Scene:
    """Pad the particle count to a multiple of the device count.

    Padding particles are frozen BOUNDARY particles parked on a line along
    the top-far box edge at r0-ish spacing so they don't stack in one cell.
    They carry the inward edge normal of that corner (like a real wall-edge
    particle, owHelper.cpp:785-826) rather than a zero normal: a zero-normal
    boundary row would still inflate the Ihmsen w/w2 sums while contributing
    nothing to n_ci, biasing the position projection of any liquid that came
    within r0.
    """
    n = scene.n_particles
    pad = (-n) % n_devices
    if pad == 0:
        return scene
    x_hi = scene.pos[:, 0].max()
    y_hi = scene.pos[:, 1].max()
    z_lo = scene.pos[:, 2].min()
    z_hi = scene.pos[:, 2].max()
    zs = z_lo + (np.arange(pad) + 0.5) * (z_hi - z_lo) / pad
    ppos = np.stack(
        [np.full(pad, x_hi), np.full(pad, y_hi), zs], axis=1
    ).astype(np.float32)
    s = np.float32(-1.0 / np.sqrt(2.0))
    pnorm = np.tile(np.array([[s, s, 0.0]], np.float32), (pad, 1))
    return Scene(
        pos=np.concatenate([scene.pos, ppos]),
        vel=np.concatenate([scene.vel, np.zeros((pad, 3), np.float32)]),
        color=np.concatenate(
            [scene.color, np.full(pad, float(BOUNDARY_PARTICLE), np.float32)]
        ),
        normal=np.concatenate([scene.normal, pnorm]),
        spring_rows=scene.spring_rows,
        spring_idx=scene.spring_idx,
        spring_rest=scene.spring_rest,
        spring_type=scene.spring_type,
        tris=scene.tris,
        muscle_model=scene.muscle_model,
    )
