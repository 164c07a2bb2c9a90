"""SPMD multi-chip simulation step via shard_map.

Parallelism strategy (round 1): **particle-sharded data parallelism with
replicated reads** — each device owns a contiguous block of particle rows and
computes neighbor search + all forces for its block only; quantities read
through neighbor indices (positions, velocities, densities, per-iteration
predicted state) are re-globalized with ``all_gather`` over the mesh
axis. This reuses the exact single-chip physics (the core kernels take
local/global array pairs and a ``gather`` callable), so sharded and
single-chip trajectories agree to the last ulp modulo reduction layout.

The communication-optimal evolution of this design is Z-slab domain
decomposition with halo-cell ``ppermute`` exchange only (the SPH analog of
context parallelism — cells are 2h wide so one halo layer suffices); the
all-gather variant is the correctness baseline it will be validated against.

The reference has no distributed path at all (`owOpenCLSolver.cpp` drives a
single OpenCL queue); this module is new capability, not a port.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import SimParams
from ..core.elastic import add_elastic_forces
from ..core.grid import build_grid
from ..core.membranes import membrane_position_correction
from ..core.neighbors import find_neighbors
from ..core.pcisph import (
    compute_density,
    compute_external_forces,
    integrate,
    pcisph_pressure_loop,
)
from ..core.state import FluidState, Membranes, Springs
from ..core.step import SceneLayout
from ..models import muscle
from ..ops import vec3
from ..ops.vec3 import V3
from .mesh import PARTICLE_AXIS


def shard_state(state: FluidState, mesh: Mesh) -> FluidState:
    """Place a FluidState with particle-axis sharding on the mesh."""
    row = NamedSharding(mesh, P(PARTICLE_AXIS))
    rep = NamedSharding(mesh, P())
    return FluidState(
        pos=jax.device_put(state.pos, row),
        vel=jax.device_put(state.vel, row),
        ptype=jax.device_put(state.ptype, row),
        normal=jax.device_put(state.normal, row),
        muscle_activation=jax.device_put(state.muscle_activation, rep),
        step=jax.device_put(state.step, rep),
    )


def make_sharded_step(
    mesh: Mesh,
    params: SimParams,
    layout: SceneLayout,
    n_steps: int = 1,
):
    """Build a jitted n-step function over the mesh.

    Returns ``fn(state, springs, membranes) -> state`` where ``state`` is
    particle-sharded (see :func:`shard_state`) and springs/membranes are
    replicated.
    """
    ax = PARTICLE_AXIS
    state_specs = FluidState(
        pos=P(ax), vel=P(ax), ptype=P(ax), normal=P(ax),
        muscle_activation=P(), step=P(),
    )
    springs_specs = Springs(row_ids=P(), idx=P(), rest=P(), muscle=P())
    membranes_specs = Membranes(tris=P(), particle_tris=P())

    def gather(a):
        return jax.lax.all_gather(a, ax, tiled=True)

    def gather3(v: V3) -> V3:
        return V3(gather(v.x), gather(v.y), gather(v.z))

    def one_step(state: FluidState, springs, membranes) -> FluidState:
        pos_l = vec3.split(state.pos)
        vel_l = vec3.split(state.vel)
        ptype_l = state.ptype
        n_loc = state.ptype.shape[0]
        dev = jax.lax.axis_index(ax)
        ids_l = dev * n_loc + jnp.arange(n_loc, dtype=jnp.int32)

        pos_g = gather3(pos_l)
        vel_g = gather3(vel_l)
        ptype_g = gather(ptype_l)
        normal_g = gather3(vec3.split(state.normal))

        grid = build_grid(pos_g, params)
        nbrs = find_neighbors(pos_l, ids_l, pos_g, grid, params)

        rho_l = compute_density(nbrs, params)
        rho_g = gather(rho_l)
        a_ext = compute_external_forces(
            pos_l, vel_l, rho_l, ptype_l, nbrs, params,
            pos_g=pos_g, vel_g=vel_g, rho_g=rho_g, ptype_g=ptype_g,
            normal_g=normal_g,
        )
        a_ext = add_elastic_forces(
            a_ext, pos_g, springs, state.muscle_activation, params,
            local_offset=dev * n_loc,
        )

        res = pcisph_pressure_loop(
            pos_l, vel_l, ptype_l, nbrs, params,
            pos_g=pos_g, gather=gather,
        )

        pos1_l, vel1_l = integrate(
            pos_l, vel_l, ptype_l, a_ext, res.a_p, nbrs, params,
            ptype_g=ptype_g, normal_g=normal_g, pos0_g=pos_g,
        )

        if membranes.n_tris > 0:
            pos1_g = gather3(pos1_l)
            pos2_l = membrane_position_correction(
                pos1_l, ptype_l, nbrs, membranes, params,
                pos_g=pos1_g, ptype_g=ptype_g,
            )
        else:
            pos2_l = pos1_l

        if layout.muscle_model:
            activation = muscle.next_activation(state.step)
        else:
            activation = state.muscle_activation

        return FluidState(
            pos=vec3.merge(pos2_l),
            vel=vec3.merge(vel1_l),
            ptype=ptype_l,
            normal=state.normal,
            muscle_activation=activation,
            step=state.step + 1,
        )

    def stepper(state, springs, membranes):
        def body(s, _):
            return one_step(s, springs, membranes), None

        out, _ = jax.lax.scan(body, state, None, length=n_steps)
        return out

    sharded = jax.shard_map(
        stepper,
        mesh=mesh,
        in_specs=(state_specs, springs_specs, membranes_specs),
        out_specs=state_specs,
        check_vma=False,
    )
    return jax.jit(sharded)
