"""The single fused simulation step.

The reference's ``simulationStep`` issues ~20 kernel launches with a
``queue.finish()`` after each, two device->host->device structural round
trips (sort, index fixup), a per-step position readback, and a per-step
embedded-Python call (`/root/reference/src/owPhysicsFluidSimulator.cpp:
79-149`, `src/owOpenCLSolver.cpp:224-226`). Here the whole step — grid build,
neighbor search, PCISPH, elastic/muscle forces, integration, membranes, and
the muscle signal — is **one jit-compiled pure function**; XLA fuses and
schedules it with zero host synchronization, and ``multi_step`` scans it so
whole trajectories run device-side.

State crosses the API boundary as ``[N, 3]`` arrays; internally everything is
component-split (ops/vec3.py): every array's minor dimension is a data
axis.
"""
from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from ..config import SimParams
from ..models import muscle
from ..ops import vec3
from .elastic import add_elastic_forces
from .grid import build_grid
from .membranes import membrane_position_correction
from .neighbors import find_neighbors
from .pcisph import (
    compute_density,
    compute_external_forces,
    integrate,
    pcisph_pressure_loop,
)
from .state import FluidState, Membranes, Springs


@dataclasses.dataclass(frozen=True)
class SceneLayout:
    """Static layout facts about a scene (hashable; jit-static).

    Particle classes are stored contiguously — the generator emits
    elastic/liquid/boundary, the file loader boundary/elastic/liquid — so
    class-restricted kernels (membranes) become static slices instead of
    full-length masked passes.
    """

    n_particles: int
    liquid_range: tuple[int, int] = (0, 0)
    elastic_range: tuple[int, int] = (0, 0)
    boundary_range: tuple[int, int] = (0, 0)
    muscle_model: bool = False  # drive activations from the wave model
    # every spring endpoint lies in elastic_range (true for the generated
    # worm; loaded scenes may also anchor springs to boundary particles,
    # which the fast engine's compact spring pass cannot represent)
    springs_elastic_only: bool = True
    # highest used partner slot across the spring table (scene-measured;
    # the reference's 32-slot table is mostly -1 padding — the worm's max
    # degree is 16). Sizes the fast engine's spring pack and match loop.
    spring_slots: int = 32
    # every spring endpoint is elastic or boundary (never liquid): the
    # halo engine reuses resort-time sorted positions for non-elastic
    # endpoints across a resort period, which is only exact for static
    # (boundary) particles
    springs_anchors_static: bool = True

    @property
    def n_liquid(self) -> int:
        return self.liquid_range[1] - self.liquid_range[0]

    @property
    def n_elastic(self) -> int:
        return self.elastic_range[1] - self.elastic_range[0]

    @property
    def n_boundary(self) -> int:
        return self.boundary_range[1] - self.boundary_range[0]


def step_fn(
    state: FluidState,
    springs: Springs,
    membranes: Membranes,
    params: SimParams,
    layout: SceneLayout,
) -> FluidState:
    """One PCISPH step (pure; jit via ``simulation_step``).

    Same stage order as `owPhysicsFluidSimulator.cpp:79-149`.
    """
    pos = vec3.split(state.pos)
    ids = jnp.arange(layout.n_particles, dtype=jnp.int32)

    # -- neighbor phase --
    grid = build_grid(pos, params)
    nbrs = find_neighbors(pos, ids, pos, grid, params)
    return step_core(state, springs, membranes, params, layout, nbrs)


def step_core(
    state: FluidState,
    springs: Springs,
    membranes: Membranes,
    params: SimParams,
    layout: SceneLayout,
    nbrs,
) -> FluidState:
    """The step stages after the neighbor phase (everything consumes the
    NeighborList). Split out so multi_step_cached can run them against a
    cached-index list with freshened distances."""
    pos = vec3.split(state.pos)
    vel = vec3.split(state.vel)
    normal = vec3.split(state.normal)
    ptype = state.ptype

    # -- forces at time t --
    rho = compute_density(nbrs, params)
    a_ext = compute_external_forces(
        pos, vel, rho, ptype, nbrs, params, normal_g=normal
    )
    a_ext = add_elastic_forces(
        a_ext, pos, springs, state.muscle_activation, params
    )

    # -- PCISPH prediction-correction --
    res = pcisph_pressure_loop(pos, vel, ptype, nbrs, params)

    # -- integrate + membrane interaction --
    pos1, vel1 = integrate(
        pos, vel, ptype, a_ext, res.a_p, nbrs, params, normal_g=normal
    )
    pos2 = membrane_position_correction(
        pos1, ptype, nbrs, membranes, params,
        liquid_range=layout.liquid_range,
    )

    # -- muscle signal for the next step --
    if layout.muscle_model:
        activation = muscle.next_activation(state.step)
    else:
        activation = state.muscle_activation

    return FluidState(
        pos=vec3.merge(pos2),
        vel=vec3.merge(vel1),
        ptype=ptype,
        normal=state.normal,
        muscle_activation=activation,
        step=state.step + 1,
    )


@partial(jax.jit, static_argnames=("params", "layout"))
def simulation_step(
    state: FluidState,
    springs: Springs,
    membranes: Membranes,
    params: SimParams,
    layout: SceneLayout,
) -> FluidState:
    """Advance the simulation by one PCISPH step."""
    return step_fn(state, springs, membranes, params, layout)


@partial(jax.jit, static_argnames=("params", "layout", "n_steps"))
def multi_step(
    state: FluidState,
    springs: Springs,
    membranes: Membranes,
    params: SimParams,
    layout: SceneLayout,
    n_steps: int,
) -> FluidState:
    """Run ``n_steps`` steps fully on device (lax.scan; no host round trips)."""

    def body(s, _):
        return step_fn(s, springs, membranes, params, layout), None

    out, _ = jax.lax.scan(body, state, None, length=n_steps)
    return out


def _freshen_neighbors(s: FluidState, idx, params: SimParams):
    """Rebuild a NeighborList from cached neighbor INDICES and the state's
    CURRENT positions: distances are exact, pairs drifted beyond h are
    invalidated (kernel support stays exact). Same f32 arithmetic as the
    neighbor kernel, so a fresh-index freshen is bit-identical to
    ``find_neighbors`` output."""
    from .neighbors import NeighborList

    pos = vec3.split(s.pos)
    h2 = jnp.float32(params.h * params.h)
    inv_h = jnp.float32(1.0 / params.h)
    safe = jnp.maximum(idx, 0)
    d2 = (pos.x[:, None] - pos.x[safe]) ** 2
    d2 = d2 + (pos.y[:, None] - pos.y[safe]) ** 2
    d2 = d2 + (pos.z[:, None] - pos.z[safe]) ** 2
    valid = (idx >= 0) & (d2 <= h2)
    q = jnp.where(valid, jnp.sqrt(jnp.maximum(d2, 0.0)) * inv_h, 0.0)
    return NeighborList(idx=jnp.where(valid, idx, -1), q=q, valid=valid)


@partial(jax.jit, static_argnames=("params", "layout", "n_steps",
                                   "refresh_every"))
def multi_step_cached(
    state: FluidState,
    springs: Springs,
    membranes: Membranes,
    params: SimParams,
    layout: SceneLayout,
    n_steps: int,
    refresh_every: int = 10,
) -> FluidState:
    """``multi_step`` with CACHED neighbor indices: the
    8-cell candidate gather + top-k — the dominant exact-engine cost at
    dense-scene scale — runs once per ``refresh_every`` steps; between
    refreshes only the [N, 32] pair distances are recomputed from current
    positions each step (pairs drifting beyond h are invalidated, so the
    kernel support is still exact). This matches the reference's own
    semantics of reusing structure between sorts and the fast engine's
    window-staleness class; at ``refresh_every=1`` it is bit-identical to
    ``multi_step``. Intended as the practical-cost dense-scene ORACLE for
    deviation studies (cap studies, stale-window A/Bs), not as a perf
    path."""
    ids = jnp.arange(layout.n_particles, dtype=jnp.int32)

    def freshen(s, idx):
        return _freshen_neighbors(s, idx, params)

    def sweep(s, k):
        pos = vec3.split(s.pos)
        grid = build_grid(pos, params)
        idx = find_neighbors(pos, ids, pos, grid, params).idx

        def body(s, _):
            out = step_core(s, springs, membranes, params, layout,
                            freshen(s, idx))
            return out, None

        out, _ = jax.lax.scan(body, s, None, length=k)
        return out

    full, rem = divmod(n_steps, max(1, refresh_every))
    if full:
        state, _ = jax.lax.scan(
            lambda s, _: (sweep(s, refresh_every), None), state, None,
            length=full,
        )
    if rem:
        state = sweep(state, rem)
    return state


@partial(jax.jit, static_argnames=("params",))
def diagnostics(state: FluidState, params: SimParams) -> dict:
    """Density/pressure/neighbor diagnostics for the state API
    (counterparts of getDensity_cpp / getParticleIndex_cpp etc.,
    `owPhysicsFluidSimulator.h:14-21`)."""
    pos = vec3.split(state.pos)
    ids = jnp.arange(state.pos.shape[0], dtype=jnp.int32)
    grid = build_grid(pos, params)
    nbrs = find_neighbors(pos, ids, pos, grid, params)
    rho = compute_density(nbrs, params)
    res = pcisph_pressure_loop(
        pos, vec3.split(state.vel), state.ptype, nbrs, params
    )
    from .grid import cell_occupancy_overflow
    from .neighbors import neighbor_overflow

    return {
        "rho": rho,
        "pressure": res.pressure,
        "neighbor_count": jnp.sum(nbrs.valid, axis=1),
        "neighbor_overflow": neighbor_overflow(nbrs),
        "cell_overflow": cell_occupancy_overflow(grid, params),
    }
