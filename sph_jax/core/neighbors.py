"""Fixed-capacity neighbor search on the hash grid.

Replaces the reference's two-pass histogram kernel
(`/root/reference/src/sphFluid.cl:207-329`): pass 0 built a 30-bin radius
histogram to pick a threshold capturing ~32 neighbors, pass 1 re-scanned the
same 8 cells to fill the list. Here we gather all candidates from the same
2x2x2 corner cell block in one shot and select the **exact** 32 nearest within
radius ``h`` with a top-k — strictly more accurate than the histogram
approximation, same fixed [Nq, 32] output shape, one pass.

Output convention mirrors the padded ``neighborMap`` (`sphFluid.cl:64-92`):
-1 ids for empty slots; distances are stored nondimensionally as
``q = r / h`` (identically ``r_scaled / h_scaled``).

Local/global split: the query set may be a shard of the particles while the
grid and position table are global — this is how the shard_map data-parallel
path partitions the search without duplicating physics code. Single-chip
callers pass the same arrays for both.

All vector math is component-split (see ops/vec3.py): candidate distance
intermediates are ``[Nq, 8*K]`` scalar planes, never ``[Nq, 8*K, 3]``.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import SimParams
from ..ops.vec3 import V3
from .grid import Grid, cell_coords_of

# The 8 searched cells: own cell + 7 toward the nearest cell corner
# (sphFluid.cl:266-308). Each entry selects which axes apply the +-1 delta.
_CORNER_COMBOS = (
    (0, 0, 0), (1, 0, 0), (0, 1, 0), (0, 0, 1),
    (1, 1, 0), (1, 0, 1), (0, 1, 1), (1, 1, 1),
)


class NeighborList(NamedTuple):
    idx: jax.Array    # [Nq,32] i32 neighbor ids in GLOBAL index space, -1 pad
    q: jax.Array      # [Nq,32] f32 r/h in [0,1], 0 where padded
    valid: jax.Array  # [Nq,32] bool


def find_neighbors(
    query: V3,
    query_ids: jax.Array,
    pos: V3,
    grid: Grid,
    params: SimParams,
) -> NeighborList:
    """Neighbors of ``query`` particles against the global ``pos``/``grid``.

    ``query_ids``: global particle ids of the query rows (for
    self-exclusion). Single chip: query = pos, query_ids = arange(N).
    """
    n_glob = pos.x.shape[0]
    k_cap = params.cell_capacity
    m = params.max_neighbors
    dims = params.grid_dims
    bx, by, bz = params.box_min
    cell = jnp.float32(params.cell_size)
    h = jnp.float32(params.h)

    qc = cell_coords_of(query, params)

    # Direction of the nearest cell corner per axis: the interaction radius h
    # is half the cell edge, so candidates fit in own cell + that corner block
    # (lo test at sphFluid.cl:266-271).
    def corner_delta(p, b, cc):
        frac = (p - jnp.float32(b)) - cc.astype(p.dtype) * cell
        return jnp.where(frac < h, -1, 1).astype(jnp.int32)

    dx = corner_delta(query.x, bx, qc.x)
    dy = corner_delta(query.y, by, qc.y)
    dz = corner_delta(query.z, bz, qc.z)

    slots = jnp.arange(k_cap, dtype=jnp.int32)[None, :]
    cand_chunks = []
    for mx, my, mz in _CORNER_COMBOS:
        cx = qc.x + (dx * mx if mx else 0)
        cy = qc.y + (dy * my if my else 0)
        cz = qc.z + (dz * mz if mz else 0)
        in_range = (
            (cx >= 0) & (cx < dims[0])
            & (cy >= 0) & (cy < dims[1])
            & (cz >= 0) & (cz < dims[2])
        )
        lin = (
            jnp.clip(cx, 0, dims[0] - 1)
            + dims[0] * (jnp.clip(cy, 0, dims[1] - 1)
                         + dims[1] * jnp.clip(cz, 0, dims[2] - 1))
        )
        start = grid.cell_start[lin]
        count = jnp.minimum(grid.cell_start[lin + 1] - start, k_cap)
        slot_ok = (slots < count[:, None]) & in_range[:, None]
        gather_at = jnp.minimum(start[:, None] + slots, n_glob - 1)
        cand = grid.order[gather_at]
        cand_chunks.append(jnp.where(slot_ok, cand, -1))

    cand = jnp.concatenate(cand_chunks, axis=1)  # [Nq, 8*k_cap] i32
    safe = jnp.maximum(cand, 0)

    # componentwise distance planes — no [Nq, 8K, 3] intermediate
    d2 = (query.x[:, None] - pos.x[safe]) ** 2
    d2 = d2 + (query.y[:, None] - pos.y[safe]) ** 2
    d2 = d2 + (query.z[:, None] - pos.z[safe]) ** 2

    h2 = jnp.float32(params.h * params.h)
    ok = (cand >= 0) & (cand != query_ids[:, None]) & (d2 <= h2)

    key = jnp.where(ok, d2, jnp.inf)
    neg_d2, sel = jax.lax.top_k(-key, m)
    nbr_d2 = -neg_d2
    found = jnp.isfinite(nbr_d2)
    nbr_idx = jnp.where(
        found, jnp.take_along_axis(cand, sel, axis=1), -1
    ).astype(jnp.int32)
    q = jnp.where(
        found,
        jnp.sqrt(jnp.maximum(nbr_d2, 0.0)) * jnp.float32(1.0 / params.h),
        0.0,
    ).astype(jnp.float32)
    return NeighborList(idx=nbr_idx, q=q, valid=found)


def neighbor_overflow(nbrs: NeighborList) -> jax.Array:
    """Count of particles with all 32 slots filled (possible truncation).

    The reference truncates silently (`sphFluid.cl:169`); we expose it.
    """
    return jnp.sum(jnp.all(nbrs.valid, axis=1).astype(jnp.int32))
