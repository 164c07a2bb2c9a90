"""On-device uniform hash grid.

Replaces the reference's five-stage, host-synchronizing grid build
(``hashParticles`` -> host qsort -> ``sortPostPass`` -> per-cell binary-search
``indexx`` -> host backward-scan fixup; `/root/reference/src/
owOpenCLSolver.cpp:229-319`, `src/sphFluid.cl:346-466`) with two fused
device ops: one ``argsort`` on full-precision cell ids and one vectorized
``searchsorted`` producing CSR offsets directly — no sentinel holes, so the
host fixup pass has no equivalent. The reference's 16-bit cell-id truncation
(`sphFluid.cl:377`) is deliberately not reproduced: it aliases distinct cells
for z > ~200 sim units; we keep exact ids.

Cell coordinates are stored as three 1-D arrays (see ops/vec3.py for why
``[N, 3]`` layouts are avoided inside the step).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from ..config import SimParams
from ..ops.vec3 import V3


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class Grid:
    """CSR cell->particle map in original-index space."""

    ccx: jax.Array        # [N] i32 cell x-coordinate per particle
    ccy: jax.Array        # [N] i32
    ccz: jax.Array        # [N] i32
    order: jax.Array      # [N] i32 particle ids sorted by linear cell id
    cell_start: jax.Array  # [n_cells+1] i32 offsets into ``order``

    @property
    def coords(self) -> V3:
        return V3(self.ccx, self.ccy, self.ccz)


def cell_coords_of(pos: V3, params: SimParams) -> V3:
    """Integer cell coordinates, clipped into the grid.

    Matches ``cellFactors`` (`sphFluid.cl:187-201`): plain truncation of
    pos * (1 / (2h)); positions are box-clamped by the integrator so the clip
    is a no-op in normal operation.
    """
    nx, ny, nz = params.grid_dims
    inv = jnp.float32(1.0 / params.cell_size)
    bx, by, bz = params.box_min
    cx = ((pos.x - jnp.float32(bx)) * inv).astype(jnp.int32)
    cy = ((pos.y - jnp.float32(by)) * inv).astype(jnp.int32)
    cz = ((pos.z - jnp.float32(bz)) * inv).astype(jnp.int32)
    return V3(
        jnp.clip(cx, 0, nx - 1),
        jnp.clip(cy, 0, ny - 1),
        jnp.clip(cz, 0, nz - 1),
    )


def linear_cell_id(c: V3, params: SimParams) -> jax.Array:
    """x-major linearization, same layout as ``cellId`` (sphFluid.cl:332-342)."""
    nx, ny, _ = params.grid_dims
    return c.x + nx * (c.y + ny * c.z)


def build_grid(pos: V3, params: SimParams) -> Grid:
    c = cell_coords_of(pos, params)
    cell_ids = linear_cell_id(c, params)
    order = jnp.argsort(cell_ids, stable=True).astype(jnp.int32)
    sorted_ids = cell_ids[order]
    cell_start = jnp.searchsorted(
        sorted_ids,
        jnp.arange(params.n_cells + 1, dtype=sorted_ids.dtype),
        side="left",
    ).astype(jnp.int32)
    return Grid(ccx=c.x, ccy=c.y, ccz=c.z, order=order, cell_start=cell_start)


def max_cell_occupancy(pos, params: SimParams) -> int:
    """Max 2h-cell occupancy of the given positions (host-side NumPy)."""
    import numpy as np

    nx, ny, nz = params.grid_dims
    p = np.asarray(pos, np.float64) - np.asarray(params.box_min)
    c = np.clip((p / params.cell_size).astype(np.int64),
                0, [nx - 1, ny - 1, nz - 1])
    cid = c[:, 0] + nx * (c[:, 1] + ny * c[:, 2])
    return int(np.bincount(cid).max()) if len(cid) else 0


def measured_cell_capacity(
    pos, params: SimParams, margin: float = 1.25
) -> int:
    """Scene-derived ``cell_capacity``: max 2h-cell occupancy of the given
    positions times a safety margin, rounded up to a multiple of 16 and never
    below the params default. Host-side; run once at scene build."""
    occ = max_cell_occupancy(pos, params)
    need = -(-int(occ * margin) // 16) * 16
    return max(need, params.cell_capacity)


def cell_occupancy_overflow(grid: Grid, params: SimParams) -> jax.Array:
    """Total particles beyond ``cell_capacity`` in their cell (diagnostic).

    The reference silently truncates neighbor candidates at 32
    (`sphFluid.cl:169`); we surface capacity overflow instead of hiding it.
    """
    counts = grid.cell_start[1:] - grid.cell_start[:-1]
    return jnp.sum(jnp.maximum(counts - params.cell_capacity, 0))
