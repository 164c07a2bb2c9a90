"""Elastic (spring) and muscle contraction forces.

Counterpart of ``pcisph_computeElasticForces``
(`/root/reference/src/sphFluid.cl:709-815`): per elastic particle, walk its
padded spring list; Hooke acceleration ``-(r_hat) * (r - r0) * k`` with
k = 6e8 (cl:741, :775), plus a contraction term ``-(r_hat) * signal * 800``
when the spring's muscle id is active (cl:777-784). The reference's
muscle-matching inner loop over all 100 muscles per spring (cl:777) is a
single gather here. The commented-out center-of-mass damping block
(cl:787-800) is dead code upstream and intentionally not reproduced.

Springs live in absolute particle-id space, so the reference's load-path
dependent ``offset`` argument (`owOpenCLSolver.cpp:435`) does not exist.
Under shard_map the (small, replicated) spring rows are evaluated against
global positions and scattered into the local acceleration shard via
``local_offset``.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..config import SimParams
from ..ops.vec3 import V3
from .state import Springs


def elastic_accel(
    pos_g: V3,
    springs: Springs,
    activation: jax.Array,
    params: SimParams,
) -> V3:
    """Spring + muscle acceleration per spring row (V3 of [Ne]).

    Shapes: pos_g of [N] (global); activation [MUSCLE_COUNT].
    """
    i = springs.row_ids                       # [Ne]
    valid = springs.idx >= 0                  # [Ne,32]
    j = jnp.maximum(springs.idx, 0)

    scale = jnp.float32(params.simulation_scale)
    d = (pos_g.take(i).expand(1) - pos_g.take(j)) * scale  # [Ne,32], meters
    r = d.norm()
    ok = valid & (r != 0.0)
    inv_r = 1.0 / jnp.maximum(r, 1e-30)

    stretch = r - springs.rest
    coef = jnp.where(ok, -stretch * jnp.float32(params.k_spring), 0.0)

    muscle_id = springs.muscle                 # [Ne,32], 0 = plain
    # activation lookup as a one-hot contraction over the 96-entry table
    # instead of a [Ne*32]-element gather
    n_act = activation.shape[0]
    oh = (
        muscle_id[:, :, None]
        == jnp.arange(1, n_act + 1, dtype=muscle_id.dtype)
    ).astype(jnp.float32)
    act = jnp.einsum(
        "nsm,m->ns", oh, activation,
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    m_on = ok & (muscle_id > 0) & (act > 0.0)
    coef = coef + jnp.where(
        m_on, -act * jnp.float32(params.muscle_force), 0.0
    )

    return (d * (coef * inv_r)).sum(axis=1)


def add_elastic_forces(
    a_ext: V3,
    pos_g: V3,
    springs: Springs,
    activation: jax.Array,
    params: SimParams,
    local_offset: jax.Array | int = 0,
) -> V3:
    """Scatter-add spring + muscle accelerations into the local ``a_ext``.

    ``local_offset``: global id of a_ext's row 0 (shard start); rows outside
    the local range are dropped by the scatter's out-of-bounds mode.
    """
    if springs.n_elastic == 0:
        return a_ext
    a = elastic_accel(pos_g, springs, activation, params)
    i_loc = springs.row_ids - local_offset
    n_loc = a_ext.x.shape[0]
    in_range = (i_loc >= 0) & (i_loc < n_loc)
    i_safe = jnp.where(in_range, i_loc, n_loc)  # OOB index -> dropped
    return V3(
        a_ext.x.at[i_safe].add(a.x, mode="drop"),
        a_ext.y.at[i_safe].add(a.y, mode="drop"),
        a_ext.z.at[i_safe].add(a.z, mode="drop"),
    )
