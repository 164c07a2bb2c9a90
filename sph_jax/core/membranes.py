"""Liquid <-> membrane interaction.

Counterpart of the reference's three-kernel group ``clearMembraneBuffers`` /
``computeInteractionWithMembranes`` / ``..._finalize``
(`/root/reference/src/sphFluid.cl:1214-1682`), which runs *after* integration
on the updated positions: each liquid particle collects the membrane
triangles of its elastic neighbors, averages oriented plane normals per
neighbor, and applies an Ihmsen-style position projection; deltas accumulate
in a scratch buffer and are applied in a second phase. Here the two-phase
accumulate-then-apply structure is a pure functional update, so the scratch
halves of position/velocity (cl:1224-1225) have no equivalent.

Re-design of the inner math: the reference projects the particle onto
each triangle plane via 3x3 Cramer determinants (cl:1229-1308) only to form
``normalize(x_i - proj)`` — which is exactly the triangle's unit plane normal
oriented toward x_i. We precompute unit normals per triangle once per step
and orient by the sign of a dot product, eliminating the per-(particle,
neighbor, triangle) solve. All math is component-split (ops/vec3.py).

Two evaluation modes:
* single chip — liquid particles are a contiguous block, so the kernel runs
  on a **static slice** (the reference's per-particle type check,
  cl:1393-1395, for free);
* shard_map — each shard evaluates all its rows with a liquid mask against
  global positions.

Documented deviation: the reference zeroes the **z** component of the
particle-to-neighbor vector before taking its length (cl:1437, a likely typo
for ``.w`` when converting from subscripting); we use the true 3D distance.
Degenerate cases the reference aborts on with printf (zero-area triangle,
particle exactly in-plane, cl:1468-1472/1501-1505) are masked out instead.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..config import SimParams
from ..constants import ELASTIC_PARTICLE, LIQUID_PARTICLE
from ..ops.vec3 import V3
from .neighbors import NeighborList
from .state import Membranes


def triangle_normals(pos_g: V3, membranes: Membranes) -> tuple[V3, V3]:
    """Unit plane normals and reference vertex positions (V3 of [M])."""
    va = pos_g.take(membranes.tris[:, 0])
    vb = pos_g.take(membranes.tris[:, 1])
    vc = pos_g.take(membranes.tris[:, 2])
    ab, ac = vb - va, vc - va
    n = V3(
        ab.y * ac.z - ab.z * ac.y,
        ab.z * ac.x - ab.x * ac.z,
        ab.x * ac.y - ab.y * ac.x,
    )
    n2 = n.norm2()
    inv = jnp.where(n2 > 0.0, jax.lax.rsqrt(jnp.maximum(n2, 1e-30)), 0.0)
    return n * inv, va


def _membrane_delta(
    x_i: V3,
    liquid_mask: jax.Array,
    idx: jax.Array,
    valid: jax.Array,
    pos_g: V3,
    ptype_g: jax.Array,
    membranes: Membranes,
    params: SimParams,
) -> V3:
    """Position correction for the given rows (V3 of [R])."""
    n_plane, ref_a = triangle_normals(pos_g, membranes)

    j = jnp.maximum(idx, 0)
    elastic_j = valid & (ptype_g[j] == ELASTIC_PARTICLE) \
        & liquid_mask[:, None]

    # 3D particle-to-neighbor distance (see deviation note in module doc).
    dist_ij = (x_i.expand(1) - pos_g.take(j)).norm()  # [R,32]

    # Triangles of each elastic neighbor: a static loop over the 7
    # membrane slots keeps every temp at [R, cap] (no [R, cap, 7] batch
    # with a short minor dimension).
    cnt = jnp.zeros(j.shape, jnp.int32)           # [R,32]
    n_avg_acc = None
    for c in range(membranes.particle_tris.shape[1]):
        t = membranes.particle_tris[j, c]         # [R,32]
        t_ok = elastic_j & (t >= 0)
        t_safe = jnp.maximum(t, 0)
        n_t = n_plane.take(t_safe)                # V3 of [R,32]
        a_t = ref_a.take(t_safe)

        # Orient each plane normal toward the liquid particle (the
        # reference's normalize(x_i - projection), cl:1477-1483).
        s = (x_i.expand(1) - a_t).dot(n_t)        # [R,32]
        n_nonzero = n_t.norm2() > 0.0
        contrib_ok = t_ok & (s != 0.0) & n_nonzero
        sgn = jnp.where(contrib_ok, jnp.sign(s), 0.0)

        cnt = cnt + contrib_ok
        term = n_t * sgn
        n_avg_acc = term if n_avg_acc is None else n_avg_acc + term

    inv_cnt = 1.0 / jnp.maximum(cnt, 1)
    n_avg = n_avg_acc * inv_cnt                   # V3 of [R,32]

    is_entry = cnt > 0                            # neighbor in >=1 membrane
    r0 = jnp.float32(params.r0)
    w = jnp.where(is_entry, jnp.maximum(0.0, (r0 - dist_ij) / r0), 0.0)
    n_ci = (n_avg * w).sum(axis=1)                # V3 of [R]
    w_sum = jnp.sum(w, axis=1)
    w2_sum = jnp.sum(w * (r0 - dist_ij) * is_entry, axis=1)

    n_len2 = n_ci.norm2()
    has = (n_len2 > 0.0) & liquid_mask
    inv_len = jax.lax.rsqrt(jnp.maximum(n_len2, 1e-30))
    coef = jnp.where(has, inv_len * w2_sum / jnp.maximum(w_sum, 1e-30), 0.0)
    return n_ci * coef


def membrane_position_correction(
    pos_l: V3,
    ptype_l: jax.Array,
    nbrs: NeighborList,
    membranes: Membranes,
    params: SimParams,
    liquid_range: tuple[int, int] | None = None,
    pos_g: V3 | None = None,
    ptype_g: jax.Array | None = None,
) -> V3:
    """Updated local positions after membrane interaction."""
    if membranes.n_tris == 0:
        return pos_l
    pos_is_global = pos_g is None
    pos_g = pos_l if pos_g is None else pos_g
    ptype_g = ptype_l if ptype_g is None else ptype_g

    if liquid_range is not None and pos_is_global:
        lo, hi = liquid_range
        if hi <= lo:
            return pos_l
        sl = slice(lo, hi)
        x_i = V3(pos_l.x[sl], pos_l.y[sl], pos_l.z[sl])
        delta = _membrane_delta(
            x_i, jnp.ones(hi - lo, bool), nbrs.idx[sl], nbrs.valid[sl],
            pos_g, ptype_g, membranes, params,
        )
        return V3(
            pos_l.x.at[sl].add(delta.x),
            pos_l.y.at[sl].add(delta.y),
            pos_l.z.at[sl].add(delta.z),
        )

    liquid_mask = ptype_l == LIQUID_PARTICLE
    delta = _membrane_delta(
        pos_l, liquid_mask, nbrs.idx, nbrs.valid,
        pos_g, ptype_g, membranes, params,
    )
    return pos_l + delta
