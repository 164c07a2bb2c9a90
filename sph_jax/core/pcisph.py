"""PCISPH solver core: density, external forces, the prediction-correction
loop, boundary handling, and integration.

Physics is the reference's, re-factored for f32 accelerators (see
:mod:`sph_jax.config` for the nondimensionalization and :mod:`sph_jax.ops.
vec3` for the component-split layout). Per-kernel citations:

* density           — `/root/reference/src/sphFluid.cl:472-518`
* ext forces        — `sphFluid.cl:589-708` (viscosity, gravity, surf. tension)
* predict positions — `sphFluid.cl:889-979`
* predict density   — `sphFluid.cl:982-1059`
* correct pressure  — `sphFluid.cl:1062-1098`
* pressure force    — `sphFluid.cl:1101-1212` (incl. close-range anti-clump)
* boundary response — `sphFluid.cl:824-887` (Ihmsen et al. 2010 frozen particles)
* integrate         — `sphFluid.cl:1684-1808`

Local/global split for SPMD: every function computes outputs for a *local*
row set (a shard of the particles) while neighbor gathers read *global*
arrays; quantities that evolve inside the PCISPH loop are re-globalized
through a ``gather`` callable — identity on one chip, ``lax.all_gather`` on
the particle mesh axis under shard_map. Single-chip callers pass the same
array for local and global and ``gather=None``.

Reference quirks preserved deliberately (they shape the dynamics):
* Position prediction integrates **only** the pressure acceleration; the
  viscous/gravity/elastic half is commented out upstream (sphFluid.cl:924).
* Pressure is corrected for *all* particles including boundary ones
  (the boundary skip at sphFluid.cl:1084-1086 is commented out), which is
  what gives frozen boundary particles their pressure contribution.
* For boundary neighbors the "velocity" entering the viscosity sum is the
  stored wall normal — the reference keeps normals in the velocity buffer
  (sphFluid.cl:653 reading what :860 documents as normals).
* Integration writes back the *average* of old and new velocity
  (sphFluid.cl:1759) after computing the position from the full new velocity.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from ..config import SimParams
from ..constants import BOUNDARY_PARTICLE
from ..ops.smoothing import poly6_term, spiky_term, visc_term
from ..ops.vec3 import V3, masked
from .neighbors import NeighborList

GatherFn = Callable


def _identity_gather(x):
    return x


def compute_density(nbrs: NeighborList, params: SimParams) -> jax.Array:
    """rho_i = c_rho * max(1, sum_j (1 - q^2)^3).

    The max(1, .) clamp is the reference's `density < hScaled6 -> hScaled6`
    (sphFluid.cl:514) in nondimensional form; 1 is exactly the missing
    self-contribution term.
    """
    q2 = nbrs.q * nbrs.q
    s = jnp.sum(jnp.where(nbrs.valid, poly6_term(q2), 0.0), axis=1)
    s = jnp.maximum(s, 1.0)
    return jnp.float32(params.c_rho) * s


def compute_external_forces(
    pos_l: V3,
    vel_l: V3,
    rho_l: jax.Array,
    ptype_l: jax.Array,
    nbrs: NeighborList,
    params: SimParams,
    pos_g: V3 | None = None,
    vel_g: V3 | None = None,
    rho_g: jax.Array | None = None,
    ptype_g: jax.Array | None = None,
    normal_g: V3 | None = None,
) -> V3:
    """Viscosity + gravity + surface tension -> a_ext (V3 of local rows).

    Boundary particles get zero (they never move, sphFluid.cl:616-622).
    ``normal_g`` must be provided (boundary normals of all particles).
    """
    pos_g = pos_l if pos_g is None else pos_g
    vel_g = vel_l if vel_g is None else vel_g
    rho_g = rho_l if rho_g is None else rho_g
    ptype_g = ptype_l if ptype_g is None else ptype_g

    j = jnp.maximum(nbrs.idx, 0)
    mask = nbrs.valid & (nbrs.q < 1.0)

    # Boundary particles' "velocity" is their wall normal (see module doc).
    is_b_j = ptype_g[j] == BOUNDARY_PARTICLE
    vel_j = normal_g.take(j).where(is_b_j, vel_g.take(j))

    w_v = jnp.where(mask, visc_term(nbrs.q) / rho_g[j], 0.0)
    visc = ((vel_j - vel_l.expand(1)) * w_v).sum(axis=1)
    a = visc * (jnp.float32(params.c_visc) / rho_l)

    st = masked(mask, pos_l.expand(1) - pos_g.take(j)).sum(axis=1)
    a = a + st * jnp.float32(params.c_surf)

    gx, gy, gz = params.gravity
    a = V3(a.x + jnp.float32(gx), a.y + jnp.float32(gy),
           a.z + jnp.float32(gz))

    return masked(ptype_l != BOUNDARY_PARTICLE, a)


class PcisphResult(NamedTuple):
    pressure: jax.Array  # [n_local]
    a_p: V3              # pressure-force acceleration, V3 of [n_local]


def pcisph_pressure_loop(
    pos_l: V3,
    vel_l: V3,
    ptype_l: jax.Array,
    nbrs: NeighborList,
    params: SimParams,
    pos_g: V3 | None = None,
    gather: GatherFn | None = None,
) -> PcisphResult:
    """The fixed-3-iteration prediction-correction loop
    (`owPhysicsFluidSimulator.cpp:99-106`), fully on device via fori_loop.

    ``gather`` re-globalizes per-iteration local arrays (predicted positions,
    predicted densities, pressures) for neighbor reads.
    """
    pos_g = pos_l if pos_g is None else pos_g
    gather = _identity_gather if gather is None else gather

    n_loc = pos_l.x.shape[0]
    j = jnp.maximum(nbrs.idx, 0)
    mask = nbrs.valid
    mask_h = mask & (nbrs.q < 1.0)
    not_b = ptype_l != BOUNDARY_PARTICLE

    dt = jnp.float32(params.time_step)
    pos_dt = jnp.float32(params.time_step * params.simulation_scale_inv)
    inv_h2 = jnp.float32(1.0 / (params.h * params.h))
    c_rho = jnp.float32(params.c_rho)
    rho0 = jnp.float32(params.rho0)
    delta = jnp.float32(params.delta)
    c_press = jnp.float32(params.c_press)

    # Unit vectors i->j and the anti-clump branch depend only on the step-start
    # geometry (the reference uses cached neighbor distances, sphFluid.cl:1156),
    # so hoist them out of the loop.
    inv_r = 1.0 / (jnp.maximum(nbrs.q, 1e-30) * jnp.float32(params.h))
    unit_ij = (pos_l.expand(1) - pos_g.take(j)) * inv_r
    nonzero_r = nbrs.q > 0.0

    # Close-range anti-clump substitution (sphFluid.cl:1166-1170):
    # below q = 0.25, the pair term swaps to a rho0*delta-driven repulsion.
    close = nbrs.q < 0.25
    term_close = (0.25 - nbrs.q) ** 2 * 0.5 * (rho0 * delta)
    term_far_geom = spiky_term(nbrs.q) * 0.5

    def body(_, carry):
        p, apx, apy, apz = carry
        a_p = V3(apx, apy, apz)
        # -- predict positions (boundary stays put) --
        x_star = pos_l + (vel_l + a_p * dt) * pos_dt
        x_star = x_star.where(not_b, pos_l)
        x_star_g = V3(gather(x_star.x), gather(x_star.y), gather(x_star.z))

        # -- predicted density from predicted positions --
        ds = x_star.expand(1) - x_star_g.take(j)
        q2s = ds.norm2() * inv_h2
        contrib = jnp.where(mask & (q2s < 1.0), poly6_term(q2s), 0.0)
        rho_star = c_rho * jnp.maximum(jnp.sum(contrib, axis=1), 1.0)
        rho_star_g = gather(rho_star)

        # -- pressure correction: all particles, non-negative increment --
        p = p + jnp.maximum(0.0, (rho_star - rho0) * delta)
        p_g = gather(p)

        # -- pressure-force acceleration --
        term = jnp.where(
            close, term_close, term_far_geom * (p[:, None] + p_g[j])
        )
        term = term / rho_star_g[j]
        w = jnp.where(mask_h & nonzero_r, term, 0.0)
        f = (unit_ij * w).sum(axis=1)
        a_p = f * (c_press / rho_star)
        a_p = masked(not_b, a_p)
        return p, a_p.x, a_p.y, a_p.z

    zero = jnp.zeros((n_loc,), dtype=pos_l.x.dtype)
    p, apx, apy, apz = jax.lax.fori_loop(
        0, params.n_pcisph_iters, body, (zero, zero, zero, zero)
    )
    return PcisphResult(pressure=p, a_p=V3(apx, apy, apz))


def boundary_response(
    x_new: V3,
    v_new: V3,
    ptype_g: jax.Array,
    normal_g: V3,
    pos0_g: V3,
    nbrs: NeighborList,
    params: SimParams,
) -> tuple[V3, V3]:
    """Ihmsen et al. 2010 frozen-particle position projection + friction
    (sphFluid.cl:824-887). Distances in sim units against the *static*
    boundary positions; r0 = h/2."""
    j = jnp.maximum(nbrs.idx, 0)
    r0 = jnp.float32(params.r0)
    is_b_j = (ptype_g[j] == BOUNDARY_PARTICLE) & nbrs.valid

    dist = (x_new.expand(1) - pos0_g.take(j)).norm()
    w = jnp.where(is_b_j, jnp.maximum(0.0, (r0 - dist) / r0), 0.0)
    n_ci = (normal_g.take(j) * w).sum(axis=1)
    w_sum = jnp.sum(w, axis=1)
    w2_sum = jnp.sum(w * (r0 - dist) * is_b_j, axis=1)

    n_len2 = n_ci.norm2()
    has = n_len2 > 0.0
    inv_len = jax.lax.rsqrt(jnp.maximum(n_len2, 1e-30))
    coef = inv_len * w2_sum / jnp.maximum(w_sum, 1e-30)
    x_out = (x_new + n_ci * coef).where(has, x_new)

    # Tangential friction: projection uses the *unnormalized* n_ci, exactly as
    # the reference does (sphFluid.cl:878-884).
    vn = n_ci.dot(v_new)
    fric = has & (vn < 0.0)
    v_fric = (v_new - n_ci * vn) * jnp.float32(0.99)
    v_out = v_fric.where(fric, v_new)
    return x_out, v_out


def integrate(
    pos_l: V3,
    vel_l: V3,
    ptype_l: jax.Array,
    a_ext: V3,
    a_p: V3,
    nbrs: NeighborList,
    params: SimParams,
    ptype_g: jax.Array | None = None,
    normal_g: V3 | None = None,
    pos0_g: V3 | None = None,
) -> tuple[V3, V3]:
    """Semi-implicit Euler + box clamp + boundary response
    (sphFluid.cl:1684-1808). Returns (pos, vel) with boundary rows untouched."""
    ptype_g = ptype_l if ptype_g is None else ptype_g
    pos0_g = pos_l if pos0_g is None else pos0_g

    dt = jnp.float32(params.time_step)
    pos_dt = jnp.float32(params.time_step * params.simulation_scale_inv)
    v_new = vel_l + (a_ext + a_p) * dt
    x_new = pos_l + v_new * pos_dt

    lo = params.box_min
    hi = params.box_max
    eps = 1e-6
    x_new = V3(
        jnp.clip(x_new.x, jnp.float32(lo[0]), jnp.float32(hi[0] - eps)),
        jnp.clip(x_new.y, jnp.float32(lo[1]), jnp.float32(hi[1] - eps)),
        jnp.clip(x_new.z, jnp.float32(lo[2]), jnp.float32(hi[2] - eps)),
    )

    v_avg = (vel_l + v_new) * jnp.float32(0.5)
    x_new, v_avg = boundary_response(
        x_new, v_avg, ptype_g, normal_g, pos0_g, nbrs, params
    )

    not_b = ptype_l != BOUNDARY_PARTICLE
    return x_new.where(not_b, pos_l), v_avg.where(not_b, vel_l)
