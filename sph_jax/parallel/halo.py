"""Z-slab halo-exchange SPMD fast engine — the scalable multi-chip path.

Domain decomposition (SURVEY §5/§7: the SPH analog of context parallelism):
the fast engine keeps particles sorted by cell id in z-major order, so a
contiguous range of the sorted array IS a z-slab of the world. Each device
owns ``n_blocks_loc`` consecutive own-blocks (equal particle counts — load
balanced by construction, unlike equal-z splits) plus a fixed-capacity halo
band of ``halo_pad`` sorted rows on each side. Between spatial resorts the
only per-step communication is the halo exchange: two ``ppermute`` rounds
(left and right neighbor) per exchanged field group, each moving
``halo_pad`` rows — O(N/D + halo) per device instead of the all-gather
baseline's O(N) (parallel/sharded.py, kept as the correctness oracle).

Cell size h ≥ interaction radius guarantees one cell-row halos
(`/root/reference/src/owPhysicsConstant.h:22` uses 2h cells for the same
reason); ``halo_pad`` must cover the particles of one z cell-row plus
alignment slack — validated at every resort (``halo_overflow`` aux output,
nonzero means pairs were dropped and the cap must be raised).

The spatial resort has two implementations (``distributed_resort``):
the default replicated one (positions all-gathered, every device computes
the global sort + window tables — O(N) traffic once per ``resort_every``
steps), and the distributed one — global sorted ranks from an
all-gathered per-CELL histogram (O(n_cells), independent of N for a fixed
grid) + per-device prefix counts, neighbor-only particle migration through
fixed-capacity ppermute buffers, window tables from the histogram's pencil
offsets; original particle order is materialized only at the jitted call's
entry/exit. Springs/membranes evaluate on the compact elastic subset in
LOCAL slab coordinates — no per-step collective in either mode.

The reference has no distributed path at all; this module is new
capability, not a port.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..config import SimParams
from ..constants import BOUNDARY_PARTICLE, LIQUID_PARTICLE
from ..core import fast as F
from ..core.state import FluidState, Membranes, Springs
from ..core.step import SceneLayout
from ..models import muscle
from ..ops import pair_kernels as pk
from ..ops import vec3
from .mesh import PARTICLE_AXIS

ALIGN = pk.ALIGN


def measure_halo_pad(pos, params: SimParams, cfg: F.FastConfig,
                     margin: float = 1.5) -> int:
    """Scene-measured halo band size (rows exchanged per edge).

    An edge block's interaction window reaches into the neighbouring
    z-slab by at most its own (partial) z-row plus one full z-row, plus
    the ccol tile overhang. The bound used is ``margin`` x the densest
    two consecutive z-rows of the build-time scene + ccol, ALIGN-rounded
    — resort-time drift is covered by the margin, and any violation is
    surfaced (and pairs dropped) via the halo_overflow diagnostic."""
    cell = params.h
    nz = cfg.dims[2]
    zrow = np.clip(
        (np.asarray(pos)[:, 2] - params.z_min) / cell, 0, nz - 1
    ).astype(np.int64)
    counts = np.bincount(zrow, minlength=nz)
    two_row = int((counts[:-1] + counts[1:]).max()) if nz > 1 else int(
        counts.max())
    need = int(margin * two_row) + cfg.ccol
    return max(ALIGN, -(-need // ALIGN) * ALIGN)


def measure_migration_pad(pos, params: SimParams, cfg: F.FastConfig,
                          margin: float = 1.5) -> int:
    """Scene-measured migration buffer size (rows per direction per
    resort) for the distributed resort, mirroring :func:`measure_halo_pad`.

    Rows migrate when their global sorted rank crosses a device boundary
    between resorts. With the per-period pair-approach drift bound held
    under h (the ``window_drift_h`` diagnostic warns at 0.25 h), a row's
    CELL can change by at most one cell row, so every migrant was within
    the two z cell-rows straddling the boundary at the previous resort;
    rank shifts induced by *other* rows' cell changes are bounded by the
    same two-row population. The densest two consecutive z-rows of the
    scene times ``margin`` therefore bound the per-direction migration;
    violations (e.g. drift >= h dynamics) are loudly surfaced — and the
    overflowing rows dropped — via ``diag["resort_overflow"]``."""
    cell = params.h
    nz = cfg.dims[2]
    zrow = np.clip(
        (np.asarray(pos)[:, 2] - params.z_min) / cell, 0, nz - 1
    ).astype(np.int64)
    counts = np.bincount(zrow, minlength=nz)
    two_row = int((counts[:-1] + counts[1:]).max()) if nz > 1 else int(
        counts.max())
    need = int(margin * two_row)
    return max(ALIGN, -(-need // ALIGN) * ALIGN)


def make_halo_fast_multi_step(
    mesh: Mesh,
    params: SimParams,
    layout: SceneLayout,
    cfg: F.FastConfig,
    n_steps: int = 1,
    halo_pad: int | None = None,
    distributed_resort: bool = False,
    mig_cap: int | None = None,
    _session: bool = False,
):
    """Jitted run(state, springs, membranes) -> (state, diag) with
    ``diag = {"halo_overflow": int, "window_drift": f32}`` — overflow is
    the count of window bounds clipped by the halo band (pairs dropped;
    raise halo_pad), window_drift the staleness bound of core.fast
    (max-over-periods sum of per-step max Euclidean displacement).

    Scaling contract: the steady state (between resorts) runs NO O(N)
    collective — per step each device ppermutes only its halo edge bands
    (springs are the compact-slab pair pass in local slab coordinates,
    membrane geometry is slab-sourced). The RESORT:
    * ``distributed_resort=False`` (default): replicated — all-gathers
      positions/velocities/normals/types and re-sorts globally on every
      device (O(N) bytes per resort, amortized over resort_every).
    * ``distributed_resort=True``: no O(N) collective between
      the jitted call's entry sort and exit unsort — ranks from an
      all-gathered [ndev, n_cells] int32 histogram + per-device prefix
      counts, neighbor-only migration via fixed-capacity ppermute
      buffers (misses surfaced as diag["resort_overflow"]; those rows
      are dropped), window tables from histogram pencil offsets + local
      block pencil ranges, per-eid sorted-row map by O(n_el) psum.
      Intra-cell order is stable w.r.t. the PREVIOUS sorted order (the
      replicated path is stable w.r.t. original ids), so the two modes
      agree to f32 round-off, not bitwise.

    ``state`` is particle-sharded over ``mesh`` (see
    parallel.sharded.shard_state); springs/membranes replicated.
    ``cfg.n_particles`` must be a multiple of ``n_devices * cfg.block``
    (pad the scene with parallel.mesh.pad_scene_to_devices using
    ``n_devices * block``). ``halo_overflow`` > 0 means a window reached
    beyond the halo band (raise halo_pad); pairs were dropped.
    """
    ax = PARTICLE_AXIS
    ndev = mesh.devices.size
    if halo_pad is None:
        # default: 4096 rows, clamped to the per-device row count (the
        # halo_overflow diagnostic reports if physics needs more)
        per_dev = (cfg.n_blocks // max(ndev, 1)) * cfg.block
        halo_pad = max(ALIGN, min(4096, (per_dev // ALIGN) * ALIGN))
    assert halo_pad % ALIGN == 0
    n = cfg.n_particles
    assert n % (ndev * cfg.block) == 0, (
        f"n_particles {n} must be a multiple of n_devices*block "
        f"{ndev * cfg.block}"
    )
    assert cfg.n_blocks % ndev == 0, (
        f"n_blocks {cfg.n_blocks} must divide across {ndev} devices — "
        "build the config with compute_fast_config(..., "
        "block_multiple=n_devices)"
    )
    if layout.n_elastic > 0:
        assert layout.springs_anchors_static, (
            "halo engine: springs anchored to moving (liquid) particles "
            "would reuse stale resort-time positions for up to "
            "resort_every steps; only elastic/boundary anchors are exact"
        )
    nb_loc = cfg.n_blocks // ndev
    n_pad_loc = nb_loc * cfg.block
    assert n_pad_loc >= halo_pad, (
        f"halo_pad {halo_pad} exceeds per-device rows {n_pad_loc}; use a "
        "smaller halo_pad or fewer devices"
    )
    n_loc = n // ndev
    # local slab: [left halo | own rows | right halo | tile overhang]
    slab_size = n_pad_loc + 2 * halo_pad + cfg.ccol
    own_off = halo_pad  # static: own rows always start here in the slab

    # the global sorted coordinate system is shifted by +halo_pad so that
    # device 0's slab start (o0 - halo_pad) is never negative
    P0 = halo_pad
    galloc = P0 + cfg.n_pad + cfg.ccol + halo_pad

    far = np.float32(
        max(params.x_max, params.y_max, params.z_max) + 100.0 * params.h
    )
    nx, ny, nz = cfg.dims
    perm_fwd = [(i, i + 1) for i in range(ndev - 1)]   # send to next
    perm_bwd = [(i + 1, i) for i in range(ndev - 1)]   # send to prev

    inv_h2 = np.float32(1.0 / (params.h * params.h))
    inv_h = np.float32(1.0 / params.h)
    c_rho = np.float32(params.c_rho)
    r0 = np.float32(params.r0)
    kw = dict(block=cfg.block, ccol=cfg.ccol, n_blocks=nb_loc,
              inv_h2=inv_h2, interpret=cfg.interpret)
    density_pass = pk.make_density_pass(c_rho=c_rho, **kw)
    rho_star_pass = pk.make_density_pass(c_rho=c_rho, name="rho_star_pass",
                                         **kw)
    viscsurf_pass = pk.make_viscsurf_pass(**kw)
    paccel_pass = pk.make_paccel_pass(
        inv_h=inv_h, rho0_delta=np.float32(params.rho0 * params.delta),
        **kw
    )
    boundary_pass = pk.make_boundary_pass(r0=r0, **kw)
    membrane_pass = pk.make_membrane_pass(r0=r0, **kw)
    spring_pass = pk.make_spring_pass(
        inv_h=inv_h,
        h_scale=np.float32(params.h * params.simulation_scale),
        k_spring=np.float32(params.k_spring),
        n_slots=layout.spring_slots, **kw,
    ) if layout.n_elastic > 0 and layout.springs_elastic_only else None

    dt = np.float32(params.time_step)
    pos_dt = np.float32(params.time_step * params.simulation_scale_inv)
    rho0 = np.float32(params.rho0)
    delta_c = np.float32(params.delta)
    c_press = np.float32(params.c_press)
    c_visc = np.float32(params.c_visc)
    c_surf = np.float32(params.c_surf)
    gx, gy, gz = (np.float32(g) for g in params.gravity)
    lo_box = params.box_min
    hi_box = params.box_max

    def exchange(own_fields, fills):
        """Build local slabs from own rows + ppermute'd neighbor edges.

        own_fields: list of [n_pad_loc] arrays. Returns list of
        [slab_size] arrays: [prev tail | own | next head | fill].
        Devices at the chain ends receive zeros from ppermute; those bands
        are overwritten with the per-field fill value (positions -> far):
        the maskless kernels have no window test, and zero-position
        columns would sit at the box origin corner inside reach of real
        particles.
        """
        k = len(own_fields)
        stack = jnp.stack(own_fields, 0)                      # [k, n_pad_loc]
        tail = jax.lax.ppermute(stack[:, -halo_pad:], ax, perm_fwd)
        head = jax.lax.ppermute(stack[:, :halo_pad], ax, perm_bwd)
        dev = jax.lax.axis_index(ax)
        fillc = jnp.array(fills, jnp.float32)[:, None]
        tail = jnp.where(dev == 0, fillc, tail)
        head = jnp.where(dev == ndev - 1, fillc, head)
        out = []
        for i in range(k):
            fill = jnp.full((cfg.ccol,), fills[i], jnp.float32)
            out.append(jnp.concatenate(
                [tail[i], own_fields[i], head[i], fill]
            ))
        return out

    def own_of(a):
        return jax.lax.dynamic_slice(a, (own_off,), (n_pad_loc,))

    def inner_body(ctx, carry):
        """One sorted-space local step. All per-resort products (window
        tables, static slabs, spring/membrane contexts) come from ``ctx``
        so the replicated and distributed resorts share this body."""
        xo, yo, zo, vxo, vyo, vzo, act, step_no, drift = carry
        isb_s = ctx["isb_s"]
        liq_s = ctx["liq_s"]
        nxs, nys, nzs = ctx["nxs"], ctx["nys"], ctx["nzs"]
        bmask = ctx["bmask"]
        not_b = ctx["not_b"]
        tables = ctx["tables"]
        force_tables = ctx["force_tables"]

        xs, ys, zs, vxs_t, vys_t, vzs_t = exchange(
            [xo, yo, zo, vxo, vyo, vzo],
            [far, far, far, 0.0, 0.0, 0.0],
        )
        # boundary rows carry wall normals as "velocity"
        vxs = jnp.where(isb_s > 0, nxs, vxs_t)
        vys = jnp.where(isb_s > 0, nys, vys_t)
        vzs = jnp.where(isb_s > 0, nzs, vzs_t)

        ones = jnp.ones_like(xs)
        main0 = F._pack([xs, ys, zs, vxs, vys, vzs, ones, isb_s])
        rho_o = density_pass(tables, main0, main0)
        rho_o = jnp.where(rho_o <= 0, 1.0, rho_o)
        inv_rho_o = 1.0 / rho_o  # kernels take 1/rho (no pair divide)
        (inv_rho_s,) = exchange([inv_rho_o], [1.0])

        main1 = F._pack([xs, ys, zs, vxs, vys, vzs, inv_rho_s, isb_s])
        vx, vy, vz, stx, sty, stz = viscsurf_pass(
            force_tables, main1, main1)
        aex = (c_visc * vx * inv_rho_o + c_surf * stx + gx) * not_b
        aey = (c_visc * vy * inv_rho_o + c_surf * sty + gy) * not_b
        aez = (c_visc * vz * inv_rho_o + c_surf * stz + gz) * not_b

        if "spr_static" in ctx:
            # compact-slab spring pair pass over the LOCAL slab — no
            # collective: partners of owned rows are inside the band
            n_el = ctx["n_el"]
            mcap_s = ctx["spr_static"].shape[1]
            actf = jnp.matmul(
                ctx["spr_onehot"],
                act * np.float32(params.muscle_force),
                precision=jax.lax.Precision.HIGHEST,
            ).reshape(n_el, layout.spring_slots)
            actf_p = jnp.zeros(
                (layout.spring_slots, mcap_s), jnp.float32
            ).at[:, :n_el].set(actf.T)
            col_ok = ctx["spr_col_ok"]
            col_safe = ctx["spr_col_safe"]

            def crow(a):
                v = jnp.where(col_ok, a[col_safe], far)
                return jnp.full((mcap_s,), far, jnp.float32).at[
                    :n_el].set(v)

            spr_pack = jnp.concatenate([
                jnp.stack([crow(xs), crow(ys), crow(zs)], axis=0),
                ctx["spr_static"], actf_p,
            ], axis=0)
            sfx, sfy, sfz = spring_pass(ctx["spr_tables"], main1, spr_pack)
            aex = aex + sfx
            aey = aey + sfy
            aez = aez + sfz
        elif "fb_row_eid" in ctx:
            springs = ctx["springs"]
            ebuf = ctx["fb_globalize"](xo, yo, zo)
            # endpoint positions: elastic endpoints from the [3, n_el]
            # psum buffer, anything else (boundary — never moves) from
            # the entry-time original-order positions. eid maps live in
            # the ORIGINAL-id domain, so they are resort-independent.
            ep_eid = ctx["fb_ep_eid"]
            row_eid = ctx["fb_row_eid"]
            exg = jnp.where(ep_eid >= 0,
                            ebuf[0, jnp.maximum(ep_eid, 0)],
                            ctx["fb_static_x"])
            eyg = jnp.where(ep_eid >= 0,
                            ebuf[1, jnp.maximum(ep_eid, 0)],
                            ctx["fb_static_y"])
            ezg = jnp.where(ep_eid >= 0,
                            ebuf[2, jnp.maximum(ep_eid, 0)],
                            ctx["fb_static_z"])
            rxg = ebuf[0, jnp.maximum(row_eid, 0)]
            ryg = ebuf[1, jnp.maximum(row_eid, 0)]
            rzg = ebuf[2, jnp.maximum(row_eid, 0)]
            scale = jnp.float32(params.simulation_scale)
            dx = (rxg[:, None] - exg) * scale
            dy = (ryg[:, None] - eyg) * scale
            dz = (rzg[:, None] - ezg) * scale
            r = jnp.sqrt(dx * dx + dy * dy + dz * dz)
            ok = (springs.idx >= 0) & (r != 0.0)
            inv_r = 1.0 / jnp.maximum(r, 1e-30)
            stretch = r - springs.rest
            coefs = jnp.where(
                ok, -stretch * jnp.float32(params.k_spring), 0.0)
            mid = springs.muscle
            mact = act[jnp.maximum(mid - 1, 0)]
            m_on = ok & (mid > 0) & (mact > 0.0)
            coefs = coefs + jnp.where(
                m_on, -mact * jnp.float32(params.muscle_force), 0.0)
            aex_e = (dx * (coefs * inv_r)).sum(axis=1)
            aey_e = (dy * (coefs * inv_r)).sum(axis=1)
            aez_e = (dz * (coefs * inv_r)).sum(axis=1)
            own_rows_local = ctx["fb_own_rows_local"]
            tgt = jnp.where(
                (own_rows_local >= 0) & (own_rows_local < n_pad_loc),
                own_rows_local, n_pad_loc)
            aex = aex.at[tgt].add(aex_e, mode="drop")
            aey = aey.at[tgt].add(aey_e, mode="drop")
            aez = aez.at[tgt].add(aez_e, mode="drop")

        # PCISPH
        p_o = jnp.zeros(n_pad_loc, jnp.float32)
        apx = jnp.zeros(n_pad_loc, jnp.float32)
        apy = jnp.zeros(n_pad_loc, jnp.float32)
        apz = jnp.zeros(n_pad_loc, jnp.float32)
        own_x = own_of(xs)
        own_y = own_of(ys)
        own_z = own_of(zs)
        for _i in range(params.n_pcisph_iters):
            xst = jnp.where(bmask, own_x,
                            own_x + pos_dt * (vxo + dt * apx))
            yst = jnp.where(bmask, own_y,
                            own_y + pos_dt * (vyo + dt * apy))
            zst = jnp.where(bmask, own_z,
                            own_z + pos_dt * (vzo + dt * apz))
            xsts, ysts, zsts = exchange([xst, yst, zst],
                                        [far, far, far])
            iter_pack = F._pack([xsts, ysts, zsts])
            rho_star = rho_star_pass(tables, iter_pack, iter_pack)
            p_o = p_o + jnp.maximum(0.0, (rho_star - rho0) * delta_c)
            irs_s, p_s = exchange(
                [1.0 / jnp.maximum(rho_star, 1.0), p_o], [1.0, 0.0])
            pa_pack = F._pack([xs, ys, zs, irs_s, p_s])
            fx, fy, fz = paccel_pass(force_tables, pa_pack, pa_pack)
            coef = jnp.where(bmask, 0.0, c_press / rho_star)
            apx, apy, apz = coef * fx, coef * fy, coef * fz

        # integrate
        vnx = vxo + dt * (aex + apx)
        vny = vyo + dt * (aey + apy)
        vnz = vzo + dt * (aez + apz)
        xn = jnp.clip(own_x + pos_dt * vnx,
                      np.float32(lo_box[0]), np.float32(hi_box[0] - 1e-6))
        yn = jnp.clip(own_y + pos_dt * vny,
                      np.float32(lo_box[1]), np.float32(hi_box[1] - 1e-6))
        zn = jnp.clip(own_z + pos_dt * vnz,
                      np.float32(lo_box[2]), np.float32(hi_box[2] - 1e-6))
        vax = (vxo + vnx) * 0.5
        vay = (vyo + vny) * 0.5
        vaz = (vzo + vnz) * 0.5

        xns, yns, zns = exchange([xn, yn, zn], [far, far, far])
        own_pack = F._pack([xs, ys, zs, xns, yns, zns])
        bnd_pack = F._pack([xs, ys, zs, nxs, nys, nzs, isb_s])
        ncx, ncy, ncz, wsum, w2sum = boundary_pass(
            ctx["bnd_tables"], own_pack, bnd_pack)
        nlen2 = ncx * ncx + ncy * ncy + ncz * ncz
        has = nlen2 > 0
        coef = jnp.where(
            has,
            jax.lax.rsqrt(jnp.maximum(nlen2, 1e-30))
            * w2sum / jnp.maximum(wsum, 1e-30),
            0.0,
        )
        xn = xn + ncx * coef
        yn = yn + ncy * coef
        zn = zn + ncz * coef
        vn_dot = ncx * vax + ncy * vay + ncz * vaz
        fric = has & (vn_dot < 0)
        vax = jnp.where(fric, (vax - ncx * vn_dot) * 0.99, vax)
        vay = jnp.where(fric, (vay - ncy * vn_dot) * 0.99, vay)
        vaz = jnp.where(fric, (vaz - ncz * vn_dot) * 0.99, vaz)

        if "mem_tri_cols" in ctx:
            # triangle geometry from the LOCAL slab (no collective);
            # row gathers of stacked fields as in core.fast; triangles
            # with ANY out-of-slab vertex are zeroed — they can only
            # belong to zero-weight columns on this device
            tri_cols = ctx["mem_tri_cols"]
            n_tri = tri_cols.shape[0]
            n_el = ctx["n_el"]
            xyzn_slab = jnp.stack(
                [xns, yns, zns, jnp.zeros_like(xns)], axis=1
            )                                        # [slab, 4]
            vabc = xyzn_slab[tri_cols.reshape(-1)].reshape(
                n_tri, 3, 4)
            a3 = vabc[:, 0, :3]
            u3 = vabc[:, 1, :3] - a3
            w3 = vabc[:, 2, :3] - a3
            tn = jnp.cross(u3, w3) * ctx["mem_tri_in_slab"]
            tl2 = jnp.sum(tn * tn, axis=1, keepdims=True)
            til = jnp.where(
                tl2 > 0, jax.lax.rsqrt(jnp.maximum(tl2, 1e-30)), 0.0)
            tri8 = jnp.concatenate(
                [tn * til, a3,
                 jnp.zeros((n_tri, 2), jnp.float32)], axis=1)
            t_ok = ctx["mem_t_ok"]
            t_safe = ctx["mem_t_safe"]
            g = jnp.where(
                t_ok.reshape(-1, 1), tri8[t_safe.reshape(-1)], 0.0)
            tri_mat = g[:, :6].reshape(n_el, 42).T   # [42, n_el]
            mem_pack = jnp.zeros((pk.MEM_COLS, slab_size), jnp.float32)
            el_cols = ctx["mem_el_cols"]
            colt = jnp.where(
                (el_cols >= 0) & (el_cols < slab_size), el_cols,
                slab_size)
            mem_pack = mem_pack.at[:42, colt].set(tri_mat, mode="drop")
            mem_pack = mem_pack.at[pk.PMM_XN].set(xns)
            mem_pack = mem_pack.at[pk.PMM_YN].set(yns)
            mem_pack = mem_pack.at[pk.PMM_ZN].set(zns)
            mem_pack = mem_pack.at[pk.PMM_XT].set(xs)
            mem_pack = mem_pack.at[pk.PMM_YT].set(ys)
            mem_pack = mem_pack.at[pk.PMM_ZT].set(zs)
            mnx, mny, mnz, mws, mw2 = membrane_pass(
                ctx["mem_tables"], own_pack, mem_pack)
            ml2 = mnx * mnx + mny * mny + mnz * mnz
            mhas = (ml2 > 0) & (
                liq_s[own_off:own_off + n_pad_loc] > 0)
            mcoef = jnp.where(
                mhas,
                jax.lax.rsqrt(jnp.maximum(ml2, 1e-30))
                * mw2 / jnp.maximum(mws, 1e-30),
                0.0,
            )
            xn = xn + mnx * mcoef
            yn = yn + mny * mcoef
            zn = zn + mnz * mcoef

        # pin boundary rows
        xn = jnp.where(bmask, own_x, xn)
        yn = jnp.where(bmask, own_y, yn)
        zn = jnp.where(bmask, own_z, zn)
        vax = jnp.where(bmask, vxo, vax)
        vay = jnp.where(bmask, vyo, vay)
        vaz = jnp.where(bmask, vzo, vaz)

        if layout.muscle_model:
            act_next = muscle.next_activation(step_no)
        else:
            act_next = act
        # window-staleness bound: per-step max Euclidean
        # displacement, summed over the period (see core.fast)
        d2 = ((xn - own_x) * (xn - own_x)
              + (yn - own_y) * (yn - own_y)
              + (zn - own_z) * (zn - own_z))
        drift = drift + jnp.sqrt(jnp.max(d2))
        return (xn, yn, zn, vax, vay, vaz, act_next, step_no + 1,
                drift)

    def finish_window_tables(lo_l, hi_l, base):
        """Clamp shifted-global window bounds into the local slab and
        re-chunk into disjoint+covering tiles. Returns (tables, lo_c,
        hi_c, cnt_new, overflow_local) — overflow counts clipped bounds
        (pairs dropped; raise halo_pad)."""
        slab_lo = base
        slab_hi = base + n_pad_loc + 2 * halo_pad
        lo_c = jnp.clip(lo_l, slab_lo, slab_hi)
        hi_c = jnp.clip(hi_l, slab_lo, slab_hi)
        overflow = ((lo_l - lo_c) != 0).sum() + ((hi_l - hi_c) != 0).sum()
        lo_loc = lo_c - base
        hi_loc = hi_c - base
        aln_loc, s0_new, cnt_new = F._tile_chunks(
            lo_loc, hi_loc, nb_loc, cfg.ccol
        )
        ob = jnp.full((1,), own_off, jnp.int32)
        tables = (aln_loc, lo_loc, hi_loc, s0_new, cnt_new, ob)
        return tables, lo_c, hi_c, cnt_new, overflow

    def build_spring_ctx(springs, el_rows, partner_row_of, base,
                         lo_c, hi_c, eid_own_rows, ob, n_el):
        """Compact-slab spring context: partner ids rewritten into LOCAL
        slab coordinates; out-of-slab columns poisoned.
        ``partner_row_of(orig_ids)`` maps
        original particle ids -> global sorted rows (the only piece that
        differs between the replicated and distributed resorts)."""
        e0, _ = layout.elastic_range
        n_slots = layout.spring_slots
        mcap_s = -(-n_el // ALIGN) * ALIGN + cfg.ccol
        perm_e = jnp.argsort(el_rows).astype(jnp.int32)
        els_g = el_rows[perm_e]                      # ascending rows
        rmap = jnp.full(n, -1, jnp.int32).at[springs.row_ids].set(
            jnp.arange(springs.n_elastic, dtype=jnp.int32)
        )
        r_of_col = rmap[e0 + perm_e]                 # [n_el]
        r_safe = jnp.maximum(r_of_col, 0)
        sidx_c = jnp.where(
            (r_of_col >= 0)[:, None],
            springs.idx[r_safe, :n_slots], -1,
        )                                            # [n_el,k] orig ids
        col_slab = els_g + P0 - base                 # [n_el] slab coord
        col_ok = (col_slab >= 0) & (col_slab < slab_size)
        idx_slab = jnp.where(
            sidx_c >= 0, partner_row_of(sidx_c) + P0 - base, -1,
        )
        idx_f = jnp.where(
            col_ok[:, None] & (sidx_c >= 0),
            idx_slab.astype(jnp.float32), -1.0,
        )
        rest_c = jnp.where(
            sidx_c >= 0, springs.rest[r_safe, :n_slots], 0.0)
        idx_p = jnp.full((n_slots, mcap_s), -1.0, jnp.float32).at[
            :, :n_el].set(idx_f.T)
        rest_p = jnp.zeros((n_slots, mcap_s), jnp.float32).at[
            :, :n_el].set(rest_c.T)
        spr_static = jnp.concatenate([idx_p, rest_p], axis=0)
        mid_c = jnp.where(
            sidx_c >= 0, springs.muscle[r_safe, :n_slots], 0)
        from ..constants import MUSCLE_COUNT
        spr_onehot = (
            mid_c.reshape(-1)[:, None]
            == jnp.arange(1, MUSCLE_COUNT + 1, dtype=mid_c.dtype)
        ).astype(jnp.float32)
        # windows onto the compact column space (slab-clipped bounds
        # so only in-slab columns are ever streamed)
        lo_e = jnp.searchsorted(
            els_g, lo_c - P0, side="left").astype(jnp.int32)
        hi_e = jnp.searchsorted(
            els_g, hi_c - P0, side="left").astype(jnp.int32)
        aln_e, s0_e, cnt_e = F._tile_chunks(
            lo_e, hi_e, nb_loc, cfg.ccol)
        own_loc = idx_slab - own_off
        aln_e, s0_e, cnt_e = F._spring_chunks(
            aln_e, s0_e, cnt_e,
            jnp.where(col_ok[:, None] & (sidx_c >= 0) & (own_loc >= 0)
                      & (own_loc < n_pad_loc), own_loc, -1),
            nb_loc, cfg.block, cfg.ccol)
        own_el_blk = (
            eid_own_rows.reshape(nb_loc, cfg.block) >= 0
        ).any(axis=1)
        spr_tables = (aln_e, lo_e, hi_e, s0_e,
                      jnp.where(own_el_blk, cnt_e, 0), ob)
        return dict(
            spr_static=spr_static, spr_onehot=spr_onehot,
            spr_col_ok=col_ok,
            spr_col_safe=jnp.clip(col_slab, 0, slab_size - 1),
            spr_tables=spr_tables, n_el=n_el,
        )

    def build_mem_ctx(membranes, el_rows, tri_rows, base, seg_m,
                      plo_l, phi_l, own_liq, tables, cnt_new, ob):
        """Membrane context: triangle vertices as LOCAL slab coordinates,
        triangles with ANY out-of-slab vertex zeroed (they can only feed
        zero-weight columns on this device). ``seg_m`` is the
        per-pencil count of membrane-flagged rows (replicated)."""
        e0, e1 = layout.elastic_range
        n_el = e1 - e0
        pt = membranes.particle_tris[e0:e1]
        t_ok = pt >= 0
        t_safe = jnp.maximum(pt, 0)
        tri_raw = tri_rows + P0 - base
        tri_in_slab = ((tri_raw >= 0) & (tri_raw < slab_size)).all(
            axis=1, keepdims=True)                   # [M,1] per-device
        tri_cols = jnp.clip(tri_raw, 0, slab_size - 1)
        el_cols = el_rows - base + P0
        csum_m = jnp.concatenate(
            [jnp.zeros(1, seg_m.dtype), jnp.cumsum(seg_m)]
        )
        chunk_mem = (csum_m[phi_l] - csum_m[plo_l]).sum(axis=1) > 0
        mem_tables = tables[:4] + (
            jnp.where(chunk_mem & own_liq, cnt_new, 0), ob)
        return dict(
            mem_tri_cols=tri_cols, mem_tri_in_slab=tri_in_slab,
            mem_t_ok=t_ok, mem_t_safe=t_safe, mem_el_cols=el_cols,
            mem_tables=mem_tables, n_el=n_el,
        )

    def sweep(state_l, springs, membranes, r_steps):
        """One resort + r_steps sorted-space local steps. state_l holds the
        device's original-space rows [n_loc]."""
        # ---- replicated resort -------------------------------------------
        def ag(a):
            return jax.lax.all_gather(a, ax, tiled=True)

        pos = vec3.split(state_l.pos)
        pos_g = vec3.V3(ag(pos.x), ag(pos.y), ag(pos.z))
        vel = vec3.split(state_l.vel)
        vel_g = vec3.V3(ag(vel.x), ag(vel.y), ag(vel.z))
        nrm = vec3.split(state_l.normal)
        nrm_g = vec3.V3(ag(nrm.x), ag(nrm.y), ag(nrm.z))
        ptype_g = ag(state_l.ptype)
        is_b = (ptype_g == BOUNDARY_PARTICLE).astype(jnp.float32)
        is_liq = (ptype_g == LIQUID_PARTICLE).astype(jnp.float32)

        cell = jnp.float32(1.0 / params.h)
        bx, by, bz = (jnp.float32(b) for b in params.box_min)
        cx = jnp.clip(((pos_g.x - bx) * cell).astype(jnp.int32), 0, nx - 1)
        cy = jnp.clip(((pos_g.y - by) * cell).astype(jnp.int32), 0, ny - 1)
        cz = jnp.clip(((pos_g.z - bz) * cell).astype(jnp.int32), 0, nz - 1)
        pencil = cx + nx * cz
        cid = cy + ny * pencil
        order = jnp.argsort(cid, stable=True).astype(jnp.int32)
        inv = jnp.zeros(n, jnp.int32).at[order].set(
            jnp.arange(n, dtype=jnp.int32)
        )
        pencil_s = pencil[order]

        tables_g, _, pranges = F._window_tables(pencil_s, cfg)
        _aln_g, lo_g, hi_g, _s0_g, _cnt_g, _ = tables_g

        dev = jax.lax.axis_index(ax)
        o0 = dev * n_pad_loc                      # own start, sorted coords
        base = o0 - halo_pad + P0                 # slab start, shifted
        # shifted-global window bounds for the local block range
        t0 = dev * nb_loc * 3
        lo_l = jax.lax.dynamic_slice(lo_g, (t0,), (nb_loc * 3,)) + P0
        hi_l = jax.lax.dynamic_slice(hi_g, (t0,), (nb_loc * 3,)) + P0
        tables, lo_c, hi_c, cnt_new, ovf_loc = finish_window_tables(
            lo_l, hi_l, base)
        overflow = jax.lax.psum(ovf_loc, ax)
        ob = tables[5]

        # sorted static fields, local slab slices
        def sl(a_g_sorted, fill):
            g = jnp.full((galloc,), fill, a_g_sorted.dtype)
            g = jax.lax.dynamic_update_slice(g, a_g_sorted, (P0,))
            return jax.lax.dynamic_slice(g, (base,), (slab_size,))

        # fill 1.0: rows outside the real sorted range (phantom pads of
        # the last device, never-real shift regions) are pinned like
        # walls — maskless tiles can overhang into them
        isb_s = sl(is_b[order], 1.0)
        liq_s = sl(is_liq[order], 0.0)
        nxs = sl(nrm_g.x[order], 0.0)
        nys = sl(nrm_g.y[order], 0.0)
        nzs = sl(nrm_g.z[order], 0.0)
        xs0 = sl(pos_g.x[order], far)
        ys0 = sl(pos_g.y[order], far)
        zs0 = sl(pos_g.z[order], far)
        vx0 = sl(vel_g.x[order], 0.0)
        vy0 = sl(vel_g.y[order], 0.0)
        vz0 = sl(vel_g.z[order], 0.0)

        bmask = isb_s[own_off:own_off + n_pad_loc] > 0
        not_b = (~bmask).astype(jnp.float32)

        # per-block gates (as core.fast.sort_ctx)
        own_nonb = (
            isb_s[own_off:own_off + n_pad_loc]
            .reshape(nb_loc, cfg.block).min(axis=1) == 0
        )
        force_tables = tables[:4] + (jnp.where(own_nonb, cnt_new, 0), ob)
        seg_b = jax.ops.segment_sum(
            is_b[order], pencil_s, num_segments=cfg.n_pencils
        )
        csum_b = jnp.concatenate(
            [jnp.zeros(1, seg_b.dtype), jnp.cumsum(seg_b)]
        )
        plo_r, phi_r = pranges
        plo_l = jax.lax.dynamic_slice(plo_r, (dev * nb_loc, 0), (nb_loc, 3))
        phi_l = jax.lax.dynamic_slice(phi_r, (dev * nb_loc, 0), (nb_loc, 3))
        win_has_b = (csum_b[phi_l] - csum_b[plo_l]).sum(axis=1) > 0
        bnd_tables = tables[:4] + (
            jnp.where(own_nonb & win_has_b, cnt_new, 0), ob)

        # ---- elastic-slot machinery (shared by springs + membranes) ------
        have_springs = springs.n_elastic > 0
        have_mem = membranes.n_tris > 0
        if have_springs or have_mem:
            e0, e1 = layout.elastic_range
            n_el = e1 - e0
            eid_of_orig = jnp.full(n, -1, jnp.int32).at[
                jnp.arange(e0, e1)
            ].set(jnp.arange(n_el, dtype=jnp.int32))
            eid_sorted = eid_of_orig[order]
            # eid of each own row, for the per-step psum globalization
            eid_own_rows = own_of(
                sl(eid_sorted.astype(jnp.float32), -1.0)
            ).astype(jnp.int32)
            el_rows = inv[jnp.arange(e0, e1)]            # sorted row per eid

            def globalize_elastic(xo, yo, zo):
                """psum-gather current elastic positions -> [3, n_el]."""
                tgt = jnp.where(eid_own_rows >= 0, eid_own_rows, n_el)
                buf = jnp.zeros((3, n_el + 1), jnp.float32)
                buf = buf.at[0, tgt].add(xo, mode="drop")
                buf = buf.at[1, tgt].add(yo, mode="drop")
                buf = buf.at[2, tgt].add(zo, mode="drop")
                return jax.lax.psum(buf[:, :n_el], ax)

        use_compact_springs = have_springs and layout.springs_elastic_only
        if use_compact_springs:
            spr_ctx = build_spring_ctx(
                springs, el_rows,
                lambda sidx: inv[jnp.maximum(sidx, 0)],
                base, lo_c, hi_c, eid_own_rows, ob, n_el)
        elif have_springs:
            # gather fallback (non-elastic-anchored scenes): springs.idx/
            # row_ids are absolute particle ids; endpoint positions come
            # from a [3, n_el] psum plus original-order static positions
            # for boundary anchors — asserted static at build.
            own_rows_local = inv[springs.row_ids] - o0   # scatter target
            sidx_safe = jnp.maximum(springs.idx, 0)

        # ---- membranes: replicated triangle geometry ---------------------
        if have_mem:
            e0m, e1m = layout.elastic_range
            has_mem_orig = jnp.zeros(n, jnp.float32).at[
                jnp.arange(e0m, e1m)
            ].set((membranes.particle_tris[e0m:e1m] >= 0).any(
                axis=1).astype(jnp.float32))
            seg_m = jax.ops.segment_sum(
                has_mem_orig[order], pencil_s, num_segments=cfg.n_pencils
            )
            own_liq = (
                liq_s[own_off:own_off + n_pad_loc]
                .reshape(nb_loc, cfg.block).max(axis=1) > 0
            )
            mem_ctx = build_mem_ctx(
                membranes, el_rows, inv[membranes.tris], base, seg_m,
                plo_l, phi_l, own_liq, tables, cnt_new, ob)

        # ---- per-resort context for the shared inner body -----------------
        ctx = dict(
            isb_s=isb_s, liq_s=liq_s, nxs=nxs, nys=nys, nzs=nzs,
            bmask=bmask, not_b=not_b,
            tables=tables, force_tables=force_tables,
            bnd_tables=bnd_tables,
        )
        if use_compact_springs:
            ctx.update(spr_ctx)
        elif have_springs:
            ctx.update(
                springs=springs,
                fb_row_eid=eid_of_orig[springs.row_ids],
                fb_ep_eid=jnp.where(
                    springs.idx >= 0, eid_of_orig[sidx_safe], -1),
                fb_static_x=pos_g.x[sidx_safe],
                fb_static_y=pos_g.y[sidx_safe],
                fb_static_z=pos_g.z[sidx_safe],
                fb_own_rows_local=own_rows_local,
                fb_globalize=globalize_elastic,
                n_el=n_el,
            )
        if have_mem:
            ctx.update(mem_ctx)

        carry0 = (own_of(xs0), own_of(ys0), own_of(zs0),
                  own_of(vx0), own_of(vy0), own_of(vz0),
                  state_l.muscle_activation, state_l.step,
                  jnp.zeros((), jnp.float32))
        carry, _ = jax.lax.scan(
            lambda c, x: (inner_body(ctx, c), None), carry0, None,
            length=r_steps,
        )
        xn, yn, zn, vxn, vyn, vzn, act, step_no, drift = carry
        drift = jax.lax.pmax(drift, ax)

        # ---- re-globalize own rows, unsort, slice original shard ---------
        def agp(a):  # [n_pad_loc] -> global sorted [cfg.n_pad]
            return jax.lax.all_gather(a, ax, tiled=True)

        def unsort(a_sorted_g):
            full = jnp.zeros(n, jnp.float32).at[order].set(a_sorted_g[:n])
            return jax.lax.dynamic_slice(full, (dev * n_loc,), (n_loc,))

        pos_new = jnp.stack(
            [unsort(agp(xn)), unsort(agp(yn)), unsort(agp(zn))], axis=1)
        vel_new = jnp.stack(
            [unsort(agp(vxn)), unsort(agp(vyn)), unsort(agp(vzn))], axis=1)
        new_state = FluidState(
            pos=pos_new, vel=vel_new, ptype=state_l.ptype,
            normal=state_l.normal, muscle_activation=act, step=step_no,
        )
        return new_state, overflow, drift

    # ======================= distributed resort ==========================
    # Replaces the replicated O(N) all-gather resort (SURVEY §5 comm-
    # backend row): state stays sharded in SORTED space across sweeps;
    # global sorted ranks come from an all-gathered per-CELL histogram
    # (O(n_cells), constant in N) + per-device prefix counts; only rows
    # whose rank crosses a device boundary migrate, through fixed-capacity
    # ppermute buffers; window tables are rebuilt from the histogram's
    # pencil offsets + local block pencil ranges. Original particle order
    # is materialized only at the jitted call's entry/exit.
    npen = cfg.n_pencils
    n_cells = ny * npen
    if mig_cap is None:
        # size with measure_migration_pad for a scene-derived bound;
        # halo_pad (>= the same two-z-row population + ccol) is a safe
        # default — overruns drop rows and are surfaced loudly
        mig_cap = halo_pad

    def _pencil_cid_of(x, y, z):
        cell = jnp.float32(1.0 / params.h)
        bx, by, bz = (jnp.float32(b) for b in params.box_min)
        cx = jnp.clip(((x - bx) * cell).astype(jnp.int32), 0, nx - 1)
        cy = jnp.clip(((y - by) * cell).astype(jnp.int32), 0, ny - 1)
        cz = jnp.clip(((z - bz) * cell).astype(jnp.int32), 0, nz - 1)
        pen = cx + nx * cz
        return pen, cy + ny * pen

    def resort_distributed(rows, springs, membranes, statics):
        """One collective-free-in-N resort. rows: dict(x y z vx vy vz
        [n_pad_loc] f32, oid [n_pad_loc] i32; oid -1 = phantom pad row).
        Returns (new rows, ctx, ovf_win, ovf_mig): ovf_win counts window
        bounds clipped by the halo band (as the replicated path), ovf_mig
        counts rows that needed to move more than one device or overran
        the mig_cap buffers — those particles are DROPPED (raise the
        resort cadence or halo_pad/mig_cap)."""
        dev = jax.lax.axis_index(ax)
        base0 = dev * n_pad_loc
        oid = rows["oid"]
        real = oid >= 0
        realf = real.astype(jnp.float32)
        pen0, cid = _pencil_cid_of(rows["x"], rows["y"], rows["z"])
        cid = jnp.where(real, cid, n_cells)          # sentinel bucket

        # global sorted rank: histogram + device prefix + local offset.
        # Intra-cell order = (device, previous sorted order) — a stable
        # sort w.r.t. the PREVIOUS sorted order, vs the replicated path's
        # stable sort w.r.t. original ids: same cells, different intra-
        # cell permutation, so reductions differ by f32 round-off only.
        cnt_loc = jnp.zeros(n_cells, jnp.int32).at[cid].add(1, mode="drop")
        cnt_all = jax.lax.all_gather(cnt_loc, ax)    # [ndev, n_cells]
        hist = cnt_all.sum(axis=0)
        cell_start = jnp.concatenate(
            [jnp.zeros(1, jnp.int32), jnp.cumsum(hist)])
        prefix_dev = jnp.cumsum(cnt_all, axis=0) - cnt_all
        my_prefix = jnp.take(prefix_dev, dev, axis=0)
        s_l = jnp.argsort(cid, stable=True)
        cid_s = cid[s_l]
        first_occ = jnp.searchsorted(cid_s, cid_s, side="left")
        occ = jnp.zeros(n_pad_loc, jnp.int32).at[s_l].set(
            jnp.arange(n_pad_loc, dtype=jnp.int32)
            - first_occ.astype(jnp.int32))
        csafe = jnp.minimum(cid, n_cells - 1)
        rank = cell_start[csafe] + my_prefix[csafe] + occ
        rank = jnp.where(real, rank, cfg.n_pad)      # phantoms: beyond all

        # neighbor-only migration via fixed-capacity ppermute buffers
        ddev = rank // n_pad_loc
        stay = real & (ddev == dev)
        go_l = real & (ddev == dev - 1)
        go_r = real & (ddev == dev + 1)
        lost = real & ~(stay | go_l | go_r)
        ovf_mig = (lost.sum()
                   + jnp.maximum(go_l.sum() - mig_cap, 0)
                   + jnp.maximum(go_r.sum() - mig_cap, 0))
        ovf_mig = jax.lax.psum(ovf_mig, ax)

        fpack = jnp.stack([rows["x"], rows["y"], rows["z"],
                           rows["vx"], rows["vy"], rows["vz"]], 0)
        ipack = jnp.stack([oid, rank], 0)
        f_pad = jnp.concatenate(
            [fpack, jnp.zeros((6, 1), jnp.float32)], 1)
        i_pad = jnp.concatenate(
            [ipack, jnp.array([[-1], [0]], jnp.int32)], 1)

        def pack(mask):
            idx = jnp.nonzero(mask, size=mig_cap, fill_value=n_pad_loc)[0]
            return f_pad[:, idx], i_pad[:, idx]

        fl, il = pack(go_l)
        fr, ir = pack(go_r)
        rxl_f = jax.lax.ppermute(fr, ax, perm_fwd)   # from left neighbor
        rxl_i = jax.lax.ppermute(ir, ax, perm_fwd)
        rxr_f = jax.lax.ppermute(fl, ax, perm_bwd)   # from right neighbor
        rxr_i = jax.lax.ppermute(il, ax, perm_bwd)
        # chain-end devices receive ZEROS from ppermute and oid 0 is a
        # real id — mask by device position as well as slot validity
        vl = (dev > 0) & (rxl_i[0] >= 0)
        vr = (dev < ndev - 1) & (rxr_i[0] >= 0)

        sent = n_pad_loc                             # scatter sentinel
        t_stay = jnp.where(stay, rank - base0, sent)
        t_l = jnp.where(vl, rxl_i[1] - base0, sent)
        t_l = jnp.where((t_l >= 0) & (t_l <= sent), t_l, sent)
        t_r = jnp.where(vr, rxr_i[1] - base0, sent)
        t_r = jnp.where((t_r >= 0) & (t_r <= sent), t_r, sent)

        def scat(fill, own_v, lv, rv, dtype=jnp.float32):
            a = jnp.full((n_pad_loc + 1,), fill, dtype)
            a = a.at[t_stay].set(own_v)
            a = a.at[t_l].set(lv)
            a = a.at[t_r].set(rv)
            return a[:n_pad_loc]

        new = dict(
            x=scat(far, rows["x"], rxl_f[0], rxr_f[0]),
            y=scat(far, rows["y"], rxl_f[1], rxr_f[1]),
            z=scat(far, rows["z"], rxl_f[2], rxr_f[2]),
            vx=scat(0.0, rows["vx"], rxl_f[3], rxr_f[3]),
            vy=scat(0.0, rows["vy"], rxl_f[4], rxr_f[4]),
            vz=scat(0.0, rows["vz"], rxl_f[5], rxr_f[5]),
            oid=scat(-1, oid, rxl_i[0], rxr_i[0], jnp.int32),
        )

        # ---- window tables: pstart from the histogram (replicated
        # O(pencils)), block pencil ranges from local rows -------------
        pstart = cell_start[jnp.arange(npen + 1, dtype=jnp.int32) * ny]
        oidn = new["oid"]
        realn = oidn >= 0
        pen_n, _ = _pencil_cid_of(new["x"], new["y"], new["z"])
        base = base0 - halo_pad + P0
        rows_b = jnp.arange(nb_loc, dtype=jnp.int32) * cfg.block
        last_i = jnp.clip(rows_b + cfg.block - 1, 0,
                          jnp.maximum(n - 1 - base0, 0))
        first_p = pen_n[rows_b]
        last_p = pen_n[last_i]
        phantom_blk = (base0 + rows_b) >= n
        prev_hi = jnp.zeros(nb_loc, jnp.int32)
        los, his, plos, phis = [], [], [], []
        for dz in (-1, 0, 1):
            lo_p = jnp.clip(first_p + dz * nx - 1, 0, npen)
            hi_p = jnp.clip(last_p + dz * nx + 2, 0, npen)
            lo_p = jnp.maximum(lo_p, prev_hi)
            hi_p = jnp.maximum(hi_p, lo_p)
            prev_hi = hi_p
            off = pstart[lo_p]
            end = jnp.where(phantom_blk, off, pstart[hi_p])
            los.append(off)
            his.append(end)
            plos.append(lo_p)
            phis.append(hi_p)
        lo_l = jnp.stack(los, 1).reshape(-1) + P0
        hi_l = jnp.stack(his, 1).reshape(-1) + P0
        plo_l = jnp.stack(plos, 1)
        phi_l = jnp.stack(phis, 1)
        tables, lo_c, hi_c, cnt_new, ovf_loc = finish_window_tables(
            lo_l, hi_l, base)
        ovf_win = jax.lax.psum(ovf_loc, ax)
        ob = tables[5]

        # ---- static fields: O(n_loc) gathers from replicated original-
        # order tables, then one halo exchange builds the slabs ---------
        safe = jnp.maximum(oidn, 0)
        realnf = realn.astype(jnp.float32)
        isb_own = jnp.where(realn, statics["is_b"][safe], 1.0)
        liq_own = jnp.where(realn, statics["is_liq"][safe], 0.0)
        nxo = jnp.where(realn, statics["nrm_x"][safe], 0.0)
        nyo = jnp.where(realn, statics["nrm_y"][safe], 0.0)
        nzo = jnp.where(realn, statics["nrm_z"][safe], 0.0)
        isb_s, liq_s, nxs, nys, nzs = exchange(
            [isb_own, liq_own, nxo, nyo, nzo],
            [1.0, 0.0, 0.0, 0.0, 0.0],
        )
        bmask = isb_s[own_off:own_off + n_pad_loc] > 0
        not_b = (~bmask).astype(jnp.float32)
        own_nonb = (
            isb_s[own_off:own_off + n_pad_loc]
            .reshape(nb_loc, cfg.block).min(axis=1) == 0
        )
        force_tables = tables[:4] + (jnp.where(own_nonb, cnt_new, 0), ob)
        pen_safe = jnp.where(realn, pen_n, npen)

        def pencil_count(w):
            buf = jnp.zeros(npen + 1, jnp.float32).at[pen_safe].add(w)
            return jax.lax.psum(buf[:npen], ax)

        seg_b = pencil_count(isb_own * realnf)
        csum_b = jnp.concatenate(
            [jnp.zeros(1, seg_b.dtype), jnp.cumsum(seg_b)])
        win_has_b = (csum_b[phi_l] - csum_b[plo_l]).sum(axis=1) > 0
        bnd_tables = tables[:4] + (
            jnp.where(own_nonb & win_has_b, cnt_new, 0), ob)

        ctx = dict(
            isb_s=isb_s, liq_s=liq_s, nxs=nxs, nys=nys, nzs=nzs,
            bmask=bmask, not_b=not_b,
            tables=tables, force_tables=force_tables,
            bnd_tables=bnd_tables,
        )

        have_springs = springs.n_elastic > 0
        have_mem = membranes.n_tris > 0
        if have_springs or have_mem:
            e0, e1 = layout.elastic_range
            n_el = e1 - e0
            # sorted row of each elastic id: O(n_el) psum scatter (each
            # eid lives on exactly one device)
            eid_own = jnp.where(realn, statics["eid_of_orig"][safe], -1)
            rows_glob = base0 + jnp.arange(n_pad_loc, dtype=jnp.int32)
            tgt_e = jnp.where(eid_own >= 0, eid_own, n_el)
            ebuf = jnp.zeros(n_el + 1, jnp.int32).at[tgt_e].add(
                jnp.where(eid_own >= 0, rows_glob, 0))
            el_rows = jax.lax.psum(ebuf[:n_el], ax)
        if have_springs and layout.springs_elastic_only:
            # compact pass: partner rows from the eid -> sorted-row map
            ctx.update(build_spring_ctx(
                springs, el_rows,
                lambda sidx: el_rows[jnp.maximum(
                    statics["eid_of_orig"][jnp.maximum(sidx, 0)], 0)],
                base, lo_c, hi_c, eid_own, ob, n_el))
        elif have_springs:
            # gather fallback: eid maps live in the original-id domain
            # (resort-independent); boundary anchors use entry-time
            # original-order positions (boundary never moves); scatter
            # targets come from the per-resort eid -> sorted-row map
            def globalize_elastic_d(xo, yo, zo):
                tgt = jnp.where(eid_own >= 0, eid_own, n_el)
                buf = jnp.zeros((3, n_el + 1), jnp.float32)
                buf = buf.at[0, tgt].add(xo, mode="drop")
                buf = buf.at[1, tgt].add(yo, mode="drop")
                buf = buf.at[2, tgt].add(zo, mode="drop")
                return jax.lax.psum(buf[:, :n_el], ax)

            row_eid = statics["eid_of_orig"][springs.row_ids]
            sidx_safe = jnp.maximum(springs.idx, 0)
            own_rows_local = jnp.where(
                row_eid >= 0,
                el_rows[jnp.maximum(row_eid, 0)] - base0, -1)
            ctx.update(
                springs=springs,
                fb_row_eid=row_eid,
                fb_ep_eid=jnp.where(
                    springs.idx >= 0,
                    statics["eid_of_orig"][sidx_safe], -1),
                fb_static_x=statics["pos_x"][sidx_safe],
                fb_static_y=statics["pos_y"][sidx_safe],
                fb_static_z=statics["pos_z"][sidx_safe],
                fb_own_rows_local=own_rows_local,
                fb_globalize=globalize_elastic_d,
                n_el=n_el,
            )
        if have_mem:
            seg_m = pencil_count(
                jnp.where(realn, statics["has_mem"][safe], 0.0))
            own_liq = (
                liq_s[own_off:own_off + n_pad_loc]
                .reshape(nb_loc, cfg.block).max(axis=1) > 0
            )
            tri_eid = statics["eid_of_orig"][membranes.tris]
            tri_rows = el_rows[jnp.maximum(tri_eid, 0)]
            ctx.update(build_mem_ctx(
                membranes, el_rows, tri_rows, base, seg_m,
                plo_l, phi_l, own_liq, tables, cnt_new, ob))
        return new, ctx, ovf_win, ovf_mig

    def entry_sort_distributed(state_l):
        """Replicated entry sort — with the exit unsort, the ONLY O(N)
        gathers of a distributed run (once per jitted call, not per
        resort)."""
        def ag(a):
            return jax.lax.all_gather(a, ax, tiled=True)

        pos = vec3.split(state_l.pos)
        vel = vec3.split(state_l.vel)
        xg, yg, zg = ag(pos.x), ag(pos.y), ag(pos.z)
        vxg, vyg, vzg = ag(vel.x), ag(vel.y), ag(vel.z)
        _, cid = _pencil_cid_of(xg, yg, zg)
        order = jnp.argsort(cid, stable=True).astype(jnp.int32)
        dev = jax.lax.axis_index(ax)
        base0 = dev * n_pad_loc

        def loc(a_sorted, fill, dtype=jnp.float32):
            g = jnp.full((cfg.n_pad,), fill, dtype)
            g = g.at[:n].set(a_sorted)
            return jax.lax.dynamic_slice(g, (base0,), (n_pad_loc,))

        return dict(
            x=loc(xg[order], far), y=loc(yg[order], far),
            z=loc(zg[order], far),
            vx=loc(vxg[order], 0.0), vy=loc(vyg[order], 0.0),
            vz=loc(vzg[order], 0.0),
            oid=loc(order, -1, jnp.int32),
        )

    r_every = max(1, cfg.resort_every)
    full, rem = divmod(n_steps, r_every)

    def stepper(state, springs, membranes):
        ovf = jnp.zeros((), jnp.int32)
        drf = jnp.zeros((), jnp.float32)
        if full:
            def body(c, _):
                s, o, d = c
                s2, o2, d2 = sweep(s, springs, membranes, r_every)
                return (s2, jnp.maximum(o, o2), jnp.maximum(d, d2)), None

            (state, ovf, drf), _ = jax.lax.scan(
                body, (state, ovf, drf), None, length=full)
        if rem:
            state, o2, d2 = sweep(state, springs, membranes, rem)
            ovf = jnp.maximum(ovf, o2)
            drf = jnp.maximum(drf, d2)
        return state, {"halo_overflow": ovf, "window_drift": drf}

    def build_statics(state_l, membranes):
        """Replicated original-order static tables (gathered once per
        jitted call — or once per SESSION under make_halo_session)."""
        nrm = vec3.split(state_l.normal)
        pos0 = vec3.split(state_l.pos)
        ptype_g = jax.lax.all_gather(state_l.ptype, ax, tiled=True)
        statics = dict(
            is_b=(ptype_g == BOUNDARY_PARTICLE).astype(jnp.float32),
            is_liq=(ptype_g == LIQUID_PARTICLE).astype(jnp.float32),
            nrm_x=jax.lax.all_gather(nrm.x, ax, tiled=True),
            nrm_y=jax.lax.all_gather(nrm.y, ax, tiled=True),
            nrm_z=jax.lax.all_gather(nrm.z, ax, tiled=True),
            # entry-time original-order positions: static-anchor (boundary)
            # spring endpoints only — boundary never moves
            pos_x=jax.lax.all_gather(pos0.x, ax, tiled=True),
            pos_y=jax.lax.all_gather(pos0.y, ax, tiled=True),
            pos_z=jax.lax.all_gather(pos0.z, ax, tiled=True),
        )
        e0, e1 = layout.elastic_range
        n_el_s = e1 - e0
        statics["eid_of_orig"] = jnp.full(n, -1, jnp.int32).at[
            jnp.arange(e0, e1)].set(jnp.arange(n_el_s, dtype=jnp.int32))
        hm = jnp.zeros(n, jnp.float32)
        if membranes.n_tris > 0:
            hm = hm.at[jnp.arange(e0, e1)].set(
                (membranes.particle_tris[e0:e1] >= 0).any(
                    axis=1).astype(jnp.float32))
        statics["has_mem"] = hm
        return statics

    def sweep_d(rows, act, step_no, springs, membranes, statics,
                r_steps):
        rows2, ctx, o_win, o_mig = resort_distributed(
            rows, springs, membranes, statics)
        carry0 = (rows2["x"], rows2["y"], rows2["z"],
                  rows2["vx"], rows2["vy"], rows2["vz"],
                  act, step_no, jnp.zeros((), jnp.float32))
        carry, _ = jax.lax.scan(
            lambda c, x: (inner_body(ctx, c), None), carry0, None,
            length=r_steps,
        )
        xn, yn, zn, vxn, vyn, vzn, act2, s2, drift = carry
        drift = jax.lax.pmax(drift, ax)
        rows3 = dict(x=xn, y=yn, z=zn, vx=vxn, vy=vyn, vz=vzn,
                     oid=rows2["oid"])
        return rows3, act2, s2, o_win, o_mig, drift

    def exit_unsort(rows, act, step_no, state_l):
        """Materialize original order from sorted rows (the O(N) exit
        boundary — once per jitted call, or once per session)."""
        def agp(a):
            return jax.lax.all_gather(a, ax, tiled=True)

        og = agp(rows["oid"])
        tgt = jnp.where(og >= 0, og, n)
        dev = jax.lax.axis_index(ax)

        def unsort(a):
            buf = jnp.zeros(n + 1, jnp.float32).at[tgt].set(agp(a))
            return jax.lax.dynamic_slice(
                buf[:n], (dev * n_loc,), (n_loc,))

        pos_new = jnp.stack(
            [unsort(rows["x"]), unsort(rows["y"]), unsort(rows["z"])], 1)
        vel_new = jnp.stack(
            [unsort(rows["vx"]), unsort(rows["vy"]),
             unsort(rows["vz"])], 1)
        return FluidState(
            pos=pos_new, vel=vel_new, ptype=state_l.ptype,
            normal=state_l.normal, muscle_activation=act, step=step_no,
        )

    def stepper_distributed(state_l, springs, membranes):
        """As ``stepper`` but with the O(cells) distributed resort between
        sweeps: the replicated entry sort / exit unsort are the only O(N)
        collectives, paid once per jitted call. diag additionally carries
        ``resort_overflow`` (migration misses — dropped particles)."""
        statics = build_statics(state_l, membranes)
        rows = entry_sort_distributed(state_l)
        act = state_l.muscle_activation
        step_no = state_l.step

        ovf = jnp.zeros((), jnp.int32)
        mig = jnp.zeros((), jnp.int32)
        drf = jnp.zeros((), jnp.float32)
        if full:
            def body(c, _):
                rows, act, s, o, m, d = c
                rows2, act2, s2, o2, m2, d2 = sweep_d(
                    rows, act, s, springs, membranes, statics, r_every)
                return (rows2, act2, s2, jnp.maximum(o, o2),
                        jnp.maximum(m, m2), jnp.maximum(d, d2)), None

            (rows, act, step_no, ovf, mig, drf), _ = jax.lax.scan(
                body, (rows, act, step_no, ovf, mig, drf), None,
                length=full)
        if rem:
            rows, act, step_no, o2, m2, d2 = sweep_d(
                rows, act, step_no, springs, membranes, statics, rem)
            ovf = jnp.maximum(ovf, o2)
            mig = jnp.maximum(mig, m2)
            drf = jnp.maximum(drf, d2)

        new_state = exit_unsort(rows, act, step_no, state_l)
        return new_state, {"halo_overflow": ovf, "window_drift": drf,
                           "resort_overflow": mig}

    state_specs = FluidState(
        pos=P(ax), vel=P(ax), ptype=P(ax), normal=P(ax),
        muscle_activation=P(), step=P(),
    )
    springs_specs = Springs(row_ids=P(), idx=P(), rest=P(), muscle=P())
    membranes_specs = Membranes(tris=P(), particle_tris=P())

    if _session:
        # (make_halo_session): three small jitted functions; the session
        # pytree keeps state in SORTED space across calls, so the O(N)
        # entry/exit gathers happen once per session, not per chunk
        assert distributed_resort

        def begin_local(state_l, membranes):
            return dict(
                rows=entry_sort_distributed(state_l),
                statics=build_statics(state_l, membranes),
                act=state_l.muscle_activation, step=state_l.step,
            )

        def step_local(sess, springs, membranes):
            rows, act, s2, o_win, o_mig, drift = sweep_d(
                sess["rows"], sess["act"], sess["step"], springs,
                membranes, sess["statics"], r_every)
            out = dict(rows=rows, statics=sess["statics"], act=act,
                       step=s2)
            return out, {"halo_overflow": o_win, "window_drift": drift,
                         "resort_overflow": o_mig}

        def finish_local(sess, state_l):
            return exit_unsort(sess["rows"], sess["act"], sess["step"],
                               state_l)

        rows_specs = {k: P(ax) for k in
                      ("x", "y", "z", "vx", "vy", "vz", "oid")}
        statics_specs = {k: P() for k in
                         ("is_b", "is_liq", "nrm_x", "nrm_y", "nrm_z",
                          "pos_x", "pos_y", "pos_z", "eid_of_orig",
                          "has_mem")}
        sess_specs = dict(rows=rows_specs, statics=statics_specs,
                          act=P(), step=P())
        diag3 = {"halo_overflow": P(), "window_drift": P(),
                 "resort_overflow": P()}
        begin = jax.jit(jax.shard_map(
            begin_local, mesh=mesh,
            in_specs=(state_specs, membranes_specs),
            out_specs=sess_specs, check_vma=False))
        step = jax.jit(jax.shard_map(
            step_local, mesh=mesh,
            in_specs=(sess_specs, springs_specs, membranes_specs),
            out_specs=(sess_specs, diag3), check_vma=False))
        finish = jax.jit(jax.shard_map(
            finish_local, mesh=mesh,
            in_specs=(sess_specs, state_specs),
            out_specs=state_specs, check_vma=False))
        return begin, step, finish

    diag_specs = {"halo_overflow": P(), "window_drift": P()}
    if distributed_resort:
        diag_specs["resort_overflow"] = P()
    sharded = jax.shard_map(
        stepper_distributed if distributed_resort else stepper,
        mesh=mesh,
        in_specs=(state_specs, springs_specs, membranes_specs),
        out_specs=(state_specs, diag_specs),
        check_vma=False,
    )
    return jax.jit(sharded)


def make_halo_session(
    mesh: Mesh,
    params: SimParams,
    layout: SceneLayout,
    cfg: F.FastConfig,
    halo_pad: int | None = None,
):
    """Stateful sorted-space stepping over the distributed resort:

        begin(state, membranes) -> session       # one O(N) entry sort
        step(session, springs, membranes) -> (session, diag)
        finish(session, state) -> state          # one O(N) exit unsort

    Each ``step`` call advances ``cfg.resort_every`` steps (one
    distributed resort + one sorted-space scan) with NO O(N) collective
    — the session pytree keeps particle state sharded in sorted space
    between calls, so chunked stepping (the Simulator's pattern) pays
    the entry/exit gathers once per session instead of once per chunk.
    diag carries halo_overflow / window_drift / resort_overflow for the
    span of that call."""
    return make_halo_fast_multi_step(
        mesh, params, layout, cfg, n_steps=cfg.resort_every,
        halo_pad=halo_pad, distributed_resort=True, _session=True,
    )
