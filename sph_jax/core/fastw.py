"""The wall-compact fast engine: the static-wall lever.

44% of the worm scene (101,332 of 231,811 particles) is frozen boundary
wall (`/root/reference/src/owHelper.cpp:775-928` generates them once,
`sphFluid.cl:616-622` freezes them), yet the fast engine streams every
wall as a live candidate column of its pair passes and carries them
through the hot scan. This engine removes walls from the hot loop
STRUCTURALLY while preserving the exact pair semantics of core/fast.py:

* the sorted step carry holds only MOVING rows (liquid + elastic) —
  ~130k instead of ~232k on the worm; walls are re-sorted once per
  resort into a static pack that never enters the scan carry;
* a thin SHELL of walls (those whose grid cell lies within a
  ``dilate``-cell dilation of any moving-occupied cell — a superset of
  every wall reachable within h during the resort period, see
  ``_shell_of``) stays live: its rho/rho*/p are recomputed each step
  from a shell-rows x moving-columns pass plus a per-resort static
  wall-wall constant (walls never move, so their mutual t^3 density
  sums are invariant within — and across — resort periods);
* moving rows take their wall contributions (density, viscosity-with-
  normal-as-velocity per sphFluid.cl:860, surface tension, pressure
  force, Ihmsen boundary response) from compact shell-column passes;
  deep walls vanish from the step entirely (their rho is never read:
  every wall neighbor of a moving particle is in the shell by
  construction).

Pair-set equivalence to core/fast.py (hence to the reference's
all-pairs-within-h semantics, see fast.py's documented deviation): every
pair with both ends moving is covered by the moving-window pass; every
moving-wall pair within reach is covered by the shell passes (a wall
within h of a moving particle at any step of the period is inside the
dilated occupancy at the resort that opened it, for per-period drift
< (dilate-1) cells — the adaptive-resort drift ladder guards the bound);
wall-wall pairs only feed wall densities, static by construction. The
only numerical difference from fast.py is f32 summation order (moving
and wall contributions reduce in separate passes).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp

from ..config import SimParams
from ..constants import BOUNDARY_PARTICLE, LIQUID_PARTICLE, MUSCLE_COUNT
from ..models import muscle
from ..ops import pair_kernels as pk
from ..ops import vec3
from .state import FluidState, Membranes, Springs
from .step import SceneLayout
from . import fast as F

ALIGN = pk.ALIGN


@dataclasses.dataclass(frozen=True)
class FastWConfig:
    """Static shapes of the wall-compact engine (hashable; jit-static)."""

    n_mov: int          # count of moving (liquid+elastic) particles
    n_wall: int         # count of boundary particles
    mov_lo: int         # moving ids are [0, mov_lo) + [wall_hi, n)
    wall_lo: int        # boundary ids are [wall_lo, wall_hi)
    wall_hi: int
    n_blocks: int       # moving-row blocks
    n_blocks_s: int     # shell-row blocks (shell_cap = n_blocks_s * block)
    block: int
    ccol: int           # moving-column tile width
    dims: tuple[int, int, int]
    interpret: bool = False
    resort_every: int = F.RESORT_EVERY
    ccol_c: int | None = None   # compact (shell/elastic) tile width
    dilate: int = 2     # shell = walls within this cell dilation of moving

    @property
    def ccol_compact(self) -> int:
        return self.ccol_c or self.ccol

    @property
    def n_pad(self) -> int:
        return self.n_blocks * self.block

    @property
    def n_alloc(self) -> int:
        return self.n_pad + self.ccol

    @property
    def shell_cap(self) -> int:
        return self.n_blocks_s * self.block

    @property
    def shell_alloc(self) -> int:
        return self.shell_cap + self.ccol_compact

    @property
    def n_pencils(self) -> int:
        return self.dims[0] * self.dims[2]

    def mov_cfg(self) -> F.FastConfig:
        """FastConfig view of the moving-row space (so core.fast's
        `_window_tables` machinery is reused verbatim)."""
        return F.FastConfig(
            n_particles=self.n_mov, n_blocks=self.n_blocks,
            block=self.block, ccol=self.ccol, dims=self.dims,
            interpret=self.interpret, resort_every=self.resort_every,
            ccol_c=self.ccol_c,
        )


def _mov_wall_split(layout: SceneLayout):
    """(mov_lo, wall_lo, wall_hi): moving ids are [0, wall_lo) +
    [wall_hi, n) — boundary is contiguous in both scene orders
    (generator: elastic/liquid/boundary; loader: boundary/elastic/
    liquid, see SceneLayout docstring)."""
    b0, b1 = layout.boundary_range
    return b0, b0, b1


def measure_shell_cap(pos, ptype, params: SimParams, dims,
                      dilate: int = 2) -> int:
    """Scene-measured shell POPULATION (walls within the dilated moving
    occupancy) at the given positions. NumPy; mirrors the in-jit
    `_shell_of` exactly. `compute_fastw_config` applies the growth
    margin and block rounding on top."""
    nx, ny, nz = dims
    pos = np.asarray(pos)
    is_w = np.asarray(ptype) == BOUNDARY_PARTICLE
    cell = 1.0 / params.h
    lo = np.asarray(params.box_min)
    c = np.clip(((pos - lo) * cell).astype(np.int64), 0,
                np.array([nx, ny, nz]) - 1)
    occ = np.zeros((nz, nx, ny), bool)
    cm = c[~is_w]
    occ[cm[:, 2], cm[:, 0], cm[:, 1]] = True
    d = dilate
    dil = np.zeros_like(occ)
    for dz in range(-d, d + 1):
        for dx in range(-d, d + 1):
            for dy in range(-d, d + 1):
                src = occ[
                    max(0, -dz):nz - max(0, dz),
                    max(0, -dx):nx - max(0, dx),
                    max(0, -dy):ny - max(0, dy),
                ]
                dil[
                    max(0, dz):nz - max(0, -dz),
                    max(0, dx):nx - max(0, -dx),
                    max(0, dy):ny - max(0, -dy),
                ] |= src
    cw = c[is_w]
    return int(dil[cw[:, 2], cw[:, 0], cw[:, 1]].sum())


def compute_fastw_config(
    pos,
    params: SimParams,
    layout: SceneLayout,
    block: int = F.BLOCK,
    ccol: int = F.CCOL,
    ccol_c: int | None = None,
    interpret: bool | None = None,
    resort_every: int = F.RESORT_EVERY,
    dilate: int = 2,
    shell_margin: float = 1.3,
    ptype=None,
) -> FastWConfig:
    """Static shapes: moving-row blocks from the layout's class ranges,
    shell capacity measured from the initial positions (overflow at run
    time is surfaced as a loud diagnostic, not silent truncation)."""
    cell = params.h
    nx = int((params.x_max - params.x_min) / cell) + 1
    ny = int((params.y_max - params.y_min) / cell) + 1
    nz = int((params.z_max - params.z_min) / cell) + 1
    mov_lo, wall_lo, wall_hi = _mov_wall_split(layout)
    n = layout.n_particles
    n_mov = n - (wall_hi - wall_lo)
    nb = -(-n_mov // block)
    if interpret is None:
        interpret = pk.default_interpret()
    if ptype is None:
        # synthesize the class vector from the layout ranges
        pt = np.zeros(n, np.int32)
        pt[wall_lo:wall_hi] = BOUNDARY_PARTICLE
    else:
        pt = np.asarray(ptype)
    n_sh = measure_shell_cap(pos, pt, params, (nx, ny, nz), dilate=dilate)
    cap = max(block, -(-int(shell_margin * max(n_sh, 1)) // block) * block)
    cap = min(cap, -(-max(wall_hi - wall_lo, 1) // block) * block)
    return FastWConfig(
        n_mov=n_mov, n_wall=wall_hi - wall_lo, mov_lo=mov_lo,
        wall_lo=wall_lo, wall_hi=wall_hi,
        n_blocks=nb, n_blocks_s=cap // block, block=block, ccol=ccol,
        dims=(nx, ny, nz), interpret=interpret,
        resort_every=resort_every, ccol_c=ccol_c, dilate=dilate,
    )


def precompute_wall_static(pos, normal, params: SimParams,
                           layout: SceneLayout, cfg: FastWConfig):
    """Host-side wall constants: walls never move
    (`owHelper.cpp:775-928` generates them once, `sphFluid.cl:616-622`
    freezes them), so their cell sort AND their mutual t^3 density sums
    are simulation invariants — hoisted out of every resort. Replaces,
    inside ``sort_ctx``: the 101k-row wall argsort + 6 gathers, the
    wall-prefix searchsorted, the shell-rows x wall-cols ``raw_sw`` pair
    pass, and its window tables. The mutual sums are computed in f64
    (cKDTree within-h pairs) and cast once — strictly tighter than the
    f32 on-chip reduction they replace.

    Returns None when the scene has no walls."""
    wall_lo, wall_hi = cfg.wall_lo, cfg.wall_hi
    if wall_hi <= wall_lo:
        return None
    nx, ny, nz = cfg.dims
    pw = np.asarray(pos, np.float32)[wall_lo:wall_hi]
    nw = np.asarray(normal, np.float32)[wall_lo:wall_hi]
    # mirror _cells in f32 so cell assignment matches the in-jit path
    cell = np.float32(1.0 / params.h)
    lo = np.asarray(params.box_min, np.float32)
    c = np.clip(((pw - lo) * cell).astype(np.int32), 0,
                np.array([nx, ny, nz], np.int32) - 1)
    pencil = c[:, 0] + nx * c[:, 2]
    cid = c[:, 1] + ny * pencil
    order = np.argsort(cid, kind="stable")
    ps, nss = pw[order], nw[order]

    from scipy.spatial import cKDTree

    h2 = np.float64(params.h) ** 2
    tree = cKDTree(ps.astype(np.float64))
    pairs = tree.query_pairs(r=float(params.h), output_type="ndarray")
    ww = np.zeros(len(ps), np.float64)
    if len(pairs):
        d2 = np.sum(
            (ps[pairs[:, 0]].astype(np.float64)
             - ps[pairs[:, 1]].astype(np.float64)) ** 2, axis=1)
        t3 = np.maximum(h2 - d2, 0.0) ** 3
        np.add.at(ww, pairs[:, 0], t3)
        np.add.at(ww, pairs[:, 1], t3)
    return dict(
        x=jnp.asarray(ps[:, 0]), y=jnp.asarray(ps[:, 1]),
        z=jnp.asarray(ps[:, 2]),
        nx=jnp.asarray(nss[:, 0]), ny=jnp.asarray(nss[:, 1]),
        nz=jnp.asarray(nss[:, 2]),
        pencil=jnp.asarray(pencil[order].astype(np.int32)),
        cid=jnp.asarray(cid[order].astype(np.int32)),
        ww=jnp.asarray(ww.astype(np.float32)),
    )


def _cross_tables(first, last, pstart, nx, npen, nb, ccol):
    """6-tuple window tables for own blocks with pencil ranges
    [first, last] into a FOREIGN compact column space described by its
    per-pencil prefix offsets ``pstart`` (len npen+1, nondecreasing).
    Same dz-band dedup (window space) + tile dedup (prev_tend) as
    core.fast._window_tables — tiles stay disjoint + covering, so the
    maskless-kernel invariant holds: any covered column outside the
    pencil-band window is >= h from every own row at sort time."""
    alns, los, his, nsubs = [], [], [], []
    prev_hi = jnp.zeros(nb, jnp.int32)
    prev_tend = jnp.zeros(nb, jnp.int32)
    for dz in (-1, 0, 1):
        lo_p = jnp.clip(first + dz * nx - 1, 0, npen)
        hi_p = jnp.clip(last + dz * nx + 2, 0, npen)
        lo_p = jnp.maximum(lo_p, prev_hi)
        hi_p = jnp.maximum(hi_p, lo_p)
        prev_hi = hi_p
        off = pstart[lo_p]
        end = pstart[hi_p]
        aligned = jnp.maximum((off // ALIGN) * ALIGN, prev_tend)
        nsub = jnp.where(end > aligned, -((aligned - end) // ccol), 0)
        prev_tend = aligned + nsub * ccol
        alns.append(aligned)
        los.append(off)
        his.append(end)
        nsubs.append(nsub.astype(jnp.int32))
    nsub = jnp.stack(nsubs, 1)
    s0 = jnp.cumsum(nsub, axis=1) - nsub
    return (
        jnp.stack(alns, 1).reshape(-1), jnp.stack(los, 1).reshape(-1),
        jnp.stack(his, 1).reshape(-1), s0.reshape(-1), nsub.sum(axis=1),
        jnp.zeros(1, jnp.int32),
    )


def _gate(tables, active):
    aln, lo, hi, s0, cnt, ob = tables
    return (aln, lo, hi, s0, jnp.where(active, cnt, 0), ob)


def _shell_of(cid_m, cid_w_s, cfg: FastWConfig):
    """Shell membership flag per SORTED wall: its cell lies within the
    ``dilate``-cell box dilation of the moving-occupied cells. Any wall
    within h(1 + drift) of a moving particle during the period (drift in
    cells < dilate - 1) is captured: per-axis cell distance is at most
    ceil((h + drift)/h) <= dilate."""
    nx, ny, nz = cfg.dims
    occ = jnp.zeros(nx * ny * nz, jnp.float32).at[cid_m].set(
        1.0, mode="drop"
    ).reshape(nz, nx, ny)
    d = cfg.dilate
    dil = jax.lax.reduce_window(
        occ, -jnp.inf, jax.lax.max,
        window_dimensions=(2 * d + 1, 2 * d + 1, 2 * d + 1),
        window_strides=(1, 1, 1), padding="SAME",
    ).reshape(-1)
    return dil[cid_w_s] > 0.0


def _pad_to(a, width, fill=0.0):
    return jnp.concatenate(
        [a, jnp.full((width - a.shape[0],), fill, a.dtype)]
    )


def _make_step_parts_w(params: SimParams, layout: SceneLayout,
                       cfg: FastWConfig, wall_static=None):
    """Build (sort_ctx, carry_of, inner_step, unsort_state) — the
    wall-compact analog of core.fast._make_step_parts. Same stage order
    and physics (sphFluid.cl stage sequence via core/step.py); moving
    rows only in the carry, shell walls recomputed per step, deep walls
    absent.

    ``wall_static``: optional ``precompute_wall_static`` result. When
    given, the per-resort wall argsort/gathers/searchsorted and the
    shell x wall ``raw_sw`` density pass are replaced by constant-table
    lookups (walls never move). When None the original in-jit path runs
    (kept for callers without host positions; the two paths differ only
    by f32 summation order of the wall-wall sums)."""
    if layout.n_elastic > 0:
        assert layout.springs_elastic_only, (
            "fastw requires elastic-only spring anchors (wall rows are "
            "not addressable in the moving-compact sorted space); use "
            "the fast engine for wall-anchored scenes"
        )
    inv_h2 = np.float32(1.0 / (params.h * params.h))
    inv_h = np.float32(1.0 / params.h)
    c_rho = np.float32(params.c_rho)
    r0 = np.float32(params.r0)
    h2 = np.float32(params.h * params.h)
    self3 = np.float32(h2 * h2) * h2
    inv_h6 = inv_h2 * inv_h2 * inv_h2

    nb_m, nb_s, B = cfg.n_blocks, cfg.n_blocks_s, cfg.block
    ccol, ccol_c = cfg.ccol, cfg.ccol_compact
    kw = dict(block=B, inv_h2=inv_h2, interpret=cfg.interpret)
    raw_mm = pk.make_density_pass(
        ccol=ccol, n_blocks=nb_m, c_rho=c_rho, raw=True, **kw)
    raw_ms = pk.make_density_pass(
        ccol=ccol_c, n_blocks=nb_m, c_rho=c_rho, raw=True, **kw)
    raw_sm = pk.make_density_pass(
        ccol=ccol, n_blocks=nb_s, c_rho=c_rho, raw=True, **kw)
    raw_sw = pk.make_density_pass(
        ccol=ccol_c, n_blocks=nb_s, c_rho=c_rho, raw=True, **kw)
    visc_mm = pk.make_viscsurf_pass(ccol=ccol, n_blocks=nb_m, **kw)
    visc_ms = pk.make_viscsurf_pass(ccol=ccol_c, n_blocks=nb_m, **kw)
    pacc_kw = dict(inv_h=inv_h,
                   rho0_delta=np.float32(params.rho0 * params.delta))
    pacc_mm = pk.make_paccel_pass(ccol=ccol, n_blocks=nb_m, **pacc_kw, **kw)
    pacc_ms = pk.make_paccel_pass(ccol=ccol_c, n_blocks=nb_m, **pacc_kw,
                                  **kw)
    bnd_ms = pk.make_boundary_pass(r0=r0, ccol=ccol_c, n_blocks=nb_m, **kw)
    mem_ms = pk.make_membrane_pass(r0=r0, ccol=ccol_c, n_blocks=nb_m, **kw)
    n_slots = layout.spring_slots
    spring_ms = pk.make_spring_pass(
        inv_h=inv_h,
        h_scale=np.float32(params.h * params.simulation_scale),
        k_spring=np.float32(params.k_spring), n_slots=n_slots,
        ccol=ccol_c, n_blocks=nb_m, **kw,
    )

    n = layout.n_particles
    n_mov, n_wall = cfg.n_mov, cfg.n_wall
    nx, ny, nz = cfg.dims
    npen = cfg.n_pencils
    far = np.float32(
        max(params.x_max, params.y_max, params.z_max) + 100.0 * params.h
    )
    # moving/wall original-id split (static)
    wall_lo, wall_hi = cfg.wall_lo, cfg.wall_hi
    mov_ids = jnp.asarray(np.concatenate(
        [np.arange(0, wall_lo), np.arange(wall_hi, n)]
    ).astype(np.int32))
    wall_ids = jnp.asarray(np.arange(wall_lo, wall_hi, dtype=np.int32))

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
    # pad rows of the moving space are pinned (they carry `far`):
    pad_mask = jnp.arange(cfg.n_pad) >= n_mov

    wall_alloc = -(-max(n_wall, 1) // ALIGN) * ALIGN + ccol_c

    def _cells(px, py, pz):
        cell = jnp.float32(1.0 / params.h)
        bx, by, bz = (jnp.float32(b) for b in params.box_min)
        cx = jnp.clip(((px - bx) * cell).astype(jnp.int32), 0, nx - 1)
        cy = jnp.clip(((py - by) * cell).astype(jnp.int32), 0, ny - 1)
        cz = jnp.clip(((pz - bz) * cell).astype(jnp.int32), 0, nz - 1)
        pencil = cx + nx * cz
        return pencil, cy + ny * pencil

    def sort_ctx(state: FluidState, springs: Springs, membranes: Membranes):
        pos = vec3.split(state.pos)
        nrm = vec3.split(state.normal)
        is_liq = state.ptype == LIQUID_PARTICLE

        # ---- moving sort ----
        pm = jax.tree.map(lambda a: a[mov_ids], pos)
        pencil_m, cid_m = _cells(pm.x, pm.y, pm.z)
        order = jnp.argsort(cid_m, stable=True).astype(jnp.int32)
        orig_of_sorted = mov_ids[order]            # [n_mov] original ids
        # original id -> moving sorted row (walls stay -1)
        inv_m = jnp.full(n, -1, jnp.int32).at[orig_of_sorted].set(
            jnp.arange(n_mov, dtype=jnp.int32)
        )
        pencil_ms = pencil_m[order]
        mcfg = cfg.mov_cfg()
        tables_m, pstart_m, pranges = F._window_tables(pencil_ms, mcfg)
        plo_r, phi_r = pranges
        bidx = jnp.arange(nb_m, dtype=jnp.int32)
        first_m = pencil_ms[jnp.minimum(bidx * B, n_mov - 1)]
        last_m = pencil_ms[jnp.minimum(bidx * B + B - 1, n_mov - 1)]

        ctx = dict(order=order, orig_of_sorted=orig_of_sorted)
        diag = dict(shell_overflow=jnp.zeros((), jnp.int32))

        def srt(a, fill=0.0):
            return _pad_to(a[mov_ids][order], cfg.n_alloc, fill)

        ctx["liq_s"] = srt(is_liq.astype(jnp.float32))
        ctx["tables_m"] = tables_m

        # ---- wall sort + shell selection ----
        if n_wall > 0:
            if wall_static is not None:
                ws = wall_static
                wx, wy, wz = ws["x"], ws["y"], ws["z"]
                wnx, wny, wnz = ws["nx"], ws["ny"], ws["nz"]
                pencil_ws = ws["pencil"]
                cid_ws = ws["cid"]
            else:
                pw = jax.tree.map(lambda a: a[wall_ids], pos)
                nw = jax.tree.map(lambda a: a[wall_ids], nrm)
                pencil_w, cid_w = _cells(pw.x, pw.y, pw.z)
                order_w = jnp.argsort(cid_w, stable=True).astype(jnp.int32)
                wx, wy, wz = pw.x[order_w], pw.y[order_w], pw.z[order_w]
                wnx, wny, wnz = nw.x[order_w], nw.y[order_w], nw.z[order_w]
                pencil_ws = pencil_w[order_w]
                cid_ws = cid_w[order_w]

            shell_flag = _shell_of(cid_m, cid_ws, cfg)
            n_sh = shell_flag.sum().astype(jnp.int32)
            diag["shell_overflow"] = jnp.maximum(0, n_sh - cfg.shell_cap)
            sh_rows = jnp.nonzero(
                shell_flag, size=cfg.shell_cap, fill_value=n_wall
            )[0]
            real = jnp.arange(cfg.shell_cap) < n_sh
            safe = jnp.minimum(sh_rows, n_wall - 1)

            def sgat(a, fill):
                return _pad_to(
                    jnp.where(real, a[safe], fill), cfg.shell_alloc, fill
                )

            sx, sy, sz = sgat(wx, far), sgat(wy, far), sgat(wz, far)
            snx, sny, snz = sgat(wnx, 0.0), sgat(wny, 0.0), sgat(wnz, 0.0)
            s_isb = _pad_to(real.astype(jnp.float32), cfg.shell_alloc, 0.0)
            ctx["shell_static"] = (sx, sy, sz, snx, sny, snz, s_isb)
            ctx["shell_pos_pack"] = F._pack([sx, sy, sz])
            ctx["bnd_pack"] = F._pack([sx, sy, sz, snx, sny, snz, s_isb])

            # shell pencils: window form (pads clamp to the last real
            # pencil so partial blocks don't window to the array tail),
            # key form (pads = npen so pstart_sh sees real rows only)
            pen_sh_raw = pencil_ws[safe]
            pen_last = pen_sh_raw[jnp.maximum(n_sh - 1, 0)]
            pen_sh_win = jnp.where(real, pen_sh_raw, pen_last)
            pen_sh_key = jnp.where(real, pen_sh_raw, npen)
            pstart_sh = jnp.searchsorted(
                pen_sh_key, jnp.arange(npen + 1, dtype=pen_sh_key.dtype),
                side="left",
            ).astype(jnp.int32)

            # mov rows -> shell cols (density/visc/paccel/boundary)
            t_ms = _cross_tables(first_m, last_m, pstart_sh, nx, npen,
                                 nb_m, ccol_c)
            ctx["tables_ms"] = _gate(t_ms, bidx * B < n_mov)
            # shell rows -> mov cols (shell rho/rho*)
            sbidx = jnp.arange(nb_s, dtype=jnp.int32)
            first_s = pen_sh_win[jnp.minimum(sbidx * B, cfg.shell_cap - 1)]
            last_s = pen_sh_win[
                jnp.minimum(sbidx * B + B - 1, cfg.shell_cap - 1)
            ]
            t_sm = _cross_tables(first_s, last_s, pstart_m, nx, npen,
                                 nb_s, ccol)
            ctx["tables_sm"] = _gate(t_sm, sbidx * B < n_sh)
            if wall_static is not None:
                # walls never move: their mutual density sums are
                # precomputed once on the host (f64) — gather the shell's
                # rows instead of running the raw_sw pass every resort
                ctx["ww_const"] = jnp.where(
                    real, wall_static["ww"][safe], 0.0)
            else:
                # shell rows -> wall cols (per-resort static wall-wall
                # sums)
                pstart_w = jnp.searchsorted(
                    pencil_ws,
                    jnp.arange(npen + 1, dtype=pencil_ws.dtype),
                    side="left",
                ).astype(jnp.int32)
                t_sw = _cross_tables(first_s, last_s, pstart_w, nx, npen,
                                     nb_s, ccol_c)
                t_sw = _gate(t_sw, sbidx * B < n_sh)
                wall_pack = F._pack([
                    _pad_to(wx, wall_alloc, far),
                    _pad_to(wy, wall_alloc, far),
                    _pad_to(wz, wall_alloc, far),
                ])
                shell_own = ctx["shell_pos_pack"]
                # include the wall's own self term, subtracted here once
                ctx["ww_const"] = raw_sw(t_sw, shell_own, wall_pack) \
                    - self3

        # ---- compact elastic slab (springs + membranes) ----
        have_springs = springs.n_elastic > 0
        have_mem = membranes.n_tris > 0
        if have_springs or have_mem:
            e0, e1 = layout.elastic_range
            n_el = e1 - e0
            el_rows = inv_m[jnp.arange(e0, e1)]
            perm = jnp.argsort(el_rows)
            els = el_rows[perm]
            ctx["els"] = els
            aln_t, lo_t, hi_t, s0_t, cnt_t, ob_t = tables_m
            lo_c = jnp.searchsorted(els, lo_t).astype(jnp.int32)
            hi_c = jnp.searchsorted(els, hi_t).astype(jnp.int32)
            aln_c, s0_c, cnt_c = F._tile_chunks(lo_c, hi_c, nb_m, ccol_c)

        if have_springs:
            mcap = -(-n_el // ALIGN) * ALIGN + ccol_c
            rmap = jnp.full(n, -1, jnp.int32).at[springs.row_ids].set(
                jnp.arange(springs.n_elastic, dtype=jnp.int32)
            )
            r_of_col = rmap[jnp.arange(e0, e1)[perm]]
            r_safe = jnp.maximum(r_of_col, 0)
            sidx = jnp.where(
                (r_of_col >= 0)[:, None],
                springs.idx[r_safe, :n_slots], -1
            )
            own_rows = jnp.where(sidx >= 0, inv_m[jnp.maximum(sidx, 0)], -1)
            idx_f = own_rows.astype(jnp.float32)
            rest_c = jnp.where(
                sidx >= 0, springs.rest[r_safe, :n_slots], 0.0
            )
            idx_p = jnp.full((n_slots, mcap), -1.0, jnp.float32).at[
                :, :n_el].set(idx_f.T)
            rest_p = jnp.zeros((n_slots, mcap), jnp.float32).at[
                :, :n_el].set(rest_c.T)
            ctx["spr_static"] = jnp.concatenate([idx_p, rest_p], axis=0)
            mid = jnp.where(
                sidx >= 0, springs.muscle[r_safe, :n_slots], 0
            )
            n_act = int(MUSCLE_COUNT)
            ctx["spr_onehot"] = (
                mid.reshape(-1)[:, None]
                == jnp.arange(1, n_act + 1, dtype=mid.dtype)
            ).astype(jnp.float32)
            own_el = (
                jnp.zeros(cfg.n_pad, jnp.float32).at[els].set(1.0)
                .reshape(nb_m, B).max(axis=1) > 0
            )
            aln_s, s0_s, cnt_s = F._spring_chunks(
                aln_c, s0_c, cnt_c, own_rows, nb_m, B, ccol_c)
            ctx["spr_tables"] = (
                aln_s, lo_c, hi_c, s0_s, jnp.where(own_el, cnt_s, 0), ob_t,
            )

        if have_mem:
            pt = membranes.particle_tris[e0:e1]
            ctx["mem_vidx"] = inv_m[membranes.tris]
            ctx["mem_pt_ok"] = pt[perm] >= 0
            ctx["mem_pt_safe"] = jnp.maximum(pt[perm], 0)
            has_mem_m = jnp.zeros(n_mov, jnp.float32).at[
                el_rows
            ].set((pt >= 0).any(axis=1).astype(jnp.float32))
            seg = jax.ops.segment_sum(
                has_mem_m, pencil_ms, num_segments=npen
            )
            csum = jnp.concatenate(
                [jnp.zeros(1, seg.dtype), jnp.cumsum(seg)]
            )
            chunk_mem = (csum[phi_r] - csum[plo_r]).sum(axis=1) > 0
            own_liq = (
                ctx["liq_s"][: cfg.n_pad].reshape(nb_m, B).max(axis=1) > 0
            )
            ctx["mem_tables"] = (
                aln_c, lo_c, hi_c, s0_c,
                jnp.where(chunk_mem & own_liq, cnt_c, 0), ob_t,
            )
        return ctx, diag

    def carry_of(ctx, state: FluidState):
        pos = vec3.split(state.pos)
        vel = vec3.split(state.vel)
        order = ctx["order"]

        def srt(a, fill=0.0):
            return _pad_to(a[mov_ids][order], cfg.n_alloc, fill)

        return (
            srt(pos.x, far), srt(pos.y, far), srt(pos.z, far),
            srt(vel.x), srt(vel.y), srt(vel.z),
            state.muscle_activation, state.step,
            jnp.zeros((), jnp.float32),
        )

    have_walls = n_wall > 0

    def inner_step(ctx, carry):
        xs, ys, zs, vxs, vys, vzs, act, step_no, drift = carry
        tables_m = ctx["tables_m"]

        # ---- density (moving + shell-wall rows) ----
        pos_pack = F._pack([xs, ys, zs])
        s_mm = raw_mm(tables_m, pos_pack, pos_pack)
        if have_walls:
            shp = ctx["shell_pos_pack"]
            s_mw = raw_ms(ctx["tables_ms"], pos_pack, shp)
            rho_m = c_rho * jnp.maximum(
                (s_mm - self3 + s_mw) * inv_h6, 1.0)
            s_sm = raw_sm(ctx["tables_sm"], shp, pos_pack)
            rho_sh = c_rho * jnp.maximum(
                (s_sm + ctx["ww_const"]) * inv_h6, 1.0)
        else:
            rho_m = c_rho * jnp.maximum((s_mm - self3) * inv_h6, 1.0)
        inv_rho_m = 1.0 / rho_m                      # [n_pad]

        # ---- external forces (viscosity + surface tension) ----
        main1 = F._pack([
            xs, ys, zs, vxs, vys, vzs,
            _pad_to(inv_rho_m, cfg.n_alloc, 1.0), jnp.zeros_like(xs),
        ])
        vx, vy, vz, stx, sty, stz = visc_mm(tables_m, main1, main1)
        if have_walls:
            sxs, sys, szs, snx, sny, snz, _ = ctx["shell_static"]
            shell_v = F._pack([
                sxs, sys, szs, snx, sny, snz,
                _pad_to(1.0 / rho_sh, cfg.shell_alloc, 1.0),
                jnp.zeros_like(sxs),
            ])
            vx2, vy2, vz2, sx2, sy2, sz2 = visc_ms(
                ctx["tables_ms"], main1, shell_v)
            vx, vy, vz = vx + vx2, vy + vy2, vz + vz2
            stx, sty, stz = stx + sx2, sty + sy2, stz + sz2
        aex = c_visc * vx * inv_rho_m + c_surf * stx + gx
        aey = c_visc * vy * inv_rho_m + c_surf * sty + gy
        aez = c_visc * vz * inv_rho_m + c_surf * stz + gz

        # ---- elastic + muscle forces ----
        if "spr_static" in ctx:
            els = ctx["els"]
            n_el = els.shape[0]
            mcap = ctx["spr_static"].shape[1]
            actf = jnp.matmul(
                ctx["spr_onehot"],
                act * np.float32(params.muscle_force),
                precision=jax.lax.Precision.HIGHEST,
            ).reshape(n_el, n_slots)
            actf_p = jnp.zeros((n_slots, mcap), jnp.float32).at[
                :, :n_el].set(actf.T)

            def crow(a):
                return jnp.full((mcap,), far, jnp.float32).at[:n_el].set(
                    a[els]
                )

            spr_pack = jnp.concatenate([
                jnp.stack([crow(xs), crow(ys), crow(zs)], axis=0),
                ctx["spr_static"], actf_p,
            ], axis=0)
            sfx, sfy, sfz = spring_ms(ctx["spr_tables"], main1, spr_pack)
            aex = aex + sfx
            aey = aey + sfy
            aez = aez + sfz

        # ---- PCISPH prediction-correction ----
        p_m = jnp.zeros(cfg.n_pad, jnp.float32)
        apx = jnp.zeros(cfg.n_pad, jnp.float32)
        apy = jnp.zeros(cfg.n_pad, jnp.float32)
        apz = jnp.zeros(cfg.n_pad, jnp.float32)
        if have_walls:
            p_sh = jnp.zeros(cfg.shell_cap, jnp.float32)
        own_x = xs[: cfg.n_pad]
        own_y = ys[: cfg.n_pad]
        own_z = zs[: cfg.n_pad]
        own_vx = vxs[: cfg.n_pad]
        own_vy = vys[: cfg.n_pad]
        own_vz = vzs[: cfg.n_pad]

        for _ in range(params.n_pcisph_iters):
            xst = own_x + pos_dt * (own_vx + dt * apx)
            yst = own_y + pos_dt * (own_vy + dt * apy)
            zst = own_z + pos_dt * (own_vz + dt * apz)
            iter_pack = F._pack([
                _pad_to(xst, cfg.n_alloc, far),
                _pad_to(yst, cfg.n_alloc, far),
                _pad_to(zst, cfg.n_alloc, far),
            ])
            rs_mm = raw_mm(tables_m, iter_pack, iter_pack)
            if have_walls:
                rs_mw = raw_ms(ctx["tables_ms"], iter_pack,
                               ctx["shell_pos_pack"])
                rho_star = c_rho * jnp.maximum(
                    (rs_mm - self3 + rs_mw) * inv_h6, 1.0)
                rs_sm = raw_sm(ctx["tables_sm"], ctx["shell_pos_pack"],
                               iter_pack)
                rho_star_sh = c_rho * jnp.maximum(
                    (rs_sm + ctx["ww_const"]) * inv_h6, 1.0)
                p_sh = p_sh + jnp.maximum(
                    0.0, (rho_star_sh - rho0) * delta_c)
            else:
                rho_star = c_rho * jnp.maximum(
                    (rs_mm - self3) * inv_h6, 1.0)
            p_m = p_m + jnp.maximum(0.0, (rho_star - rho0) * delta_c)
            pa_pack = F._pack([
                xs, ys, zs,
                _pad_to(1.0 / jnp.maximum(rho_star, 1.0), cfg.n_alloc,
                        1.0),
                _pad_to(p_m, cfg.n_alloc),
            ])
            fx, fy, fz = pacc_mm(tables_m, pa_pack, pa_pack)
            if have_walls:
                sxs, sys, szs = ctx["shell_static"][:3]
                sh_pa = F._pack([
                    sxs, sys, szs,
                    _pad_to(1.0 / jnp.maximum(rho_star_sh, 1.0),
                            cfg.shell_alloc, 1.0),
                    _pad_to(p_sh, cfg.shell_alloc),
                ])
                fx2, fy2, fz2 = pacc_ms(ctx["tables_ms"], pa_pack, sh_pa)
                fx, fy, fz = fx + fx2, fy + fy2, fz + fz2
            coef = c_press / rho_star
            apx, apy, apz = coef * fx, coef * fy, coef * fz

        # ---- integrate ----
        vnx = own_vx + dt * (aex + apx)
        vny = own_vy + dt * (aey + apy)
        vnz = own_vz + dt * (aez + apz)
        xn = jnp.clip(own_x + pos_dt * vnx,
                      np.float32(lo_box[0]), np.float32(hi_box[0] - 1e-6))
        yn = jnp.clip(own_y + pos_dt * vny,
                      np.float32(lo_box[1]), np.float32(hi_box[1] - 1e-6))
        zn = jnp.clip(own_z + pos_dt * vnz,
                      np.float32(lo_box[2]), np.float32(hi_box[2] - 1e-6))
        vax = (own_vx + vnx) * 0.5
        vay = (own_vy + vny) * 0.5
        vaz = (own_vz + vnz) * 0.5

        # ---- Ihmsen boundary response (shell columns) ----
        own_pack = F._pack(
            [xs, ys, zs, _pad_to(xn, cfg.n_alloc, far),
             _pad_to(yn, cfg.n_alloc, far), _pad_to(zn, cfg.n_alloc, far)],
        )
        if have_walls:
            ncx, ncy, ncz, wsum, w2sum = bnd_ms(
                ctx["tables_ms"], own_pack, ctx["bnd_pack"]
            )
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

        # ---- membranes ----
        if "mem_vidx" in ctx:
            vidx = ctx["mem_vidx"]
            n_tri = vidx.shape[0]
            xyz_n = jnp.stack(
                [xn, yn, zn, jnp.zeros_like(xn)], axis=1
            )
            vabc = xyz_n[vidx.reshape(-1)].reshape(n_tri, 3, 4)
            a3 = vabc[:, 0, :3]
            u3 = vabc[:, 1, :3] - a3
            w3 = vabc[:, 2, :3] - a3
            tn = jnp.cross(u3, w3)
            tl2 = jnp.sum(tn * tn, axis=1, keepdims=True)
            til = jnp.where(
                tl2 > 0, jax.lax.rsqrt(jnp.maximum(tl2, 1e-30)), 0.0
            )
            tri8 = jnp.concatenate(
                [tn * til, a3, jnp.zeros((n_tri, 2), jnp.float32)], axis=1
            )
            t_ok = ctx["mem_pt_ok"]
            t_safe = ctx["mem_pt_safe"]
            els = ctx["els"]
            n_el = els.shape[0]
            g = jnp.where(
                t_ok.reshape(-1, 1), tri8[t_safe.reshape(-1)], 0.0
            )
            tri_mat = g[:, :6].reshape(n_el, 42).T
            mcap = -(-n_el // ALIGN) * ALIGN + ccol_c
            pos6 = jnp.stack(
                [xn, yn, zn, xs[: cfg.n_pad], ys[: cfg.n_pad],
                 zs[: cfg.n_pad], jnp.zeros_like(xn), jnp.zeros_like(xn)],
                axis=1,
            )[els]
            mem_pack = jnp.full((pk.MEM_COLS, mcap), far, jnp.float32)
            mem_pack = mem_pack.at[:42, :].set(0.0)
            mem_pack = mem_pack.at[:42, :n_el].set(tri_mat)
            mem_pack = mem_pack.at[42:48, :n_el].set(pos6[:, :6].T)

            mnx, mny, mnz, mws, mw2 = mem_ms(
                ctx["mem_tables"], own_pack, mem_pack,
            )
            ml2 = mnx * mnx + mny * mny + mnz * mnz
            mhas = (ml2 > 0) & (ctx["liq_s"][: cfg.n_pad] > 0)
            mcoef = jnp.where(
                mhas,
                jax.lax.rsqrt(jnp.maximum(ml2, 1e-30))
                * mw2 / jnp.maximum(mws, 1e-30),
                0.0,
            )
            xn = xn + mnx * mcoef
            yn = yn + mny * mcoef
            zn = zn + mnz * mcoef

        # pad rows stay pinned at `far` with zero velocity
        xn = jnp.where(pad_mask, own_x, xn)
        yn = jnp.where(pad_mask, own_y, yn)
        zn = jnp.where(pad_mask, own_z, zn)
        vax = jnp.where(pad_mask, 0.0, vax)
        vay = jnp.where(pad_mask, 0.0, vay)
        vaz = jnp.where(pad_mask, 0.0, vaz)

        if layout.muscle_model:
            act_next = muscle.next_activation(step_no)
        else:
            act_next = act

        d2 = ((xn - own_x) * (xn - own_x)
              + (yn - own_y) * (yn - own_y)
              + (zn - own_z) * (zn - own_z))
        drift = drift + jnp.sqrt(jnp.max(d2))

        return (
            _pad_to(xn, cfg.n_alloc, far), _pad_to(yn, cfg.n_alloc, far),
            _pad_to(zn, cfg.n_alloc, far),
            _pad_to(vax, cfg.n_alloc), _pad_to(vay, cfg.n_alloc),
            _pad_to(vaz, cfg.n_alloc),
            act_next, step_no + 1, drift,
        )

    def unsort_state(ctx, carry, state: FluidState) -> FluidState:
        xs, ys, zs, vtx, vty, vtz, act, step_no, _drift = carry
        dest = ctx["orig_of_sorted"]
        pos = vec3.split(state.pos)
        vel = vec3.split(state.vel)

        def scat(base, a_sorted):
            return base.at[dest].set(a_sorted[:n_mov])

        return FluidState(
            pos=vec3.merge(vec3.V3(
                scat(pos.x, xs), scat(pos.y, ys), scat(pos.z, zs))),
            vel=vec3.merge(vec3.V3(
                scat(vel.x, vtx), scat(vel.y, vty), scat(vel.z, vtz))),
            ptype=state.ptype,
            normal=state.normal,
            muscle_activation=act,
            step=step_no,
        )

    return sort_ctx, carry_of, inner_step, unsort_state


def make_fastw_multi_step(params, layout, cfg: FastWConfig,
                          n_steps: int = 1, return_diag: bool = False,
                          wall_static=None):
    """Jitted run(state, springs, membranes) -> state after n_steps
    (wall-compact engine). ``return_diag``: also return a dict with the
    window-staleness drift bound and the shell overflow count (max over
    the call's resort periods) — overflow means pairs were DROPPED and
    must be surfaced loudly by the caller.

    Same nested-scan structure as core.fast.make_fast_multi_step."""
    sort_ctx, carry_of, inner_step, unsort_state = _make_step_parts_w(
        params, layout, cfg, wall_static=wall_static
    )
    r_every = max(1, cfg.resort_every)
    full, rem = divmod(n_steps, r_every)

    def scan_steps(ctx, carry, length):
        def body(c, _):
            return inner_step(ctx, c), None

        m_in = min(length, 10)
        m_out, rem2 = divmod(length, m_in)

        def outer(c, _):
            c2, _ = jax.lax.scan(body, c, None, length=m_in)
            return c2, None

        carry, _ = jax.lax.scan(outer, carry, None, length=m_out)
        if rem2:
            carry, _ = jax.lax.scan(body, carry, None, length=rem2)
        return carry

    @jax.jit
    def run(state, springs, membranes):
        def sweep(state, r_steps):
            ctx, diag = sort_ctx(state, springs, membranes)
            carry = carry_of(ctx, state)
            carry = scan_steps(ctx, carry, r_steps)
            return unsort_state(ctx, carry, state), carry[-1], diag

        drift = jnp.zeros((), jnp.float32)
        ovf = dict(shell_overflow=jnp.zeros((), jnp.int32))

        def fold(ovf, diag):
            return {k: jnp.maximum(ovf[k], diag[k]) for k in ovf}

        if full:
            def body(c, _):
                s, d, o = c
                s2, d2, diag = sweep(s, r_every)
                return (s2, jnp.maximum(d, d2), fold(o, diag)), None

            (state, drift, ovf), _ = jax.lax.scan(
                body, (state, drift, ovf), None, length=full,
            )
        if rem:
            state, d2, diag = sweep(state, rem)
            drift = jnp.maximum(drift, d2)
            ovf = fold(ovf, diag)
        if return_diag:
            return state, dict(window_drift=drift, **ovf)
        return state

    return run


def make_fastw_stepper(params, layout, cfg: FastWConfig,
                       inner_steps: int = 10, wall_static=None):
    """Stateful stepping API mirroring core.fast.make_fast_stepper: the
    sorted context and carry live across calls so the resort period is
    decoupled from compiled graph length."""
    sort_ctx, carry_of, inner_step, unsort_state = _make_step_parts_w(
        params, layout, cfg, wall_static=wall_static
    )

    @jax.jit
    def sort(state, springs, membranes):
        ctx, diag = sort_ctx(state, springs, membranes)
        return ctx, carry_of(ctx, state), diag

    @jax.jit
    def inner(ctx, carry):
        def body(c, _):
            return inner_step(ctx, c), None

        out, _ = jax.lax.scan(body, carry, None, length=inner_steps)
        return out

    @jax.jit
    def unsort(ctx, carry, state):
        return unsort_state(ctx, carry, state)

    return sort, inner, unsort
