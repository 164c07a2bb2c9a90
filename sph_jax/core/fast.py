"""The fast (Pallas) engine: one PCISPH step built on blocked pair kernels.

Same stage order and physics as :mod:`sph_jax.core.step` (the exact-semantics
neighbor-list engine), recomposed around blocked pair passes:

* particles are re-sorted by h-granularity cell id each step (argsort — fast)
  in z-major / x-pencil / y-run order (y = the world box's shortest occupied
  axis, so interaction windows are tight) and the whole step runs in sorted
  space; original order is restored once at the end (springs and membrane
  triangle ids stay in original/absolute space);
* every per-neighbor reduction is a blocked all-pairs Pallas pass over
  contiguous sorted windows (see ops/pair_kernels.py) — no gathers, no
  neighbor lists, no capacity truncation (windows are covered exactly with
  a dynamic tile count per block);
* elastic/muscle forces keep the (small, irregular) spring-graph gather in
  XLA original space and scatter into the sorted accumulator.

Documented deviation from the reference: no 32-neighbor cap (all pairs
within radius h interact; the reference's histogram cap keeps the ~32
nearest, sphFluid.cl:207-329). Near-cap neighbors sit at q ~ 1 where all
kernel terms vanish, so trajectories track the exact engine closely; the
exact engine remains available for parity validation.
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
from .elastic import elastic_accel
from .state import FluidState, Membranes, Springs
from .step import SceneLayout

ALIGN = pk.ALIGN
# default pair-pass widths: own rows per kernel program and slab tile
# columns — the fastest pair of the H100 sweep on the worm (PERF.md)
BLOCK = 8
CCOL = 8
# default steps between spatial resorts (window rebuilds). Windows are
# exact at the resort and miss pairs that close in from beyond them until
# the next one; on the worm, 10 cut the worst per-period density share of
# such pairs ~750x at the median against 30, for ~6 % more time per step
# (PERF.md, scripts/window_staleness.py)
RESORT_EVERY = 10


@dataclasses.dataclass(frozen=True)
class FastConfig:
    """Static shapes of the fast engine (hashable; jit-static)."""

    n_particles: int
    n_blocks: int
    block: int  # own-block size (sorted particles per kernel program)
    ccol: int   # slab tile width (power of two, multiple of pk.ALIGN)
    dims: tuple[int, int, int]  # h-granularity grid dims
    interpret: bool = False
    resort_every: int = RESORT_EVERY  # steps between spatial re-sorts
    # tile width of the COMPACT-slab passes (boundary/spring/membrane):
    # their windows are sparse intersections of the main window with the
    # compact slab, so wide tiles are mostly quantization waste.
    # None = use ccol (the halo engine always does).
    ccol_c: int | None = None

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
    def n_pencils(self) -> int:
        # a pencil is a y-column of cells, indexed cx + nx * cz
        return self.dims[0] * self.dims[2]


def compute_fast_config(
    pos: np.ndarray,
    params: SimParams,
    block: int = BLOCK,
    ccol: int = CCOL,
    interpret: bool | None = None,
    resort_every: int = RESORT_EVERY,
    block_multiple: int = 1,
    ccol_c: int | None = None,
) -> FastConfig:
    """Static fast-engine shapes. There is no measured slab capacity:
    windows are walked with a dynamic tile count, so nothing here depends
    on the particle distribution (only on the count).

    ``block_multiple``: round the block count up to this multiple
    (phantom blocks get zero tile counts). The halo engine passes the
    device count so the blocks divide evenly across devices."""
    cell = params.h
    nx = int((params.x_max - params.x_min) / cell) + 1
    ny = int((params.y_max - params.y_min) / cell) + 1
    nz = int((params.z_max - params.z_min) / cell) + 1
    n = len(pos)
    m = block_multiple
    nb = -(-(-(-n // block)) // m) * m
    if interpret is None:
        interpret = pk.default_interpret()
    return FastConfig(
        n_particles=n, n_blocks=nb, block=block, ccol=ccol,
        dims=(nx, ny, nz), interpret=interpret, resort_every=resort_every,
        ccol_c=ccol_c,
    )


def _window_tables(pencil_s, cfg: FastConfig):
    """Per-block interaction-window descriptors.

    For each own block (``block`` consecutive sorted particles) the
    candidate set is three contiguous sorted-array windows — the pencil
    bands (z-1, z, z+1) x (x span +- 1 pencil) around the block's pencil
    range. Returns the chunk tables for the pair passes
    (aligned_offset, lo, hi, tile_start, tile_count, own_base), the
    per-pencil start offsets, and the per-block pencil ranges (for the
    membrane flag logic).

    Chunks are deduplicated both in window space (``prev_hi``) and in TILE
    space (``prev_tend``): a block's tiles are disjoint and cover every
    in-window column exactly once, so the kernels need no per-pair window
    mask at all — any real column a tile adds beyond the pencil-band range
    is >= h away from every own particle (the bands' +-1-pencil margin is
    exactly the h reach), where every pair term vanishes; pad columns
    carry ``far`` positions (see pair_kernels module docstring).
    """
    n, nb, B = cfg.n_particles, cfg.n_blocks, cfg.block
    nx = cfg.dims[0]
    npen = cfg.n_pencils
    ccol = cfg.ccol
    pstart = jnp.searchsorted(
        pencil_s, jnp.arange(npen + 1, dtype=pencil_s.dtype), side="left"
    ).astype(jnp.int32)

    bidx = jnp.arange(nb, dtype=jnp.int32)
    first = pencil_s[jnp.minimum(bidx * B, n - 1)]
    last = pencil_s[jnp.minimum(bidx * B + B - 1, n - 1)]

    alns, los, his, nsubs, plos, phis = [], [], [], [], [], []
    prev_hi = jnp.zeros(nb, jnp.int32)
    prev_tend = jnp.zeros(nb, jnp.int32)  # tile-space dedup watermark
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
        plos.append(lo_p)
        phis.append(hi_p)

    nsub = jnp.stack(nsubs, 1)                       # [nb, 3]
    # phantom blocks (entirely beyond the particle count) do no work
    nsub = jnp.where((bidx * B >= n)[:, None], 0, nsub)
    s0 = jnp.cumsum(nsub, axis=1) - nsub             # exclusive cumsum
    cnt = nsub.sum(axis=1)
    # flattened [nb * 3]; trailing [1] own_base = 0 (own blocks start at
    # pack column 0 on one device; the halo-exchange engine overrides it)
    tables = (
        jnp.stack(alns, 1).reshape(-1), jnp.stack(los, 1).reshape(-1),
        jnp.stack(his, 1).reshape(-1), s0.reshape(-1), cnt,
        jnp.zeros(1, jnp.int32),
    )
    pencil_ranges = (jnp.stack(plos, 1), jnp.stack(phis, 1))
    return tables, pstart, pencil_ranges


def _tile_chunks(lo, hi, n_blocks, ccol):
    """Per-block chunk descriptors (aln, s0, cnt) from flattened [nb*3]
    lo/hi column ranges, deduplicated in tile space (each block's tiles
    are disjoint and cover every in-range column exactly once — the
    maskless-kernel invariant). lo/hi must be nondecreasing per block."""
    lo3 = lo.reshape(n_blocks, 3)
    hi3 = hi.reshape(n_blocks, 3)
    alns, nsubs = [], []
    prev_tend = jnp.zeros(n_blocks, jnp.int32)
    for c in range(3):
        aligned = jnp.maximum((lo3[:, c] // ALIGN) * ALIGN, prev_tend)
        nsub = jnp.where(
            hi3[:, c] > aligned, -((aligned - hi3[:, c]) // ccol), 0
        ).astype(jnp.int32)
        prev_tend = aligned + nsub * ccol
        alns.append(aligned)
        nsubs.append(nsub)
    nsub = jnp.stack(nsubs, 1)
    s0 = (jnp.cumsum(nsub, axis=1) - nsub).reshape(-1)
    return jnp.stack(alns, 1).reshape(-1), s0, nsub.sum(axis=1)


def _spring_chunks(aln, s0, cnt, own_rows, n_blocks, block, ccol):
    """Spring-pass chunk tables (aln, s0, cnt) that hold every spring.

    The spring pass matches partners by id with no radius cutoff, so a
    spring acts only if its partner's compact column lies inside the
    tiles of its own row's block. The pencil-band chunks (aln, s0, cnt)
    hold every partner within h at sort time; a block with a partner
    outside them (a spring stretched past the bands) walks instead one
    chunk over the span of all its partners' columns. Columns are fixed
    for the resort period, so this holds for the whole period.

    own_rows: [n_el, k] own-block row (0-based, in the pass's own row
    space) of the spring whose partner is compact column j; -1 = none."""
    n_el = own_rows.shape[0]
    ok = own_rows >= 0
    blk = jnp.where(ok, own_rows // block, n_blocks).reshape(-1)
    col = jnp.broadcast_to(
        jnp.arange(n_el, dtype=jnp.int32)[:, None], own_rows.shape
    ).reshape(-1)
    nsub = jnp.diff(
        jnp.concatenate([s0.reshape(n_blocks, 3), cnt[:, None]], axis=1),
        axis=1,
    )
    a3 = jnp.concatenate([aln.reshape(n_blocks, 3),
                          jnp.zeros((1, 3), jnp.int32)])[blk]
    e3 = a3 + jnp.concatenate([nsub * ccol,
                               jnp.zeros((1, 3), jnp.int32)])[blk]
    inside = ((col[:, None] >= a3) & (col[:, None] < e3)).any(axis=1)
    seg = dict(segment_ids=blk, num_segments=n_blocks + 1)
    widen = jax.ops.segment_max(
        jnp.where(inside, 0, 1).astype(jnp.int32), **seg)[:n_blocks] > 0
    lo = jax.ops.segment_min(col, **seg)[:n_blocks]
    hi = jax.ops.segment_max(col, **seg)[:n_blocks] + 1
    a0 = (lo // ALIGN) * ALIGN
    n_span = -((a0 - hi) // ccol)
    aln_w = jnp.where(widen[:, None], a0[:, None], aln.reshape(n_blocks, 3))
    s0_w = jnp.where(widen[:, None],
                     jnp.stack([jnp.zeros_like(n_span), n_span, n_span], 1),
                     s0.reshape(n_blocks, 3))
    return (aln_w.reshape(-1), s0_w.reshape(-1),
            jnp.where(widen, n_span, cnt))


def _pad_field(a, cfg: FastConfig, fill=0.0):
    pad = cfg.n_alloc - a.shape[0]
    return jnp.concatenate(
        [a, jnp.full((pad,), fill, a.dtype)]
    )


def _pack(fields):
    """Column-major [rows, n_alloc] field pack: own blocks and slab tiles
    are contiguous row segments of this one layout."""
    return jnp.stack(fields, axis=0)


def _make_step_parts(params: SimParams, layout: SceneLayout, cfg: FastConfig):
    """Build (sort_ctx, inner_step, unsort_state).

    The step is split so the sort/window machinery runs once per
    ``cfg.resort_every`` steps while the physics runs every step *in sorted
    space*. Window staleness over the resort period can only drop
    pairs entering radius h from beyond the one-cell window margin, each
    at q ~ 1 where every kernel term vanishes. On the worm at the default
    period such pairs carried at most 3.8e-3 of a row's density sum
    (median period 1.6e-6; scripts/window_staleness.py, PERF.md).
    """
    inv_h2 = np.float32(1.0 / (params.h * params.h))
    inv_h = np.float32(1.0 / params.h)
    c_rho = np.float32(params.c_rho)
    r0 = np.float32(params.r0)
    kw = dict(block=cfg.block, ccol=cfg.ccol, n_blocks=cfg.n_blocks,
              inv_h2=inv_h2, interpret=cfg.interpret)
    density_pass = pk.make_density_pass(c_rho=c_rho, **kw)
    rho_star_pass = pk.make_density_pass(c_rho=c_rho, name="rho_star_pass",
                                         **kw)
    viscsurf_pass = pk.make_viscsurf_pass(**kw)
    paccel_pass = pk.make_paccel_pass(
        inv_h=inv_h, rho0_delta=np.float32(params.rho0 * params.delta),
        **kw
    )
    # compact-slab passes use their own (narrower) tile width: their
    # windows are sparse intersections, so main-width tiles are mostly
    # quantization waste
    ckw = dict(kw, ccol=cfg.ccol_compact)
    boundary_pass = pk.make_boundary_pass(r0=r0, **ckw)
    membrane_pass = pk.make_membrane_pass(r0=r0, **ckw)
    n_slots = layout.spring_slots
    spring_pass = pk.make_spring_pass(
        inv_h=inv_h,
        h_scale=np.float32(params.h * params.simulation_scale),
        k_spring=np.float32(params.k_spring), n_slots=n_slots, **ckw,
    )

    n = cfg.n_particles
    nx, ny, nz = cfg.dims
    far = np.float32(
        max(params.x_max, params.y_max, params.z_max) + 100.0 * params.h
    )

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

    def sort_ctx(state: FluidState, springs: Springs, membranes: Membranes):
        """Everything derived from the spatial sort (valid for the whole
        resort period): permutation, window tables, per-block gates,
        sorted static fields, and spring/membrane ids translated to
        sorted space."""
        pos = vec3.split(state.pos)
        nrm = vec3.split(state.normal)
        is_b = state.ptype == BOUNDARY_PARTICLE
        is_liq = state.ptype == LIQUID_PARTICLE

        # sort by cell id: z-major, x-pencil, y-run (binning matches
        # grid.cell_coords_of: subtract box_min before scaling)
        cell = jnp.float32(1.0 / params.h)
        bx, by, bz = (jnp.float32(b) for b in params.box_min)
        cx = jnp.clip(((pos.x - bx) * cell).astype(jnp.int32), 0, nx - 1)
        cy = jnp.clip(((pos.y - by) * cell).astype(jnp.int32), 0, ny - 1)
        cz = jnp.clip(((pos.z - bz) * cell).astype(jnp.int32), 0, nz - 1)
        pencil = cx + nx * cz
        cid = cy + ny * pencil
        order = jnp.argsort(cid, stable=True).astype(jnp.int32)
        inv = jnp.zeros(n, jnp.int32).at[order].set(
            jnp.arange(n, dtype=jnp.int32)
        )
        pencil_s = pencil[order]

        def srt(a, fill=0.0):
            return _pad_field(a[order], cfg, fill)

        tables, pstart, pranges = _window_tables(pencil_s, cfg)
        # pad/phantom rows are flagged boundary (fill 1.0): maskless tiles
        # can overhang into pad columns, so phantom rows must be pinned
        # like walls (otherwise they would integrate off the `far` fill
        # and re-enter the box as spurious columns)
        isb_s = srt(is_b.astype(jnp.float32), 1.0)
        liq_s = srt(is_liq.astype(jnp.float32))
        nxs = srt(nrm.x)
        nys = srt(nrm.y)
        nzs = srt(nrm.z)

        # per-block force gating: a block whose own particles are all
        # boundary walls receives no forces (its accelerations are masked
        # to zero anyway), so the force passes skip it exactly by zeroing
        # its tile count; density/rho* still run everywhere (neighbors
        # read boundary rho). ~44% of the worm scene is static boundary.
        own_nonb = (
            isb_s[: cfg.n_pad].reshape(cfg.n_blocks, cfg.block).min(axis=1)
            == 0
        )
        aln_t, lo_t, hi_t, s0_t, cnt_t, ob_t = tables
        force_tables = (aln_t, lo_t, hi_t, s0_t,
                        jnp.where(own_nonb, cnt_t, 0), ob_t)
        # boundary-response pass additionally needs boundary in the window
        seg_b = jax.ops.segment_sum(
            isb_s[:n], pencil_s, num_segments=cfg.n_pencils
        )
        csum_b = jnp.concatenate(
            [jnp.zeros(1, seg_b.dtype), jnp.cumsum(seg_b)]
        )
        plo_r, phi_r = pranges
        win_has_b = (csum_b[phi_r] - csum_b[plo_r]).sum(axis=1) > 0
        # boundary pass: compact static slab of boundary-only columns
        # (walls never move within a resort period, so the whole pack is
        # built once here); window tables mapped by searchsorted
        b0, b1 = layout.boundary_range
        if b1 > b0:
            bels = jnp.sort(inv[jnp.arange(b0, b1)])     # ascending rows
            lo_b = jnp.searchsorted(bels, lo_t).astype(jnp.int32)
            hi_b = jnp.searchsorted(bels, hi_t).astype(jnp.int32)
            aln_b, s0_b, cnt_b = _tile_chunks(
                lo_b, hi_b, cfg.n_blocks, cfg.ccol_compact
            )
            bnd_tables = (aln_b, lo_b, hi_b, s0_b,
                          jnp.where(own_nonb & win_has_b, cnt_b, 0), ob_t)
            n_b = b1 - b0
            bcap = -(-n_b // ALIGN) * ALIGN + cfg.ccol_compact

            def brow(a, fill):
                return jnp.full((bcap,), fill, jnp.float32).at[
                    : n_b].set(a[bels])

            bnd_pack = _pack([
                brow(srt(pos.x, far), far), brow(srt(pos.y, far), far),
                brow(srt(pos.z, far), far),
                brow(nxs, 0.0), brow(nys, 0.0), brow(nzs, 0.0),
                jnp.full((bcap,), 0.0, jnp.float32).at[:n_b].set(1.0),
            ])
        else:
            bnd_tables = (aln_t, lo_t, hi_t, s0_t,
                          jnp.zeros_like(cnt_t), ob_t)
            bnd_pack = jnp.zeros((pk.BND_COLS, cfg.ccol_compact),
                                 jnp.float32)
        # density/rho* skip wall blocks with no moving particle in reach:
        # their rho is only ever read for pairs that the q2 cutoff masks
        # (a moving particle within h of a boundary row implies it is in
        # that row's block window). ~30% of the worm scene is far-wall.
        seg_mv = jax.ops.segment_sum(
            1.0 - isb_s[:n], pencil_s, num_segments=cfg.n_pencils
        )
        csum_mv = jnp.concatenate(
            [jnp.zeros(1, seg_mv.dtype), jnp.cumsum(seg_mv)]
        )
        win_has_mv = (csum_mv[phi_r] - csum_mv[plo_r]).sum(axis=1) > 0
        rho_tables = (aln_t, lo_t, hi_t, s0_t,
                      jnp.where(own_nonb | win_has_mv, cnt_t, 0), ob_t)

        ctx = dict(
            order=order, inv=inv, isb_s=isb_s, liq_s=liq_s,
            nxs=nxs, nys=nys, nzs=nzs,
            tables=tables, force_tables=force_tables,
            bnd_tables=bnd_tables, rho_tables=rho_tables,
            bnd_pack=bnd_pack,
            bmask=isb_s[: cfg.n_pad] > 0,
            not_b=(isb_s[: cfg.n_pad] == 0).astype(jnp.float32),
        )

        # ---- compact elastic slab machinery (springs + membranes both
        # stream elastic-only columns; the full sorted array is ~23x
        # larger on the worm) ----
        have_springs = springs.n_elastic > 0
        have_mem = membranes.n_tris > 0
        if have_springs or have_mem:
            e0, e1 = layout.elastic_range
            n_el = e1 - e0
            el_rows = inv[jnp.arange(e0, e1)]            # sorted row per eid
            perm = jnp.argsort(el_rows)                  # compact col order
            els = el_rows[perm]                          # ascending rows
            ctx["els"] = els
            # window tables in compact coordinates (chunks stay disjoint
            # and ascending under searchsorted); tile-deduped (maskless)
            lo_c = jnp.searchsorted(els, lo_t).astype(jnp.int32)
            hi_c = jnp.searchsorted(els, hi_t).astype(jnp.int32)
            aln_c, s0_c, cnt_c = _tile_chunks(
                lo_c, hi_c, cfg.n_blocks, cfg.ccol_compact
            )

        # springs as a pair pass over the compact slab: each compact
        # column j carries its 32 spring-partner sorted ids + rest
        # lengths (static per resort) and per-step activation terms
        if have_springs and layout.springs_elastic_only:
            mcap = -(-n_el // ALIGN) * ALIGN + cfg.ccol_compact
            rmap = jnp.full(n, -1, jnp.int32).at[springs.row_ids].set(
                jnp.arange(springs.n_elastic, dtype=jnp.int32)
            )
            r_of_col = rmap[e0 + perm]                   # [n_el]
            r_safe = jnp.maximum(r_of_col, 0)
            sidx = jnp.where(
                (r_of_col >= 0)[:, None],
                springs.idx[r_safe, :n_slots], -1
            )                                            # [n_el,k] orig ids
            own_rows = jnp.where(sidx >= 0, inv[jnp.maximum(sidx, 0)], -1)
            idx_f = own_rows.astype(jnp.float32)
            rest_c = jnp.where(
                sidx >= 0, springs.rest[r_safe, :n_slots], 0.0
            )
            # pad columns must carry partner id -1 (0.0 would maskless-
            # match sorted row 0 when a block's tiles overhang the slab)
            idx_p = jnp.full((n_slots, mcap), -1.0, jnp.float32).at[
                :, :n_el].set(idx_f.T)
            rest_p = jnp.zeros((n_slots, mcap), jnp.float32).at[
                :, :n_el].set(rest_c.T)
            ctx["spr_static"] = jnp.concatenate([idx_p, rest_p], axis=0)
            mid = jnp.where(
                sidx >= 0, springs.muscle[r_safe, :n_slots], 0
            )                                            # [n_el,k]
            # per-slot muscle one-hot, built ONCE per resort (hoisted
            # out of inner_step)
            n_act = int(MUSCLE_COUNT)
            ctx["spr_onehot"] = (
                mid.reshape(-1)[:, None]
                == jnp.arange(1, n_act + 1, dtype=mid.dtype)
            ).astype(jnp.float32)                        # [n_el*k, n_act]
            # gate: own block contains at least one elastic row
            own_el = (
                jnp.zeros(cfg.n_pad, jnp.float32).at[els].set(1.0)
                .reshape(cfg.n_blocks, cfg.block).max(axis=1) > 0
            )
            aln_s, s0_s, cnt_s = _spring_chunks(
                aln_c, s0_c, cnt_c, own_rows, cfg.n_blocks, cfg.block,
                cfg.ccol_compact)
            ctx["spr_tables"] = (
                aln_s, lo_c, hi_c, s0_s, jnp.where(own_el, cnt_s, 0), ob_t,
            )
        elif have_springs:
            # general fallback (springs anchored outside the elastic
            # block): translate to sorted row space and gather in XLA
            sidx = springs.idx
            ctx["springs_s"] = Springs(
                row_ids=inv[springs.row_ids],
                idx=jnp.where(sidx >= 0, inv[jnp.maximum(sidx, 0)], -1),
                rest=springs.rest,
                muscle=springs.muscle,
            )

        # membrane machinery: the membrane pass streams the compact slab
        # too (a small fraction of the full sorted array on the worm)
        if have_mem:
            pt = membranes.particle_tris[e0:e1]          # [Ne,7]
            ctx["mem_vidx"] = inv[membranes.tris]        # [M,3] sorted rows
            ctx["mem_pt_ok"] = pt[perm] >= 0
            ctx["mem_pt_safe"] = jnp.maximum(pt[perm], 0)
            has_mem_orig = jnp.zeros(n, jnp.float32).at[
                jnp.arange(e0, e1)
            ].set((pt >= 0).any(axis=1).astype(jnp.float32))
            hm_s = has_mem_orig[order]
            seg = jax.ops.segment_sum(
                hm_s, pencil_s, num_segments=cfg.n_pencils
            )
            csum = jnp.concatenate(
                [jnp.zeros(1, seg.dtype), jnp.cumsum(seg)]
            )
            chunk_mem = (csum[phi_r] - csum[plo_r]).sum(axis=1) > 0
            own_liq = (
                liq_s[: cfg.n_pad].reshape(cfg.n_blocks, cfg.block)
                .max(axis=1) > 0
            )
            flags = chunk_mem & own_liq
            ctx["mem_tables"] = (
                aln_c, lo_c, hi_c, s0_c, jnp.where(flags, cnt_c, 0), ob_t,
            )
        return ctx

    def carry_of(ctx, state: FluidState):
        """Sorted-space step carry from an original-space state."""
        pos = vec3.split(state.pos)
        vel = vec3.split(state.vel)
        order = ctx["order"]

        def srt(a, fill=0.0):
            return _pad_field(a[order], cfg, fill)

        return (
            srt(pos.x, far), srt(pos.y, far), srt(pos.z, far),
            srt(vel.x), srt(vel.y), srt(vel.z),
            state.muscle_activation, state.step,
            jnp.zeros((), jnp.float32),  # window-staleness drift bound
        )

    def inner_step(ctx, carry):
        xs, ys, zs, vtx, vty, vtz, act, step_no, drift = carry
        isb_s = ctx["isb_s"]
        bmask = ctx["bmask"]
        tables = ctx["tables"]
        force_tables = ctx["force_tables"]

        # boundary rows carry the wall normal as "velocity"
        # (sphFluid.cl:860); dynamics below use the true velocity
        vxs = jnp.where(isb_s > 0, ctx["nxs"], vtx)
        vys = jnp.where(isb_s > 0, ctx["nys"], vty)
        vzs = jnp.where(isb_s > 0, ctx["nzs"], vtz)

        # ---- density ----
        ones = jnp.ones_like(xs)
        main0 = _pack([xs, ys, zs, vxs, vys, vzs, ones, isb_s])
        rho_s = _pad_field(
            density_pass(ctx["rho_tables"], main0, main0)[: cfg.n_pad],
            cfg, 1.0
        )[: cfg.n_alloc]
        rho_s = jnp.where(rho_s <= 0, 1.0, rho_s)  # padding guard
        inv_rho_s = 1.0 / rho_s  # kernels take 1/rho (no per-pair divide)

        # ---- external forces (viscosity + surface tension fused) ----
        main1 = _pack([xs, ys, zs, vxs, vys, vzs, inv_rho_s, isb_s])
        vx, vy, vz, stx, sty, stz = viscsurf_pass(force_tables, main1, main1)
        own_irho = inv_rho_s[: cfg.n_pad]
        not_b = ctx["not_b"]
        aex = (c_visc * vx * own_irho + c_surf * stx + gx) * not_b
        aey = (c_visc * vy * own_irho + c_surf * sty + gy) * not_b
        aez = (c_visc * vz * own_irho + c_surf * stz + gz) * not_b

        # ---- elastic + muscle forces (sorted-space gather/scatter) ----
        if "spr_static" in ctx:
            els = ctx["els"]
            n_el = els.shape[0]
            mcap = ctx["spr_static"].shape[1]
            # per-slot activation force term via one-hot contraction; the
            # one-hot matrix is static per resort and lives in ctx
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
            sfx, sfy, sfz = spring_pass(
                ctx["spr_tables"], main1, spr_pack
            )
            aex = aex + sfx
            aey = aey + sfy
            aez = aez + sfz
        elif "springs_s" in ctx:
            sp = ctx["springs_s"]
            pos_sorted = vec3.V3(xs[:n], ys[:n], zs[:n])
            ae = elastic_accel(pos_sorted, sp, act, params)
            aex = aex.at[sp.row_ids].add(ae.x)
            aey = aey.at[sp.row_ids].add(ae.y)
            aez = aez.at[sp.row_ids].add(ae.z)

        # ---- PCISPH prediction-correction ----
        p_s = jnp.zeros(cfg.n_pad, jnp.float32)
        apx = jnp.zeros(cfg.n_pad, jnp.float32)
        apy = jnp.zeros(cfg.n_pad, jnp.float32)
        apz = jnp.zeros(cfg.n_pad, jnp.float32)
        own_x = xs[: cfg.n_pad]
        own_y = ys[: cfg.n_pad]
        own_z = zs[: cfg.n_pad]
        own_vx = vtx[: cfg.n_pad]
        own_vy = vty[: cfg.n_pad]
        own_vz = vtz[: cfg.n_pad]

        for _ in range(params.n_pcisph_iters):
            xst = jnp.where(bmask, own_x, own_x + pos_dt * (own_vx + dt * apx))
            yst = jnp.where(bmask, own_y, own_y + pos_dt * (own_vy + dt * apy))
            zst = jnp.where(bmask, own_z, own_z + pos_dt * (own_vz + dt * apz))
            iter_pack = _pack([
                _pad_field(xst, cfg, far), _pad_field(yst, cfg, far),
                _pad_field(zst, cfg, far),
            ])
            rho_star = rho_star_pass(ctx["rho_tables"], iter_pack, iter_pack)
            p_s = p_s + jnp.maximum(0.0, (rho_star - rho0) * delta_c)
            pa_pack = _pack([
                xs, ys, zs,
                _pad_field(1.0 / jnp.maximum(rho_star, 1.0), cfg, 1.0),
                _pad_field(p_s, cfg),
            ])
            fx, fy, fz = paccel_pass(force_tables, pa_pack, pa_pack)
            coef = jnp.where(bmask, 0.0, c_press / rho_star)
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

        # boundary response
        own_pack = _pack(
            [xs, ys, zs, _pad_field(xn, cfg, far),
             _pad_field(yn, cfg, far), _pad_field(zn, cfg, far)],
        )
        ncx, ncy, ncz, wsum, w2sum = boundary_pass(
            ctx["bnd_tables"], own_pack, ctx["bnd_pack"]
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
            # everything below gathers rows of stacked matrices (two
            # gathers total) instead of 42 + 9 per-field gathers
            vidx = ctx["mem_vidx"]
            n_tri = vidx.shape[0]
            xyz_n = jnp.stack(
                [xn, yn, zn, jnp.zeros_like(xn)], axis=1
            )                                            # [n_pad, 4]
            vabc = xyz_n[vidx.reshape(-1)].reshape(n_tri, 3, 4)
            a3 = vabc[:, 0, :3]
            u3 = vabc[:, 1, :3] - a3
            w3 = vabc[:, 2, :3] - a3
            tn = jnp.cross(u3, w3)                       # [M, 3]
            tl2 = jnp.sum(tn * tn, axis=1, keepdims=True)
            til = jnp.where(
                tl2 > 0, jax.lax.rsqrt(jnp.maximum(tl2, 1e-30)), 0.0
            )
            tri8 = jnp.concatenate(
                [tn * til, a3, jnp.zeros((n_tri, 2), jnp.float32)], axis=1
            )                                            # [M, 8] (n, a)

            t_ok = ctx["mem_pt_ok"]
            t_safe = ctx["mem_pt_safe"]
            els = ctx["els"]
            n_el = els.shape[0]
            g = jnp.where(
                t_ok.reshape(-1, 1), tri8[t_safe.reshape(-1)], 0.0
            )                                            # [n_el*7, 8]
            # [n_el, 7, 6] -> rows 6t..6t+5 = slot t's (n, a) per column
            tri_mat = (
                g[:, :6].reshape(n_el, 42).T
            )                                            # [42, n_el]
            mcap = -(-n_el // ALIGN) * ALIGN + cfg.ccol_compact
            # rows 42-47: x(t+1) and x(t) of the elastic columns — one
            # 8-wide row gather of the stacked fields
            pos6 = jnp.stack(
                [xn, yn, zn, xs[: cfg.n_pad], ys[: cfg.n_pad],
                 zs[: cfg.n_pad], jnp.zeros_like(xn), jnp.zeros_like(xn)],
                axis=1,
            )[els]                                       # [n_el, 8]

            mem_pack = jnp.full((pk.MEM_COLS, mcap), far, jnp.float32)
            mem_pack = mem_pack.at[:42, :].set(0.0)
            mem_pack = mem_pack.at[:42, :n_el].set(tri_mat)
            mem_pack = mem_pack.at[42:48, :n_el].set(pos6[:, :6].T)

            mnx, mny, mnz, mws, mw2 = membrane_pass(
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

        # boundary particles are pinned: walls never move, and the carry
        # must stay exact across the whole resort period
        xn = jnp.where(bmask, own_x, xn)
        yn = jnp.where(bmask, own_y, yn)
        zn = jnp.where(bmask, own_z, zn)
        vax = jnp.where(bmask, own_vx, vax)
        vay = jnp.where(bmask, own_vy, vay)
        vaz = jnp.where(bmask, own_vz, vaz)

        if layout.muscle_model:
            act_next = muscle.next_activation(step_no)
        else:
            act_next = act

        # window-staleness bound: accumulate the per-step max
        # Euclidean displacement — the SUM of per-step maxima bounds any
        # intra-period excursion, and 2x it bounds relative pair approach
        # (two particles converging). Boundary/pad rows are pinned (diff
        # exactly 0), so the max is over real moving rows only.
        d2 = ((xn - own_x) * (xn - own_x)
              + (yn - own_y) * (yn - own_y)
              + (zn - own_z) * (zn - own_z))
        drift = drift + jnp.sqrt(jnp.max(d2))

        return (
            _pad_field(xn, cfg, far), _pad_field(yn, cfg, far),
            _pad_field(zn, cfg, far),
            _pad_field(vax, cfg), _pad_field(vay, cfg),
            _pad_field(vaz, cfg),
            act_next, step_no + 1, drift,
        )

    def unsort_state(ctx, carry, state: FluidState) -> FluidState:
        xs, ys, zs, vtx, vty, vtz, act, step_no, _drift = carry
        order = ctx["order"]

        def unsort(a_sorted):
            return jnp.zeros(n, jnp.float32).at[order].set(a_sorted[:n])

        return FluidState(
            pos=vec3.merge(vec3.V3(unsort(xs), unsort(ys), unsort(zs))),
            vel=vec3.merge(vec3.V3(unsort(vtx), unsort(vty), unsort(vtz))),
            ptype=state.ptype,
            normal=state.normal,
            muscle_activation=act,
            step=step_no,
        )

    return sort_ctx, carry_of, inner_step, unsort_state


def make_fast_multi_step(params, layout, cfg, n_steps: int = 1,
                         return_drift: bool = False):
    """Jitted run(state, springs, membranes) -> state after n_steps.

    ``return_drift``: also return the window-staleness bound — the max
    over resort periods of (sum over the period's steps of the per-step
    max Euclidean displacement). 2x this bounds how far any PAIR can have
    approached while the period's windows were stale.

    Resorts every ``cfg.resort_every`` steps; between resorts the physics
    scans in sorted space with cached window tables. The sorted-space scan
    is NESTED (an outer scan over <=10-step inner scans), which keeps
    every loop body at <=10 steps whatever the resort period."""
    sort_ctx, carry_of, inner_step, unsort_state = _make_step_parts(
        params, layout, cfg
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
            ctx = sort_ctx(state, springs, membranes)
            carry = carry_of(ctx, state)
            carry = scan_steps(ctx, carry, r_steps)
            return unsort_state(ctx, carry, state), carry[-1]

        drift = jnp.zeros((), jnp.float32)
        if full:
            def body(c, _):
                s, d = c
                s2, d2 = sweep(s, r_every)
                return (s2, jnp.maximum(d, d2)), None

            (state, drift), _ = jax.lax.scan(
                body, (state, drift), None, length=full,
            )
        if rem:
            state, d2 = sweep(state, rem)
            drift = jnp.maximum(drift, d2)
        if return_drift:
            return state, drift
        return state

    return run


def make_fast_stepper(params, layout, cfg, inner_steps: int = 10):
    """Stateful stepping API: three small jitted functions so the resort
    period is decoupled from compiled graph length. The sorted-space
    context and carry live across calls:

        sort, inner, unsort = make_fast_stepper(params, layout, cfg)
        ctx, carry = sort(state, springs, membranes)
        for _ in range(m):                  # resort period = m*inner_steps
            carry = inner(ctx, carry)
        state = unsort(ctx, carry, state)
    """
    sort_ctx, carry_of, inner_step, unsort_state = _make_step_parts(
        params, layout, cfg
    )

    @jax.jit
    def sort(state, springs, membranes):
        ctx = sort_ctx(state, springs, membranes)
        return ctx, carry_of(ctx, state)

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
