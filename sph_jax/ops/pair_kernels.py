"""Blocked pair-interaction passes — the fast engines' hot ops.

Replaces both the neighbor-list build and every per-neighbor gather of the
reference pipeline (the reference's `src/sphFluid.cl`) with *blocked
all-pairs* passes over cell-sorted particles:

* particles are kept sorted by cell id at h granularity in z-major /
  x-pencil / y-run order (a pencil = one vertical column of cells; y is the
  shortest occupied axis of the reference world box, so pencils are short
  and interaction windows tight);
* an "own" block is ``block`` consecutive sorted particles (dense, no
  padding);
* its interaction candidates are three **contiguous** windows of the sorted
  array — the pencil bands (z-1, z, z+1) x (x span +- 1) covering every cell
  within radius h of the block — walked as ``ccol``-wide tiles with a
  *dynamic* trip count, so each block pays for its actual window, not a
  global worst case;
* windows are exact AT SORT TIME: there is no slab capacity and nothing
  is ever truncated. They have zero Verlet skin, so a pair entering reach h
  between resorts is missed until the next resort — a smooth q~1 boundary
  perturbation, surfaced per resort period by the Simulator as
  ``window_drift_h`` (resort_every=1 restores per-step-exact neighbor
  semantics);
* pair distances and weights are direct f32 differences (no
  |a|^2-2ab+|b|^2 cancellation) and every reduction ``sum_j w_ij * f_j``
  is an f32 row sum of the (block, ccol) pair tile — no neighbor list and
  no pair tile is ever written to device memory.

MASKLESS INVARIANT: the table builders (core.fast._window_tables /
_tile_chunks) emit tiles that are *disjoint and covering* per block — every
in-window column appears in exactly one tile. The passes therefore apply
NO window-validity test per pair:

* any real column a tile covers beyond the pencil-band window is >= h away
  from every own particle at sort time (the bands' +-1-pencil / +-1-row
  margin is exactly the h reach in x and z), where every pair term already
  vanishes (poly6/visc weights hit 0 at q = 1; boundary/membrane weights
  reach only r0 = h/2 on post-step distances);
* pad columns carry ``far`` positions (and zero flags), excluded the same
  way — the caller must pin pad/phantom OWN rows (fast.py pads the
  boundary flag with 1 so they integrate as walls);
* self-interaction is handled per pass: density/rho* subtract the exact
  self term (q = 0 -> poly6 weight exactly 1), the viscosity/surface sums
  vanish on the self pair (ve_i - ve_i = x_i - x_i = 0), pressure/spring
  weights carry a q^2 > 0 factor.

Layout: every field pack is column-major ``[rows, n_alloc]``, so an own
block and a slab tile are contiguous row segments. Tile starts are aligned
to ``ALIGN`` columns.

Two builds of every pass share one ``prep_fn``/``tile_fn`` pair:

* :func:`build_pass` — a Pallas kernel through Triton (``backend="triton"``):
  one program per own block; the program reads its own chunk table
  entries, walks its tiles with a ``fori_loop`` and keeps the sums in
  registers. Compiled on the GPU, interpreted on the CPU (tests).
* :func:`reference_pass` — the same blocked pass in plain ``jax.numpy``:
  a ``vmap`` over blocks of a ``fori_loop`` over ``lax.dynamic_slice``
  tiles. The oracle for the kernels' tests and the on-card check; no
  engine selects it.

Semantic deviation from the reference (documented): the reference caps each
particle at the ~32 nearest neighbors via a histogram threshold
(`sphFluid.cl:207-329`); these passes use *all* pairs within radius h.
Beyond-32 neighbors sit near q = 1 where every kernel term vanishes, so the
physical difference is a boundary-shell correction. The neighbor-list engine
(core/step.py) remains the exact-semantics implementation.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

# Tile start alignment (columns) and warps per kernel program, from the
# H100 sweep on the worm (PERF.md): 8 x 8 tiles, one warp, starts aligned
# to the tile width.
ALIGN = 8
NUM_WARPS = 1


def interpret_for(platform: str) -> bool:
    """Pallas interpret mode for a JAX backend: the CPU interprets (the
    test suite), the GPU compiles, and anything else has no kernel."""
    if platform == "cpu":
        return True
    if platform == "gpu":
        return False
    raise ValueError(
        f"no pair-pass kernel for platform {platform!r} (cpu interprets, "
        "gpu compiles)"
    )


def default_interpret() -> bool:
    return interpret_for(jax.default_backend())


# main pack rows (time-t fields)
MAIN_COLS = 8
(PM_X, PM_Y, PM_Z, PM_VEX, PM_VEY, PM_VEZ, PM_RHO, PM_ISB) = range(8)

# iteration packs
ITER_COLS = 3      # [x*, y*, z*] (predicted positions only)
PACC_COLS = 5      # [x, y, z, rho*, p]

# boundary pack rows
BND_COLS = 7
(PB_X, PB_Y, PB_Z, PB_NX, PB_NY, PB_NZ, PB_ISB) = range(7)

# own pack for the post-integrate passes: [x_t, y_t, z_t, xn, yn, zn]
OWN_COLS = 6

# membrane pack rows: 7 triangles x (n, a) + x(t+1) + x(t)
MEM_COLS = 48
PMM_XN, PMM_YN, PMM_ZN = 42, 43, 44
PMM_XT, PMM_YT, PMM_ZT = 45, 46, 47


def _tile_offset(s, tab, ccol):
    """Slab column of tile s of a block whose three chunks start at
    aligned columns a0..a2 and at tile indices 0, s1, s2."""
    a0, a1, a2, s1, s2 = tab
    return jnp.where(
        s >= s2, a2 + (s - s2) * ccol,
        jnp.where(s >= s1, a1 + (s - s1) * ccol, a0 + s * ccol),
    )


def build_pass(prep_fn, tile_fn, *, n_outputs, block, ccol, n_blocks,
               interpret=False, name="pair_pass"):
    """Pallas/Triton pair pass over ``n_blocks`` own blocks.

    prep_fn(orow) -> own — once per block; orow(a) reads own field a as a
      (block,) vector.
    tile_fn(own, srow, gid, accs) -> accs — per ccol-wide slab tile;
      srow(a) reads slab field a as a (1, ccol) row, gid is the (block,)
      vector of the own rows' pack columns (id-matching passes only), accs
      a tuple of (block,) f32 sums. There is NO per-pair window mask:
      tiles are disjoint + covering (see module docstring).

    Tables arrive in the 6-tuple format of core.fast._window_tables —
    aln/lo/hi/s0 flattened [n_blocks * 3] int32 chunk descriptors, cnt
    [n_blocks] tiles per block, own_base [1] (the pack column of own block
    0; 0 on one device, the halo engine passes its slab offset).
    Returns ``call(tables, own_pack, slab_pack)`` -> tuple of n_outputs
    [n_blocks * block] arrays.
    """

    def kernel(aln_ref, s0_ref, cnt_ref, ob_ref, own_ref, slab_ref,
               *out_refs):
        b = pl.program_id(0)
        base = ob_ref[0] + b * block
        own = prep_fn(lambda a: own_ref[a, pl.ds(base, block)])
        gid = base + jax.lax.broadcasted_iota(jnp.int32, (block,), 0)
        b3 = b * 3
        tab = (aln_ref[b3], aln_ref[b3 + 1], aln_ref[b3 + 2],
               s0_ref[b3 + 1], s0_ref[b3 + 2])

        def body(s, accs):
            off = _tile_offset(s, tab, ccol)
            return tile_fn(
                own, lambda a: slab_ref[a, pl.ds(off, ccol)][None, :],
                gid, accs,
            )

        accs = jax.lax.fori_loop(
            0, cnt_ref[b], body,
            tuple(jnp.zeros((block,), jnp.float32)
                  for _ in range(n_outputs)),
        )
        for ref, acc in zip(out_refs, accs):
            ref[...] = acc

    out_shape = tuple(
        jax.ShapeDtypeStruct((n_blocks * block,), jnp.float32)
        for _ in range(n_outputs)
    )
    out_specs = tuple(
        pl.BlockSpec((block,), lambda b: (b,)) for _ in range(n_outputs)
    )

    def call(tables, own_pack, slab_pack):
        aln, _, _, s0, cnt, ob = tables
        return pl.pallas_call(
            kernel,
            grid=(n_blocks,),
            out_specs=out_specs,
            out_shape=out_shape,
            interpret=interpret,
            backend="triton",
            compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS),
            name=name,
        )(aln, s0, cnt, ob, own_pack, slab_pack)

    return call


def reference_pass(prep_fn, tile_fn, *, n_outputs, block, ccol, n_blocks,
                   **_):
    """The plain jax.numpy build of :func:`build_pass` (same contract):
    a vmap over blocks of a fori_loop over ``lax.dynamic_slice`` tiles."""

    def call(tables, own_pack, slab_pack):
        aln, _, _, s0, cnt, ob = tables
        rows = slab_pack.shape[0]

        def one_block(b):
            base = ob[0] + b * block
            own = prep_fn(
                lambda a: jax.lax.dynamic_slice(own_pack[a], (base,),
                                                (block,)))
            gid = base + jnp.arange(block, dtype=jnp.int32)
            tab = (aln[3 * b], aln[3 * b + 1], aln[3 * b + 2],
                   s0[3 * b + 1], s0[3 * b + 2])

            def body(s, accs):
                tile = jax.lax.dynamic_slice(
                    slab_pack, (0, _tile_offset(s, tab, ccol)),
                    (rows, ccol))
                return tile_fn(own, lambda a: tile[a][None, :], gid, accs)

            return jax.lax.fori_loop(
                0, cnt[b], body,
                tuple(jnp.zeros((block,), jnp.float32)
                      for _ in range(n_outputs)),
            )

        outs = jax.vmap(one_block)(jnp.arange(n_blocks, dtype=jnp.int32))
        return tuple(o.reshape(-1) for o in outs)

    return call


def _cols(orow, rows):
    """Own fields as (block, 1) columns for pair broadcasts."""
    return [orow(a)[:, None] for a in rows]


def _diff(oc, srow, row0=0):
    """Pair differences own - slab (block, ccol) of the 3 own columns oc
    and slab rows [row0, +3), and their squared norm."""
    dx = oc[0] - srow(row0)
    dy = oc[1] - srow(row0 + 1)
    dz = oc[2] - srow(row0 + 2)
    return dx, dy, dz, dx * dx + dy * dy + dz * dz


def _rsum(w):
    return jnp.sum(w, axis=1)


def make_density_pass(*, block, ccol, n_blocks, inv_h2, c_rho,
                      interpret=False, raw=False, name="density_pass", **_):
    """rho_i = c_rho * max(1, sum_{j != i} poly6 over pairs q^2 <= 1)
    (sphFluid.cl:472-518, all-pairs form) — also the predicted density
    rho* of the PCISPH loop (sphFluid.cl:982-1059) on a pack of predicted
    positions.

    Maskless: the tile accumulates t^3 with t = max(h^2 - r^2, 0) — zero
    for every column beyond the window, and the 1/h^2 scale is folded into
    the output constants; the exact self term (r = 0 -> t^3 = (h^2)^3 in
    f32 rounding) is subtracted after the reduction.

    Documented rho* deviation: the reference restricts the pair set to the
    time-t neighborMap in addition to the predicted-distance cutoff;
    prediction displacement per iteration is ~1e-3 h, so the symmetric
    difference lies in the q* ~ 1 shell where (1-q*^2)^3 ~ 1e-9 — below
    f32 round-off of the sum.

    ``raw=True`` returns the bare t^3 pair sums (NO self-term subtraction
    or c_rho clamp): the wall-compact engine (core/fastw.py) splits each
    density into several column-set passes (moving/shell/wall) and must
    combine the raw sums before the single clamp."""
    h2 = np.float32(1.0) / np.float32(inv_h2)
    self3 = np.float32(h2 * h2) * h2             # f32-rounded (h^2)^3
    inv_h6 = np.float32(inv_h2) * np.float32(inv_h2) * np.float32(inv_h2)

    def prep(orow):
        return _cols(orow, range(3))

    def tile(oc, srow, gid, accs):
        t = jnp.maximum(h2 - _diff(oc, srow)[3], 0.0)
        (acc,) = accs
        return (acc + _rsum(t * t * t),)

    raw_call = build_pass(prep, tile, n_outputs=1, block=block, ccol=ccol,
                          n_blocks=n_blocks, interpret=interpret, name=name)

    if raw:
        def call_raw(tables, own_pack, slab_pack):
            return raw_call(tables, own_pack, slab_pack)[0]

        return call_raw

    def call(tables, own_pack, slab_pack):
        # subtract the exact self term (included maskless); rows with a
        # zeroed tile count (gated far walls, phantoms) sum 0 and clamp
        # to c_rho
        (s,) = raw_call(tables, own_pack, slab_pack)
        return c_rho * jnp.maximum((s - self3) * inv_h6, 1.0)

    return call


def make_viscsurf_pass(*, block, ccol, n_blocks, inv_h2, interpret=False,
                       **_):
    """Fused viscosity + surface-tension pair sums (sphFluid.cl:589-708),
    over q < 1 pairs: visc = sum (ve_j - ve_i)(1-q)/rho_j, surf = sum
    (x_i - x_j). Boundary neighbors contribute wall normals as velocity
    (pack's VE rows pre-substituted). Outputs (vx, vy, vz, sx, sy, sz).

    The PM_RHO slab row carries 1/rho (pre-inverted by the caller: one
    reciprocal per particle instead of one divide per pair).

    Maskless: wv = max(1-q, 0)/rho_j and the q < 1 indicator vanish
    beyond the window; the self pair contributes ve_i - ve_i = 0 and
    x_i - x_i = 0."""
    h = np.float32(1.0) / np.float32(np.sqrt(inv_h2))
    h2 = np.float32(1.0) / np.float32(inv_h2)

    def prep(orow):
        return _cols(orow, (PM_X, PM_Y, PM_Z, PM_VEX, PM_VEY, PM_VEZ))

    def tile(oc, srow, gid, accs):
        # r-domain: t = max(h - r, 0) = h * max(1 - q, 0); the extra h
        # factor is divided back out of the reduced outputs in call()
        dx, dy, dz, r2 = _diff(oc, srow)
        wv = jnp.maximum(h - jnp.sqrt(r2), 0.0) * srow(PM_RHO)
        ws = jnp.where(r2 < h2, 1.0, 0.0)
        vx, vy, vz, stx, sty, stz = accs
        return (vx + _rsum(wv * (srow(PM_VEX) - oc[3])),
                vy + _rsum(wv * (srow(PM_VEY) - oc[4])),
                vz + _rsum(wv * (srow(PM_VEZ) - oc[5])),
                stx + _rsum(ws * dx), sty + _rsum(ws * dy),
                stz + _rsum(ws * dz))

    raw = build_pass(prep, tile, n_outputs=6, block=block, ccol=ccol,
                     n_blocks=n_blocks, interpret=interpret,
                     name="viscsurf_pass")
    inv_h = np.float32(np.sqrt(inv_h2))

    def call(tables, own_pack, slab_pack):
        vx, vy, vz, stx, sty, stz = raw(tables, own_pack, slab_pack)
        return vx * inv_h, vy * inv_h, vz * inv_h, stx, sty, stz

    return call


def make_paccel_pass(*, block, ccol, n_blocks, inv_h2, inv_h, rho0_delta,
                     interpret=False, **_):
    """Pressure-force pair sums (sphFluid.cl:1101-1212): for 0 < q < 1
    pairs, term = (1-q)^2 * 0.5 * (p_i + p_j)/rho*_j, anti-clump
    substitution below q = 0.25; direction = unit(x_i - x_j), scaled by
    inv_h to match the reference's spiky gradient (applied once to the
    reduced outputs, not per pair).
    Pack rows: [x, y, z, 1/rho*, p] (time-t positions; rho* pre-inverted
    by the caller).
    Maskless: the r^2 > 0 factor excludes self (and coincident pairs,
    matching the reference's zero-distance guard); beyond the window the
    far branch max(1-q, 0)^2 vanishes and q >= 1 > 0.25 never selects the
    close branch, so no q < 1 test is needed."""
    h = np.float32(1.0) / np.float32(inv_h)
    h4 = np.float32(h / 4.0)
    rho0_delta_f = np.float32(rho0_delta)

    def prep(orow):
        return _cols(orow, range(5))

    def tile(oc, srow, gid, accs):
        # r-domain: every q-term is computed as h*(that term) so the
        # inv_h2 pair-scale and the common 0.5 factor fold into the
        # output constant in call()
        dx, dy, dz, r2 = _diff(oc, srow)
        # one rsqrt yields both r (= r2 * rsqrt(r2)) and 1/r
        inv_r = jax.lax.rsqrt(jnp.maximum(r2, 1e-30))
        r = r2 * inv_r
        t = jnp.maximum(h - r, 0.0)              # h * (1 - q)
        far = t * t * (oc[4] + srow(4))
        cm = h4 - r                              # h * (0.25 - q)
        close = cm * cm * rho0_delta_f
        term = jnp.where(cm > 0.0, close, far) * srow(3)  # row 3: 1/rho*
        w = jnp.where(r2 > 0.0, term * inv_r, 0.0)
        ax, ay, az = accs
        return ax + _rsum(w * dx), ay + _rsum(w * dy), az + _rsum(w * dz)

    raw = build_pass(prep, tile, n_outputs=3, block=block, ccol=ccol,
                     n_blocks=n_blocks, interpret=interpret,
                     name="paccel_pass")
    # in-kernel w = 2h * (reference w): the r-domain terms carry h^2 and
    # drop the common 0.5; with the reference's final inv_h gradient
    # scale the reduced outputs need x inv_h/(2h) = 0.5 * inv_h^2
    out_c = np.float32(0.5) * np.float32(inv_h) * np.float32(inv_h)

    def call(tables, own_pack, slab_pack):
        fx, fy, fz = raw(tables, own_pack, slab_pack)
        return fx * out_c, fy * out_c, fz * out_c

    return call


# spring pack rows: 0-2 elastic positions, then n_slots neighbor sorted
# ids (f32, -1 pad), n_slots rest lengths (m), n_slots activation force
# terms — n_slots is the scene's max spring degree (the reference's fixed
# 32-slot table is mostly padding: the worm's max degree is 16).
SPR_IDX0 = 3


def spr_cols(n_slots: int) -> int:
    return 3 + 3 * n_slots


def make_spring_pass(*, block, ccol, n_blocks, inv_h, h_scale, k_spring,
                     n_slots=32, interpret=False, **_):
    """Elastic + muscle spring forces as a pair pass over the COMPACT
    elastic slab (sphFluid.cl:709-815), replacing [Ne, 32] position
    gathers.

    The slab lists each elastic particle j's spring partners as sorted row
    ids; a pair (own i, slab j) matches when i appears in j's list (the
    graph is symmetric). Matching uses NO radius cutoff: a spring acts
    whenever its partner column lands in the block's tiles, and the
    engines' spring tables (core.fast._spring_chunks) cover every
    partner, however far the spring is stretched.

    Own pack = the main pack (positions at rows 0-2). Outputs (ax, ay, az)
    in scaled-SI acceleration units. The (r - rest) difference cancels
    heavily, so every term stays in f32 (a 1e-3 operand rounding here
    becomes a several-percent spring-force error).
    """

    def prep(orow):
        return _cols(orow, range(3))

    def tile(oc, srow, gid, accs):
        # dx etc. in sim units; q2 = dist^2 / h^2
        dx, dy, dz, r2 = _diff(oc, srow)
        q2 = r2 * (inv_h * inv_h)
        gid_f = gid.astype(jnp.float32)[:, None]

        msum = jnp.zeros_like(q2)
        rest_acc = jnp.zeros_like(q2)
        actf_acc = jnp.zeros_like(q2)
        for s in range(n_slots):
            m = jnp.where(srow(SPR_IDX0 + s) == gid_f, 1.0, 0.0)
            msum = msum + m
            rest_acc = rest_acc + m * srow(SPR_IDX0 + n_slots + s)
            actf_acc = actf_acc + m * srow(SPR_IDX0 + 2 * n_slots + s)

        inv_q = jax.lax.rsqrt(jnp.maximum(q2, 1e-30))
        r_m = q2 * inv_q * h_scale                  # r in meters
        coef = -(r_m * msum - rest_acc) * k_spring - actf_acc
        ok = (msum > 0.0) & (q2 > 0.0)
        # accel = (x_i - x_j)_m / r_m * coef; on sim-unit dx that is
        # dx * coef * rsqrt(q2) / h
        w = jnp.where(ok, coef * inv_q * inv_h, 0.0)
        ax, ay, az = accs
        return ax + _rsum(w * dx), ay + _rsum(w * dy), az + _rsum(w * dz)

    return build_pass(prep, tile, n_outputs=3, block=block, ccol=ccol,
                      n_blocks=n_blocks, interpret=interpret,
                      name="spring_pass")


def make_boundary_pass(*, block, ccol, n_blocks, inv_h2, r0,
                       interpret=False, **_):
    """Ihmsen boundary-response pair sums (sphFluid.cl:824-887).

    own pack rows: [x_t, y_t, z_t, xn, yn, zn]; slab = boundary pack.
    Pair set: slab is boundary; weights from the distance of the *new*
    own position to the boundary particle.
    Outputs: n_ci (3), w_sum, w2_sum."""
    inv_r0 = np.float32(1.0 / r0)

    def prep(orow):
        return _cols(orow, range(3, 6))

    def tile(on, srow, gid, accs):
        # no self-exclusion: own boundary rows that would self-pair have
        # their outputs pinned by the caller anyway. The reference's
        # additional time-t h-cutoff is dropped: the weight reaches only
        # r0 = h/2 on post-step distances, so a pair it would exclude
        # must close from > h to < h/2 in ONE step — CFL-violating.
        # Multiplying by the {0,1} isb flag masks pad columns (which are
        # also far) and, on the halo engine's full slab, moving columns.
        dist = jnp.sqrt(_diff(on, srow, PB_X)[3])
        w = jnp.maximum(0.0, (r0 - dist) * inv_r0) * srow(PB_ISB)
        ax, ay, az, ws, w2 = accs
        return (ax + _rsum(w * srow(PB_NX)), ay + _rsum(w * srow(PB_NY)),
                az + _rsum(w * srow(PB_NZ)), ws + _rsum(w),
                w2 + _rsum(w * (r0 - dist)))

    return build_pass(prep, tile, n_outputs=5, block=block, ccol=ccol,
                      n_blocks=n_blocks, interpret=interpret,
                      name="boundary_pass")


def make_membrane_pass(*, block, ccol, n_blocks, inv_h2, r0,
                       interpret=False, **_):
    """Membrane interaction pair sums (sphFluid.cl:1369-1650).

    own pack rows: [x_t, y_t, z_t, xn, yn, zn]; slab = membrane pack: per
    particle 7 x (plane normal, ref point) at rows 6t..6t+5 (zeros when
    absent), rows 42-44 x(t+1), rows 45-47 x(t). Blocks without
    liquid-near-membrane work have their tile count zeroed by the caller.
    Maskless: out-of-window columns are >= h away, where the r0-reach
    weight vanishes; non-membrane columns carry all-zero triangle normals
    (cnt = 0 excludes them); own rows receiving the correction are
    liquid-masked by the caller.
    Outputs: n_ci (3), w_sum, w2_sum.

    The signed triangle normals are combined into ONE per-pair vector
    v = sum_t sgn_t * n_t (3 madds per triangle) before the row sums."""

    def prep(orow):
        return _cols(orow, range(3, 6))

    def tile(on, srow, gid, accs):
        # (the reference's additional time-t h-cutoff is dropped, same
        # CFL argument as the boundary pass: the weight reaches only
        # r0 = h/2 on post-step distances)
        xno, yno, zno = on
        # per-triangle side signs: s = nt . (xn_own - at); nt == 0 rows
        # (absent triangles) give |nt|^2 == 0 and are skipped via has_t
        cnt = vx = vy = vz = 0.0
        for t in range(7):
            ntx = srow(6 * t + 0)
            nty = srow(6 * t + 1)
            ntz = srow(6 * t + 2)
            s = ((xno - srow(6 * t + 3)) * ntx + (yno - srow(6 * t + 4)) * nty
                 + (zno - srow(6 * t + 5)) * ntz)
            has_t = (ntx * ntx + nty * nty + ntz * ntz > 0.0) & (s != 0.0)
            sgn = jnp.where(has_t, jnp.sign(s), 0.0)
            cnt = cnt + jnp.abs(sgn)
            vx = vx + sgn * ntx
            vy = vy + sgn * nty
            vz = vz + sgn * ntz

        dist = jnp.sqrt(_diff(on, srow, PMM_XN)[3])
        w = jnp.where(cnt > 0.0, jnp.maximum(0.0, (r0 - dist) / r0), 0.0)
        wc = w / jnp.maximum(cnt, 1.0)
        ax, ay, az, ws, w2 = accs
        return (ax + _rsum(wc * vx), ay + _rsum(wc * vy),
                az + _rsum(wc * vz), ws + _rsum(w),
                w2 + _rsum(w * (r0 - dist)))

    return build_pass(prep, tile, n_outputs=5, block=block, ccol=ccol,
                      n_blocks=n_blocks, interpret=interpret,
                      name="membrane_pass")
