"""Membrane kernel vs an independent f64 transcription.

Without this oracle the most intricate reference kernel
(`sphFluid.cl:1369-1682`, computeInteractionWithMembranes) would be
validated only by a synthetic direction test and fast-vs-exact parity —
which compares the same rewrite against itself. ``oracle.membrane_interaction``
is a literal f64 transcription of the LIVE reference path (per-jd
averaged Cramer-projection normals, z-zeroed neighbor distance, Ihmsen
sums, liquid-only application, degenerate-abort), against which the
engine is tested here on the worm's REAL membrane mesh, and the two
documented deviations (3D distance vs z-zeroed, cl:1439; masked vs
aborted degenerates, cl:1468/1501) are quantified.
"""
import numpy as np
import pytest

import oracle
from sph_jax.config import SimParams
from sph_jax.constants import LIQUID_PARTICLE
from sph_jax.core.membranes import membrane_position_correction
from sph_jax.core.neighbors import NeighborList
from sph_jax.core.state import Membranes
from sph_jax.core.step import multi_step
from sph_jax.ops import vec3
from sph_jax.scene.scene import Scene

MAXN = 32


def _nbrs_to_list(nbrs, n):
    idx = np.full((n, MAXN), -1, np.int32)
    for i, lst in enumerate(nbrs):
        for s, (j, _) in enumerate(lst):
            idx[i, s] = j
    return NeighborList(
        idx=idx, q=np.zeros((n, MAXN), np.float32), valid=idx >= 0
    )


def _engine_membrane(pos, ptype, nbrs, tris, particle_tris, params):
    """Run the engine's membrane stage on explicit inputs (f32)."""
    n = len(pos)
    mem = Membranes(
        tris=np.asarray(tris, np.int32),
        particle_tris=np.asarray(particle_tris, np.int32),
    )
    out = membrane_position_correction(
        vec3.split(np.asarray(pos, np.float32)),
        np.asarray(ptype, np.int32),
        _nbrs_to_list(nbrs, n), mem, params,
    )
    return np.stack([np.asarray(out.x), np.asarray(out.y),
                     np.asarray(out.z)], axis=1)


def worm_membrane_patch(radius_h=3.0, max_n=1500):
    """A real patch of the worm: all particles within radius of a
    mid-body membrane triangle centroid, triangle list remapped."""
    params = SimParams()
    from sph_jax.scene import generate_worm_scene

    scene = generate_worm_scene(params)
    pos = np.asarray(scene.pos, np.float64)
    typ = np.asarray(scene.ptype)
    tris = np.asarray(scene.tris)
    assert len(tris) > 0
    # mid-body triangle whose surroundings contain liquid
    cent = pos[tris].mean(axis=1)
    mid = np.argsort(np.abs(cent[:, 2] - np.median(cent[:, 2])))[0]
    c = cent[mid]
    d = np.linalg.norm(pos - c, axis=1)
    keep = d <= radius_h * params.h
    if keep.sum() > max_n:
        keep &= d <= np.sort(d[keep])[max_n - 1]
    ids = np.nonzero(keep)[0]
    remap = -np.ones(len(pos), np.int64)
    remap[ids] = np.arange(len(ids))
    # triangles fully inside the patch
    t_keep = keep[tris].all(axis=1)
    tris_p = remap[tris[t_keep]]
    # rebuild particle_tris (reference particleMembranesList semantics:
    # -1-terminated slots)
    slots = 7
    ptris = np.full((len(ids), slots), -1, np.int32)
    fill = np.zeros(len(ids), np.int32)
    for t, (a, b, cc) in enumerate(tris_p):
        for v in (a, b, cc):
            if fill[v] < slots:
                ptris[v, fill[v]] = t
                fill[v] += 1
    return params, pos[ids], typ[ids], tris_p.astype(np.int32), ptris


@pytest.fixture(scope="module")
def patch():
    return worm_membrane_patch()


def test_engine_matches_oracle_on_worm_mesh(patch):
    """Engine membrane stage vs f64 oracle in ENGINE mode (3D distance,
    masked degenerates) on the worm's real membrane mesh: the rewrite
    (precomputed oriented plane normals instead of per-pair Cramer
    projections) must agree to f32 round-off."""
    params, pos, typ, tris, ptris = patch
    n_liq = int((typ == LIQUID_PARTICLE).sum())
    assert n_liq >= 50, f"patch has too little liquid ({n_liq})"
    nbrs = oracle.exact_neighbors(pos, params.h, MAXN)
    ref = oracle.membrane_interaction(
        pos, typ, nbrs, tris, ptris, params,
        z_zeroed=False, abort_on_degenerate=False,
    )
    moved = np.abs(ref - pos).max()
    assert moved > 0, "patch exercises no membrane interaction"
    got = _engine_membrane(pos, typ, nbrs, tris, ptris, params)
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-4)


def test_deviation_bounds_on_worm_mesh(patch):
    """Quantify the two documented deviations on the real mesh,
    attributing each separately.

    A single particle's correction is bounded by r0 in either mode
    (delta = n_hat * sum(w (r0-d)) / sum(w) with 0 <= r0-d <= r0), so
    any mode pair can disagree by at most 2 r0 — that is the hard
    physical bound asserted here. Of the per-particle deviations:
    z-zeroing the neighbor distance
    (sphFluid.cl:1439) INFLATES Ihmsen weights (d can only shrink), and
    abort-on-degenerate (cl:1468/1501) zeroes whole particles, so
    individual corrections can legitimately differ by the full
    correction scale while the aggregate (mean/affected-count) stays
    small."""
    params, pos, typ, tris, ptris = patch
    nbrs = oracle.exact_neighbors(pos, params.h, MAXN)
    eng = oracle.membrane_interaction(
        pos, typ, nbrs, tris, ptris, params,
        z_zeroed=False, abort_on_degenerate=False,
    )
    dev_by = {}
    for name, kw in (
        ("z_zeroed", dict(z_zeroed=True, abort_on_degenerate=False)),
        ("abort", dict(z_zeroed=False, abort_on_degenerate=True)),
        ("both(reference)", dict(z_zeroed=True, abort_on_degenerate=True)),
    ):
        ref = oracle.membrane_interaction(
            pos, typ, nbrs, tris, ptris, params, **kw)
        d = np.linalg.norm(eng - ref, axis=1)
        dev_by[name] = (float(d.max()), float(d.mean()),
                        int((d > 0).sum()))
    corr = float(np.linalg.norm(eng - pos, axis=1).max())
    moved = int((np.abs(eng - pos).max(axis=1) > 0).sum())
    print(f"membrane one-stage: engine correction max {corr:.3e} over "
          f"{moved} particles; deviation (max, mean, affected) per mode: "
          f"{dev_by}")
    assert corr > 0
    r0 = params.r0
    for name, (dmax, dmean, naff) in dev_by.items():
        assert dmax <= 2 * r0 + 1e-9, (name, dmax, r0)
        # the quirks perturb a handful of particles, not the field:
        # the mean deviation stays far below the max correction
        assert dmean <= 0.05 * corr, (name, dmean, corr)


def test_exact_engine_full_step_with_membranes_vs_oracle():
    """End-to-end: one exact-engine step on a membrane scene vs the f64
    oracle full step WITH membranes (engine-mode flags) — validates the
    stage ORDER (post-integrate, step-start neighbor lists) as well as
    the math."""
    params = SimParams(x_max=8 * 3.34, y_max=8 * 3.34, z_max=8 * 3.34)
    r0 = params.r0
    rng = np.random.default_rng(3)
    # two-triangle elastic quad + a few liquid particles hovering near it
    quad = np.array([
        [8.0, 8.0, 8.0], [8.0 + r0, 8.0, 8.0],
        [8.0, 8.0, 8.0 + r0], [8.0 + r0, 8.0, 8.0 + r0],
    ], np.float64)
    liq = np.array([
        [8.0 + 0.5 * r0, 8.0 + 0.4 * r0, 8.0 + 0.5 * r0],
        [8.0 + 0.2 * r0, 8.0 + 0.5 * r0, 8.0 + 0.8 * r0],
        [8.0 + 0.8 * r0, 8.0 + 0.6 * r0, 8.0 + 0.3 * r0],
    ], np.float64)
    pos = np.concatenate([quad, liq])
    vel = rng.normal(scale=0.01, size=pos.shape)
    color = np.array([2.1] * 4 + [1.1] * 3, np.float32)
    tris = np.array([[0, 1, 2], [1, 3, 2]], np.int32)
    scene = Scene(
        pos=pos.astype(np.float32), vel=vel.astype(np.float32),
        color=color, normal=np.zeros_like(pos, dtype=np.float32),
        tris=tris,
    )
    state, springs, membranes = scene.device_state()
    got = multi_step(state, springs, membranes, params, scene.layout(), 1)

    typ = np.asarray(scene.ptype)
    ptris = np.asarray(scene.particle_tris())
    ref_pos, _, _ = oracle.full_step(
        pos, vel, typ, np.zeros_like(pos), params,
        membranes=(tris, ptris),
        z_zeroed=False, abort_on_degenerate=False,
    )
    np.testing.assert_allclose(
        np.asarray(got.pos), ref_pos, rtol=0, atol=5e-5
    )
    # the membranes actually acted: liquid got pushed off the plane
    assert np.abs(np.asarray(got.pos)[4:] - pos[4:]).max() > 0
