"""Physics-equivalence tests: f32 step vs float64 reference oracle."""
import numpy as np
import jax.numpy as jnp

import oracle
from sph_jax.config import SimParams
from sph_jax.constants import (
    BOUNDARY_PARTICLE,
    ELASTIC_PARTICLE,
    LIQUID_PARTICLE,
    MAX_NEIGHBORS,
    MUSCLE_COUNT,
)
from sph_jax.core.elastic import add_elastic_forces
from sph_jax.core.grid import build_grid
from sph_jax.core.neighbors import find_neighbors
from sph_jax.core.pcisph import (
    compute_density,
    compute_external_forces,
    integrate,
    pcisph_pressure_loop,
)
from sph_jax.core.state import FluidState, Springs, empty_membranes, empty_springs
from sph_jax.ops import vec3
from sph_jax.core.step import SceneLayout, simulation_step


def small_params(**kw):
    h = 3.34
    d = dict(x_max=8 * h, y_max=8 * h, z_max=8 * h, cell_capacity=80)
    d.update(kw)
    return SimParams(**d)


def liquid_blob(params, n_side=6, seed=0, vel_scale=0.05):
    """Jittered lattice at ~r0 spacing (realistic SPH density)."""
    rng = np.random.default_rng(seed)
    r0 = params.r0
    base = np.array(params.box_min) + 2.0
    ax = np.arange(n_side) * r0
    g = np.stack(np.meshgrid(ax, ax, ax, indexing="ij"), -1).reshape(-1, 3)
    pos = base + g + rng.uniform(-0.05, 0.05, g.shape) * r0
    vel = rng.normal(scale=vel_scale, size=pos.shape)
    return pos.astype(np.float32), vel.astype(np.float32)


def boundary_floor(params, y=1.0):
    """A one-layer floor plate with +y normals at spacing r0."""
    r0 = params.r0
    xs = np.arange(1.0, params.x_max - 1.0, r0)
    zs = np.arange(1.0, params.z_max - 1.0, r0)
    g = np.stack(np.meshgrid(xs, zs, indexing="ij"), -1).reshape(-1, 2)
    pos = np.stack([g[:, 0], np.full(len(g), y), g[:, 1]], -1)
    normal = np.tile(np.array([[0.0, 1.0, 0.0]]), (len(g), 1))
    return pos.astype(np.float32), normal.astype(np.float32)


def jax_neighbors(pos, params):
    v = vec3.split(jnp.asarray(pos))
    grid = build_grid(v, params)
    ids = jnp.arange(len(pos), dtype=jnp.int32)
    return find_neighbors(v, ids, v, grid, params)


def test_density_matches_oracle():
    params = small_params()
    pos, _ = liquid_blob(params)
    nbrs = jax_neighbors(pos, params)
    rho = np.asarray(compute_density(nbrs, params))

    onbrs = oracle.exact_neighbors(pos.astype(np.float64), params.h)
    orho = oracle.density(pos.astype(np.float64), onbrs, params)
    np.testing.assert_allclose(rho, orho, rtol=5e-5)
    # near a filled lattice at r0 spacing the density should be near rho0
    interior = rho[np.argsort(rho)[len(rho) // 2]]
    assert 0.3 * params.rho0 < interior < 3.0 * params.rho0


def test_external_forces_match_oracle():
    params = small_params()
    pos, vel = liquid_blob(params)
    n = len(pos)
    ptype = np.full(n, LIQUID_PARTICLE, np.int32)
    normal = np.zeros((n, 3), np.float32)
    nbrs = jax_neighbors(pos, params)
    rho = compute_density(nbrs, params)
    a = np.asarray(vec3.merge(
        compute_external_forces(
            vec3.split(jnp.asarray(pos)), vec3.split(jnp.asarray(vel)), rho,
            jnp.asarray(ptype), nbrs, params,
            normal_g=vec3.split(jnp.asarray(normal)),
        )
    ))
    onbrs = oracle.exact_neighbors(pos.astype(np.float64), params.h)
    orho = oracle.density(pos.astype(np.float64), onbrs, params)
    oa = oracle.external_forces(
        pos.astype(np.float64), vel.astype(np.float64), orho,
        ptype, normal.astype(np.float64), onbrs, params,
    )
    scale = np.abs(oa).max()
    np.testing.assert_allclose(a, oa, atol=2e-5 * scale, rtol=2e-4)


def test_pressure_loop_matches_oracle():
    params = small_params()
    pos, vel = liquid_blob(params)
    n = len(pos)
    ptype = np.full(n, LIQUID_PARTICLE, np.int32)
    nbrs = jax_neighbors(pos, params)
    res = pcisph_pressure_loop(
        vec3.split(jnp.asarray(pos)), vec3.split(jnp.asarray(vel)),
        jnp.asarray(ptype), nbrs, params
    )
    p_jax = np.asarray(res.pressure)
    ap_jax = np.asarray(vec3.merge(res.a_p))

    onbrs = oracle.exact_neighbors(pos.astype(np.float64), params.h)
    p_o, ap_o = oracle.pcisph_loop(
        pos.astype(np.float64), vel.astype(np.float64), ptype, onbrs, params
    )
    p_scale = max(np.abs(p_o).max(), 1e-12)
    a_scale = max(np.abs(ap_o).max(), 1e-12)
    np.testing.assert_allclose(p_jax, p_o, atol=5e-4 * p_scale, rtol=5e-4)
    np.testing.assert_allclose(ap_jax, ap_o, atol=1e-3 * a_scale, rtol=5e-3)


def _run_full_step_comparison(pos, vel, ptype, normal, params,
                              springs_jax=None, springs_oracle=None,
                              activation=None):
    n = len(pos)
    state = FluidState(
        pos=jnp.asarray(pos), vel=jnp.asarray(vel),
        ptype=jnp.asarray(ptype), normal=jnp.asarray(normal),
        muscle_activation=jnp.asarray(
            activation if activation is not None
            else np.zeros(MUSCLE_COUNT, np.float32)
        ),
        step=jnp.zeros((), jnp.int32),
    )
    layout = SceneLayout(n_particles=n)
    sj = springs_jax if springs_jax is not None else empty_springs()
    new = simulation_step(state, sj, empty_membranes(n), params, layout)

    o_pos, o_vel, _ = oracle.full_step(
        pos, vel, ptype, normal.astype(np.float64), params,
        springs=springs_oracle,
        activation=activation,
    )
    dx_o = o_pos - pos
    dx_j = np.asarray(new.pos) - pos
    moving = ptype != BOUNDARY_PARTICLE
    dscale = max(np.abs(dx_o[moving]).max(), 1e-12)
    vscale = max(np.abs(o_vel[moving]).max(), 1e-12)
    np.testing.assert_allclose(
        dx_j[moving], dx_o[moving], atol=2e-3 * dscale, rtol=2e-3
    )
    np.testing.assert_allclose(
        np.asarray(new.vel)[moving], o_vel[moving],
        atol=2e-3 * vscale, rtol=2e-3,
    )
    # boundary rows must be exactly frozen
    np.testing.assert_array_equal(np.asarray(new.pos)[~moving], pos[~moving])
    np.testing.assert_array_equal(np.asarray(new.vel)[~moving], vel[~moving])


def test_full_step_liquid_only():
    params = small_params()
    pos, vel = liquid_blob(params)
    n = len(pos)
    ptype = np.full(n, LIQUID_PARTICLE, np.int32)
    normal = np.zeros((n, 3), np.float32)
    _run_full_step_comparison(pos, vel, ptype, normal, params)


def test_full_step_with_boundary_floor():
    params = small_params()
    bpos, bnorm = boundary_floor(params, y=1.0)
    lpos, lvel = liquid_blob(params, n_side=5, seed=4)
    # drop the blob close to the floor so the boundary response activates
    lpos[:, 1] = lpos[:, 1] - lpos[:, 1].min() + 1.0 + 0.6 * params.r0
    lvel[:, 1] -= 0.2
    pos = np.concatenate([lpos, bpos])
    vel = np.concatenate([lvel, np.zeros_like(bpos)])
    normal = np.concatenate([np.zeros_like(lpos), bnorm])
    ptype = np.concatenate([
        np.full(len(lpos), LIQUID_PARTICLE, np.int32),
        np.full(len(bpos), BOUNDARY_PARTICLE, np.int32),
    ])
    _run_full_step_comparison(pos, vel, ptype, normal, params)


def make_chain_springs(ids, pos, params, muscle_id=0):
    """Chain of springs along consecutive ids, rest = current length."""
    ne = len(ids)
    idx = np.full((ne, MAX_NEIGHBORS), -1, np.int32)
    rest = np.zeros((ne, MAX_NEIGHBORS), np.float32)
    mus = np.zeros((ne, MAX_NEIGHBORS), np.int32)
    olist = []
    for a in range(ne):
        conns = []
        slot = 0
        for b in (a - 1, a + 1):
            if 0 <= b < ne:
                i, j = ids[a], ids[b]
                r = np.linalg.norm(
                    (pos[i] - pos[j]) * params.simulation_scale
                )
                idx[a, slot] = j
                rest[a, slot] = r * 0.98  # pre-stretched 2%
                mus[a, slot] = muscle_id
                conns.append((j, r * 0.98, muscle_id))
                slot += 1
        olist.append((ids[a], conns))
    springs = Springs(
        row_ids=jnp.asarray(np.array(ids, np.int32)),
        idx=jnp.asarray(idx),
        rest=jnp.asarray(rest),
        muscle=jnp.asarray(mus),
    )
    return springs, olist


def test_full_step_with_springs_and_muscle():
    params = small_params()
    pos, vel = liquid_blob(params, n_side=5, seed=7)
    n = len(pos)
    ptype = np.full(n, LIQUID_PARTICLE, np.int32)
    ptype[:10] = ELASTIC_PARTICLE
    normal = np.zeros((n, 3), np.float32)
    springs, olist = make_chain_springs(
        list(range(10)), pos.astype(np.float64), params, muscle_id=3
    )
    activation = np.zeros(MUSCLE_COUNT, np.float32)
    activation[2] = 0.7  # muscle id 3 active
    _run_full_step_comparison(
        pos, vel, ptype, normal, params,
        springs_jax=springs, springs_oracle=olist, activation=activation,
    )


def test_elastic_force_unit():
    params = small_params()
    pos = np.array(
        [[5.0, 5.0, 5.0], [5.0 + params.r0, 5.0, 5.0]], np.float32
    )
    # one spring stretched 10% beyond rest
    rest = params.r0 * params.simulation_scale * 0.9
    springs = Springs(
        row_ids=jnp.asarray(np.array([0], np.int32)),
        idx=jnp.asarray(np.array([[1] + [-1] * 31], np.int32)),
        rest=jnp.asarray(np.array([[rest] + [0] * 31], np.float32)),
        muscle=jnp.asarray(np.zeros((1, 32), np.int32)),
    )
    a = np.asarray(vec3.merge(
        add_elastic_forces(
            vec3.split(jnp.zeros((2, 3))), vec3.split(jnp.asarray(pos)),
            springs, jnp.zeros(MUSCLE_COUNT), params,
        )
    ))
    r = params.r0 * params.simulation_scale
    # stretched spring pulls particle 0 toward its +x neighbor:
    # a0 = -(d/r)(r-rest)k with d = x0-x1 = (-r, 0, 0)
    expect_x = (r - rest) * params.k_spring
    np.testing.assert_allclose(a[0], [expect_x, 0, 0], rtol=1e-4)
    np.testing.assert_allclose(a[1], 0.0)


def test_multi_step_cached_neighbors():
    """multi_step_cached (the practical-cost dense-scene oracle): at
    refresh_every=1 it is BIT-identical to multi_step (same index order,
    same f32 distance arithmetic); at refresh_every=3 over 6 gentle steps
    the stale-index deviation stays in the q~1 round-off class."""
    from sph_jax.core.state import make_state
    from sph_jax.core.step import multi_step, multi_step_cached

    params = small_params()
    pos, vel = liquid_blob(params, n_side=6, seed=2, vel_scale=0.02)
    n = len(pos)
    ptype = np.full(n, LIQUID_PARTICLE, np.int32)
    state = make_state(pos, vel, ptype, np.zeros((n, 3), np.float32))
    springs = empty_springs()
    membranes = empty_membranes(n)
    lay = SceneLayout(n_particles=n, liquid_range=(0, n))

    ref = multi_step(state, springs, membranes, params, lay, 6)
    exact1 = multi_step_cached(state, springs, membranes, params, lay, 6,
                               refresh_every=1)
    np.testing.assert_array_equal(np.asarray(exact1.pos),
                                  np.asarray(ref.pos))
    np.testing.assert_array_equal(np.asarray(exact1.vel),
                                  np.asarray(ref.vel))

    cached3 = multi_step_cached(state, springs, membranes, params, lay, 6,
                                refresh_every=3)
    assert int(cached3.step) == 6
    d = np.abs(np.asarray(cached3.pos) - np.asarray(ref.pos)).max()
    assert np.isfinite(np.asarray(cached3.pos)).all()
    assert d < 5e-3, d
