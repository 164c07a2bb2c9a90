"""Hash-grid and neighbor-search tests against brute-force NumPy oracles."""
import numpy as np
import pytest

pytestmark = pytest.mark.smoke
import jax.numpy as jnp

from sph_jax.config import SimParams
from sph_jax.core.grid import build_grid, cell_coords_of, linear_cell_id
from sph_jax.core.neighbors import find_neighbors
from sph_jax.ops import vec3


def small_params(**kw):
    """A small test world: 8h x 8h x 8h box."""
    h = 3.34
    defaults = dict(
        x_max=8 * h, y_max=8 * h, z_max=8 * h, cell_capacity=64
    )
    defaults.update(kw)
    return SimParams(**defaults)


def random_cloud(n, params, seed=0, margin=0.01):
    rng = np.random.default_rng(seed)
    lo = np.array(params.box_min) + margin
    hi = np.array(params.box_max) - margin
    return rng.uniform(lo, hi, size=(n, 3)).astype(np.float32)


def test_grid_csr_consistency():
    params = small_params()
    pos = random_cloud(500, params)
    grid = build_grid(vec3.split(jnp.asarray(pos)), params)

    coords = np.stack([np.asarray(grid.ccx), np.asarray(grid.ccy),
                       np.asarray(grid.ccz)], axis=1)
    order = np.asarray(grid.order)
    start = np.asarray(grid.cell_start)

    # oracle cell ids
    c = ((pos - np.array(params.box_min)) / params.cell_size).astype(np.int64)
    nx, ny, nz = params.grid_dims
    lin = c[:, 0] + nx * (c[:, 1] + ny * c[:, 2])
    np.testing.assert_array_equal(
        coords, np.clip(c, 0, np.array(params.grid_dims) - 1)
    )

    # CSR: for every cell, order[start[c]:start[c+1]] holds exactly the
    # particles of that cell.
    assert start[0] == 0 and start[-1] == len(pos)
    for cell in np.unique(lin):
        got = np.sort(order[start[cell]: start[cell + 1]])
        expect = np.sort(np.nonzero(lin == cell)[0])
        np.testing.assert_array_equal(got, expect)


def brute_force_neighbors(pos, h, max_n):
    """Exact <=max_n nearest within radius h, per particle."""
    d = np.linalg.norm(pos[:, None, :] - pos[None, :, :], axis=-1)
    np.fill_diagonal(d, np.inf)
    out_idx, out_d = [], []
    for i in range(len(pos)):
        cand = np.nonzero(d[i] <= h)[0]
        sel = cand[np.argsort(d[i][cand], kind="stable")][:max_n]
        out_idx.append(set(sel.tolist()))
        out_d.append(np.sort(d[i][sel]))
    return out_idx, out_d


def test_neighbors_match_bruteforce():
    params = small_params()
    pos = random_cloud(400, params, seed=1)
    grid = build_grid(vec3.split(jnp.asarray(pos)), params)
    v = vec3.split(jnp.asarray(pos))
    ids = jnp.arange(len(pos), dtype=jnp.int32)
    nbrs = find_neighbors(v, ids, v, grid, params)

    idx = np.asarray(nbrs.idx)
    q = np.asarray(nbrs.q)
    valid = np.asarray(nbrs.valid)

    oracle_sets, oracle_d = brute_force_neighbors(
        pos.astype(np.float64), params.h, params.max_neighbors
    )
    for i in range(len(pos)):
        got = set(idx[i][valid[i]].tolist())
        # distance multiset must match exactly (ties can swap ids)
        got_d = np.sort(q[i][valid[i]] * params.h)
        assert len(got) == len(oracle_sets[i]), f"particle {i}"
        np.testing.assert_allclose(got_d, oracle_d[i], rtol=2e-5, atol=1e-5)
        # and with random positions, ties are measure-zero: sets match
        assert got == oracle_sets[i], f"particle {i}"


def test_neighbors_dense_cluster_truncates_to_32():
    """More than 32 particles within h: list fills exactly 32 nearest."""
    params = small_params()
    rng = np.random.default_rng(3)
    center = np.array([13.0, 13.0, 13.0])
    pos = (center + rng.normal(scale=0.4 * params.h, size=(64, 3))).astype(
        np.float32
    )
    pos = np.clip(pos, 0.01, np.array(params.box_max) - 0.01)
    grid = build_grid(vec3.split(jnp.asarray(pos)), params)
    v = vec3.split(jnp.asarray(pos))
    ids = jnp.arange(len(pos), dtype=jnp.int32)
    nbrs = find_neighbors(v, ids, v, grid, params)
    valid = np.asarray(nbrs.valid)
    idx = np.asarray(nbrs.idx)
    q = np.asarray(nbrs.q)

    oracle_sets, oracle_d = brute_force_neighbors(
        pos.astype(np.float64), params.h, params.max_neighbors
    )
    for i in range(len(pos)):
        assert valid[i].sum() == len(oracle_sets[i])
        got_d = np.sort(q[i][valid[i]] * params.h)
        np.testing.assert_allclose(got_d, oracle_d[i], rtol=2e-5, atol=1e-5)


def test_neighbor_q_is_scale_free():
    params = small_params()
    pos = random_cloud(100, params, seed=2)
    grid = build_grid(vec3.split(jnp.asarray(pos)), params)
    v = vec3.split(jnp.asarray(pos))
    ids = jnp.arange(len(pos), dtype=jnp.int32)
    nbrs = find_neighbors(v, ids, v, grid, params)
    q = np.asarray(nbrs.q)
    valid = np.asarray(nbrs.valid)
    assert np.all(q[valid] >= 0) and np.all(q[valid] <= 1.0 + 1e-6)
    assert np.all(q[~valid] == 0)


def test_empty_and_single_particle():
    params = small_params()
    pos = vec3.split(jnp.asarray(np.array([[5.0, 5.0, 5.0]], np.float32)))
    grid = build_grid(pos, params)
    nbrs = find_neighbors(
        pos, jnp.arange(1, dtype=jnp.int32), pos, grid, params
    )
    assert not bool(np.asarray(nbrs.valid).any())
    assert int(np.asarray(nbrs.idx)[0, 0]) == -1
