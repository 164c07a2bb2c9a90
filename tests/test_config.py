"""Constants/config tests against independent float64 transcriptions of the
reference's formulas (owPhysicsConstant.h, owPhysicsFluidSimulator.cpp)."""
import math

import numpy as np
import pytest

pytestmark = pytest.mark.smoke

from sph_jax.config import DEFAULT_PARAMS, SimParams


def test_simulation_scale():
    p = DEFAULT_PARAMS
    expect = 0.004 * p.mass ** (1 / 3) / 0.00025 ** (1 / 3)
    assert math.isclose(p.simulation_scale, expect, rel_tol=1e-12)
    # magnitude sanity: ~2e-6 m per sim unit
    assert 1e-6 < p.simulation_scale < 1e-5


def test_kernel_coefficients():
    p = DEFAULT_PARAMS
    hs = p.h * p.simulation_scale
    assert math.isclose(p.w_poly6, 315.0 / (64.0 * math.pi * hs**9), rel_tol=1e-12)
    assert math.isclose(p.grad_w_spiky, -45.0 / (math.pi * hs**6), rel_tol=1e-12)
    # nondimensional folds
    assert math.isclose(p.c_rho, p.mass * p.w_poly6 * hs**6, rel_tol=1e-12)
    assert math.isclose(
        p.c_press, p.mass * abs(p.grad_w_spiky) * hs**2, rel_tol=1e-12
    )
    assert math.isclose(
        p.c_visc, p.mass * p.viscosity * (-p.grad_w_spiky) * hs, rel_tol=1e-12
    )


def test_c_rho_is_self_density_contribution():
    # c_rho == mass * Wpoly6(0): the density clamp floor equals one
    # self-contribution, as in sphFluid.cl:514.
    p = DEFAULT_PARAMS
    w0 = p.w_poly6 * (p.h_s**2) ** 3
    assert math.isclose(p.c_rho, p.mass * w0, rel_tol=1e-12)
    # and it should be O(100) so f32 sums are comfortable
    assert 50 < p.c_rho < 500


def test_delta_matches_reference_algorithm():
    """Re-derive delta exactly as owPhysicsFluidSimulator.cpp:164-203."""
    p = DEFAULT_PARAMS
    x = np.array([1, 1, 0, -1, -1, -1, 0, 1, 1, 1, 0, -1, -1, -1, 0, 1,
                  1, 1, 0, -1, -1, -1, 0, 1, 2, -2, 0, 0, 0, 0, 0, 0], float)
    y = np.array([0, 1, 1, 1, 0, -1, -1, -1, 0, 1, 1, 1, 0, -1, -1, -1,
                  0, 1, 1, 1, 0, -1, -1, -1, 0, 0, 2, -2, 0, 0, 0, 0], float)
    z = np.array([0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1,
                  -1, -1, -1, -1, -1, -1, -1, -1, 0, 0, 0, 0, 2, -2, 1, -1],
                 float)
    pr = (p.mass / p.rho0) ** (1 / 3)
    v = np.stack([x, y, z], axis=1) * 0.8 * pr
    dist = np.linalg.norm(v, axis=1)
    sel = dist <= p.h_s
    h_r_2 = (p.h_s - dist[sel]) ** 2
    s1 = np.sum(h_r_2[:, None] * v[sel] / dist[sel, None], axis=0)
    s2 = np.sum(h_r_2**2)
    expect = 1.0 / (
        p.beta * p.grad_w_spiky**2 * (np.dot(s1, s1) + s2)
    )
    assert math.isclose(p.delta, expect, rel_tol=1e-10)
    assert p.delta > 0


def test_grid_dims():
    p = DEFAULT_PARAMS
    nx, ny, nz = p.grid_dims
    # box is 30h x 20h x 250h, cells are 2h; particles are clamped strictly
    # below the upper box faces, so floor(extent/2h)+1 cells always cover.
    assert (nx, ny, nz) == (15, 11, 126)
    assert p.n_cells == 15 * 11 * 126
    assert nx * p.cell_size >= p.x_max - 1e-3
    assert ny * p.cell_size >= p.y_max - 1e-3
    assert nz * p.cell_size >= p.z_max - 1e-3
    assert math.isclose(p.cell_size, 2 * p.h, rel_tol=0)


def test_params_hashable_and_static():
    p1 = SimParams()
    p2 = SimParams()
    assert hash(p1) == hash(p2) and p1 == p2
    p3 = SimParams(h=4.0)
    assert p3 != p1
