"""Native (C++) scene-builder vs NumPy fallback equivalence."""
import numpy as np
import pytest

from sph_jax.config import SimParams
from sph_jax.scene import native, worm

H = 3.34


@pytest.fixture()
def params():
    return SimParams(x_max=12 * H, y_max=10 * H, z_max=40 * H)


@pytest.fixture()
def force_python(monkeypatch):
    def ctx():
        monkeypatch.setattr(native, "available", lambda: False)
    return ctx


needs_native = pytest.mark.skipif(
    not native.available(), reason="libsphscene.so not built"
)


@needs_native
def test_pool_and_boundary_bitwise(params, force_python):
    r0 = np.float32(params.r0)
    pool_n = native.pool_liquid(r0, params.x_max, params.y_max,
                                params.z_max, 0.15)
    bp_n, bn_n = native.boundary_box(r0, params.x_max, params.y_max,
                                     params.z_max)
    force_python()
    pool_p = worm._pool_liquid(params)
    bp_p, bn_p = worm._boundary_box(params)
    np.testing.assert_array_equal(pool_n, pool_p)
    np.testing.assert_array_equal(bp_n, bp_p)
    np.testing.assert_array_equal(bn_n, bn_p)


@needs_native
def test_inner_liquid_close(params, force_python):
    """Ring trig differs from NumPy at the last ulp (libm vs numpy sin);
    counts must match exactly, positions to 1e-5."""
    r0 = np.float32(params.r0)
    inner_n = native.inner_worm_liquid(r0, params.x_max, params.y_max,
                                       params.z_max)
    force_python()
    inner_p = worm._inner_worm_liquid(params)
    assert inner_n.shape == inner_p.shape
    np.testing.assert_allclose(inner_n, inner_p, atol=1e-5)


@needs_native
def test_spring_graph_bitwise(params, force_python):
    scene_n = worm.generate_worm_scene(params)
    force_python()
    scene_p = worm.generate_worm_scene(params)
    assert scene_n.n_particles == scene_p.n_particles
    np.testing.assert_array_equal(scene_n.spring_idx, scene_p.spring_idx)
    np.testing.assert_array_equal(scene_n.spring_rest, scene_p.spring_rest)
    np.testing.assert_array_equal(scene_n.spring_type, scene_p.spring_type)
    np.testing.assert_array_equal(scene_n.tris, scene_p.tris)
