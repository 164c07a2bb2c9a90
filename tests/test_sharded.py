"""Multi-chip (virtual 8-device CPU mesh) SPMD tests.

Sharded and single-chip trajectories must agree — the sharded path reuses the
same physics kernels with all-gathered reads.
"""
import numpy as np
import jax
import pytest

from sph_jax.config import SimParams
from sph_jax.core.step import multi_step
from sph_jax.parallel import (
    make_mesh,
    make_sharded_step,
    pad_scene_to_devices,
    shard_state,
)
from sph_jax.scene import generate_liquid_box_scene, generate_worm_scene

H = 3.34


@pytest.fixture(scope="module")
def n_dev():
    n = len(jax.devices())
    if n < 2:
        pytest.skip("needs multiple (virtual) devices")
    return n


def test_sharded_matches_single_chip_box(n_dev):
    params = SimParams(x_max=8 * H, y_max=8 * H, z_max=8 * H)
    scene = generate_liquid_box_scene(params, fill_fraction=0.5)
    scene = pad_scene_to_devices(scene, n_dev)
    assert scene.n_particles % n_dev == 0

    state, springs, membranes = scene.device_state()
    layout = scene.layout()

    ref = multi_step(state, springs, membranes, params, layout, 5)

    mesh = make_mesh(n_dev)
    step8 = make_sharded_step(mesh, params, layout, n_steps=5)
    sharded = step8(shard_state(state, mesh), springs, membranes)

    np.testing.assert_allclose(
        np.asarray(sharded.pos), np.asarray(ref.pos), rtol=0, atol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(sharded.vel), np.asarray(ref.vel), rtol=0, atol=1e-6
    )
    assert int(sharded.step) == 5


def test_sharded_matches_single_chip_worm(n_dev):
    """Full physics (springs + muscles + membranes) under sharding."""
    params = SimParams(x_max=20 * H, y_max=12 * H, z_max=110 * H)
    scene = generate_worm_scene(params)
    scene = pad_scene_to_devices(scene, n_dev)

    state, springs, membranes = scene.device_state()
    layout = scene.layout()

    ref = multi_step(state, springs, membranes, params, layout, 2)

    mesh = make_mesh(n_dev)
    stepn = make_sharded_step(mesh, params, layout, n_steps=2)
    sharded = stepn(shard_state(state, mesh), springs, membranes)

    np.testing.assert_allclose(
        np.asarray(sharded.pos), np.asarray(ref.pos), rtol=0, atol=2e-5
    )
    np.testing.assert_allclose(
        np.asarray(sharded.vel), np.asarray(ref.vel), rtol=0, atol=2e-5
    )
    np.testing.assert_allclose(
        np.asarray(sharded.muscle_activation),
        np.asarray(ref.muscle_activation),
        atol=1e-7,
    )
