"""Checks that need a GPU: the compiled Triton pair kernels against the
plain reference and the exact engine. They skip on the CPU; run them on a
GPU machine with

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/test_gpu.py

``chip_smoke.py`` runs the same checks (sph_jax.checks.GPU_CHECKS).
"""
import jax
import pytest

from sph_jax import checks

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu():
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU (JAX_PLATFORMS=cuda)")


@pytest.mark.parametrize("name", sorted(checks.GPU_CHECKS))
def test_gpu_check(gpu, name):
    res = checks.GPU_CHECKS[name]()
    assert res["ok"], res
