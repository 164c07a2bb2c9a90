"""Pair-pass kernels on the CPU: each Triton kernel in Pallas interpret
mode against the plain-XLA reference build of the same pass, the tile
walk's disjoint-and-covering invariant, the backend rule for interpret
mode, and the compile-cache location."""
import os
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sph_jax import checks
from sph_jax.config import SimParams
from sph_jax.core import fast as F
from sph_jax.ops import pair_kernels as pk


@pytest.fixture(scope="module")
def small_worm_errors():
    return checks.fast_pass_errors(*checks.small_worm())


@pytest.mark.parametrize("name", checks.PASS_NAMES)
def test_pass_matches_reference(small_worm_errors, name):
    """Every pass of one fast-engine step of the small worm: interpreted
    kernel vs plain reference on the same inputs."""
    assert name in small_worm_errors
    assert small_worm_errors[name] <= checks.pass_tolerance(name)


def test_tile_walk_is_disjoint_and_covering():
    """The tile offsets the kernels walk (pk._tile_offset over each
    block's chunk tables) cover every in-window column exactly once."""
    rng = np.random.default_rng(0)
    params = SimParams()
    pos = rng.uniform(
        [params.x_min, params.y_min, params.z_min],
        [params.x_max, params.y_max, 40 * params.h], (3000, 3),
    ).astype(np.float32)
    cfg = F.compute_fast_config(pos, params, block=64, ccol=64)
    nx, ny, nz = cfg.dims
    c = np.clip(((pos - np.asarray(params.box_min)) / params.h).astype(int),
                0, np.array(cfg.dims) - 1)
    pencil = c[:, 0] + nx * c[:, 2]
    pencil_s = pencil[np.argsort(c[:, 1] + ny * pencil, kind="stable")]
    tables = F._window_tables(jnp.asarray(pencil_s, jnp.int32), cfg)[0]
    aln, lo, hi, s0, cnt, _ = (np.asarray(t) for t in tables)
    for b in range(cfg.n_blocks):
        tab = (aln[3 * b], aln[3 * b + 1], aln[3 * b + 2],
               s0[3 * b + 1], s0[3 * b + 2])
        offs = [int(pk._tile_offset(s, tab, cfg.ccol))
                for s in range(cnt[b])]
        assert all(o % pk.ALIGN == 0 for o in offs)
        cols = np.concatenate(
            [np.arange(o, o + cfg.ccol) for o in offs] or [[]])
        assert len(cols) == len(set(cols.tolist()))       # disjoint
        window = set()
        for k in range(3):
            window |= set(range(lo[3 * b + k], hi[3 * b + k]))
        assert window <= set(cols.tolist())               # covering
        assert (cols < cfg.n_alloc).all()


@pytest.mark.parametrize("platform,expect", [
    ("cpu", True), ("gpu", False), ("metal", None), ("rocm", None),
])
def test_interpret_platform_rule(platform, expect):
    """cpu -> interpret (tests), gpu -> compile, anything else raises."""
    if expect is None:
        with pytest.raises(ValueError):
            pk.interpret_for(platform)
    else:
        assert pk.interpret_for(platform) is expect


def test_engines_follow_platform_rule():
    params = SimParams()
    pos = np.zeros((10, 3), np.float32)
    assert F.compute_fast_config(pos, params).interpret is (
        pk.interpret_for(jax.default_backend()))


def test_pallas_imports_are_gpu_routes():
    """The package imports Pallas only as itself and its Triton route."""
    allowed = {"from jax.experimental import pallas as pl",
               "from jax.experimental.pallas import triton as plgpu"}
    root = pathlib.Path(__file__).resolve().parents[1] / "sph_jax"
    for path in root.rglob("*.py"):
        for line in path.read_text().splitlines():
            if "pallas" in line and "import" in line:
                assert line.strip() in allowed, (path, line)


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_dir(monkeypatch, tmp_path, env_set):
    from sph_jax.runtime import cache

    prev = jax.config.jax_compilation_cache_dir
    try:
        if env_set:
            monkeypatch.setenv(cache.CACHE_ENV, str(tmp_path))
            assert cache.enable_compile_cache() == str(tmp_path)
            assert jax.config.jax_compilation_cache_dir == prev  # untouched
        else:
            monkeypatch.delenv(cache.CACHE_ENV, raising=False)
            path = cache.enable_compile_cache()
            assert path == cache.DEFAULT_CACHE_DIR
            assert jax.config.jax_compilation_cache_dir == path
            assert os.path.dirname(path) == str(
                pathlib.Path(__file__).resolve().parents[1])
    finally:
        jax.config.update("jax_compilation_cache_dir", prev)
