"""Persistent XLA compile cache for the entry points (CLI, bench.py,
chip_smoke.py). Never enabled by importing the package."""
from __future__ import annotations

import os

import jax

CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"
# <checkout>/.jax_cache: a fixed path, so a later run in the same checkout
# finds what an earlier one compiled
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))),
    ".jax_cache",
)


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compile cache and return its directory.

    If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already uses it and
    nothing is set here; otherwise the cache goes to the fixed in-checkout
    ``DEFAULT_CACHE_DIR``."""
    path = os.environ.get(CACHE_ENV)
    if path:
        return path
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR
