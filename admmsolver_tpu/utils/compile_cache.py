"""Persistent XLA compile cache for the entry-point scripts.

The library itself never configures a cache.  Scripts (``chip_smoke.py``,
``bench.py``, ``benches/*.py``) call :func:`enable_compile_cache` once,
before their first compilation, so repeated runs reuse compiled programs.
"""
from __future__ import annotations

import os
from pathlib import Path

import jax

__all__ = ["CACHE_ENV", "DEFAULT_CACHE_DIR", "enable_compile_cache"]

CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"
#: Fixed location inside the checkout (git-ignored).  A fixed path, not a
#: temporary one: the path is part of what makes a later run hit.
DEFAULT_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Place JAX's persistent compile cache and return its directory.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and
    nothing is changed.  Otherwise the cache goes to
    :data:`DEFAULT_CACHE_DIR`.
    """
    path = os.environ.get(CACHE_ENV)
    if path:
        return path
    path = str(DEFAULT_CACHE_DIR)
    jax.config.update("jax_compilation_cache_dir", path)
    return path
