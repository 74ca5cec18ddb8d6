"""JAX's persistent compilation cache, at one fixed place.

If JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and nothing here
changes it. Otherwise the cache goes to <repo>/.cache/jax, a path that never
depends on a temporary name, a pid or the time, so that a later run of the
same checkout finds what an earlier one compiled.
"""
from __future__ import annotations

import os

ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".cache", "jax",
)


def enable_compile_cache() -> str:
    """Turn the persistent cache on; returns the directory it uses."""
    env = os.environ.get(ENV)
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
