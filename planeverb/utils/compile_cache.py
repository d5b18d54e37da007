"""Persistent XLA compile cache at one fixed place.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX keeps its cache there by
itself and nothing is set here. Otherwise the cache goes to
``<checkout>/.jax_cache`` (listed in .gitignore): a fixed path, since the
path is part of the cache's key and a directory that moves never hits.
"""

from __future__ import annotations

import os

__all__ = ["enable_compile_cache", "DEFAULT_CACHE_DIR"]

DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def enable_compile_cache() -> str:
    """Turn the persistent compile cache on; returns its directory."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR
