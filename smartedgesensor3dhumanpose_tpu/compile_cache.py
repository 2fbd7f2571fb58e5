"""The persistent XLA compilation cache: one rule for every entry point.

Where `JAX_COMPILATION_CACHE_DIR` is set, JAX reads it itself and this
module sets no other directory. Otherwise the cache lives at one fixed,
git-ignored path inside the checkout: the path is part of what a cached
program is found by, so it is never built from a temporary name, a process
id or the time.
"""

from __future__ import annotations

import os

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
)


def cache_dir() -> str:
    """The directory the cache uses under the rule above."""
    return os.environ.get(ENV_VAR) or DEFAULT_DIR


def enable(min_compile_time_secs: float = 1.0, min_entry_size_bytes: int = 0):
    """Turn the persistent cache on; returns its directory."""
    path = cache_dir()
    if not os.environ.get(ENV_VAR):
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update(
        "jax_persistent_cache_min_compile_time_secs", min_compile_time_secs
    )
    jax.config.update(
        "jax_persistent_cache_min_entry_size_bytes", min_entry_size_bytes
    )
    return path
