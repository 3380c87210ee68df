"""Persistent XLA compilation cache setup.

JAX keys every cache entry on the program, the backend, the device kind
and the compiler version, so one directory serves CPU and GPU processes
alike.  The directory is JAX_COMPILATION_CACHE_DIR, exactly, when that is
set; otherwise a fixed path inside the checkout (`.jax_cache`, listed in
.gitignore), because the path is part of what makes a later process find
the entries again.
"""
from __future__ import annotations

import os

__all__ = ["enable_compile_cache", "cache_dir", "DEFAULT_CACHE_DIR"]

DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def cache_dir() -> str:
    """JAX_COMPILATION_CACHE_DIR if set, else DEFAULT_CACHE_DIR."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_CACHE_DIR


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at cache_dir(); returns it."""
    import jax

    path = cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.1)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return path
