"""Persistent compilation cache at a path that does not move.

JAX keys its cache by, among other things, the cache directory, so a
directory that changes from run to run never hits. `enable()` uses
`JAX_COMPILATION_CACHE_DIR` when it is set (JAX reads that variable
itself, so no directory is set in code) and otherwise the fixed
`<repo>/.jax_cache`, which `.gitignore` lists.
"""
from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache")


def cache_dir() -> str:
    """The directory the compile cache lands in."""
    return os.environ.get(ENV_VAR) or DEFAULT_DIR


def enable() -> str:
    """Enable the persistent compilation cache (idempotent).

    Must run before the first compilation.  Returns the cache directory.
    """
    import jax
    if not os.environ.get(ENV_VAR):
        jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return cache_dir()
