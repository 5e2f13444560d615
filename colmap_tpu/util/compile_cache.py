"""Where the persistent XLA compile cache lives.

The mapper, BA and matcher programs are compiled once per shape class; the
persistent cache lets later processes load them instead of compiling. If
`JAX_COMPILATION_CACHE_DIR` is set, JAX reads it itself and nothing here
overrides it. Otherwise the cache goes to one fixed directory inside the
checkout, `.jax_cache` (listed in .gitignore): a fixed path, because the
directory is part of what makes a later process find the entries.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def cache_dir() -> str:
    """The directory the compile cache is written to."""
    return os.environ.get(ENV_VAR) or REPO_CACHE_DIR


def setup_compile_cache() -> str:
    """Point JAX at `cache_dir()`; returns it.

    Only programs whose compile took >= 0.5 s are persisted: every large
    device program, but none of the thousands of sub-ms CPU test programs
    (writing those to disk measurably slows the test suite).
    """
    import jax

    if not os.environ.get(ENV_VAR):
        jax.config.update("jax_compilation_cache_dir", REPO_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return cache_dir()
