"""Persistent XLA compilation cache helper.

The solver while-loops take seconds to compile; JAX's persistent
compilation cache stores the compiled executables on disk, so a later
process with the same programs skips straight to execution.  Enable it
explicitly from entry points (bench.py, chip_smoke.py, examples) — library
code must not mutate global jax config on import.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".cache",
    "jax",
)


def enable_persistent_cache() -> str:
    """Turn on the on-disk compilation cache (idempotent). Returns the dir.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and no
    directory is set here.  Otherwise the cache lives at the fixed
    in-checkout path ``<repo>/.cache/jax``.

    Call before the first jit execution.  Safe to call when the backend is
    already initialized; only affects compilations that happen afterwards.
    """
    import jax

    env_dir = os.environ.get(ENV_VAR)
    if env_dir:
        cache_dir = env_dir
    else:
        cache_dir = DEFAULT_CACHE_DIR
        os.makedirs(cache_dir, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    # Cache every program: the default thresholds skip programs that
    # compile in under a second, and a solve builds many of them.
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    return cache_dir
