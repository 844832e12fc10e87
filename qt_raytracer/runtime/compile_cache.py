"""Persistent XLA compilation cache (opt-in per entry point).

The 1080p render and training graphs take tens of seconds to minutes to
compile. JAX's disk cache makes a recompile of an UNCHANGED program a cache
hit, so a second process starts computing at once.

Entry points (CLI, bench.py, chip_smoke.py, run_baselines.py) call
`enable_compilation_cache()` once at startup. Library imports do NOT enable
it implicitly: a cache write is a side effect a library should not spring on
its host process.

Where the cache lives:
  - JAX_COMPILATION_CACHE_DIR set: JAX reads it itself and this module sets
    no directory of its own;
  - otherwise: a fixed directory inside the checkout, CACHE_DIR
    (<repo>/.jax_cache, listed in .gitignore). The path is part of the
    cache key, so it must not move between runs.
"""

from __future__ import annotations

import os
import pathlib

CACHE_DIR = pathlib.Path(__file__).resolve().parents[2] / ".jax_cache"

_ENABLED_DIR: str | None = None


def cache_dir() -> str:
    """The directory the persistent cache uses (see module docstring)."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(CACHE_DIR)


def enable_compilation_cache(min_compile_time_secs: float = 1.0) -> str:
    """Idempotently enable JAX's persistent compilation cache; returns the
    cache directory in use."""
    global _ENABLED_DIR
    if _ENABLED_DIR is not None:
        return _ENABLED_DIR
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        CACHE_DIR.mkdir(exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", str(CACHE_DIR))
    # Cache every compile that took >= min_compile_time_secs, pinned so a
    # change of JAX's default cannot silently stop caching the render graphs.
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      min_compile_time_secs)
    _ENABLED_DIR = cache_dir()
    return _ENABLED_DIR
