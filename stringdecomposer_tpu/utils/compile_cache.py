"""Persistent XLA compilation cache.

With the cache a fresh process reloads its compiled programs instead of
compiling them again. Enabled once per process by the pipeline entry points:

  - JAX_COMPILATION_CACHE_DIR set: JAX reads it itself; nothing is set here;
  - otherwise: <checkout>/.jax_cache, one fixed directory (git-ignored),
    so every run from this checkout finds the programs earlier runs cached.
"""

from __future__ import annotations

import os

CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)

_enabled = False


def enable_compile_cache() -> None:
    global _enabled
    if _enabled:
        return
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        os.makedirs(CACHE_DIR, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1)
    _enabled = True
