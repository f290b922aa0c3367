"""Persistent XLA compilation cache.

Grad-through-SCF graphs take tens of seconds to minutes each to compile,
and the fit/validation/test entry points relaunch processes constantly.
Enabling JAX's persistent compilation cache makes every recompile of an
identical graph a disk hit instead.

Call `enable()` BEFORE the first jit execution (safe to call repeatedly).
Where `JAX_COMPILATION_CACHE_DIR` is set, JAX already reads the directory
from it and no other is set here; otherwise the cache lives at the fixed
path `.jax_cache/` at the repo root (the path is part of the cache key, so
it must not move between runs).
"""

from __future__ import annotations

import os

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
)


def enable() -> None:
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        os.makedirs(DEFAULT_DIR, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 2.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
