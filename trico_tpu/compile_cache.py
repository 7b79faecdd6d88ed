"""Persistent XLA compilation cache location, shared by every entry point.

If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX uses it and nothing here changes
it. Otherwise the cache lives at ``<checkout>/build/jax_cache``: a fixed path,
because the path is part of the cache key and a moving directory never hits.
"""

from __future__ import annotations

import os
from pathlib import Path

CACHE_DIR = Path(__file__).resolve().parent.parent / "build" / "jax_cache"


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory; return it."""
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = str(CACHE_DIR)
        jax.config.update("jax_compilation_cache_dir", path)
    # cache every program that took measurable time to compile
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return path
