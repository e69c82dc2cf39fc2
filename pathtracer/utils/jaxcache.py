"""Persistent XLA compilation cache setup.

Every entry point enables JAX's persistent compilation cache, so a
process that compiles a program another process already compiled reads
it from disk.  `JAX_COMPILATION_CACHE_DIR`, when set, names the directory
and JAX reads it itself; otherwise the cache lives at one fixed path
inside the checkout (`.jax_cache/`, listed in `.gitignore`), since the
path is part of what makes a later run hit.

Source locations are left out of compiled programs: the Triton route
embeds the kernel's IR, locations included, in the program, so a
checkout at another path would otherwise never hit the cache.
"""

from __future__ import annotations

import os
from pathlib import Path

DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def cache_dir() -> str:
    """The directory the cache uses: the environment's, else the default."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(DEFAULT_DIR)


def enable() -> str:
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        DEFAULT_DIR.mkdir(exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    jax.config.update("jax_traceback_in_locations_limit", 0)
    return cache_dir()
