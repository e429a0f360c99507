"""Persistent XLA compilation cache location, shared by every entry point.

If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and nothing
is set here. Otherwise the cache lives at ``<checkout>/.jax_cache`` (listed
in ``.gitignore``): a fixed path, so a later run of the same checkout finds
what an earlier one compiled.
"""

from __future__ import annotations

import os
from pathlib import Path

__all__ = ["enable_compile_cache"]

_DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory and
    return that directory."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", str(_DEFAULT_DIR))
    return str(_DEFAULT_DIR)
