"""Where JAX keeps compiled programs between processes."""

from __future__ import annotations

import os

_CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def use_compile_cache() -> str:
    """Point JAX's persistent compilation cache at a fixed directory and
    return the directory in use.

    If JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and nothing
    is set here. Otherwise the cache is <checkout>/.jax_cache (gitignored):
    a fixed path, since the path is part of what a later process must
    find again."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    path = os.path.join(_CHECKOUT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
