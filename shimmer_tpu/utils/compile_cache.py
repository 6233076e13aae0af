"""Persistent XLA compilation cache, one policy for every entry point.

When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
helper sets nothing.  Otherwise the cache lives at ``<checkout>/.jax_cache``
(git-ignored): a fixed path, because the path is part of what makes a
cached entry findable again.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compile_cache() -> str:
    """Turn on the persistent compilation cache; returns its directory."""
    import jax

    env = os.environ.get(ENV_VAR)
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
