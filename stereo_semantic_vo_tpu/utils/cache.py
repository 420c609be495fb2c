"""Persistent XLA compilation cache.

The full tracking step is a large XLA program whose first compile takes
tens of seconds.  Enabling JAX's persistent cache makes every subsequent
process start in seconds — essential for the CLI, benchmarks, and tests that
respawn interpreters.  ``JAX_COMPILATION_CACHE_DIR`` wins when set;
otherwise the cache lives at a fixed, git-ignored ``.jax_cache/`` in the
checkout (the directory is part of the cache key, so it must not move).
"""

from __future__ import annotations

import os


def enable_persistent_cache(path: str | None = None) -> str:
    import jax

    repo_root = os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )
    path = path or os.environ.get(
        "JAX_COMPILATION_CACHE_DIR", os.path.join(repo_root, ".jax_cache")
    )
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 2.0)
    return path
