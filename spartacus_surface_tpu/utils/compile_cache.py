"""Persistent XLA compilation cache for the CLI, chip_smoke.py and bench.py.

A repeat run on the same shapes then skips compilation, which is the
dominant cold-start cost of a CLI run.  Where JAX_COMPILATION_CACHE_DIR is
set, JAX reads it itself and nothing is set here; otherwise the cache
lives in a fixed directory of the checkout (git-ignored), so its path —
part of every cache key — never moves between runs.
"""

from __future__ import annotations

import os

CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))),
    ".jax_cache",
)


def configure() -> str:
    """Point JAX's persistent compilation cache at its directory and
    return that directory."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return CACHE_DIR
