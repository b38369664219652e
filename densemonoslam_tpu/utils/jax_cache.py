"""Persistent XLA compilation cache setup.

The SLAM pipeline compiles a handful of large programs (the fused per-frame
step, bundle adjustment, map compaction, loop-closure programs), and several
of them first run mid-sequence (BA once enough keyframes exist, compaction at
its cadence, PGO on the first loop).  A persistent cache turns each such
compile into a once-per-machine cost instead of a stall in a live pipeline.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
module sets no directory.  Otherwise the cache lives at the fixed path
``<checkout>/.jax_cache``: the path is part of the cache key, so a directory
that moved between runs would never hit.
"""

from __future__ import annotations

import os

import jax

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable() -> str:
    """Turn the persistent compilation cache on; returns its directory."""
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
