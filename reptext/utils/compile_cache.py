"""Persistent XLA compilation cache for CLI / serving cold starts.

The first trace of the fused sampler compiles for tens of seconds per
(geometry, batch-bucket) signature. JAX's persistent compilation cache keys
compiled executables on the serialized HLO, compile options and jaxlib
version, so a later process with the same graphs loads them from disk: serve
restarts, repeated CLI runs and crash recovery (sampling/elastic.py) skip
straight to execution.

Where the cache lives: ``$JAX_COMPILATION_CACHE_DIR`` when it is set (JAX
reads it itself and no other directory is set here), otherwise the fixed
path ``<checkout>/.cache/xla``. The path is part of every cache key, so it
never depends on a temporary name, a process id or the time.
"""

from __future__ import annotations

import os
from typing import Optional

_CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(_CHECKOUT, ".cache", "xla")


def cache_dir() -> str:
    """The directory the cache uses: the environment's, else the checkout's."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_DIR


def enable_compile_cache(enabled: bool = True) -> Optional[str]:
    """Turn on JAX's persistent compilation cache at :func:`cache_dir`.

    Returns the directory in use, or None when ``enabled`` is False.
    """
    if not enabled:
        return None

    import jax

    directory = cache_dir()
    os.makedirs(directory, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", directory)
    # Cache every compile that took measurable work; the tiny-graph floor
    # avoids churning the cache with sub-second helper compiles.
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return directory
