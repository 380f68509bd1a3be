"""JAX runtime configuration: the persistent compilation cache.

The DP engines compile a handful of sizable XLA programs (wavefront scans,
traceback walks), so a CLI run should not pay that compile again in every
process.  Every engine module enables JAX's persistent compilation cache
before its first compile:

* where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
  module sets no other directory;
* otherwise the cache lives at :data:`DEFAULT_CACHE_DIR`, a fixed
  directory inside the checkout (git-ignored).  A fixed path matters: the
  path is part of the cache's key, so a directory that moves never hits.
"""

from __future__ import annotations

import os

_done = False

DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))),
    ".jax_cache",
)


def ensure_compile_cache() -> None:
    """Idempotently enable the persistent JAX compilation cache."""
    global _done
    if _done:
        return
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        os.makedirs(DEFAULT_CACHE_DIR, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    # keep every executable: a CLI run dispatches many small programs
    # cold, and each costs a compile in a fresh process
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    _done = True
