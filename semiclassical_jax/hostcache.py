# coding: utf-8
"""Where JAX's persistent compilation cache lives.

One rule for every entry point (the `semi` CLI, bench.py, chip_smoke.py,
the GPU test tier and the scripts): when ``JAX_COMPILATION_CACHE_DIR`` is
set, JAX already reads it and that directory is the cache; otherwise the
cache is ``<checkout>/.jax_cache``. The path is part of the cache key, so a
fixed location is what lets a later process find an earlier one's programs.
"""

from __future__ import annotations

import os
import pathlib

__all__ = ["CHECKOUT_CACHE_DIR", "use_compile_cache",
           "disable_persistent_cache"]

CHECKOUT_CACHE_DIR = str(pathlib.Path(__file__).resolve().parents[1]
                         / ".jax_cache")


def use_compile_cache() -> str:
    """Turn the persistent compilation cache on and return its directory.

    Call before the first compilation. Every compiled program is cached,
    however small or quick to compile."""
    import jax

    cache_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR") or ""
    if not cache_dir:
        cache_dir = CHECKOUT_CACHE_DIR
        os.makedirs(cache_dir, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
    return cache_dir


def disable_persistent_cache() -> None:
    """Turn the persistent compilation cache off entirely.

    Long-lived CPU processes (the full test suite: hundreds of compiled
    programs in one process) crashed reproducibly inside the cache
    machinery at the same test — once SIGSEGV in
    ``get_executable_and_time`` (executable deserialize), once SIGABRT
    in ``put_executable_and_time`` (executable serialize). The same test
    passes standalone, so the trigger is accumulated process state, not
    the program itself; with the cache disabled the whole
    serialize/deserialize surface is gone. CPU compiles are local and
    cheap relative to the suite's physics gates."""
    import jax

    jax.config.update("jax_enable_compilation_cache", False)
