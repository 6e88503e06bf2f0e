"""Persistent XLA compile cache for the entry points.

A 4096^2 step takes seconds to compile; a process that finds it in the
cache skips that.  The cache's directory is part of what makes a hit, so
it must not move between runs.
"""

from __future__ import annotations

import contextlib
import os

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
# a fixed path inside the checkout (listed in .gitignore)
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def enable_compile_cache():
    """Turn on the persistent compile cache; returns its directory.

    If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and this
    sets nothing.  Otherwise the cache goes to ``DEFAULT_DIR`` — on an
    accelerator only: CPU programs (tests, rehearsals) compile in seconds,
    and XLA:CPU entries are tied to the host's CPU features (which the
    cache key leaves out, while the directory may travel to another host),
    so on the CPU backend this sets nothing and returns None.  A process
    on an accelerator that also compiles for the CPU does so inside
    :func:`no_cache_writes`."""
    path = os.environ.get(ENV_VAR)
    if path:
        return path
    if jax.default_backend() == "cpu":
        return None
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR


@contextlib.contextmanager
def no_cache_writes():
    """Keep what compiles inside out of the persistent compile cache (for
    XLA:CPU programs in a process whose accelerator programs are cached;
    see :func:`enable_compile_cache`)."""
    key = "jax_persistent_cache_min_compile_time_secs"
    prev = getattr(jax.config, key)
    jax.config.update(key, float("inf"))
    try:
        yield
    finally:
        jax.config.update(key, prev)
