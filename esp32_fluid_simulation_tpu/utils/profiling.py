"""Profiling helpers (SURVEY.md §5: the reference's author profiled with
gprof off-device; here the equivalent is a ``jax.profiler`` device trace,
and wall-clock windows that end in ``block_until_ready``)."""

from __future__ import annotations

import contextlib
import time

import jax


@contextlib.contextmanager
def trace(log_dir: str):
    """jax.profiler trace context; view with TensorBoard/XProf."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def compile_timed(fn, *args):
    """AOT-compile jitted ``fn`` for ``args``; returns (compiled, seconds)."""
    t0 = time.perf_counter()
    compiled = fn.lower(*args).compile()
    return compiled, time.perf_counter() - t0


def seconds_per_call(one, carry, n, warmup=1):
    """Seconds per call of ``carry = one(carry)`` over a window of ``n``
    calls that ends in ``block_until_ready``.  ``warmup`` calls run before
    the window (they compile, unless ``one`` is already compiled).
    Returns (seconds per call, last carry)."""
    for _ in range(warmup):
        carry = one(carry)
    jax.block_until_ready(carry)
    t0 = time.perf_counter()
    for _ in range(n):
        carry = one(carry)
    jax.block_until_ready(carry)
    return (time.perf_counter() - t0) / n, carry
