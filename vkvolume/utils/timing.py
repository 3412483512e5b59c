"""Timing + metrics helpers.

The reference's observability is std::chrono around fenced submits plus
vkb::Stats frame times (src/volume_render.cpp:210-215, 399-430, 249-251); the
JAX equivalent is timed jit dispatch with ``block_until_ready`` and
``jax.profiler`` traces.
"""

from __future__ import annotations

import contextlib
import time

import jax


def time_jitted(fn, *args, warmup: int = 1, iters: int = 10, **kwargs):
    """Median wall time of a jitted callable (seconds); blocks on results."""
    for _ in range(warmup):
        jax.block_until_ready(fn(*args, **kwargs))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args, **kwargs))
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]


@contextlib.contextmanager
def profiler_trace(log_dir: str | None):
    """Optional jax.profiler trace around a block."""
    if log_dir:
        with jax.profiler.trace(log_dir):
            yield
    else:
        yield
