"""Timers and profiling.

The analog of the reference's Teuchos::TimeMonitor counters
(reference: src/driver.cpp:41-42, 217-229 — `profile: true` writes
MrHyDE.profile). Wall-clock accumulators per named scope plus optional
jax.profiler trace capture of device work.
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager

__all__ = ["timed", "timer_report", "reset_timers", "trace"]

_ACCUM = defaultdict(float)
_COUNT = defaultdict(int)


@contextmanager
def timed(name: str):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _ACCUM[name] += time.perf_counter() - t0
        _COUNT[name] += 1


def reset_timers():
    _ACCUM.clear()
    _COUNT.clear()


def timer_report() -> str:
    lines = ["timer, total_seconds, calls"]
    for name in sorted(_ACCUM):
        lines.append(f"{name}, {_ACCUM[name]:.6f}, {_COUNT[name]}")
    return "\n".join(lines)


@contextmanager
def trace(logdir: str = "/tmp/mrhyde_tpu_trace"):
    """Capture a jax profiler trace (view with TensorBoard/xprof)."""
    import jax
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
