"""Profiling hooks: wall-clock phase timers + JAX/XLA device traces.

The reference has no profiling at all (SURVEY.md §5). Here: `phase_timer`
for cheap host-side timings and `device_trace` wrapping jax.profiler so a
TensorBoard-compatible XLA trace of any region can be captured with one line.
"""
from __future__ import annotations

import logging
import time
from contextlib import contextmanager
from typing import Dict

logger = logging.getLogger(__name__)

_TIMINGS: Dict[str, float] = {}


@contextmanager
def phase_timer(name: str, sync=None):
    """Times a region; pass sync=array/pytree to block on device completion."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if sync is not None:
            import jax

            jax.block_until_ready(sync)
        dt = time.perf_counter() - t0
        _TIMINGS[name] = _TIMINGS.get(name, 0.0) + dt
        logger.info("phase %s: %.3fs", name, dt)


def timings() -> Dict[str, float]:
    return dict(_TIMINGS)


def reset_timings() -> None:
    _TIMINGS.clear()


@contextmanager
def device_trace(log_dir: str):
    """Capture an XLA device trace viewable in TensorBoard / xprof."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()
        logger.info("device trace written to %s", log_dir)
