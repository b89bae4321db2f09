"""Profiling & tracing helpers.

Reference analog: boofcv-ip misc/ProfileOperation.java (stopwatch),
misc/MovingAverage.java, Performer/PerformerBase micro-bench drivers.
Additions (SURVEY §5): jax.profiler trace capture (Perfetto-
compatible) and a per-stage timer that blocks on device results so
stage boundaries are honest under async dispatch.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict

import jax


class MovingAverage:
    """Exponential moving average (misc/MovingAverage.java)."""

    def __init__(self, decay: float = 0.95):
        self.decay = decay
        self.average = 0.0
        self._first = True

    def update(self, value: float) -> float:
        if self._first:
            self.average = float(value)
            self._first = False
        else:
            self.average = (self.decay * self.average
                            + (1.0 - self.decay) * float(value))
        return self.average


class StageTimer:
    """Named per-stage wall-clock accumulator.  Use as
    ``with timer.stage("klt"): ...`` — the context exit blocks on any
    jax arrays passed to ``sync`` so device work is attributed to the
    right stage."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str, *sync):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            for a in sync:
                jax.block_until_ready(a)
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> Dict[str, float]:
        """Mean milliseconds per stage."""
        return {k: 1e3 * self.totals[k] / max(self.counts[k], 1)
                for k in self.totals}


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a jax.profiler trace (viewable in Perfetto / TensorBoard)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
