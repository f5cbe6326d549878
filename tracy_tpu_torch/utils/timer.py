"""Stopwatch with an accumulating span (reference src/timer.h); a copy of
tracy_tpu/utils/timer.py."""

from __future__ import annotations

import time


class Timer:
    def __init__(self):
        self._t0 = 0.0
        self._span = 0.0
        self._total = 0.0

    def begin(self):
        self._t0 = time.perf_counter()

    def end(self):
        self._span = time.perf_counter() - self._t0
        self._total += self._span

    @property
    def duration(self) -> float:
        """Seconds of the last begin/end span."""
        return self._span

    @property
    def total(self) -> float:
        return self._total

    def reset(self):
        self._span = 0.0
        self._total = 0.0
