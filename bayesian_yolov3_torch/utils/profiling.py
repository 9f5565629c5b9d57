"""Tracing and timing — the counterpart of the JAX package's
``utils/profiling.py``:

* ``StepTimer`` — rolling per-step wall-clock statistics, cheap enough for
  the hot loop, written as JSONL beside the training metrics;
* ``trace`` — a ``torch.profiler`` capture of the host (CPU activity) and,
  where a card is used, the device (CUDA activity), written as a Chrome
  trace (``trace.json``, for chrome://tracing or Perfetto) into a
  directory;
* ``annotate`` — a named range (``torch.profiler.record_function``) that
  marks a host phase — loading, a step, JSON writing — inside a ``trace``.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import deque
from typing import Deque, Optional

import torch


class StepTimer:
    """Rolling wall-clock statistics over the last ``window`` steps."""

    def __init__(self, window: int = 100):
        self.window = window
        self.samples: Deque[float] = deque(maxlen=window)
        self._last: Optional[float] = None
        self.total_steps = 0

    def tick(self) -> Optional[float]:
        """Mark a step boundary; returns the last step duration (or None)."""
        now = time.perf_counter()
        dt = None
        if self._last is not None:
            dt = now - self._last
            self.samples.append(dt)
            self.total_steps += 1
        self._last = now
        return dt

    def stats(self) -> dict:
        if not self.samples:
            return {"steps": 0}
        xs = sorted(self.samples)
        n = len(xs)
        return {
            "steps": self.total_steps,
            "mean_s": sum(xs) / n,
            "p50_s": xs[n // 2],
            "p90_s": xs[min(n - 1, int(n * 0.9))],
            "max_s": xs[-1],
            "steps_per_sec": n / sum(xs),
        }

    def write(self, path: str):
        with open(path, "a") as f:
            f.write(json.dumps({"ts": time.time(), **self.stats()}) + "\n")


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the enclosed code; on exit, also on an error, the Chrome
    trace is written to ``log_dir/trace.json``.  Yields the
    ``torch.profiler.profile`` (its ``key_averages()`` sums the time by
    operation).  The device's activity is recorded too where
    ``torch.cuda.is_available()``."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    try:
        with prof:
            try:
                yield prof
            finally:
                if cuda:
                    torch.cuda.synchronize()
    finally:
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """A named range of the host's timeline inside a ``trace`` (a no-op
    outside one)."""
    return torch.profiler.record_function(name)
