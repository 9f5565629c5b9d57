"""Step timing for the training loop: ``StepTimer``, rolling wall-clock
statistics cheap enough for the hot loop, written as JSONL beside the
training metrics.  (Device traces belong to the tools slice.)"""

from __future__ import annotations

import json
import time
from collections import deque
from typing import Deque, Optional


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
