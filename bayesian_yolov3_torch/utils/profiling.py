"""Tracing and timing — the counterpart of the JAX package's
``utils/profiling.py``:

* ``StepTimer`` — rolling per-step wall-clock statistics, cheap enough for
  the hot loop, written as JSONL beside the training metrics;
* ``trace`` — a ``torch.profiler`` capture of the host (CPU activity) and,
  where a card is used, the device (CUDA activity), written as a Chrome
  trace (``trace.json``, for chrome://tracing or Perfetto) into a
  directory;
* ``annotate`` — a span: a named range of the host's time, stamped with
  ``time.time_ns()`` and kept in memory with the request it belongs to;
  under a profiler (``trace``, or any ``torch.profiler.profile``) it is
  also a ``record_function`` range, a ``user_annotation`` in the Chrome
  trace;
* ``Request`` / ``request`` — one unit of served work (an
  ``InferenceRunner.predict`` call, a batch of ``run()``): its root span,
  its spans and integer counters, kept in a ring of the last
  ``REQUESTS_KEPT`` (``requests()``).

Stamps are ``time.time_ns()``: a Chrome trace's event ``ts`` (us) plus its
``baseTimeNanoseconds`` / 1e3 is the same clock, so a span sits on the
device trace's timeline.  Recording costs two clock reads and an append a
span; ``record_function`` (about 14 us a range even with no profiler
running) is entered only while a profiler runs.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import json
import os
import threading
import time
from collections import deque
from typing import Deque, Dict, List, Optional

import torch
from torch.autograd import profiler as _autograd_profiler


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


REQUESTS_KEPT = 4096
COUNTERS = ("images", "nms_certificate_failed", "nms_exact_retry", "h2d_bytes")

_requests: Deque[Dict] = deque(maxlen=REQUESTS_KEPT)
_ids = itertools.count(1)  # span ids; a request's id is its root span's


class _Thread(threading.local):
    """This thread's current ``Request`` and its open kept spans, innermost
    last (class defaults: a ``getattr`` that misses costs about 1 us)."""

    request = None

    def __init__(self):
        self.open = []


_local = _Thread()


def _record_function(name: str):
    """An entered ``record_function`` range while a profiler runs, else None."""
    if not _autograd_profiler._is_profiler_enabled:
        return None
    rf = torch.profiler.record_function(name)
    rf.__enter__()
    return rf


class Request:
    """One request: a fresh id, its root span ``name`` open from now until
    ``end()``, and its counters (``COUNTERS``, all 0).  ``with request:``
    makes it this thread's current request, the one that spans and
    ``count`` attach to; the scope can be entered again (``run()`` enters a
    batch's request at its launch and again at its drain).  ``end()`` closes
    the root and keeps the record in the ring."""

    __slots__ = ("record", "root", "_rf", "_outer")

    def __init__(self, name: str, images: int = 0):
        self._rf = _record_function(name)
        rid = next(_ids)
        self.root = {"name": name, "id": rid, "parent": None, "request": rid,
                     "start_ns": time.time_ns(), "end_ns": None}
        self.record = {"id": rid, "spans": [self.root], "profiled": self._rf is not None,
                       "counters": {**dict.fromkeys(COUNTERS, 0), "images": int(images)}}
        self._outer = []

    def count(self, key: str, n: int = 1) -> None:
        self.record["counters"][key] += int(n)

    def __enter__(self):
        self._outer.append(_local.request)
        _local.request = self
        return self

    def __exit__(self, *exc):
        _local.request = self._outer.pop()

    def end(self, keep: bool = True) -> None:
        """Close the root span; ``keep``: put the record in the ring."""
        self.root["end_ns"] = time.time_ns()
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
            self._rf = None
        if keep:
            _requests.append(self.record)


@contextlib.contextmanager
def request(name: str, images: int):
    """A ``Request`` current for the enclosed code, ended on exit (and not
    kept when the code raises)."""
    req = Request(name, images)
    try:
        with req:
            yield req
    except BaseException:
        req.end(keep=False)
        raise
    req.end()


class annotate:
    """A span ``name`` over the enclosed code.  It belongs to ``request``
    (a ``Request``; a thread of its own passes it explicitly) or else to
    this thread's current request; its parent is the innermost open span of
    that request on this thread, or the request's root.  Outside any
    request it is not kept.  While a profiler runs it is also a
    ``record_function`` range.  As a decorator, ``@annotate(name)`` opens a
    fresh span around every call of the function."""

    __slots__ = ("name", "request", "span", "_rf")

    def __init__(self, name: str, request: Optional[Request] = None):
        self.name = name
        self.request = request
        self.span = self._rf = None

    def __enter__(self):
        self._rf = _record_function(self.name)
        req = self.request = self.request or _local.request
        if req is not None:
            open_ = _local.open
            rid = req.root["id"]
            parent = open_[-1]["id"] if open_ and open_[-1]["request"] == rid else rid
            self.span = {"name": self.name, "id": next(_ids), "parent": parent, "request": rid,
                         "start_ns": time.time_ns(), "end_ns": None}
            open_.append(self.span)
        return self

    def __exit__(self, *exc):
        if self.span is not None:
            self.span["end_ns"] = time.time_ns()
            _local.open.pop()
            self.request.record["spans"].append(self.span)
        if self._rf is not None:
            self._rf.__exit__(None, None, None)

    def __call__(self, fn):
        name = self.name

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with annotate(name):
                return fn(*args, **kwargs)

        return spanned


def count(key: str, n: int = 1) -> None:
    """Add ``n`` to counter ``key`` of this thread's current request (none:
    nothing)."""
    req = _local.request
    if req is not None:
        req.count(key, n)


def requests() -> List[Dict]:
    """The kept requests, oldest first: each ``{"id", "spans", "counters",
    "profiled"}``; ``spans[0]`` is the root, every span ``{"name", "id",
    "parent", "request", "start_ns", "end_ns"}``."""
    return list(_requests)
