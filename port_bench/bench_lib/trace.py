"""``torch.profiler`` over a steady sub-window of the run, reduced to what
the per-layer metrics and the breakdown read: device busy time, kernel time
by name, and the device's idle gaps named by what the host was doing."""

from __future__ import annotations

import bisect
import json
import os
import re
import tempfile
from collections import defaultdict
from typing import Dict, List, Optional

WINDOW = "pb.trace_window"  # the harness's range around the traced calls
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
SHORT_GAP_US = 10.0  # gaps under this are summed under one name


def profiler():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def device_ms(fn, reps: int) -> float:
    """Device ms of one call of ``fn``: the time some operation ran on the
    device in the profiler's trace of ``reps`` calls, after one call that is
    not traced, over ``reps``."""
    import torch

    fn()
    torch.cuda.synchronize()
    with profiler() as prof:
        with torch.profiler.record_function(WINDOW):
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
    return 1e3 * export(prof)["busy_s"] / reps


def export(prof) -> Dict:
    """The profile's Chrome trace, reduced (see ``reduce``); the file is
    written under the run's temp directory and removed."""
    fd, path = tempfile.mkstemp(prefix="pb_trace_", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    finally:
        os.remove(path)
    return reduce(data)


def _union(intervals):
    """Sorted disjoint union of (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _innermost(host, starts, t) -> Optional[dict]:
    """The host event with the latest start at or before ``t`` that is still
    running at ``t`` (the innermost of the nested ranges around ``t``)."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - 400, -1), -1):
        e = host[j]
        if e["ts"] + e["dur"] >= t:
            return e
    return None


def reduce(data) -> Dict:
    events = data["traceEvents"] if isinstance(data, dict) else data
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    wins = [e for e in xs if e.get("name") == WINDOW and e.get("cat") == "user_annotation"]
    if not wins:
        return {}
    win = wins[0]
    w0, w1 = float(win["ts"]), float(win["ts"]) + float(win["dur"])
    dev = []
    for e in xs:
        if e.get("cat") not in DEVICE_CATS:
            continue
        s, t = max(float(e["ts"]), w0), min(float(e["ts"]) + float(e["dur"]), w1)
        if t > s:
            dev.append((s, t, e["name"], e["cat"]))
    by_name: Dict[str, float] = defaultdict(float)
    for s, t, name, _ in dev:
        by_name[name] += (t - s) * 1e-6
    busy = _union([(s, t) for s, t, _, _ in dev])
    busy_s = sum(t - s for s, t in busy) * 1e-6
    # idle gaps, named by the host's innermost range at the gap's middle and
    # by the device op that ends the gap
    host = sorted((e for e in xs if e.get("cat") in HOST_CATS and e.get("tid") == win.get("tid")
                   and e.get("pid") == win.get("pid") and e.get("name") != WINDOW),
                  key=lambda e: float(e["ts"]))
    starts = [float(e["ts"]) for e in host]
    dev_starts = sorted((s, name) for s, _, name, _ in dev)
    ds = [s for s, _ in dev_starts]
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps: Dict[str, float] = defaultdict(float)
    for g0, g1 in zip(edges[0::2], edges[1::2]):
        if g1 <= g0:
            continue
        if g1 - g0 < SHORT_GAP_US:
            gaps[f"gaps under {SHORT_GAP_US:g} us"] += (g1 - g0) * 1e-6
            continue
        h = _innermost(host, starts, (g0 + g1) / 2)
        k = bisect.bisect_left(ds, g1)
        nxt = dev_starts[k][1][:48] if k < len(dev_starts) else "window end"
        gaps[f"{h['name'][:48] if h else 'host, no op'} -> {nxt}"] += (g1 - g0) * 1e-6
    return {"window_s": (w1 - w0) * 1e-6, "busy_s": busy_s,
            "device_ops": dict(by_name), "idle_gaps": dict(gaps)}


def kernel_s(tr: Dict, pattern: str) -> float:
    """Device seconds of the ops whose name matches ``pattern`` (a regex)."""
    rx = re.compile(pattern)
    return sum(s for name, s in tr.get("device_ops", {}).items() if rx.search(name))


def top(d: Dict[str, float], n: int = 10) -> List[list]:
    return [[k[:120], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]
