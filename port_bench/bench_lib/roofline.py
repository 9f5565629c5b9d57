"""A kernel's share of its roofline over the traced calls: the least time
its work can take on the published peaks (``kernels/<kernel>.py`` counts
the bytes and operations) over the device time of its launches in the
trace."""

from __future__ import annotations

from typing import Dict, Optional

from . import cells, peaks, trace


def share(rec: Dict, kernel: str) -> Optional[float]:
    """Percent, or None where the trace holds no launch of the kernel."""
    tr = rec.get("trace")
    if not tr or not rec["run"].get("traced_calls"):
        return None
    k = cells.module("kernels", kernel, rec["root"])
    spent = trace.kernel_s(tr, k.PATTERN)
    if spent <= 0:
        return None
    nbytes, flops, peak = k.work(rec)
    return 100.0 * peaks.bound_s(nbytes, flops, peak) / spent


def traced_calls(rec: Dict):
    """The per-call records of the traced calls."""
    first = int(rec["traffic"]["trace"]["first_call"])
    return rec["calls"][first:first + rec["run"]["traced_calls"]]
