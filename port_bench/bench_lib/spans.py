"""The program's own spans and counters (``bayesian_yolov3_torch.utils.
profiling``: each ``InferenceRunner.predict`` call is one request record),
read in the run's process after the window.  A traced run's metrics read
the plain calls: the ``first_call`` requests just before the profiled ones,
the calls ``latency_p95_ms`` reads, since the profiler slows the host.  A
program that keeps no requests (one without the spans) gives None, as does
a run with fewer plain calls than that."""

from __future__ import annotations

from typing import Callable, Dict, List, Optional


def _kept() -> Optional[List[Dict]]:
    from bayesian_yolov3_torch.utils import profiling

    requests = getattr(profiling, "requests", None)
    return None if requests is None else requests()


def plain_requests(rec: Dict) -> Optional[List[Dict]]:
    """The ``first_call`` requests before the last run of profiled ones (in
    a run's process the only one), none of them profiled; None where there
    are fewer."""
    if rec["kind"] != "infer":
        return None
    reqs = _kept()
    if not reqs:
        return None
    n = int(rec["traffic"]["trace"]["first_call"])
    last = max((i for i, r in enumerate(reqs) if r["profiled"]), default=None)
    if last is None:
        return None
    first = last
    while first > 0 and reqs[first - 1]["profiled"]:
        first -= 1
    plain = reqs[max(first - n, 0):first]
    return None if len(plain) < n or any(r["profiled"] for r in plain) else plain


def span_ms(reqs: List[Dict], keep: Callable[[str], bool]) -> float:
    """Host ms of every span whose name ``keep`` takes."""
    return sum(s["end_ns"] - s["start_ns"] for r in reqs for s in r["spans"]
               if keep(s["name"])) * 1e-6


def ms_per_image(rec: Dict, name: str) -> Optional[float]:
    """Host ms per image of span ``name`` in the plain calls."""
    reqs = plain_requests(rec)
    if reqs is None:
        return None
    return span_ms(reqs, lambda s: s == name) / sum(r["counters"]["images"] for r in reqs)


def wait_pct(rec: Dict) -> Optional[float]:
    """Share of the plain calls' host time (root spans) spent waiting for
    the device (``byolo.wait.*`` spans)."""
    reqs = plain_requests(rec)
    if reqs is None:
        return None
    whole = sum(r["spans"][0]["end_ns"] - r["spans"][0]["start_ns"] for r in reqs) * 1e-6
    return 100.0 * span_ms(reqs, lambda s: s.startswith("byolo.wait.")) / whole


def retry_pct(rec: Dict) -> Optional[float]:
    """Share of the plain calls that took the exact-NMS retry (counter
    ``nms_exact_retry``)."""
    reqs = plain_requests(rec)
    if reqs is None:
        return None
    return 100.0 * sum(r["counters"]["nms_exact_retry"] for r in reqs) / len(reqs)
