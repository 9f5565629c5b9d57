"""95th percentile of the time from a frame being handed to ``predict``
until its rows are on the host, over every call of the traced run before
the profiled range (the profiler slows the calls it records and the ones
after it)."""

import numpy as np


def read(rec):
    if rec["kind"] != "infer":
        return None
    ms = [c["ms"] for c in rec["calls"][:int(rec["traffic"]["trace"]["first_call"])]]
    return float(np.percentile(ms, 95)) if ms else None
