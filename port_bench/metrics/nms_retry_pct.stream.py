"""Share of the camera stream's plain calls that took the exact-NMS retry
(the program's ``nms_exact_retry`` counter; ``spans.retry_pct``)."""

from bench_lib import spans


def read(rec):
    return spans.retry_pct(rec)
