"""Share of offline detection's plain calls (batches) that took the
exact-NMS retry (the program's ``nms_exact_retry`` counter;
``spans.retry_pct``)."""

from bench_lib import spans


def read(rec):
    return spans.retry_pct(rec)
