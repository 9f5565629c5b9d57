"""Share of a batch's host time in offline detection spent waiting for
the device: ``byolo.wait.*`` spans over ``byolo.predict`` spans, the plain
calls of the traced run (``spans.wait_pct``)."""

from bench_lib import spans


def read(rec):
    return spans.wait_pct(rec)
