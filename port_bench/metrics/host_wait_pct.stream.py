"""Share of a frame's host time in the camera stream spent waiting for
the device: ``byolo.wait.*`` spans over ``byolo.predict`` spans, the plain
calls of the traced run (``spans.wait_pct``)."""

from bench_lib import spans


def read(rec):
    return spans.wait_pct(rec)
