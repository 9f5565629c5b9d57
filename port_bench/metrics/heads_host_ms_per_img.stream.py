"""Host ms per frame in the ``byolo.heads`` span (the T-sample head
section's enqueue, its dropout sites and device waits inside it included),
the plain calls of the traced run (``spans.ms_per_image``)."""

from bench_lib import spans


def read(rec):
    return spans.ms_per_image(rec, "byolo.heads")
