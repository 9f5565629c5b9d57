"""Host ms per frame in the 15 ``byolo.dropout`` spans (the hash-dropout
sites' enqueue over their T samples), the plain calls of the traced run
(``spans.ms_per_image``)."""

from bench_lib import spans


def read(rec):
    return spans.ms_per_image(rec, "byolo.dropout")
