"""Host ms per image in the ``byolo.h2d`` span (the uint8 batch copied from
pageable memory onto the card, staged by the host), the plain calls of the
traced run (``spans.ms_per_image``)."""

from bench_lib import spans


def read(rec):
    return spans.ms_per_image(rec, "byolo.h2d")
