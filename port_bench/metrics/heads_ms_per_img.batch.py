"""Device ms per image of the heads alone in batched detection
(``readings.layer_ms``)."""

from bench_lib import readings


def read(rec):
    return readings.layer_ms(rec, "heads_ms_per_img")
