"""Device idle share of an image's wall time in batched detection
(``readings.idle_pct``)."""

from bench_lib import readings


def read(rec):
    return readings.idle_pct(rec)
