"""The whole step's share of the card's bf16 peak in the camera stream
(``readings.mfu_pct``)."""

from bench_lib import readings


def read(rec):
    return readings.mfu_pct(rec)
