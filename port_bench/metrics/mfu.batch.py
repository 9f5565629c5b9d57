"""The whole step's share of the card's bf16 peak in batched detection
(``readings.mfu_pct``)."""

from bench_lib import readings


def read(rec):
    return readings.mfu_pct(rec)
