"""Images of batched detection whose rows reached the host in the window,
over all of the window's time (``readings.rate``)."""

from bench_lib import readings


def read(rec):
    return readings.rate(rec)
