"""Device ms per image of the 15 hash-dropout sites alone, at their shapes
in the camera stream (``readings.layer_ms``)."""

from bench_lib import readings


def read(rec):
    return readings.layer_ms(rec, "dropout_ms_per_img")
