"""Device ms per image of the backbone alone in the camera stream
(``readings.layer_ms``)."""

from bench_lib import readings


def read(rec):
    return readings.layer_ms(rec, "backbone_ms_per_img")
