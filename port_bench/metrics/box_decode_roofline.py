"""``box_decode``'s share of its roofline in the traced calls
(``kernels/box_decode.py`` counts its work)."""

from bench_lib import roofline


def read(rec):
    return roofline.share(rec, "box_decode")
