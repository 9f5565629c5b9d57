"""``greedy_nms``'s share of its roofline in the traced calls in batched
detection (``kernels/greedy_nms.py`` counts its work)."""

from bench_lib import roofline


def read(rec):
    return roofline.share(rec, "greedy_nms")
