"""``fused_res_block``'s share of its roofline in the traced calls in
batched detection (``kernels/fused_res_block.py`` counts its work)."""

from bench_lib import roofline


def read(rec):
    return roofline.share(rec, "fused_res_block")
