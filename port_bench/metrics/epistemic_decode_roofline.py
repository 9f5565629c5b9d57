"""``epistemic_decode``'s share of its roofline in the traced calls
(``kernels/epistemic_decode.py`` counts its work)."""

from bench_lib import roofline


def read(rec):
    return roofline.share(rec, "epistemic_decode")
