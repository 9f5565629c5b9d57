"""``csrc/epistemic_decode.cu``: one launch a scale, the T samples of every
anchor reduced to its epistemic row.  Bytes: the 9+C channels read of each
sample (not the stddev channels), the rows written, the priors."""

from bench_lib import peaks
from reference import arch

PATTERN = r"epistemic_decode_kernel"


def work(rec):
    cfg = rec["config"]
    t, c, nb = cfg["T"], cfg["cls_cnt"], rec["batch"]
    h, w = rec["image_hw"]
    nbytes = flops = 0
    for s in arch.STRIDES:
        cells = (h // s) * (w // s)
        nbytes += (3 * (9 + c) * t * nb * cells + nb * 3 * cells * (21 + c) + 3 * 2) * 4
        # per anchor-sample: 4 sums, 10 products and sums, 4+1+C exp, entropies
        flops += t * nb * cells * 3 * (60 + 12 * c)
    calls = rec["run"]["traced_calls"]
    return calls * nbytes, calls * flops, peaks.FP32_FLOPS
