"""``csrc/box_decode.cu``: one launch over the three scales of a batch.
Bytes: the channels it reads (the aleatoric head's two stddev groups are
not read), the rows written, the priors."""

from bench_lib import peaks
from reference import arch

PATTERN = r"box_decode_kernel"


def work(rec):
    cfg = rec["config"]
    c, nb = cfg["cls_cnt"], rec["batch"]
    aleatoric = cfg["variant"] in ("aleatoric", "bayesian")
    h, w = rec["image_hw"]
    rows = 3 * sum((h // s) * (w // s) for s in arch.STRIDES)
    n_read, width = (9 + c, 14 + c) if aleatoric else (5 + c, 7 + c)
    nbytes = (n_read * nb * rows + nb * rows * width + 18) * 4
    flops = nb * rows * (40 + 12 * c)
    calls = rec["run"]["traced_calls"]
    return calls * nbytes, calls * flops, peaks.FP32_FLOPS
