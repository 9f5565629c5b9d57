"""``csrc/greedy_nms.cu``: three kernels a chunk of sorted candidates, all
images of a call in each launch.  A pick costs one IoU and a compare against
every candidate: picks x K x 18 operations, with the picks these inputs make;
K is the pre-top-k cut, and all anchors on an exact retry.  Bytes: boxes
and scores read, indices written."""

from bench_lib import peaks
from bench_lib.roofline import traced_calls
from reference import arch

PATTERN = r"nms_presuppress|nms_mask|nms_scan"


def work(rec):
    cfg = rec["config"]
    h, w = rec["image_hw"]
    n = 3 * sum((h // s) * (w // s) for s in arch.STRIDES)
    top = cfg["nms_pre_top_k"]
    ks = [min(top, n) if top else n, n]  # the certified run, then the exact retry
    nbytes = flops = 0
    for call in traced_calls(rec):
        for k in ks[:call["nms_runs"]]:
            nbytes += len(call["picks"]) * (k * 20 + cfg["nms_max_boxes"] * 4 + 4)
            flops += sum(call["picks"]) * k * 18
    return nbytes, flops, peaks.FP32_FLOPS
