"""The FLOP counter against a count of the reference's own convolutions,
and the bound arithmetic against the chip smoke's recorded bytes and
operations (PERF.md, the kernel table)."""

import torch
import torch.nn.functional as F

from bench_lib import cells, flops, peaks, weights
from reference import yolov3 as ref_model

EPI = cells.cell("epistemic_T30_batch1")["config"]
ALE = cells.cell("aleatoric_batch11")["config"]


def test_counter_matches_the_convolutions_run(monkeypatch):
    """Every F.conv2d the reference runs on one 64x96 image, counted from
    its operands' shapes, sums to the counter's backbone + heads."""
    counted = []
    conv = F.conv2d

    def counting(x, w, *a, **kw):
        y = conv(x, w, *a, **kw)
        n, co, ho, wo = y.shape
        counted.append(2.0 * n * ho * wo * w.shape[1] * co * w.shape[2] * w.shape[3])
        return y

    monkeypatch.setattr(ref_model.F, "conv2d", counting)
    p, s = weights.make(ALE, 1, "cpu")
    img = torch.zeros((1, 64, 96, 3), dtype=torch.uint8)
    ref_model.decoded_rows({**ALE, "full_img_size": [64, 96, 3]}, p, s, img, None)
    assert len(counted) == 52 + 20 + 3
    f = flops.conv_flops(ALE, (64, 96))
    assert abs(sum(counted) - (f["backbone"] + f["heads"])) < 1e-6 * sum(counted)


def test_counter_at_the_cells_size():
    f = flops.conv_flops(EPI, (1024, 1920))
    assert round(f["backbone"] / 1e9, 1) == 557.0 and round(f["heads"] / 1e9, 1) == 185.4
    assert abs(flops.inference_per_image(EPI) - (f["backbone"] + 30 * f["heads"])) < 1
    assert abs(flops.inference_per_image(ALE) - (f["backbone"] + f["heads"])) < 1
    g = flops.conv_flops(ALE, (768, 1440))
    assert flops.training_per_image(ALE, (768, 1440)) == g["backbone"] + 3 * g["heads"]


def _rec(cfg, batch, calls, picks=None):
    return {"config": cfg, "batch": batch, "image_hw": (1024, 1920),
            "run": {"traced_calls": calls}, "traffic": {"trace": {"first_call": 0}},
            "calls": [{"nms_runs": 1, "picks": picks or [1000] * batch}] * calls}


def test_kernel_work_matches_the_smoke_record():
    res = cells.module("kernels", "fused_res_block")
    nbytes, fl, peak = res.work(_rec(EPI, 1, 1))
    assert round(fl / 1e9) == 221 and peak == peaks.BF16_FLOPS  # 221 GFLOP over the 11
    epi = cells.module("kernels", "epistemic_decode")
    nbytes, fl, peak = epi.work(_rec(EPI, 1, 2))
    assert round(nbytes / 2 / 1e6, 1) == 170.8 and peak == peaks.FP32_FLOPS  # per frame
    box = cells.module("kernels", "box_decode")
    nbytes, fl, _ = box.work(_rec(ALE, 11, 1))
    assert round(nbytes / 1e6, 1) == 143.7  # a batch of 11
    nms = cells.module("kernels", "greedy_nms")
    nbytes, fl, _ = nms.work(_rec(EPI, 1, 3))
    assert fl == 3 * 1000 * 8192 * 18


def test_bound_is_the_slower_of_bytes_and_operations():
    assert peaks.bound_s(3.35e12, 0) == 1.0
    assert peaks.bound_s(0, 989e12) == 1.0
    assert peaks.bound_s(3.35e12, 2 * 989e12) == 2.0
    assert peaks.bound_s(0, 67e12, peaks.FP32_FLOPS) == 1.0
