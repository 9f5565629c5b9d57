"""The reference against the program's plain float32 path on the CPU at
64x96: the same decoded rows of every anchor, and the same greedy picks.
(This test imports both; the reference imports nothing of the program.)"""

import numpy as np
import pytest
import torch

from bench_lib import cells, frames, seeds, weights
from reference import judge
from reference import yolov3 as ref_model

from bayesian_yolov3_torch.infer.runner import InferenceRunner
from bayesian_yolov3_torch.ops.cuda_nms import greedy_nms_plain

# T=8: the 4x4 covariance of fewer than five samples is singular, its determinant rounding noise
SMALL = {"full_img_size": [64, 96, 3], "compute_dtype": "float32", "T": 8}


def _program_rows(cfg, params, stats, imgs, keys):
    drv = cells.module("drivers", "predict_stream")
    runner = InferenceRunner(drv.program_config(cfg, imgs.shape[0], False), device="cpu")
    return runner._decoded_rows(params, stats, imgs, keys)


@pytest.mark.parametrize("cell,nb", [("epistemic_T30_batch1", 1), ("aleatoric_batch11", 2)])
def test_reference_rows_equal_the_program_float32(cell, nb):
    cfg = {**cells.cell(cell)["config"], **SMALL}
    seed = 2**31 + 7
    params, stats = weights.make(cfg, seed, "cpu")
    imgs = torch.from_numpy(frames.pool(seed, nb, cfg["full_img_size"][:2], "cpu"))
    keys = (seeds.rng(seed, "keys").integers(0, 2**32, (8, 15), dtype=np.uint32)
            if cfg.get("epistemic") else None)
    got = _program_rows(cfg, params, stats, imgs, keys)
    want = ref_model.decoded_rows(cfg, params, stats, imgs, keys)
    assert got.shape == want.shape
    cols = judge.columns(bool(cfg.get("epistemic")), cfg["cls_cnt"])
    exact = [c for c in range(want.shape[2]) if c not in cols["var"] + cols["det"]]
    torch.testing.assert_close(got[..., exact], want[..., exact], rtol=1e-4, atol=2e-5)
    # variances: the program's E[xx^T] - E[x]E[x]^T against the centred form
    torch.testing.assert_close(got[..., cols["var"]], want[..., cols["var"]],
                               rtol=2e-3, atol=1e-7)
    if cols["det"]:  # a 4x4 determinant, a difference of products of near-equal numbers
        det = want[..., cols["det"]]
        torch.testing.assert_close(got[..., cols["det"]], det, rtol=1e-2,
                                   atol=1e-3 * float(det.abs().median()))


def test_reference_greedy_nms_equals_the_programs():
    g = torch.Generator().manual_seed(3)
    for n, max_out in ((64, 10), (700, 50)):
        c = torch.rand(n, 2, generator=g)
        wh = torch.rand(n, 2, generator=g) * 0.4
        boxes = torch.cat([c - wh / 2, c + wh / 2], dim=1)
        scores = torch.rand(n, generator=g)
        scores[5] = scores[9]  # a tie: the lower index first
        scores[11] = float("-inf")
        want, cnt = greedy_nms_plain(boxes[None], scores[None], max_out, 0.5)
        got = judge.greedy_nms(boxes, scores, max_out, 0.5)
        assert got.tolist() == want[0, :cnt[0]].tolist()


def test_yardstick_is_the_reference_rounded_to_bf16():
    cfg = {**cells.cell("aleatoric_batch11")["config"], **SMALL}
    params, stats = weights.make(cfg, 5, "cpu")
    imgs = torch.from_numpy(frames.pool(5, 1, (64, 96), "cpu"))
    f32 = ref_model.decoded_rows(cfg, params, stats, imgs, None)
    bf16 = ref_model.decoded_rows(cfg, params, stats, imgs, None, dtype=torch.bfloat16)
    gap = (bf16[..., :4] - f32[..., :4]).abs().max()
    assert 0 < gap < 0.05  # rounded, and near
