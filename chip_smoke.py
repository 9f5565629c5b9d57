#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port starts and is right on an
NVIDIA Hopper GPU.  Run from the repository root, no arguments, one card:

    python3 chip_smoke.py

It imports only ``bayesian_yolov3_torch``, torch, numpy and the standard
library; needs a CUDA device (exits non-zero without one) and ``nvcc``
(every kernel is built from ``bayesian_yolov3_torch/csrc`` in this run).

Phases, each printing one JSON line:

device      card name and power limit (nvidia-smi), torch / CUDA versions
build       seconds to build the CUDA kernels
kernels     each kernel against its plain PyTorch version on the card at the
            main path's shapes; times by CUDA events
small_ref   the whole pipeline at 64x96 on the card (kernels, cuDNN) against
            the same pipeline on the CPU (plain versions), in float32 and bf16
main_path   epistemic inference at full width — bayesian, 1024x1920, T=30 —
            through InferenceRunner.run(): tfrecord -> checkpoint -> ECP JSON,
            in bf16 (the Config default: fused early backbone, five kernels)
            and in float32 (two kernels); kernel launch counters set to 0
            before each run and read after it; a packed_host_input run
main_path_batched
            batched aleatoric / standard inference at full width — 1024x1920,
            batch 11, 13 frames (one full batch, one padded batch of 2) —
            through InferenceRunner.run() in bf16 and float32, a packed run,
            an exact-NMS retry, and one Detector call on a PNG file
timing      img/s of each path after a warm-up, a stage breakdown, and for the
            batched paths run()'s wall img/s beside the host loader and the
            JSON writer, each timed alone

Then the card line, one ``{"kernels": [...]}`` line and, last,
``{"ok": true, "device": {...}}``.  Any failed check raises: the script
then exits non-zero and prints no result line.
"""

import glob
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from bayesian_yolov3_torch.config import Config, DataConfig
from bayesian_yolov3_torch.convert import tree_to
from bayesian_yolov3_torch.core.priors import priors_as_array
from bayesian_yolov3_torch.data import pipeline, proto, tfrecord
from bayesian_yolov3_torch.infer.detect import Detector
from bayesian_yolov3_torch.infer.runner import InferenceRunner
from bayesian_yolov3_torch.models import darknet, yolov3
from bayesian_yolov3_torch.ops import (
    _build, common, cuda_conv, cuda_decode, cuda_epistemic, cuda_nms, nms)
from bayesian_yolov3_torch.train.checkpoints import CheckpointStore
from bayesian_yolov3_torch.train.loop import partition_params

# published peaks of one H100 SXM (NVIDIA data sheet): the yardstick of bound_ms
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
BF16_FLOPS = 989e12  # dense, tensor cores

IMG = (1024, 1920, 3)
T = 30
C = 2
MAX_OUT = 1000
PRE_TOP_K = 8192
N_ANCHORS = 3 * (32 * 60 + 64 * 120 + 128 * 240)  # 120960
SCALES = ((32, 60), (64, 120), (128, 240))  # strides 32, 16, 8 of 1024x1920
BATCH = 11  # the batched CLIs' batch_size (cli/inference_{standard_yolov3,aleatoric}.py)
N_BATCHED_FRAMES = 13  # one full batch of 11 and one padded batch of 2

# kernel 1 against its plain version: float32 sums over T in another order.
# Columns 0..11 (corners, variances) and 13.. (entropies, whose x*log(x)
# terms cancel) as in the JAX package's own kernel test; column 12, the 4x4
# covariance determinant, is a difference of products of near-equal numbers.
EPI_TOL = (((0, 12), 1e-4, 1e-5), ((12, 13), 1e-3, 1e-6), ((13, 21 + C), 1e-4, 2e-4))

# the three conv kernels against their plain versions: both round to bf16 at
# the same points and differ in the order of the float32 sums, so an element
# differs where a sum lies on a rounding boundary, by one bf16 step (2^-8
# relative); a flipped intermediate can move the output by a second step.
# Two steps relative, plus 0.01 absolute for values near zero (one step of an
# O(1) summand that cancelled).  The JAX package's own bound for its kernels
# is rtol = atol = 0.05.
CONV_RTOL, CONV_ATOL = 2.0 ** -6, 1e-2
CONV_MAX_DIFF_SHARE = 0.05  # of elements that differ at all


def emit(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def event_ms(fn, reps, flush=None):
    """Median time of ``fn`` in ms by CUDA events, one launch per reading;
    ``flush`` (a tensor larger than L2) is overwritten between readings so
    each launch finds the cache cold, as after the producing matmul of a
    155 MB tensor."""
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


# --------------------------------------------------------------------------
# kernels
# --------------------------------------------------------------------------


def check_epistemic(dev, flush):
    gen = torch.Generator(device=dev).manual_seed(0)
    priors = torch.tensor([[0.3, 0.1], [0.15, 0.05], [0.08, 0.02]], device=dev)
    shapes = [(1, h, w) for h, w in SCALES] + [(2, 32, 60)]
    per_shape = []
    for layer_id, (nb, h, w) in enumerate(shapes):
        raw = torch.randn((3 * 2 * (5 + C), T, nb * h * w), generator=gen, device=dev)
        kw = dict(n_imgs=nb, h=h, w=w, cls_cnt=C, layer_id=layer_id % 3)
        got = cuda_epistemic.fused_epistemic_decode_cf_batched(raw, priors, **kw)
        torch.cuda.synchronize()
        want = cuda_epistemic.epistemic_decode_plain(raw, priors, **kw)
        torch.cuda.synchronize()
        check(got.shape == want.shape == (nb, 3 * h * w, 21 + C), f"shape {got.shape}")
        check(bool(torch.isfinite(got).all()), "epistemic_decode: non-finite output")
        for (lo, hi), rtol, atol in EPI_TOL:
            ok = torch.allclose(got[..., lo:hi], want[..., lo:hi], rtol=rtol, atol=atol)
            check(ok, f"epistemic_decode disagrees with its plain version at "
                      f"{(nb, h, w)}, columns {lo}:{hi} (rtol {rtol}, atol {atol}): max abs "
                      f"{float((got[..., lo:hi] - want[..., lo:hi]).abs().max())}")
        ms = event_ms(lambda: cuda_epistemic.fused_epistemic_decode_cf_batched(
            raw, priors, **kw), 10, flush)
        plain_ms = event_ms(lambda: cuda_epistemic.epistemic_decode_plain(
            raw, priors, **kw), 3, flush)
        nbytes = raw.numel() * 4 + got.numel() * 4 + priors.numel() * 4
        # per anchor-sample: 4 sums, 10 products+sums, 4+1+C exp, entropies
        flops = raw.shape[1] * raw.shape[2] * 3 * (60 + 12 * C)
        per_shape.append({
            "shape": [int(s) for s in raw.shape], "n_imgs": nb,
            "max_abs_err": float((got - want).abs().max()),
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS) * 1e3,
            "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S >= flops / FP32_FLOPS
            else "operations",
            "bytes": nbytes,
        })
        del raw, got, want
    main = per_shape[:3]  # one image of the main path = these three launches
    return {
        "name": "epistemic_decode", "route": "cuda",
        "source": "bayesian_yolov3_torch/csrc/epistemic_decode.cu",
        "replaces": "bayesian_yolov3_tpu/ops/pallas_epistemic.py:62",
        "max_abs_err": max(s["max_abs_err"] for s in per_shape),
        "ms": sum(s["ms"] for s in main),
        "plain_ms": sum(s["plain_ms"] for s in main),
        "bound_ms": sum(s["bound_ms"] for s in main),
        "bound_by": "bytes", "library_ms": None,
        "tolerance": [{"columns": list(c), "rtol": r, "atol": a} for c, r, a in EPI_TOL],
        "note": "ms/plain_ms/bound_ms: the three launches of one 1024x1920 image summed",
        "shapes": per_shape,
    }


# kernel 9 against its plain version: the same elementwise float32 math
# (sigmoid, exp, softmax, x*log(x), a correctly rounded division by the grid
# size) from two libraries, a few ulp apart; ids exactly.
BOX_TOL = (1e-5, 1e-6)


def check_box_decode(dev, flush):
    """Kernel against plain version at the three ECP scales, nb 1 and 11,
    standard and aleatoric, C 1 / 2 / 8, plus a ragged (3, 3, 5); times at
    the main path's shapes (nb 11, C 2), summed over the three scales."""
    gen = torch.Generator(device=dev).manual_seed(5)
    priors = torch.tensor([[0.3, 0.1], [0.15, 0.05], [0.08, 0.02]], device=dev)
    rtol, atol = BOX_TOL
    cases = [(nb, h, w) for nb in (1, BATCH) for h, w in SCALES] + [(3, 3, 5)]
    checked, worst, worst_ratio, timed = 0, 0.0, 0.0, {}
    for aleatoric in (False, True):
        for c in (1, 2, 8):
            chpp = 2 * (5 + c) if aleatoric else 5 + c
            for k, (nb, h, w) in enumerate(cases):
                raw = torch.randn((3 * chpp, nb, h * w), generator=gen, device=dev) * 2.0
                kw = dict(h=h, w=w, cls_cnt=c, layer_id=k % 3, aleatoric=aleatoric)
                got = cuda_decode.fused_box_decode_cf(raw, priors, **kw)
                torch.cuda.synchronize()
                want = cuda_decode.box_decode_plain(raw, priors, **kw)
                torch.cuda.synchronize()
                name = f"box_decode(aleatoric={aleatoric}, C={c}, {(nb, h, w)})"
                check(got.shape == want.shape == (nb, 3 * h * w, (14 if aleatoric else 7) + c),
                      f"{name}: shape {tuple(got.shape)}")
                check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
                check(torch.equal(got[..., -2:], want[..., -2:]), f"{name}: id columns differ")
                err = (got[..., :-2] - want[..., :-2]).abs()
                ratio = float((err / (atol + rtol * want[..., :-2].abs())).max())
                check(ratio <= 1.0, f"{name} disagrees with its plain version (rtol {rtol}, "
                                    f"atol {atol}): max abs {float(err.max())}")
                worst = max(worst, float(err.max()))
                worst_ratio = max(worst_ratio, ratio)
                checked += 1
                if nb == BATCH and c == C:
                    # bytes the function must move: the channels it reads
                    # (the aleatoric head's two stddev groups are not read),
                    # the rows, the priors
                    n_read = (9 if aleatoric else 5) + c
                    nbytes = (3 * n_read * nb * h * w + got.numel() + priors.numel()) * 4
                    flops = 3 * nb * h * w * (40 + 12 * c)
                    rec = timed.setdefault(aleatoric, {"ms": 0.0, "plain_ms": 0.0,
                                                       "back_to_back_ms": 0.0,
                                                       "bytes": 0, "flops": 0})
                    rec["ms"] += event_ms(lambda: cuda_decode.fused_box_decode_cf(
                        raw, priors, **kw), 10, flush)
                    rec["plain_ms"] += event_ms(lambda: cuda_decode.box_decode_plain(
                        raw, priors, **kw), 3, flush)
                    # 20 launches back to back, no flush: the host's launch
                    # latency hidden behind the queue
                    rec["back_to_back_ms"] += event_ms(lambda: [
                        cuda_decode.fused_box_decode_cf(raw, priors, **kw)
                        for _ in range(20)], 3) / 20
                    rec["bytes"] += nbytes
                    rec["flops"] += flops
                del raw, got, want
    for rec in timed.values():
        t_b, t_f = rec["bytes"] / HBM_BYTES_PER_S, rec["flops"] / FP32_FLOPS
        rec.update(bound_ms=max(t_b, t_f) * 1e3, bound_by="bytes" if t_b >= t_f else "operations")
    main = timed[True]
    return {
        "name": "box_decode", "route": "cuda",
        "source": "bayesian_yolov3_torch/csrc/box_decode.cu",
        "replaces": "bayesian_yolov3_tpu/ops/pallas_decode.py:26",
        "max_abs_err": worst, "ms": main["ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"], "library_ms": None,
        "tolerance": {"rtol": rtol, "atol": atol, "id_columns": "exact"},
        "max_err_over_tolerance": worst_ratio, "shapes_checked": checked,
        "aleatoric": timed[True], "standard": timed[False],
        "note": f"ms/plain_ms/bound_ms: the three aleatoric launches of one batch of {BATCH} "
                f"1024x1920 images at C={C} summed, each launch timed alone after an L2 "
                "flush (host launch latency included); back_to_back_ms: the same launches "
                "queued 20 at a time; `standard` gives the same for the standard head; no "
                "single PyTorch call computes the decode",
    }


def _random_candidates(gen, n, dev):
    yx = torch.rand((n, 2), generator=gen, device=dev) * 0.9
    hw = torch.rand((n, 2), generator=gen, device=dev) * 0.25 + 0.01
    boxes = torch.cat([yx, yx + hw], dim=1)
    return boxes, torch.rand((n,), generator=gen, device=dev)


def _nms_equal(name, boxes, scores, max_out=MAX_OUT, thresh=0.5):
    got_i, got_c = cuda_nms.greedy_nms_cuda(boxes, scores, max_out, thresh)
    torch.cuda.synchronize()
    want_i, want_c = cuda_nms.greedy_nms_plain(boxes, scores, max_out, thresh)
    torch.cuda.synchronize()
    check(torch.equal(got_c, want_c),
          f"greedy_nms[{name}]: counts {got_c.tolist()} != plain {want_c.tolist()}")
    bad = int((got_i != want_i).sum())
    check(bad == 0, f"greedy_nms[{name}]: {bad} indices differ from the plain version")
    return got_c


def check_nms(dev):
    gen = torch.Generator(device=dev).manual_seed(1)
    boxes_all, scores_all = _random_candidates(gen, 3 * N_ANCHORS, dev)
    boxes_all = boxes_all.reshape(3, N_ANCHORS, 4)
    scores_all = scores_all.reshape(3, N_ANCHORS)
    # the main path's candidates: the top 8192 by score of a full anchor set
    order = torch.sort(scores_all, dim=1, descending=True, stable=True).indices[:, :PRE_TOP_K]
    boxes_top = torch.gather(boxes_all, 1, order[:, :, None].expand(-1, -1, 4)).contiguous()
    scores_top = torch.gather(scores_all, 1, order).contiguous()
    cases = {
        "1x8192": (boxes_top[:1].contiguous(), scores_top[:1].contiguous()),
        "1x120960": (boxes_all[:1].contiguous(), scores_all[:1].contiguous()),
        "3x8192": (boxes_top, scores_top),
    }
    per_shape = []
    for name, (b, s) in cases.items():
        cnt = _nms_equal(name, b, s)
        ms = event_ms(lambda: cuda_nms.greedy_nms_cuda(b, s, MAX_OUT, 0.5), 5)
        plain_ms = event_ms(lambda: cuda_nms.greedy_nms_plain(b, s, MAX_OUT, 0.5), 1)
        nb, k = s.shape
        picks = int(cnt.max())
        nbytes = nb * (k * 20 + MAX_OUT * 4 + 4)
        # a pick costs one IoU (17 flops) + compare against every candidate
        flops = nb * picks * k * 18
        per_shape.append({
            "shape": [nb, k], "picks": cnt.tolist(), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS) * 1e3,
            "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S >= flops / FP32_FLOPS
            else "operations",
            "serial_steps": picks,
        })

    # crafted inputs: every selection rule, exactly
    crafted = {}
    b, s = _random_candidates(gen, 4096, dev)
    crafted["tied_scores"] = (b, torch.round(s * 16) / 16)
    s2 = s.clone()
    s2[torch.rand(4096, generator=gen, device=dev) < 0.6] = float("-inf")
    crafted["neg_inf_padding"] = (b, s2)
    b3 = b.clone()
    b3[::3, 2:] = b3[::3, :2]  # zero-area boxes: NaN IoU among themselves
    crafted["zero_area_nan_iou"] = (b3, torch.round(s * 16) / 16)
    big = torch.cat([torch.rand((777, 2), generator=gen, device=dev) * 0.2,
                     torch.rand((777, 2), generator=gen, device=dev) * 0.2 + 0.7], dim=1)
    crafted["fewer_than_max_out_odd_k"] = (big, torch.rand(777, generator=gen, device=dev))
    crafted["all_padding"] = (b[:100], torch.full((100,), float("-inf"), device=dev))
    dup = b.clone()
    dup[1::2] = dup[::2]
    crafted["duplicate_boxes_tied"] = (dup, s[::2].repeat_interleave(2))
    crafted_counts = {}
    for name, (bb, ss) in crafted.items():
        cnt = _nms_equal(name, bb[None].contiguous(), ss[None].contiguous())
        crafted_counts[name] = int(cnt[0])
    check(crafted_counts["fewer_than_max_out_odd_k"] < MAX_OUT, "crafted case filled up")
    check(crafted_counts["all_padding"] == 0, "-inf scores were picked")

    main = per_shape[0]
    return {
        "name": "greedy_nms", "route": "cuda",
        "source": "bayesian_yolov3_torch/csrc/greedy_nms.cu",
        "replaces": "bayesian_yolov3_tpu/ops/pallas_nms.py:156",
        "also_replaces": "bayesian_yolov3_tpu/ops/pallas_nms.py:40",
        "max_abs_err": 0.0,  # indices and counts are exactly equal, or the run fails
        "ms": main["ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": None,
        "ms_exact_retry_120960": per_shape[1]["ms"],
        "note": "ms/plain_ms/bound_ms at (1, 8192), the certified path; the real "
                "limit is the serial chain of `serial_steps` dependent argmax steps",
        "shapes": per_shape, "crafted_counts": crafted_counts,
    }


# -- the fused early backbone ------------------------------------------------


def _bound(nbytes, flops):
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return {"bound_ms": max(t_b, t_f) * 1e3, "bound_by": "bytes" if t_b >= t_f else "operations",
            "bytes": int(nbytes), "flops": int(flops)}


def _conv_weights(gen, cout, cin, k, dev):
    w = torch.randn((cout, cin, k, k), generator=gen, device=dev)
    return w * math.sqrt(2.0 / (cin * k * k))


def _conv_bn(gen, c, dev):
    """A folded BN whose bias is far from 0 (|bias| in 0.2..0.6), so a border
    that is conv-of-zeros instead of zero would show."""
    scale = torch.rand(c, generator=gen, device=dev) + 0.5
    mag = torch.rand(c, generator=gen, device=dev) * 0.4 + 0.2
    sign = torch.where(torch.rand(c, generator=gen, device=dev) < 0.5, -1.0, 1.0)
    return scale, mag * sign


def _conv_agree(name, got, want):
    """Kernel against plain version: shape, finiteness, tolerance; returns
    max abs error (all / border ring) and the share of differing elements."""
    torch.cuda.synchronize()
    check(got.shape == want.shape and got.dtype == want.dtype == torch.bfloat16,
          f"{name}: {tuple(got.shape)} {got.dtype} vs plain {tuple(want.shape)} {want.dtype}")
    g, w = got.float(), want.float()
    check(bool(torch.isfinite(g).all()), f"{name}: non-finite output")
    err = (g - w).abs()
    share = float((err > 0).float().mean())
    ring = torch.cat([err[:, 0].flatten(), err[:, -1].flatten(),
                      err[:, :, 0].flatten(), err[:, :, -1].flatten()])
    bad = err > CONV_ATOL + CONV_RTOL * w.abs()
    check(not bool(bad.any()),
          f"{name} disagrees with its plain version (rtol {CONV_RTOL}, atol {CONV_ATOL}): "
          f"{int(bad.sum())} elements, max abs {float(err.max())}, border ring max abs "
          f"{float(ring.max())}, {share:.4%} of elements differ at all")
    check(share <= CONV_MAX_DIFF_SHARE,
          f"{name}: {share:.4%} of elements differ from the plain version")
    return {"max_abs_err": float(err.max()), "border_max_abs_err": float(ring.max()),
            "differing_share": share}


def _per_image(name, shapes, counts, **extra):
    """One entry of the kernels line: times and bounds summed over the launches
    of one 1024x1920 image (``counts`` per shape), errors over every shape."""
    main = [(s, n) for s, n in zip(shapes, counts) if n]
    tot = {k: sum(s[k] * n for s, n in main)
           for k in ("ms", "kernel_only_ms", "plain_ms", "bound_ms", "unfused_ms")
           if k in shapes[0]}
    # bound_ms sums each launch's own bound; bound_by names what binds the
    # image's launches taken together
    t_bytes = sum(s["bytes"] * n for s, n in main) / HBM_BYTES_PER_S
    t_flops = sum(s["flops"] * n for s, n in main) / BF16_FLOPS
    return {"name": name, "route": "cuda",
            "source": f"bayesian_yolov3_torch/csrc/{name}.cu",
            "max_abs_err": max(s["max_abs_err"] for s in shapes),
            "border_max_abs_err": max(s["border_max_abs_err"] for s in shapes),
            "differing_share": max(s["differing_share"] for s in shapes),
            **tot, "bound_by": "bytes" if t_bytes >= t_flops else "operations",
            "tolerance": {"rtol": CONV_RTOL, "atol": CONV_ATOL},
            "launches_per_image": sum(counts), **extra, "shapes": shapes}


def check_res_block(dev, flush):
    gen = torch.Generator(device=dev).manual_seed(2)
    # (shape, launches per 1024x1920 image); the last: ragged tiles, batch 2
    cases = [((1, 512, 960, 64), 1), ((1, 256, 480, 128), 2), ((1, 128, 240, 256), 8),
             ((2, 10, 18, 128), 0), ((2, 5, 9, 256), 0), ((1, 20, 36, 64), 0)]
    shapes = []
    for shape, per_img in cases:
        n, h, w, c = shape
        x = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
        wa, wb = _conv_weights(gen, c // 2, c, 1, dev), _conv_weights(gen, c, c // 2, 3, dev)
        bna, bnb = _conv_bn(gen, c // 2, dev), _conv_bn(gen, c, dev)
        got = cuda_conv.fused_res_block(x, wa, wb, bna, bnb)
        want = cuda_conv.fused_res_block_plain(x, wa, wb, bna, bnb)
        rec = {"shape": list(shape), **_conv_agree(f"fused_res_block{shape}", got, want)}
        del got, want
        if per_img:
            wk = cuda_conv._res_kernel_weights(wa, wb)
            pa = ({"w": wa, "gamma": bna[0], "beta": bna[1]}, {"w": wb, "gamma": bnb[0], "beta": bnb[1]})
            st = [{"mean": torch.zeros_like(b[0]), "var": torch.ones_like(b[0]) - common.BN_EPS}
                  for b in (bna, bnb)]

            def unfused():  # the conv_block composition: cuDNN bf16 + elementwise passes
                t = common.conv_block(pa[0], st[0], x, compute_dtype=torch.bfloat16)
                return common.conv_block(pa[1], st[1], t, compute_dtype=torch.bfloat16) + x

            rec.update(
                ms=event_ms(lambda: cuda_conv.fused_res_block(x, wa, wb, bna, bnb), 10, flush),
                kernel_only_ms=event_ms(lambda: cuda_conv._res_launch(x, *wk, bna, bnb), 10, flush),
                plain_ms=event_ms(lambda: cuda_conv.fused_res_block_plain(x, wa, wb, bna, bnb),
                                  3, flush),
                unfused_ms=event_ms(unfused, 5, flush),
                **_bound(2 * x.numel() * 2 + (wa.numel() + wb.numel()) * 2 + 3 * c * 4,
                         n * h * w * 10 * c * c))
        shapes.append(rec)
    return _per_image(
        "fused_res_block", shapes, [k for _, k in cases], library_ms=None,
        replaces="bayesian_yolov3_tpu/ops/pallas_conv.py:282",
        note="ms (the wrapper as the main path calls it, weight relayout included), "
             "kernel_only_ms, plain_ms, bound_ms, unfused_ms: the 11 launches of one "
             "1024x1920 image summed (1 at C=64, 2 at C=128, 8 at C=256); no single "
             "PyTorch call computes the block, so library_ms is null and unfused_ms "
             "times the conv_block composition (cuDNN bf16), which the port never "
             "calls for these convs on the card")


def check_downsample(dev, flush):
    gen = torch.Generator(device=dev).manual_seed(3)
    cases = [((1, 512, 960, 64), 1), ((1, 256, 480, 128), 1),
             ((2, 10, 18, 128), 0), ((2, 11, 19, 64), 0)]
    shapes = []
    for shape, per_img in cases:
        n, h, w, c = shape
        x = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
        wt, bn = _conv_weights(gen, 2 * c, c, 3, dev), _conv_bn(gen, 2 * c, dev)
        got = cuda_conv.fused_downsample(x, wt, bn)
        want = cuda_conv.fused_downsample_plain(x, wt, bn)
        rec = {"shape": list(shape), **_conv_agree(f"fused_downsample{shape}", got, want)}
        check(torch.equal(cuda_conv.fused_downsample_packed(x, wt, bn), got),
              "fused_downsample_packed differs from fused_downsample")
        n_out = got.numel()
        del got, want
        if per_img:
            wk = cuda_conv._down_kernel_weights(wt)
            xc = x.permute(0, 3, 1, 2)  # channels_last view of the NHWC tensor
            wl = wt.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
            rec.update(
                ms=event_ms(lambda: cuda_conv.fused_downsample(x, wt, bn), 10, flush),
                kernel_only_ms=event_ms(lambda: cuda_conv._down_launch(x, wk, bn), 10, flush),
                plain_ms=event_ms(lambda: cuda_conv.fused_downsample_plain(x, wt, bn), 3, flush),
                library_ms=event_ms(lambda: torch.nn.functional.conv2d(
                    xc, wl, stride=2, padding=1), 10, flush),
                **_bound(x.numel() * 2 + n_out * 2 + wt.numel() * 2 + 4 * c * 4,
                         (n_out // (2 * c)) * 2 * 9 * c * 2 * c))
        shapes.append(rec)
    counts = [k for _, k in cases]
    return _per_image(
        "fused_downsample", shapes, counts,
        library_ms=sum(s["library_ms"] * k for s, k in zip(shapes, counts) if k),
        replaces="bayesian_yolov3_tpu/ops/pallas_conv.py:488",
        also_replaces="bayesian_yolov3_tpu/ops/pallas_conv.py:395",
        note="the 2 launches of one 1024x1920 image summed (64->128 at 512x960, 128->256 "
             "at 256x480); library_ms: one F.conv2d in bf16 channels_last of the same "
             "convolution, WITHOUT the BN / LeakyReLU epilogue; the port never calls it "
             "for these convs on the card")


def check_stem(dev, flush):
    gen = torch.Generator(device=dev).manual_seed(4)
    p0 = {"w": _conv_weights(gen, 32, 3, 3, dev)}
    p1 = {"w": _conv_weights(gen, 64, 32, 3, dev)}
    k3, k2 = darknet._stem_kernels(p0["w"].to(torch.bfloat16), p1["w"].to(torch.bfloat16))
    s1, b1 = _conv_bn(gen, 32, dev)
    bn1, bn2 = (s1.repeat(4), b1.repeat(4)), _conv_bn(gen, 64, dev)
    cases = [((1, 1024, 1920), 1), ((2, 40, 72), 0), ((1, 18, 38), 0)]
    shapes = []
    for (n, h, w), per_img in cases:
        img = torch.rand((n, h, w, 3), generator=gen, device=dev)
        x = darknet._space_to_depth(img.to(torch.bfloat16))
        got = cuda_conv.fused_stem(x, k3, k2, bn1, bn2)
        want = cuda_conv.fused_stem_plain(x, k3, k2, bn1, bn2)
        rec = {"shape": list(x.shape), **_conv_agree(f"fused_stem{tuple(x.shape)}", got, want)}
        # a strided view (channels-first memory, as the host-packed planes give)
        x_cf = x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
        check(not x_cf.is_contiguous(), "the strided stem input is contiguous")
        check(torch.equal(cuda_conv.fused_stem(x_cf, k3, k2, bn1, bn2), got),
              "fused_stem: a strided view gives other values than the contiguous tensor")
        del got, want
        if per_img:
            wk = cuda_conv._stem_kernel_weights(k3, k2)
            params = {"conv_00": {**p0, "gamma": s1, "beta": b1},
                      "conv_01": {**p1, "gamma": bn2[0], "beta": bn2[1]}}
            stats = {k: {"mean": torch.zeros_like(v["gamma"]),
                         "var": torch.ones_like(v["gamma"]) - common.BN_EPS}
                     for k, v in params.items()}
            px = n * (h // 2) * (w // 2)
            rec.update(
                ms=event_ms(lambda: cuda_conv.fused_stem(x, k3, k2, bn1, bn2), 10, flush),
                kernel_only_ms=event_ms(lambda: cuda_conv._stem_launch(x, *wk, bn1, bn2),
                                        10, flush),
                plain_ms=event_ms(lambda: cuda_conv.fused_stem_plain(x, k3, k2, bn1, bn2),
                                  3, flush),
                unfused_ms=event_ms(lambda: darknet._fast_stem(params, stats, img,
                                                               torch.bfloat16), 5, flush),
                **_bound(px * (12 + 64) * 2 + (128 * 108 + 64 * 512) * 2 + 192 * 8,
                         px * 2 * (108 * 128 + 512 * 64)))
        shapes.append(rec)
    return _per_image(
        "fused_stem", shapes, [k for _, k in cases], library_ms=None,
        replaces="bayesian_yolov3_tpu/ops/pallas_conv.py:139",
        note="one launch per 1024x1920 image, on its (1, 512, 960, 12) space-to-depth "
             "form; no single PyTorch call computes the stem, so library_ms is null and "
             "unfused_ms times models.darknet._fast_stem in bf16 (two cuDNN convolutions "
             "plus elementwise passes, space-to-depth included)")


# --------------------------------------------------------------------------
# the model, data and checkpoint of the main path
# --------------------------------------------------------------------------


def random_state(seed, spec, device, wide_boxes=False):
    """Seeded random weights with O(1) activations: glorot kernels; the head
    sections' BN gain sqrt(2) makes up for the half of the variance that
    LeakyReLU removes, so the raw heads are not all ~0.

    ``wide_boxes``: a bias of +6 on every tw/th channel makes each box
    e^6 times its prior — far larger than the image, whatever its cell — so
    NMS suppresses nearly all of the top-8192 candidates, fewer than
    max_out survive, the certificate fails and the runner takes its exact
    retry."""
    gen = torch.Generator().manual_seed(seed)
    params, stats = yolov3.init_yolov3(gen, spec, device)
    for name, block in params.items():
        if name.startswith(("head", "trans")):
            block["gamma"].fill_(math.sqrt(2.0))
            block["beta"].copy_(torch.randn(block["beta"].shape, generator=gen) * 0.1)
        if wide_boxes and name.startswith("det"):
            chpp = spec.head_channels_per_prior
            for b in range(3):
                block["b"][b * chpp + 2:b * chpp + 4] = 6.0
    return params, stats


def seeded_frame(rng, hw):
    """A compressible random frame: coarse noise blown up 16x plus bright boxes."""
    h, w = hw
    coarse = rng.integers(0, 160, (h // 16, w // 16, 3), dtype=np.uint8)
    img = np.repeat(np.repeat(coarse, 16, axis=0), 16, axis=1)
    for _ in range(6):
        y, x = int(rng.integers(0, h - h // 4)), int(rng.integers(0, w - w // 8))
        img[y:y + h // 4, x:x + w // 10] = rng.integers(160, 256, 3, dtype=np.uint8)
    return img


def write_dataset(path, rng, n, hw):
    os.makedirs(path, exist_ok=True)
    frames = []
    with tfrecord.TFRecordWriter(os.path.join(path, "smoke-00000-of-00001.tfrecord")) as wr:
        for i in range(n):
            img = seeded_frame(rng, hw)
            frames.append(img)
            wr.write(proto.encode_example({
                "image/encoded": [pipeline.encode_png(img, level=1)],
                "image/filename": [f"frame_{i:04d}.png".encode()],
            }))
    return os.path.join(path, "smoke-*-of-*.tfrecord"), frames


def make_config(tmp, name, img_size, t, pattern, **kw):
    """``compute_dtype`` is the Config default (bfloat16) unless ``kw`` says."""
    return Config(
        model="bayesian", inference_mode=True, T=t, batch_size=1,
        full_img_size=img_size, cls_cnt=C,
        checkpoint_path=os.path.join(tmp, "ckpt"), run_id=name, cpu_thread_cnt=2,
        data=DataConfig(file_pattern=pattern),
        **{"out_path": os.path.join(tmp, "out", name), **kw},
    )


def save_checkpoint(cfg, params, stats, step):
    trainable, frozen = partition_params(params, cfg.freeze_darknet53)
    CheckpointStore(cfg.checkpoint_path, cfg.run_id).save(
        step, {"params": trainable, "frozen": frozen, "stats": stats})


def reset_counters():
    cuda_epistemic.launch_count = 0
    cuda_decode.launch_count = 0
    cuda_nms.launch_count = 0
    for name in cuda_conv.launch_counts:
        cuda_conv.launch_counts[name] = 0


def read_counters():
    return {"epistemic_decode": cuda_epistemic.launch_count,
            "box_decode": cuda_decode.launch_count,
            "greedy_nms": cuda_nms.launch_count, **cuda_conv.launch_counts}


# bf16 rows, card against CPU or packed against image-fed input: the
# convolutions round to bf16 in other places (cuDNN / the conv kernels on the
# card, oneDNN / the plain versions on the CPU; one bf16 step on the input
# pixels for the packed feed), which the T-sample moments see as jitter.  Box
# corners within 0.01 of the unit image, score columns within 0.05, variance
# columns within rtol 0.35 (the JAX package's bf16-against-float32 jitter
# bound) — each held on at least 99 % of the anchors, since a single anchor's
# variance over T samples may sit at a rounding cliff — and the relative L2
# distance of all box and score columns within 0.02.
# The batched (aleatoric) rows decode each anchor's OWN sample, not a mean
# over T, so a corner moves with the jitter of exp(tw) x prior: there a
# corner is held to 0.01 plus 5 % of its box's extent.
# Column groups (variances, scores) and that share of the extent, for the
# epistemic (21+C) and the aleatoric (14+C) rows, C = 2.
EPI_COLS = (slice(4, 12), slice(14, 21), 0.0)
ALE_COLS = (slice(4, 9), slice(9, 14), 0.05)


def rows_agree_bf16(name, got, want, layout=EPI_COLS):
    check(got.shape == want.shape, f"{name}: shapes {tuple(got.shape)} {tuple(want.shape)}")
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite rows")
    var_cols, score_cols, of_extent = layout
    extent = (want[..., 2:4] - want[..., 0:2]).abs().repeat(*[1] * (want.dim() - 1), 2)
    shares = {}
    for label, cols, rtol, atol in (("corners", slice(0, 4), 0.0, 0.01),
                                    ("variances", var_cols, 0.35, 1e-6),
                                    ("scores", score_cols, 0.0, 0.05)):
        g, w = got[..., cols], want[..., cols]
        tol = atol + rtol * w.abs() + (of_extent * extent if label == "corners" else 0.0)
        err = (g - w).abs()
        ok = err <= tol
        shares[label] = float(ok.float().mean())
        over = (err / tol).flatten()
        q99 = float(torch.sort(over).values[int(0.99 * (over.numel() - 1))])
        check(shares[label] >= 0.99, f"{name}: only {shares[label]:.2%} of the {label} "
                                     f"columns within rtol {rtol} / atol {atol}"
                                     + (f" + {of_extent} x box extent" if label == "corners"
                                        else "")
                                     + f"; 99th percentile of error / tolerance {q99}")
    cols = [0, 1, 2, 3, *range(score_cols.start, score_cols.stop)]
    rel = float((got[..., cols] - want[..., cols]).norm() / want[..., cols].norm())
    check(rel <= 0.02, f"{name}: relative L2 distance {rel} of boxes and scores")
    return {"within_tolerance_share": shares, "rel_l2_boxes_scores": rel}


def small_reference(tmp, dev, dtype):
    """64x96, T=4, two images: the card's pipeline (cuDNN convs, every kernel)
    against the CPU's (plain versions), same weights, same fixed masks, stage
    by stage.  bf16 takes the fused early backbone on both (``fused_early``
    forced on the CPU, where the auto-gate would take the plain convolutions).
    NMS picks are compared on ONE set of decoded rows: on rows that differ in
    the last bits two near-tied scores could swap places, which would say
    nothing about the kernel."""
    cfg = make_config(tmp, "small", (64, 96, 3), 4, "", fixed_mc_masks=7,
                      nms_max_boxes=50, nms_pre_top_k=0, compute_dtype=dtype)
    spec = cfg.variant_spec
    tdtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    params, stats = random_state(3, spec, "cpu")
    img = np.random.default_rng(5).integers(0, 256, (2, 64, 96, 3), dtype=np.uint8)
    x = torch.from_numpy(img).float() / 255.0
    pri = {s: torch.from_numpy(p) for s, p in priors_as_array(cfg.resolved_priors()).items()}
    flats, chains = {}, {}
    with torch.no_grad():
        for d in ("cpu", dev):
            p_d, s_d = tree_to(params, d), tree_to(stats, d)
            outs = yolov3.mc_forward_cf(p_d, s_d, x.to(d), spec=spec, T=4, fixed_masks=7,
                                        compute_dtype=tdtype,
                                        fused_early=dtype == "bfloat16")
            flats[str(d)] = torch.cat([
                cuda_epistemic.fused_epistemic_decode_cf_batched(
                    raw, pri[s].to(d), n_imgs=2, h=hw[0], w=hw[1], cls_cnt=C, layer_id=i)
                for i, ((raw, hw), s) in enumerate(zip(outs, (32, 16, 8)))], dim=1)
            if dtype == "bfloat16":
                chains[str(d)] = darknet._fused_early_stages(
                    p_d["backbone"], s_d["backbone"], x.to(d), tdtype)[0].float().cpu()
    cpu_flat, gpu_flat = flats["cpu"], flats[str(dev)].cpu()
    check(cpu_flat.shape == gpu_flat.shape == (2, 3 * (6 + 24 + 96), 21 + C), "small_ref shape")
    out = {}
    if dtype == "float32":
        # 75 float32 convs sum in another order on the card: ten times the
        # kernel-vs-plain tolerances
        for (lo, hi), rtol, atol in EPI_TOL:
            check(torch.allclose(gpu_flat[..., lo:hi], cpu_flat[..., lo:hi],
                                 rtol=10 * rtol, atol=10 * atol),
                  f"small_ref: decoded columns {lo}:{hi} differ between card and CPU")
    else:
        # the fused chain alone, 14 kernels on the card against their 14 plain
        # versions on the CPU: same rounding points, other sum orders, flips
        # carried from stage to stage
        g, w = chains[str(dev)], chains["cpu"]
        out["fused_chain_rel_l2"] = float((g - w).norm() / w.norm())
        out["fused_chain_max_abs_err"] = float((g - w).abs().max())
        check(out["fused_chain_rel_l2"] <= 0.01 and
              out["fused_chain_max_abs_err"] <= 0.05 * float(w.abs().max()),
              f"small_ref: fused chain on the card against the CPU: {out}")
        out.update(rows_agree_bf16("small_ref bf16", gpu_flat, cpu_flat))
    got = nms.nms_select_batch(cpu_flat.to(dev), 14, 50, 0.5, pre_top_k=0,
                               with_certificate=True)
    want = nms.nms_select_batch(cpu_flat, 14, 50, 0.5, pre_top_k=0, with_certificate=True)
    for g, w in zip(got, want):
        check(torch.equal(g.cpu(), w), "small_ref: NMS on the card differs from the CPU's")
    return {"dtype": dtype, "valid": int(want[1].sum()),
            "max_abs_err": float((gpu_flat - cpu_flat).abs().max()), **out}


def run_and_check(runner, n_frames):
    """runner.run() with the launch counters set to 0 and the peak-memory
    reading reset just before, both read just after; every frame's ECP JSON
    checked for the fields of the runner's variant."""
    if runner.epistemic:
        fields = {"x_var_epi", "obj_mutual_info", "total_var_epi"}
    elif runner.spec.aleatoric_head:
        fields = {"x_var", "total_var", "obj_entropy", "cls_entropy", "layer_id", "prior_id"}
    else:
        fields = {"score", "layer_id", "prior_id"}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    t0 = time.time()
    out_dir = runner.run()
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = read_counters()
    peak = torch.cuda.max_memory_allocated() / 1e9
    files = sorted(glob.glob(os.path.join(out_dir, "*.json")))
    check(len(files) == n_frames, f"{len(files)} JSON files for {n_frames} frames")
    n_dets = []
    for f in files:
        with open(f) as fh:
            dets = json.load(fh)["children"]
        check(0 < len(dets) <= MAX_OUT, f"{f}: {len(dets)} detections")
        for d in dets:
            nums = [v for v in d.values() if isinstance(v, float)] + d["cls_scores"]
            check(all(math.isfinite(v) for v in nums), f"{f}: non-finite value")
            check(fields <= set(d), f"{f}: fields {sorted(fields - set(d))} missing")
        n_dets.append(len(dets))
    return out_dir, launches, {"detections": n_dets, "launches": launches,
                               "exact_retries": runner.retried, "wall_s_incl_load": wall,
                               "loop": runner.last_run, "peak_mem_GB": peak}


def main_path(tmp, dev, n_frames=3):
    rng = np.random.default_rng(11)
    pattern, frames = write_dataset(os.path.join(tmp, "data"), rng, n_frames, IMG[:2])
    kw = dict(nms_max_boxes=MAX_OUT, nms_pre_top_k=PRE_TOP_K)
    cfg = make_config(tmp, "smoke", IMG, T, pattern, **kw)  # bf16: the Config default
    check(cfg.compute_dtype == "bfloat16", "Config's default compute_dtype is not bfloat16")
    params, stats = random_state(0, cfg.variant_spec, "cpu")
    save_checkpoint(cfg, params, stats, step=1)
    del params, stats

    # bf16, the default: the fused early backbone and all five kernels
    runner = InferenceRunner(cfg, seed=0)  # device: the card, by default
    out_dir, launches, bf16_summary = run_and_check(runner, n_frames)
    check(out_dir.endswith("_1"), f"output dir {out_dir} lacks the step suffix")
    check(launches["box_decode"] == 0, "the epistemic main path ran the box decode")
    check(all(n > 0 for k, n in launches.items() if k != "box_decode"),
          f"the bf16 main path launched no kernel of: "
          f"{[k for k, n in launches.items() if not n and k != 'box_decode']}")
    passes = launches["fused_stem"]  # one stem launch per pipeline pass
    check(launches["fused_res_block"] == 11 * passes
          and launches["fused_downsample"] == 2 * passes
          and launches["epistemic_decode"] == 3 * passes,
          f"launches per pipeline pass are not 1 / 11 / 2 / 3: {launches}")
    try:
        runner.run()
    except FileExistsError:
        pass
    else:
        raise AssertionError("run() overwrote an existing output directory")

    # float32: true-float32 cuDNN convolutions, decode and NMS kernels
    cfg32 = make_config(tmp, "smoke", IMG, T, pattern, compute_dtype="float32",
                        out_path=os.path.join(tmp, "out", "smoke_f32"), **kw)
    runner32 = InferenceRunner(cfg32, seed=0)
    _, launches32, f32_summary = run_and_check(runner32, n_frames)
    check(launches32["epistemic_decode"] > 0 and launches32["greedy_nms"] > 0,
          "the float32 main path launched no kernel")
    check(not any(launches32[k] for k in cuda_conv.launch_counts),
          "the float32 path went through the fused conv kernels")

    # the same frames through weights whose certificate fails: the exact
    # (pre_top_k=0) retry inside run(), in float32
    cfg_wide = make_config(tmp, "smoke_wide", IMG, T, pattern, compute_dtype="float32", **kw)
    save_checkpoint(cfg_wide, *random_state(0, cfg.variant_spec, "cpu", wide_boxes=True), step=2)
    wide = InferenceRunner(cfg_wide, seed=1)
    _, _, wide_summary = run_and_check(wide, n_frames)
    retried = runner.retried + runner32.retried + wide.retried
    params, stats, _ = runner.load_state()
    if not retried:  # every run certified: drive the exact program once by hand
        runner.exact_pipeline(params, stats, torch.from_numpy(frames[0][None]).to(dev),
                              runner.draw_keys())
        torch.cuda.synchronize()

    # fixed masks: the same image twice gives the same rows
    cfg_fixed = make_config(tmp, "smoke", IMG, T, pattern, fixed_mc_masks=7, **kw)
    fixed = InferenceRunner(cfg_fixed, seed=0)
    rows_a, valid_a = fixed.predict(params, stats, frames[0][None])
    rows_b, valid_b = fixed.predict(params, stats, frames[0][None])
    check(np.array_equal(rows_a, rows_b) and np.array_equal(valid_a, valid_b),
          "fixed_mc_masks: two predictions of one image differ")
    check(rows_a.shape == (1, MAX_OUT, 21 + C) and np.isfinite(rows_a).all(),
          "predict: bad rows")

    # packed_host_input: run() from the loader's uint8 planes; then one frame's
    # decoded rows against the image-fed rows, anchor by anchor, fixed masks
    cfg_packed = make_config(tmp, "smoke", IMG, T, pattern, fixed_mc_masks=7,
                             packed_host_input=True,
                             out_path=os.path.join(tmp, "out", "smoke_packed"), **kw)
    packed = InferenceRunner(cfg_packed, seed=0)
    _, launches_packed, packed_summary = run_and_check(packed, n_frames)
    check(launches_packed["fused_stem"] > 0, "the packed run launched no stem kernel")
    planes = torch.from_numpy(pipeline.pack_planes_host(frames[0])[None]).to(dev)
    keys = fixed.draw_keys()
    rows_packed = packed._decoded_rows(params, stats, planes, keys)
    rows_fed = fixed._decoded_rows(params, stats, torch.from_numpy(frames[0][None]).to(dev), keys)
    packed_summary["rows_vs_image_fed"] = rows_agree_bf16("packed against image-fed",
                                                          rows_packed, rows_fed)
    del rows_packed, rows_fed, planes
    return (runner, runner32, params, stats, frames, launches,
            {"frames": n_frames, "bfloat16": bf16_summary, "float32": f32_summary,
             "float32_exact_retry": wide_summary, "packed_host_input": packed_summary,
             "exact_retries": retried, "exact_pipeline_by_hand": not retried})


def timing(runner, params, stats, frames, dev, card):
    """img/s of ``runner``'s main path (3 frames after a warm-up) and a stage
    breakdown of one certified-path pass, in the runner's compute dtype."""
    imgs = [torch.from_numpy(f[None]).to(dev) for f in frames]
    spec = runner.spec
    dtype = runner.model._dtype

    def one(img, keys):  # what predict() does, without the copies to the host
        return runner._select_certified(runner._decoded_rows(params, stats, img, keys))[2]

    # start from an empty allocator cache, as a process that runs this one
    # dtype would: blocks cached by the other dtype's run fit none of these sizes
    torch.cuda.empty_cache()
    one(imgs[0], runner.draw_keys())  # warm-up
    torch.cuda.synchronize()
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(len(imgs) + 1)]
    marks[0].record()
    retries = 0
    for img, mark in zip(imgs, marks[1:]):
        retries += one(img, runner.draw_keys())
        mark.record()
    torch.cuda.synchronize()
    total_ms = marks[0].elapsed_time(marks[-1])
    each_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]

    keys = runner.draw_keys()
    x = imgs[0].float() / 255.0
    bb, bs = params["backbone"], stats["backbone"]
    stage = {}
    with torch.no_grad():
        stage["backbone_ms"] = event_ms(lambda: darknet.darknet53(
            bb, bs, x, compute_dtype=dtype), 3)
        if dtype == torch.bfloat16:
            stage["fused_chain_ms"] = event_ms(lambda: darknet._fused_early_stages(
                bb, bs, x, dtype), 3)
        stage["forward_cf_ms"] = event_ms(lambda: yolov3.mc_forward_cf(
            params, stats, x, spec=spec, T=T, rng=keys, compute_dtype=dtype), 3)
        outs = yolov3.mc_forward_cf(params, stats, x, spec=spec, T=T, rng=keys,
                                    compute_dtype=dtype)

        def decode_all():
            return [cuda_epistemic.fused_epistemic_decode_cf_batched(
                raw, runner._priors[s], n_imgs=1, h=hw[0], w=hw[1], cls_cnt=C, layer_id=i)
                for i, ((raw, hw), s) in enumerate(zip(outs, (32, 16, 8)))]

        stage["decode_ms"] = event_ms(decode_all, 3)
        flat = torch.cat(decode_all(), dim=1)
        for name, k in (("nms_select_top8192_ms", PRE_TOP_K), ("nms_select_exact_ms", 0)):
            stage[name] = event_ms(lambda: nms.nms_select_batch(
                flat, 14, MAX_OUT, 0.5, pre_top_k=k, with_certificate=True), 3)
        # the 15 hash-dropout sites alone, at their main-path shapes and dtype
        site_shapes = [(T, h, w, c) for (h, w), cs in zip(
            SCALES, ((512, 1024, 512, 1024, 512), (256, 512, 256, 512, 256),
                     (128, 256, 128, 256, 128))) for c in cs]

        def masks():
            for shp in site_shapes:
                common.dropout(torch.ones(shp, device=dev, dtype=dtype), 0.1, list(range(T)))

        stage["dropout_15_sites_ms"] = event_ms(masks, 2)
    return {"compute_dtype": runner.config.compute_dtype,
            "img_per_s": len(imgs) / (total_ms / 1e3), "ms_per_img": total_ms / len(imgs),
            "ms_each_img": each_ms, "images": len(imgs), "exact_retries": retries,
            "card": card, **stage}


# --------------------------------------------------------------------------
# the batched standard / aleatoric path
# --------------------------------------------------------------------------


def make_batched_config(tmp, name, model, pattern, **kw):
    """Batched inference as cli/inference_{standard_yolov3,aleatoric}.py set
    it up: batch 11, ECP priors, full images; bf16 unless ``kw`` says."""
    return Config(
        model=model, inference_mode=False, batch_size=BATCH, full_img_size=IMG, cls_cnt=C,
        checkpoint_path=os.path.join(tmp, "ckpt"), run_id=name, cpu_thread_cnt=6,
        data=DataConfig(file_pattern=pattern), nms_max_boxes=MAX_OUT,
        nms_pre_top_k=PRE_TOP_K, **{"out_path": os.path.join(tmp, "out", name), **kw},
    )


def check_batched_launches(name, launches, n_batches, bf16):
    """3 box-decode launches per batch, no epistemic decode, NMS, and the
    fused conv kernels 1 / 11 / 2 times per batch in bf16, never in float32."""
    check(launches["box_decode"] == 3 * n_batches,
          f"{name}: {launches['box_decode']} box_decode launches for {n_batches} batches")
    check(launches["epistemic_decode"] == 0, f"{name}: the epistemic decode ran")
    check(launches["greedy_nms"] > 0, f"{name}: no greedy_nms launch")
    conv = (launches["fused_stem"], launches["fused_res_block"], launches["fused_downsample"])
    want = (n_batches, 11 * n_batches, 2 * n_batches) if bf16 else (0, 0, 0)
    check(conv == want, f"{name}: fused conv launches {conv}, want {want}")


def main_path_batched(tmp, dev):
    """Batched inference at 1024x1920, batch 11, 13 frames (a full batch and
    a padded batch of 2) through run(): aleatoric bf16 (the default dtype),
    standard bf16, aleatoric float32, aleatoric with packed host input, the
    exact-NMS retry, and one Detector call on a PNG file."""
    rng = np.random.default_rng(13)
    pattern, frames = write_dataset(os.path.join(tmp, "data_batched"), rng,
                                    N_BATCHED_FRAMES, IMG[:2])
    n_batches = -(-N_BATCHED_FRAMES // BATCH)
    cfg = make_batched_config(tmp, "ale", "aleatoric", pattern)
    cfg_std = make_batched_config(tmp, "std", "standard", pattern)
    check(cfg.compute_dtype == "bfloat16", "Config's default compute_dtype is not bfloat16")
    save_checkpoint(cfg, *random_state(20, cfg.variant_spec, "cpu"), step=3)
    save_checkpoint(cfg_std, *random_state(21, cfg_std.variant_spec, "cpu"), step=3)
    out = {"frames": N_BATCHED_FRAMES, "batch_size": BATCH, "batches": n_batches}

    runner = InferenceRunner(cfg, seed=0)
    _, launches, out["aleatoric_bfloat16"] = run_and_check(runner, N_BATCHED_FRAMES)
    check_batched_launches("aleatoric bf16", launches, n_batches, bf16=True)
    std = InferenceRunner(cfg_std, seed=0)
    _, launches_std, out["standard_bfloat16"] = run_and_check(std, N_BATCHED_FRAMES)
    check_batched_launches("standard bf16", launches_std, n_batches, bf16=True)
    cfg32 = make_batched_config(tmp, "ale", "aleatoric", pattern, compute_dtype="float32",
                                out_path=os.path.join(tmp, "out", "ale_f32"))
    runner32 = InferenceRunner(cfg32, seed=0)
    _, launches32, out["aleatoric_float32"] = run_and_check(runner32, N_BATCHED_FRAMES)
    check_batched_launches("aleatoric float32", launches32, n_batches, bf16=False)

    # packed host input; then a full batch's rows against the image-fed rows
    cfg_packed = make_batched_config(tmp, "ale", "aleatoric", pattern, packed_host_input=True,
                                     out_path=os.path.join(tmp, "out", "ale_packed"))
    packed = InferenceRunner(cfg_packed, seed=0)
    _, launches_p, out["packed_host_input"] = run_and_check(packed, N_BATCHED_FRAMES)
    check_batched_launches("packed bf16", launches_p, n_batches, bf16=True)
    params, stats, _ = runner.load_state()
    batch = frames[:BATCH]
    planes = torch.from_numpy(np.stack([pipeline.pack_planes_host(f) for f in batch])).to(dev)
    rows_packed = packed._decoded_rows(params, stats, planes, None)
    rows_fed = runner._decoded_rows(params, stats, torch.from_numpy(np.stack(batch)).to(dev),
                                    None)
    out["packed_host_input"]["rows_vs_image_fed"] = rows_agree_bf16(
        "batched packed against image-fed", rows_packed, rows_fed, layout=ALE_COLS)
    del rows_packed, rows_fed, planes

    # boxes e^6 times their priors: the certificate fails, run() retries exactly
    cfg_wide = make_batched_config(tmp, "ale_wide", "aleatoric", pattern)
    save_checkpoint(cfg_wide, *random_state(20, cfg.variant_spec, "cpu", wide_boxes=True),
                    step=4)
    wide = InferenceRunner(cfg_wide, seed=0)
    _, launches_w, out["exact_retry_bfloat16"] = run_and_check(wide, N_BATCHED_FRAMES)
    check(wide.retried == n_batches, f"the wide-box run retried {wide.retried} of "
                                     f"{n_batches} batches")
    check(launches_w["greedy_nms"] == 2 * n_batches, f"retry NMS launches {launches_w}")

    # one Detector call on a PNG file
    png = os.path.join(tmp, "detect_frame.png")
    with open(png, "wb") as f:
        f.write(pipeline.encode_png(frames[0], level=1))
    det = Detector(cfg)  # objectness threshold: the Config default, 0.1
    reset_counters()
    res = det.detect_file(png)
    launches_d = read_counters()
    check(launches_d["box_decode"] == 3 and launches_d["greedy_nms"] >= 1,
          f"Detector launches {launches_d}")
    check(0 < len(res["boxes"]) <= MAX_OUT and all(
        math.isfinite(b[k]) for b in res["boxes"] for k in ("x0", "y0", "x1", "y1", "score")),
        f"Detector: {len(res['boxes'])} boxes or non-finite values")
    out["detector"] = {"boxes": len(res["boxes"]), "launches": launches_d}
    return runner, runner32, frames, launches, out


def timing_batched(runner, frames, dev, card):
    """The batched device program (what predict() does without the copies to
    the host) on two batches of 11 after a warm-up, a stage breakdown of one
    batch, run()'s wall img/s over the 13 frames, and the host loader and the
    JSON writer each alone."""
    params, stats, _ = runner.load_state()
    spec, dtype = runner.spec, runner.model._dtype
    x_u8 = torch.from_numpy(np.stack(frames[:BATCH])).to(dev)
    torch.cuda.empty_cache()

    def one(img):
        return runner._select_certified(runner._decoded_rows(params, stats, img, None))[2]

    one(x_u8)  # warm-up
    torch.cuda.synchronize()
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    marks[0].record()
    retries = 0
    for mark in marks[1:]:
        retries += one(x_u8)
        mark.record()
    torch.cuda.synchronize()
    batch_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]

    x = x_u8.float() / 255.0
    bb, bs = params["backbone"], stats["backbone"]
    stage = {}
    with torch.no_grad():
        stage["backbone_ms"] = event_ms(lambda: darknet.darknet53(bb, bs, x, compute_dtype=dtype), 3)
        stage["forward_cf_ms"] = event_ms(lambda: yolov3.forward_cf(
            params, stats, x, spec=spec, compute_dtype=dtype), 3)
        stage["heads_ms"] = stage["forward_cf_ms"] - stage["backbone_ms"]
        outs = yolov3.forward_cf(params, stats, x, spec=spec, compute_dtype=dtype)
        stage["decode_ms"] = event_ms(lambda: cuda_decode.fused_box_decode_all_scales(
            outs, runner._priors, spec=spec), 5)
        flat = cuda_decode.fused_box_decode_all_scales(outs, runner._priors, spec=spec)
        obj = spec.obj_idx()
        for name, k in ((f"nms_select_nb{BATCH}_top8192_ms", PRE_TOP_K),
                        (f"nms_select_nb{BATCH}_exact_ms", 0)):
            stage[name] = event_ms(lambda: nms.nms_select_batch(
                flat, obj, MAX_OUT, 0.5, pre_top_k=k, with_certificate=True), 3)
    del outs, flat, x

    # the JSON writer alone on one batch's selections (1000 rows a frame)
    cfg = runner.config
    rows, valid = (a.cpu().numpy() for a in runner._select_certified(
        runner._decoded_rows(params, stats, x_u8, None))[:2])
    t0 = time.time()
    runner._write_batch(rows, valid, [f"writer_{i}.png" for i in range(BATCH)],
                        tempfile.mkdtemp(dir=os.path.dirname(cfg.out_path)))
    writer_ms = (time.time() - t0) * 1e3 / BATCH

    # run() end to end (warm: kernels built, allocator cache filled), then the
    # loader alone over the same records with the same threads
    out_dir = runner.run(out_path=os.path.join(os.path.dirname(cfg.out_path), "timing_"
                                               + os.path.basename(cfg.out_path)))
    check(len(glob.glob(os.path.join(out_dir, "*.json"))) == N_BATCHED_FRAMES,
          "timing run(): JSON files missing")
    run_loop = dict(runner.last_run)
    t0 = time.time()
    n = sum(b["image"].shape[0] for b in pipeline.TestLoader(cfg, batch_size=BATCH).batches())
    loader_s = time.time() - t0
    check(n == N_BATCHED_FRAMES, f"loader yielded {n} frames")
    ms_per_batch = sum(batch_ms) / len(batch_ms)
    return {"path": f"batched {cfg.model}", "compute_dtype": cfg.compute_dtype,
            "batch_size": BATCH, "img_per_s": BATCH / (ms_per_batch / 1e3),
            "ms_per_img": ms_per_batch / BATCH, "ms_each_batch": batch_ms,
            "exact_retries": retries, **stage,
            "run_img_per_s": run_loop["images"] / run_loop["seconds"], "run_loop": run_loop,
            "loader_ms_per_frame": loader_s * 1e3 / n, "loader_threads": cfg.cpu_thread_cnt,
            "writer_ms_per_frame": writer_ms,
            "card": card}


def main():
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    t_start = time.time()
    dev = torch.device("cuda:0")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    emit("device", card=card, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.time()
    libs = _build.build_all(verbose=True)
    for name in libs:
        _build.load(name)
    emit("build", seconds=time.time() - t0, kernels=sorted(libs), flags=_build.NVCC_FLAGS)

    flush = torch.empty(128 * 1024 * 1024, dtype=torch.uint8, device=dev)  # > 50 MB L2
    kernels = [check_epistemic(dev, flush), check_nms(dev), check_stem(dev, flush),
               check_res_block(dev, flush), check_downsample(dev, flush),
               check_box_decode(dev, flush)]
    del flush
    emit("kernels", card=card, kernels=kernels)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        for dtype in ("float32", "bfloat16"):
            emit("small_ref", **small_reference(tmp, dev, dtype))
        runner, runner32, params, stats, frames, launches, summary = main_path(tmp, dev)
        emit("main_path", card=card, **summary)
        emit("timing", **timing(runner32, params, stats, frames, dev, card))
        emit("timing", **timing(runner, params, stats, frames, dev, card))
        del runner, runner32, params, stats
        b_runner, b_runner32, b_frames, b_launches, b_summary = main_path_batched(tmp, dev)
        emit("main_path_batched", card=card, **b_summary)
        emit("timing", **timing_batched(b_runner32, b_frames, dev, card))
        emit("timing", **timing_batched(b_runner, b_frames, dev, card))

    # launches: each kernel's count from its own path's run — the epistemic
    # bf16 main path, and for box_decode the batched aleatoric bf16 run
    for k in kernels:
        k["launches"] = (b_launches if k["name"] == "box_decode" else launches)[k["name"]]
    emit("done", seconds=time.time() - t_start)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
