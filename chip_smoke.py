#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port starts and is right on an
NVIDIA Hopper GPU.  Run from the repository root, no arguments, one card:

    python3 chip_smoke.py
    python3 chip_smoke.py --kernels   # build, ptxas and the kernel checks only
    python3 chip_smoke.py --train     # build and the training phase only
    python3 chip_smoke.py --train-dp  # build and the dp training phase only
    python3 chip_smoke.py --tools     # build and the tools phase only
    python3 chip_smoke.py --parity    # build and parity_fullres_torch.py's main only

It imports only ``bayesian_yolov3_torch``, ``parity_fullres_torch``, torch,
numpy and the standard library; needs a CUDA device (exits non-zero without
one) and ``nvcc`` (every kernel is built from ``bayesian_yolov3_torch/csrc``
in this run).

Phases, each printing one JSON line:

device      card name and power limit (nvidia-smi), torch / CUDA versions
build       seconds to build the CUDA kernels
ptxas       registers, spills, static shared memory and warnings of the
            kernels (fused_stem, fused_res_block, fused_downsample,
            greedy_nms, epistemic_decode, epistemic_moments, box_decode,
            epistemic_finalize, quant_epilogue), from nvcc -Xptxas -v
kernels     each kernel against its plain PyTorch version on the card at the
            main path's shapes; times by CUDA events; NMS also on crafted
            cases (ties, -inf, NaN IoUs, duplicates, dense clusters whose picks
            span seven chunks) and on 120 960 boxes wider than the image; the
            epistemic decode and moments at T = 1, 7, 15, 29, 30, 50 and
            ragged grids, a second launch equal to the first, a batch of
            images equal to each image decoded alone, the moments finalized
            equal bit for bit to the decode; the box decode and the finalize
            as one launch over three scales (the ECP scales and ragged sets)
            equal bit for bit to their per-scale launches concatenated, the
            finalize's packed sums written by the moments kernel through
            ``out=`` views; the int8 epilogue torch.equal at the 20 block
            shapes of an image at T=30 (dropout keys on 15) and of a batch
            of 11, and on a stack of 70 samples (two launches)
int8_gemm   each int8 head block's convolution at T=30: im2col +
            torch._int_mm (exact against a float64 product) beside one
            cuDNN bf16 F.conv2d of the same shape
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
            JSON writer, each timed alone; the PNG decoder that ran, one frame
            decoded with rows stored under filter 0, filters 1-4 and Paeth
            only, and the loader over the frames stored with filters 1-4
mc_split    the split form on one card: the moments of n shards of one frame's
            T=30 raws summed and finalized, against the one-shot epistemic
            decode kernel, n = 1 (bit for bit), 2, 3, 5
main_path_mc
            the fused mc-sharded pipeline (parallel/epistemic.py) over a
            one-rank NCCL group at 1024x1920, T=30, fixed masks, bf16 and
            float32: launches and all-reduces (one of each per frame for the
            finalize), rows against the single-device runner's exact-NMS
            rows, ms per frame, stages, peak memory
main_path_mc_2ranks
            two spawned ranks on the one card over gloo, each running
            InferenceRunner(mesh_shape={'mc': 2}).run() over 2 frames (bf16),
            against the same split computed here and the one-rank rows; the
            all-gather fallback (use_pallas=False) on one frame
main_path_int8
            quantize="int8" through run() with its calibration on 2 frames:
            epistemic (bayesian, T=30, fixed masks, 3 frames), raws against
            bf16 within the JAX package's 0.10 of scale; the fused mc
            pipeline in int8 over a one-rank NCCL group against the
            single-device int8 rows; batched aleatoric and standard (batch
            11, 13 frames); ms per image of int8 beside bf16 read in turns,
            the head sections, epilogue launches, peak memory

main_path_dp
            data-parallel batched aleatoric inference, mesh_shape={'dp': 2}:
            two spawned ranks on the one card over gloo, batch 22 (11 a
            rank), run() over the batched frames in bf16 and int8; launches
            per rank, each rank's rows against the single-device runner's
            (bit-equal, else paired by anchor), ms per image per rank, the
            gather of the rows
main_path_sp
            spatial sharding, the image rows split into bands with a halo
            exchange around every 3x3 conv: epistemic T=30 bf16 over
            {'sp': 2, 'mc': 2} on four spawned ranks and over {'sp': 2};
            batched aleatoric batch 1 over {'sp': 2} in float32 and bf16;
            run() over the main path's 3 frames; launches, halo exchanges
            and bytes, raw gathers and all-reduces per frame and rank; frame
            0's decoded rows equal on every rank and against the single
            device (float32 rtol 1e-4 / atol 1e-5, bf16 the jitter bounds);
            ms per frame; peak memory of one frame per rank beside the
            single device's

main_path_train
            training through Trainer.run() at full width: the pretraining
            configuration (aleatoric, crops of 768x1440 from 1024x1920
            frames, batch 8, bf16, the frozen backbone on the three fused
            conv kernels) for 6 steps, a checkpoint every 3, one val step;
            then the uncertainty configuration (bayesian, aleatoric loss,
            batch 2) warm-started from it for 3 steps; launches a step
            (stem 1, res block 11, downsample 2), finite losses, the backbone
            and its statistics bit-unchanged, every head leaf moved; step 1
            through the fused kernels against the plain cuDNN bf16 step
            (loss rtol 5e-3; the backbone's outputs at relative L2 1e-2; with
            the heads in float32, the detection convs' gradients at 2.5e-2,
            and the median and 90th percentile over every head leaf within
            2x those of a control, the plain bf16 backbone against the
            plain float32 one) and the card's step against the CPU's at
            64x96 (float32 on the CPU tests' weights: loss rtol 1e-5, every
            leaf's gradient 1e-4; float64 on the smoke's weights: 1e-12,
            every leaf 1e-10); ms a step, img/s, preprocess / forward with
            loss / backward / Adam each alone, the host loader's time a
            batch, peak memory

main_path_train_dp
            data-parallel training, mesh_shape={'data': 2}, two spawned ranks
            on the one card over gloo, the pretraining configuration (global
            batch 8, 4 a rank): one step of the two ranks against one rank
            on the same global batch, in float64 (loss rtol 1e-12, new BN
            statistics rtol 1e-10, every trainable leaf's gradient relative
            L2 1e-10) and in float32 (loss and statistics rtol 1e-5, the
            gradients' median and 90th percentile gap within 2x those of one
            rank's float32 step against its float64 step); bf16,
            3 steps through Trainer.run(): launches a step and rank (stem 1,
            res block 11, downsample 2), finite losses, the ranks' params,
            Adam state and statistics bit-equal, rank 0 alone writing; ms a
            step per rank, the packed gradient all-reduce (ms, MB), the BN
            all-reduces (count, ms) of a step, peak memory
main_path_tools
            the tools, with neither PIL nor matplotlib nor tensorflow:
            cli/vis_uncertainty.py on one 1024x1920 PNG (bayesian, T=30, bf16;
            99 PNGs, 3 epistemic decode launches, the maps equal to the
            columns of the runner's decoded rows, ms of the device part and
            of the PNG writing); the qualitative eval through
            cli/uncertainty_training.py and cli/yolov3_training.py with
            training=false (crop, stacked copies; every PNG equal to the
            drawing of predict's boxes under the same keys, launches a
            predict call); cli/evaluate_detections.py on main_path's JSON;
            data/citypersons.py on a tiny tree of two 1024x2048 frames; trace
            and annotate around one training step (the annotation, the CUDA
            kernel events, whether the kernels launched through ctypes
            appear by name)
parity_short
            the accuracy-parity flow of parity_fullres_torch.py
            (eval/parity.py) at its geometry and inputs — bayesian,
            1024x1920, 10 unfrozen float32 steps with batch-statistics BN
            through all 52 Darknet convs — then one production bf16 predict
            (T=30) and one f32 twin pass on those weights: finite losses,
            every backbone leaf moved, no kernel launched in training (the
            plain convolutions), the predict's launches (stem 1, res block
            11, downsample 2, epistemic decode 3, NMS >= 1), finite rows of
            both; ms a step, peak memory of each part
entry       bayesian_yolov3_torch/dryrun.py's entry() (256x480, T=8, bf16):
            its pipeline twice on its example arguments, bit-equal; launches
dryrun      dryrun_multichip(4): four ranks spawned on the card over
            gloo through the seven compositions of the JAX package's
            __graft_entry__.py; every rank ran the moments, finalize, int8
            epilogue, box decode and NMS kernels

Then the card line, one ``{"kernels": [...]}`` line and, last,
``{"ok": true, "device": {...}}``.  Any failed check raises: the script
then exits non-zero and prints no result line.  Every run that finds a card
writes chiprun_out/CHIP_SMOKE.json under the working directory: every phase
line, each kernel check (its largest deviation from its plain version, the
tolerance), the card's name and power limit, and the error of a failed run.
The multi-rank phases start processes (spawned, joined under a timeout) and
leave none behind.
"""

import contextlib
import ctypes
import dataclasses
import glob
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from bayesian_yolov3_torch import dryrun
from bayesian_yolov3_torch.config import Config, DataConfig
from bayesian_yolov3_torch.convert import tree_to
from bayesian_yolov3_torch.core.blueprint import Variant, VariantSpec
from bayesian_yolov3_torch.core.priors import priors_as_array
from bayesian_yolov3_torch.data import encode, pipeline, proto, tfrecord
from bayesian_yolov3_torch.eval import parity as eval_parity
from bayesian_yolov3_torch.infer.detect import Detector
from bayesian_yolov3_torch.infer.ecp import bbox_to_ecp_format
from bayesian_yolov3_torch.infer.runner import InferenceRunner
from bayesian_yolov3_torch.models import darknet, yolov3
from bayesian_yolov3_torch.models import quant as mquant
from bayesian_yolov3_torch.ops import (
    _build, common, cuda_conv, cuda_decode, cuda_epistemic, cuda_moments, cuda_nms, cuda_quant,
    decode, nms, quant)
from bayesian_yolov3_torch.ops import loss as loss_ops
from bayesian_yolov3_torch.ops.launches import read as read_counters
from bayesian_yolov3_torch.ops.launches import reset as reset_counters
from bayesian_yolov3_torch.parallel import (
    initialize_distributed, local_rows, make_groups, make_mc_sharded_fused_pipeline)
from bayesian_yolov3_torch.parallel.mesh import Group
from bayesian_yolov3_torch.train.checkpoints import CheckpointStore
from bayesian_yolov3_torch.train import loop as train_loop
from bayesian_yolov3_torch.train.loop import partition_params

import parity_fullres_torch

# published peaks of one H100 SXM (NVIDIA data sheet): the yardstick of bound_ms
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
BF16_FLOPS = 989e12  # dense, tensor cores
INT8_OPS = 1979e12  # dense, tensor cores

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


RECORD_PATH = os.path.join("chiprun_out", "CHIP_SMOKE.json")
_PHASES = []  # every phase line of this run, for the record


def emit(phase, **kw):
    line = json.dumps({"phase": phase, **kw})
    _PHASES.append(json.loads(line))
    print(line, flush=True)


def write_record(card, kernels, error):
    """The run's record at RECORD_PATH (under the working directory): every
    phase line, each kernel check (its largest deviation from its plain
    version, the tolerance it was held to and, where the tolerance is a
    bound on |got - want|, the largest ratio of the deviation to its bound,
    which the check held <= 1; a check that fails raises, so every check
    listed passed), the card's name and power limit, and the error that
    ended a failed run."""
    os.makedirs(os.path.dirname(RECORD_PATH), exist_ok=True)
    checks = [{"name": k["name"], "ok": True, "max_dev": k["max_abs_err"],
               "max_err_over_tolerance": k.get("max_err_over_tolerance"),
               "tolerance": k["tolerance"], "launches": k.get("launches")} for k in kernels]
    with open(RECORD_PATH, "w") as f:
        json.dump({"ok": error is None, "card": card, "args": sys.argv[1:],
                   "kernel_checks": checks, "phases": _PHASES, "error": error}, f, indent=1)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


# GPU clock cycles of a spin queued before the start event of a `device`
# reading (about 0.3 ms): longer than the host takes to enqueue a few wrapper
# calls and a cat, so the reading holds the card's time alone
SPIN_CYCLES = 600_000


def event_ms(fn, reps, flush=None, device=False):
    """Median time of ``fn`` in ms by CUDA events, one launch per reading;
    ``flush`` (a tensor larger than L2) is overwritten between readings so
    each launch finds the cache cold, as after the producing matmul of a
    155 MB tensor.  ``device``: the card spins before the start event while
    the host enqueues ``fn``, so the host's launch latency drops out."""
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        if device:
            torch.cuda._sleep(SPIN_CYCLES)
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


# the decode's checked shapes (n_imgs, h, w, T): the main path's three
# scales at T=30 first (timed), two and four images in one launch (four
# frames of 32x60 would fill the card with fewer parts than one), every sample count
# the split of csrc/decode_common.cuh must cover at each scale (G = 1 .. 8
# parts, an empty part at T=7), and ragged grids
# the part counts the two kernels take: the powers of two up to SPLIT_WARPS
PARTS = tuple(1 << k for k in range(cuda_epistemic.SPLIT_WARPS.bit_length()))
EPI_CASES = ([(1, h, w, T) for h, w in SCALES] + [(2, 32, 60, T), (4, 32, 60, T)]
             + [(1, h, w, t) for t in (1, 7, 15, 29, 50) for h, w in SCALES]
             + [(1, 5, 7, T), (3, 5, 7, 7)])


def _decode_bytes(t, nb, h, w, c):
    """The bytes the epistemic decode must move: the 9+C channels it reads of
    every sample (not the stddev channels), the rows, the priors."""
    return (3 * (9 + c) * t * nb * h * w + nb * 3 * h * w * (21 + c) + 3 * 2) * 4


def check_epistemic(dev, flush):
    """Kernel against plain version at EPI_CASES; a second launch on the same
    input equal to the first; times at the main path's shapes, each launch
    alone after an L2 flush and the three launches of an image back to back."""
    gen = torch.Generator(device=dev).manual_seed(0)
    priors = torch.tensor([[0.3, 0.1], [0.15, 0.05], [0.08, 0.02]], device=dev)
    per_shape, main = [], []
    for k, (nb, h, w, t) in enumerate(EPI_CASES):
        raw = torch.randn((3 * 2 * (5 + C), t, nb * h * w), generator=gen, device=dev)
        kw = dict(n_imgs=nb, h=h, w=w, cls_cnt=C, layer_id=k % 3)
        name = f"epistemic_decode(T={t}, {(nb, h, w)})"
        got = cuda_epistemic.fused_epistemic_decode_cf_batched(raw, priors, **kw)
        again = cuda_epistemic.fused_epistemic_decode_cf_batched(raw, priors, **kw)
        torch.cuda.synchronize()
        want = cuda_epistemic.epistemic_decode_plain(raw, priors, **kw)
        torch.cuda.synchronize()
        check(got.shape == want.shape == (nb, 3 * h * w, 21 + C), f"{name}: shape {got.shape}")
        check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
        check(torch.equal(got, again), f"{name}: a second launch differs from the first")
        for i in range(nb if nb > 1 else 0):  # a frame's rows do not depend on its batch
            alone = cuda_epistemic.fused_epistemic_decode_cf_batched(
                raw[:, :, i * h * w:(i + 1) * h * w].contiguous(), priors, **{**kw, "n_imgs": 1})
            check(torch.equal(got[i], alone[0]), f"{name}: image {i} differs from its decode alone")
        ratio = 0.0  # the largest |got - want| / (atol + rtol |want|) of any column band
        for (lo, hi), rtol, atol in EPI_TOL:
            ok = torch.allclose(got[..., lo:hi], want[..., lo:hi], rtol=rtol, atol=atol)
            check(ok, f"{name} disagrees with its plain version, columns {lo}:{hi} (rtol "
                      f"{rtol}, atol {atol}): max abs "
                      f"{float((got[..., lo:hi] - want[..., lo:hi]).abs().max())}")
            ratio = max(ratio, float(((got[..., lo:hi] - want[..., lo:hi]).abs()
                                      / (atol + rtol * want[..., lo:hi].abs())).max()))
        rec = {"shape": [int(v) for v in raw.shape], "n_imgs": nb, "T": t,
               "parts": cuda_epistemic.frame_parts(t, 3, h, w),
               "max_abs_err": float((got - want).abs().max()), "max_err_over_tolerance": ratio}
        if k < 3:  # one image of the main path = these three launches
            nbytes = _decode_bytes(t, nb, h, w, C)
            # per anchor-sample: 4 sums, 10 products+sums, 4+1+C exp, entropies
            flops = raw.shape[1] * raw.shape[2] * 3 * (60 + 12 * C)
            rec.update(
                ms=event_ms(lambda: cuda_epistemic.fused_epistemic_decode_cf_batched(
                    raw, priors, **kw), 10, flush),
                device_ms=event_ms(lambda: cuda_epistemic.fused_epistemic_decode_cf_batched(
                    raw, priors, **kw), 10, flush, device=True),
                # the kernel's time at every part count it takes (the rule's pick in `parts`)
                device_ms_by_parts={g: event_ms(lambda: cuda_epistemic._decode_launch(
                    raw, priors, nb, h, w, C, kw["layer_id"], g), 5, flush, device=True)
                    for g in PARTS},
                plain_ms=event_ms(lambda: cuda_epistemic.epistemic_decode_plain(
                    raw, priors, **kw), 3, flush),
                bound_ms=max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS) * 1e3,
                bound_by="bytes" if nbytes / HBM_BYTES_PER_S >= flops / FP32_FLOPS
                else "operations", bytes=nbytes)
            main.append((raw, kw))
        else:
            del raw
        per_shape.append(rec)
        del got, again, want
    # the three launches of an image queued as the main path queues them, no flush
    back_to_back = event_ms(lambda: [cuda_epistemic.fused_epistemic_decode_cf_batched(
        raw, priors, **kw) for raw, kw in main], 10)
    del main
    timed = per_shape[:3]
    return {
        "name": "epistemic_decode", "route": "cuda",
        "source": "bayesian_yolov3_torch/csrc/epistemic_decode.cu",
        "replaces": "bayesian_yolov3_tpu/ops/pallas_epistemic.py:62",
        "max_abs_err": max(r["max_abs_err"] for r in per_shape),
        "max_err_over_tolerance": max(r["max_err_over_tolerance"] for r in per_shape),
        "ms": sum(r["ms"] for r in timed),
        "device_ms": sum(r["device_ms"] for r in timed),
        "plain_ms": sum(r["plain_ms"] for r in timed),
        "bound_ms": sum(r["bound_ms"] for r in timed),
        "bound_by": "bytes", "library_ms": None, "bytes": sum(r["bytes"] for r in timed),
        "back_to_back_ms": back_to_back,
        "tolerance": [{"columns": list(c), "rtol": r, "atol": a} for c, r, a in EPI_TOL],
        "shapes_checked": len(EPI_CASES),
        "note": "ms/plain_ms/bound_ms: the three launches of one 1024x1920 image at T=30 "
                "summed, each launch timed alone after an L2 flush; device_ms: the same with "
                "the host's enqueue hidden behind a spin on the card; back_to_back_ms: the "
                "three queued together without a flush; bytes: the 9+C channels read, the "
                "rows and the priors",
        "shapes": per_shape,
    }


# kernels 10-11 against their plain versions.  The moment sums: float32 sums
# over up to 50 samples, in parts combined by a fixed tree in the kernel
# (csrc/decode_common.cuh) and blocked in the plain version; that order
# moves a sum by up to ~T * 2^-24 * sum|x|, about 5e-5 for 30 unit-scale
# products — hence atol 1e-4 beside rtol 1e-5.  The finalized
# rows: the same elementwise float32 arithmetic in the same order on the same
# sums (no FMA on either side), a few ulp apart where expf / logf differ;
# ids exactly.
MOM_TOL = (1e-5, 1e-4)
FIN_TOL = (1e-5, 1e-6)
SPLIT_T = (30, 15, 1, 7, 29, 50)
SPLIT_CASES = [(h, w, t, c) for h, w in (*SCALES, (5, 7)) for t in SPLIT_T for c in (1, 2, 8)]


def _err_over_tol(got, want, rtol, atol):
    return float(((got - want).abs() / (atol + rtol * want.abs())).max())


def check_epistemic_moments(dev, flush):
    """Kernel against plain version at the three ECP scales and a ragged
    (5, 7), T_local of SPLIT_T, C 1 / 2 / 8; a second launch equal to the
    first; at C=2 the sums finalized equal, bit for bit, to the one-shot
    decode of the same raws (the shared sample split).  Times at the main
    paths' shapes (C=2, T_local=30 on one rank and 15 on each of two): per
    scale, each launch alone after an L2 flush; the three launches of an
    image summed, and queued back to back without a flush."""
    gen = torch.Generator(device=dev).manual_seed(6)
    priors = torch.tensor([[0.3, 0.1], [0.15, 0.05], [0.08, 0.02]], device=dev)
    rtol, atol = MOM_TOL
    worst, worst_ratio, timed, raws, n_equal = 0.0, 0.0, {}, {}, 0
    for k, (h, w, t_local, c) in enumerate(SPLIT_CASES):
        raw = torch.randn((3 * 2 * (5 + c), t_local, h * w), generator=gen, device=dev)
        got = cuda_moments.epistemic_moments_cf(raw, cls_cnt=c)
        again = cuda_moments.epistemic_moments_cf(raw, cls_cnt=c)
        torch.cuda.synchronize()
        want = cuda_moments.epistemic_moments_plain(raw, cls_cnt=c)
        name = f"epistemic_moments(T_local={t_local}, C={c}, {(h, w)})"
        check(got.shape == want.shape == (3, 21 + c, h * w), f"{name}: shape {tuple(got.shape)}")
        check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
        check(torch.equal(got, again), f"{name}: a second launch differs from the first")
        ratio = _err_over_tol(got, want, rtol, atol)
        check(ratio <= 1.0, f"{name} disagrees with its plain version (rtol {rtol}, atol "
                            f"{atol}): max abs {float((got - want).abs().max())}")
        worst, worst_ratio = max(worst, float((got - want).abs().max())), max(worst_ratio, ratio)
        if c == C:
            kw = dict(h=h, w=w, cls_cnt=c, layer_id=k % 3)
            rows = cuda_moments.epistemic_finalize(got, priors, T=t_local, **kw)
            one_shot = cuda_epistemic.fused_epistemic_decode_cf_batched(raw, priors, n_imgs=1,
                                                                       **kw)
            check(torch.equal(rows, one_shot),
                  f"{name}: finalized, not bit-identical to the one-shot decode: max abs "
                  f"{float((rows - one_shot).abs().max())}")
            n_equal += 1
            del rows, one_shot
        if c == C and t_local in (30, 15) and (h, w) in SCALES:
            # the bytes the function must move: the 9+C channels it reads of
            # every sample, the sums it writes
            nbytes = (3 * (9 + c) * t_local * h * w + got.numel()) * 4
            flops = 3 * t_local * h * w * (60 + 12 * c)
            rec = timed.setdefault(t_local, {"ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0,
                                             "bytes": 0, "flops": 0, "per_scale_ms": [],
                                             "per_scale_device_ms": [], "parts": [],
                                             "device_ms_by_parts": []})
            ms = event_ms(lambda: cuda_moments.epistemic_moments_cf(raw, cls_cnt=c), 10, flush)
            rec["ms"] += ms
            rec["per_scale_ms"].append(ms)
            ms = event_ms(lambda: cuda_moments.epistemic_moments_cf(raw, cls_cnt=c), 10, flush,
                          device=True)
            rec["device_ms"] += ms
            rec["per_scale_device_ms"].append(ms)
            rec["device_ms_by_parts"].append({g: event_ms(lambda: cuda_moments._moments_launch(
                raw, c, 3, None, g), 5, flush, device=True) for g in PARTS})
            rec["parts"].append(cuda_epistemic.frame_parts(t_local, 3, h, w))
            rec["plain_ms"] += event_ms(lambda: cuda_moments.epistemic_moments_plain(
                raw, cls_cnt=c), 3, flush)
            rec["bytes"] += nbytes
            rec["flops"] += flops
            raws.setdefault(t_local, []).append(raw)
        del raw, got, again, want
    for t_local, rec in timed.items():
        t_b, t_f = rec["bytes"] / HBM_BYTES_PER_S, rec["flops"] / FP32_FLOPS
        rec.update(bound_ms=max(t_b, t_f) * 1e3, bound_by="bytes" if t_b >= t_f else "operations")
        rec["back_to_back_ms"] = event_ms(lambda: [cuda_moments.epistemic_moments_cf(
            r, cls_cnt=C) for r in raws[t_local]], 10)
    del raws
    main = timed[30]
    return {
        "name": "epistemic_moments", "route": "cuda",
        "source": "bayesian_yolov3_torch/csrc/epistemic_moments.cu",
        "replaces": "bayesian_yolov3_tpu/ops/pallas_epistemic.py:156",
        "max_abs_err": worst, "ms": main["ms"], "device_ms": main["device_ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"], "library_ms": None,
        "tolerance": {"rtol": rtol, "atol": atol}, "max_err_over_tolerance": worst_ratio,
        "shapes_checked": len(SPLIT_CASES), "bit_identical_to_decode": n_equal,
        "T_local_30": timed[30], "T_local_15": timed[15],
        "note": "ms/plain_ms/bound_ms: the three launches of one 1024x1920 image at C=2 and "
                "T_local=30 (one rank) summed, each launch timed alone after an L2 flush; "
                "device_ms: the same with the host's enqueue hidden behind a spin on the card; "
                "`T_local_15` gives the same for each of two ranks; back_to_back_ms: the "
                "three queued together without a flush; bit_identical_to_decode: cases whose "
                "sums, finalized, equal the one-shot decode; no single PyTorch call computes "
                "the moments",
    }


# the scale sets of the one-launch decodes: the main path's three ECP scales,
# and ragged sets whose scales each end in a partial block (one of them with
# a scale of one cell)
SCALE_SETS = (SCALES, ((3, 5), (6, 10), (12, 20)), ((1, 1), (7, 9), (13, 29)))


def _priors_by_stride(dev):
    """Other priors at every stride, so a scale that reads another's shows."""
    return {s: torch.tensor([[0.3, 0.1], [0.15, 0.05], [0.08, 0.02]], device=dev) / (1 + k)
            for k, s in enumerate((32, 16, 8))}


def _rows_agree(name, got, want, rtol, atol):
    """Rows against their plain version: the id columns (the last two)
    exactly, the rest within rtol / atol; (max abs error, error / tolerance)."""
    check(got.shape == want.shape, f"{name}: shapes {tuple(got.shape)} {tuple(want.shape)}")
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
    check(torch.equal(got[..., -2:], want[..., -2:]), f"{name}: id columns differ")
    err = (got[..., :-2] - want[..., :-2]).abs()
    ratio = float((err / (atol + rtol * want[..., :-2].abs())).max())
    check(ratio <= 1.0, f"{name} disagrees with its plain version (rtol {rtol}, atol {atol}): "
                        f"max abs {float(err.max())}")
    return float(err.max()), ratio


def check_epistemic_finalize(dev, flush):
    """The per-scale wrapper (a one-scale table) against its plain version
    on the sums of real samples at the three ECP scales and a ragged (5, 7),
    T 30 / 15 / 1 / 7 / 29 / 50, C 1 / 2 / 8, and n_imgs 2 at C=2, T=30.
    One launch over the scales of a packed buffer
    (epistemic_finalize_all_scales) against its plain version and, bit for
    bit, against the per-scale launches concatenated: the ECP scales at
    n_imgs 1 and 2, T 30 / 15 / 1, C 1 / 2 / 8, and the ragged SCALE_SETS;
    the buffer filled by the moments kernel through ``out=`` views, each
    equal to the moments launched alone.  Times at the main path's shapes
    (C=2, T=30, one image): the one launch alone after an L2 flush, the same
    with the host's enqueue hidden, 20 back to back; and the three
    per-scale launches, each alone, for comparison."""
    gen = torch.Generator(device=dev).manual_seed(7)
    priors = torch.tensor([[0.3, 0.1], [0.15, 0.05], [0.08, 0.02]], device=dev)
    pri = _priors_by_stride(dev)
    rtol, atol = FIN_TOL
    cases = [(1, *k) for k in SPLIT_CASES] + [(2, h, w, 30, C) for h, w in SCALES]
    worst, worst_ratio = 0.0, 0.0
    for k, (nb, h, w, t, c) in enumerate(cases):
        raw = torch.randn((3 * 2 * (5 + c), t, nb * h * w), generator=gen, device=dev)
        sums = cuda_moments.epistemic_moments_plain(raw, cls_cnt=c)
        del raw
        kw = dict(T=t, h=h, w=w, cls_cnt=c, layer_id=k % 3, n_imgs=nb)
        got = cuda_moments.epistemic_finalize(sums, priors, **kw)
        torch.cuda.synchronize()
        want = cuda_moments.epistemic_finalize_plain(sums, priors, **kw)
        name = f"epistemic_finalize(T={t}, C={c}, n_imgs={nb}, {(h, w)})"
        check(got.shape == (nb, 3 * h * w, 21 + c), f"{name}: shape")
        err, ratio = _rows_agree(name, got, want, rtol, atol)
        worst, worst_ratio = max(worst, err), max(worst_ratio, ratio)
        del sums, got, want

    all_cases = ([(nb, SCALES, t, c) for nb in (1, 2) for t in (T, 15, 1) for c in (1, 2, 8)]
                 + [(nb, hws, t, c) for hws in SCALE_SETS[1:] for nb, t, c in
                    ((1, 7, 2), (3, 30, 1), (2, 15, 8))])
    timed = None
    for nb, hws, t, c in all_cases:
        M = 21 + c
        plan = decode.scale_plan(hws, 3)
        packed = torch.empty(plan.rows * M * nb, device=dev)
        views = decode.packed_views(packed, plan, M, nb)
        for view, (h, w) in zip(views, hws):
            raw = torch.randn((3 * 2 * (5 + c), t, nb * h * w), generator=gen, device=dev)
            filled = cuda_moments.epistemic_moments_cf(raw, cls_cnt=c, out=view)
            alone = cuda_moments.epistemic_moments_cf(raw, cls_cnt=c)
            check(filled.data_ptr() == view.data_ptr() and torch.equal(view, alone),
                  f"epistemic_moments(out=...) at {(nb, h, w, t, c)}: not the moments alone")
            del raw, alone
        kw = dict(T=t, hws=hws, cls_cnt=c, n_imgs=nb)
        got = cuda_moments.epistemic_finalize_all_scales(packed, pri, **kw)
        per = torch.cat([cuda_moments.epistemic_finalize(
            m, pri[s], T=t, h=h, w=w, cls_cnt=c, layer_id=i, n_imgs=nb)
            for i, (m, (h, w), s) in enumerate(zip(views, hws, (32, 16, 8)))], dim=1)
        torch.cuda.synchronize()
        want = cuda_moments.epistemic_finalize_all_scales_plain(packed, pri, **kw)
        name = f"epistemic_finalize_all_scales(T={t}, C={c}, n_imgs={nb}, {hws})"
        check(got.shape == (nb, plan.rows, M), f"{name}: shape {tuple(got.shape)}")
        check(torch.equal(got, per),
              f"{name}: one launch over the scales differs from the per-scale launches")
        err, ratio = _rows_agree(name, got, want, rtol, atol)
        worst, worst_ratio = max(worst, err), max(worst_ratio, ratio)
        if nb == 1 and hws == SCALES and t == T and c == C:
            nbytes = (packed.numel() + got.numel() + sum(p.numel() for p in pri.values())) * 4

            def one():
                return cuda_moments.epistemic_finalize_all_scales(packed, pri, **kw)

            timed = {
                "ms": event_ms(one, 10, flush),
                "device_ms": event_ms(one, 10, flush, device=True),
                "plain_ms": event_ms(lambda: cuda_moments.epistemic_finalize_all_scales_plain(
                    packed, pri, **kw), 3, flush),
                "back_to_back_ms": event_ms(lambda: [one() for _ in range(20)], 3) / 20,
                "per_scale_ms": [event_ms(lambda: cuda_moments.epistemic_finalize(
                    m, pri[s], T=t, h=h, w=w, cls_cnt=c, layer_id=i), 10, flush)
                    for i, (m, (h, w), s) in enumerate(zip(views, hws, (32, 16, 8)))],
                "per_scale_device_ms": [event_ms(lambda: cuda_moments.epistemic_finalize(
                    m, pri[s], T=t, h=h, w=w, cls_cnt=c, layer_id=i), 10, flush, device=True)
                    for i, (m, (h, w), s) in enumerate(zip(views, hws, (32, 16, 8)))],
                "bytes": nbytes}
            # the function the mc pipeline calls is the one launch
            timed["all_scales_ms"], timed["all_scales_device_ms"] = timed["ms"], timed["device_ms"]
        del packed, views, got, per, want
    return {
        "name": "epistemic_finalize", "route": "cuda",
        "source": "bayesian_yolov3_torch/csrc/epistemic_finalize.cu",
        "replaces": "bayesian_yolov3_tpu/ops/pallas_epistemic.py:181",
        "max_abs_err": worst, **timed,
        "bound_ms": timed["bytes"] / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "library_ms": None,
        "tolerance": {"rtol": rtol, "atol": atol, "id_columns": "exact",
                      "all_scales_vs_per_scale": "bit for bit"},
        "max_err_over_tolerance": worst_ratio, "shapes_checked": len(cases) + len(all_cases),
        "note": "ms/plain_ms/bound_ms: epistemic_finalize_all_scales on the packed sums of one "
                "1024x1920 image at C=2, T=30: ONE launch over the three scales, timed alone "
                "after an L2 flush; device_ms: the same with the host's enqueue hidden behind "
                "a spin on the card; all_scales_ms / all_scales_device_ms: the same function "
                "(the mc pipeline's), so the same readings; per_scale_ms / "
                "per_scale_device_ms: each scale's one-scale launch alone; back_to_back_ms: "
                "the function queued 20 at a time; a few hundred flops per anchor against 184 "
                "bytes, so bytes bound it; no single PyTorch call computes the finalize",
    }


# kernel 9 against its plain version: the same elementwise float32 math
# (sigmoid, exp, softmax, x*log(x), a correctly rounded division by the grid
# size) from two libraries, a few ulp apart; ids exactly.
BOX_TOL = (1e-5, 1e-6)


def check_box_decode(dev, flush):
    """One launch over the scales of a batch (fused_box_decode_all_scales)
    against its plain version and, bit for bit, against the per-scale
    launches (a one-scale table each) concatenated: the ECP scales at nb 1
    and 11, the ragged SCALE_SETS at nb 3, standard and aleatoric, C 1 / 2 /
    8.  Times at the main path's shapes (nb 11, C 2): the one launch alone
    after an L2 flush, the same with the host's enqueue hidden, 20 back to
    back; and the three per-scale launches, each alone, for comparison."""
    gen = torch.Generator(device=dev).manual_seed(5)
    pri = _priors_by_stride(dev)
    rtol, atol = BOX_TOL
    cases = [(nb, SCALES) for nb in (1, BATCH)] + [(3, hws) for hws in SCALE_SETS[1:]]
    checked, worst, worst_ratio, timed = 0, 0.0, 0.0, {}
    for aleatoric in (False, True):
        for c in (1, 2, 8):
            spec = VariantSpec(Variant.ALEATORIC if aleatoric else Variant.STANDARD, c)
            chpp = 2 * (5 + c) if aleatoric else 5 + c
            for nb, hws in cases:
                outs = [(torch.randn((3 * chpp, nb, h * w), generator=gen, device=dev) * 2.0,
                         (h, w)) for h, w in hws]
                per_kw = [dict(h=h, w=w, cls_cnt=c, layer_id=i, aleatoric=aleatoric)
                          for i, (h, w) in enumerate(hws)]
                got = cuda_decode.fused_box_decode_all_scales(outs, pri, spec=spec)
                per = torch.cat([cuda_decode.fused_box_decode_cf(raw, pri[s], **kw)
                                 for (raw, _), s, kw in zip(outs, (32, 16, 8), per_kw)], dim=1)
                torch.cuda.synchronize()
                want = cuda_decode.box_decode_all_scales_plain(outs, pri, spec=spec)
                torch.cuda.synchronize()
                name = f"box_decode(aleatoric={aleatoric}, C={c}, nb={nb}, {hws})"
                n_rows = 3 * sum(h * w for h, w in hws)
                check(got.shape == (nb, n_rows, spec.decoded_width()),
                      f"{name}: shape {tuple(got.shape)}")
                check(torch.equal(got, per),
                      f"{name}: one launch over the scales differs from the per-scale launches")
                err, ratio = _rows_agree(name, got, want, rtol, atol)
                worst, worst_ratio = max(worst, err), max(worst_ratio, ratio)
                checked += 1
                if nb == BATCH and c == C:
                    # bytes the function must move: the channels it reads
                    # (the aleatoric head's two stddev groups are not read),
                    # the rows, the priors
                    n_read = (9 if aleatoric else 5) + c
                    nbytes = (n_read * nb * n_rows + got.numel()
                              + sum(p.numel() for p in pri.values())) * 4
                    flops = nb * n_rows * (40 + 12 * c)
                    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS

                    def one():
                        return cuda_decode.fused_box_decode_all_scales(outs, pri, spec=spec)

                    rec = timed[aleatoric] = {
                        "ms": event_ms(one, 10, flush),
                        "device_ms": event_ms(one, 10, flush, device=True),
                        "plain_ms": event_ms(lambda: cuda_decode.box_decode_all_scales_plain(
                            outs, pri, spec=spec), 3, flush),
                        # 20 calls back to back, no flush: the host's launch
                        # latency hidden behind the queue
                        "back_to_back_ms": event_ms(lambda: [one() for _ in range(20)], 3) / 20,
                        "per_scale_ms": [event_ms(lambda: cuda_decode.fused_box_decode_cf(
                            raw, pri[s], **kw), 10, flush)
                            for (raw, _), s, kw in zip(outs, (32, 16, 8), per_kw)],
                        "per_scale_device_ms": [event_ms(lambda: cuda_decode.fused_box_decode_cf(
                            raw, pri[s], **kw), 10, flush, device=True)
                            for (raw, _), s, kw in zip(outs, (32, 16, 8), per_kw)],
                        "bytes": nbytes, "flops": flops,
                        "bound_ms": max(t_b, t_f) * 1e3,
                        "bound_by": "bytes" if t_b >= t_f else "operations"}
                    # the function the runner calls is the one launch
                    rec["all_scales_ms"], rec["all_scales_device_ms"] = rec["ms"], rec["device_ms"]
                del outs, got, per, want
    main = timed[True]
    return {
        "name": "box_decode", "route": "cuda",
        "source": "bayesian_yolov3_torch/csrc/box_decode.cu",
        "replaces": "bayesian_yolov3_tpu/ops/pallas_decode.py:26",
        "max_abs_err": worst, **{k: main[k] for k in (
            "ms", "device_ms", "all_scales_ms", "all_scales_device_ms", "plain_ms", "bound_ms",
            "bound_by")}, "library_ms": None,
        "tolerance": {"rtol": rtol, "atol": atol, "id_columns": "exact",
                      "all_scales_vs_per_scale": "bit for bit"},
        "max_err_over_tolerance": worst_ratio, "shapes_checked": checked,
        "aleatoric": timed[True], "standard": timed[False],
        "note": f"ms/plain_ms/bound_ms: fused_box_decode_all_scales on the three aleatoric "
                f"scales of one batch of {BATCH} 1024x1920 images at C={C}: ONE launch, timed "
                "alone after an L2 flush (host launch latency included); device_ms: the same "
                "with the host's enqueue hidden behind a spin on the card; all_scales_ms / "
                "all_scales_device_ms: the same function (the runner's), so the same readings; "
                "per_scale_ms / per_scale_device_ms: each scale's one-scale launch alone; "
                "back_to_back_ms: the function queued 20 at a time; `standard` gives the same "
                "for the standard head; no single PyTorch call computes the decode",
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
    return got_i, got_c


def check_nms(dev):
    gen = torch.Generator(device=dev).manual_seed(1)
    boxes_all, scores_all = _random_candidates(gen, 3 * N_ANCHORS, dev)
    boxes_all = boxes_all.reshape(3, N_ANCHORS, 4)
    scores_all = scores_all.reshape(3, N_ANCHORS)
    # the main path's candidates: the top 8192 by score of a full anchor set
    order = torch.sort(scores_all, dim=1, descending=True, stable=True).indices[:, :PRE_TOP_K]
    boxes_top = torch.gather(boxes_all, 1, order[:, :, None].expand(-1, -1, 4)).contiguous()
    scores_top = torch.gather(scores_all, 1, order).contiguous()
    # the exact retry's candidates: boxes e^6 times an ECP-sized prior, far
    # larger than the image, so one pick suppresses nearly all of them and
    # the scan runs through every chunk
    centre = torch.rand((1, N_ANCHORS, 2), generator=gen, device=dev)
    half = (torch.rand((1, N_ANCHORS, 2), generator=gen, device=dev) * 0.3 + 0.02) \
        * math.exp(6.0) / 2
    boxes_wide = torch.cat([centre - half, centre + half], dim=2).contiguous()
    cases = {
        "1x8192": (boxes_top[:1].contiguous(), scores_top[:1].contiguous()),
        "1x120960": (boxes_all[:1].contiguous(), scores_all[:1].contiguous()),
        "3x8192": (boxes_top, scores_top),
        "11x8192": (boxes_top[[0, 1, 2] * 3 + [0, 1]].contiguous(),
                    scores_top[[0, 1, 2] * 3 + [0, 1]].contiguous()),
        "1x120960_wide_boxes": (boxes_wide, scores_all[:1].contiguous()),
    }
    per_shape = []
    for name, (b, s) in cases.items():
        _, cnt = _nms_equal(name, b, s)
        ms = event_ms(lambda: cuda_nms.greedy_nms_cuda(b, s, MAX_OUT, 0.5), 5)
        plain_ms = event_ms(lambda: cuda_nms.greedy_nms_plain(b, s, MAX_OUT, 0.5), 1)
        nb, k = s.shape
        picks = int(cnt.max())
        nbytes = nb * (k * 20 + MAX_OUT * 4 + 4)
        # a pick costs one IoU (17 flops) + compare against every candidate
        flops = nb * picks * k * 18
        per_shape.append({
            "name": name, "shape": [nb, k], "picks": cnt.tolist(), "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS) * 1e3,
            "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S >= flops / FP32_FLOPS
            else "operations",
            "chunks": -(-k // cuda_nms.CHUNK),
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
    # dense clusters, 900 of 30 jittered copies, ordered cluster by cluster:
    # each cluster's first copy is picked unless an earlier cluster covers it,
    # picks reach across seven chunks and clusters straddle chunk boundaries
    n_cl, per = 900, 30
    centres, _ = _random_candidates(gen, n_cl, dev)
    crafted["dense_clusters_multichunk"] = (
        centres.repeat_interleave(per, dim=0)
        + (torch.rand((n_cl * per, 4), generator=gen, device=dev) - 0.5) * 0.008,
        (n_cl - torch.arange(n_cl * per, device=dev) // per).float()
        + torch.rand(n_cl * per, generator=gen, device=dev) * 0.9)
    crafted_counts, crafted_chunks = {}, {}
    for name, (bb, ss) in crafted.items():
        got_i, cnt = _nms_equal(name, bb[None].contiguous(), ss[None].contiguous())
        crafted_counts[name] = int(cnt[0])
        rank = torch.empty_like(ss, dtype=torch.long)
        rank[torch.sort(ss, descending=True, stable=True).indices] = torch.arange(
            len(ss), device=dev)
        picked = got_i[0, :crafted_counts[name]].long()
        crafted_chunks[name] = len(set((rank[picked] // cuda_nms.CHUNK).tolist()))
    check(crafted_counts["fewer_than_max_out_odd_k"] < MAX_OUT, "crafted case filled up")
    check(crafted_counts["all_padding"] == 0, "-inf scores were picked")
    check(crafted_chunks["dense_clusters_multichunk"] >= 3,
          f"the multi-chunk case picked from {crafted_chunks} chunks")

    main = per_shape[0]
    return {
        "name": "greedy_nms", "route": "cuda",
        "source": "bayesian_yolov3_torch/csrc/greedy_nms.cu",
        "replaces": "bayesian_yolov3_tpu/ops/pallas_nms.py:156",
        "also_replaces": "bayesian_yolov3_tpu/ops/pallas_nms.py:40",
        "max_abs_err": 0.0,  # indices and counts are exactly equal, or the run fails
        "tolerance": "exact (indices and counts torch.equal)",
        "ms": main["ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": None,
        "ms_exact_120960": per_shape[1]["ms"],
        "note": "ms/plain_ms/bound_ms at (1, 8192), the certified path, wrapper (stable "
                "sort, gathers) included; the kernels scan the sorted candidates in "
                f"chunks of {cuda_nms.CHUNK}",
        "shapes": per_shape, "crafted_counts": crafted_counts,
        "crafted_chunks_with_picks": crafted_chunks,
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
    allowed = CONV_ATOL + CONV_RTOL * w.abs()
    bad = err > allowed
    check(not bool(bad.any()),
          f"{name} disagrees with its plain version (rtol {CONV_RTOL}, atol {CONV_ATOL}): "
          f"{int(bad.sum())} elements, max abs {float(err.max())}, border ring max abs "
          f"{float(ring.max())}, {share:.4%} of elements differ at all")
    check(share <= CONV_MAX_DIFF_SHARE,
          f"{name}: {share:.4%} of elements differ from the plain version")
    return {"max_abs_err": float(err.max()), "border_max_abs_err": float(ring.max()),
            "max_err_over_tolerance": float((err / allowed).max()), "differing_share": share}


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
            "max_err_over_tolerance": max(s["max_err_over_tolerance"] for s in shapes),
            "differing_share": max(s["differing_share"] for s in shapes),
            **tot, "bound_by": "bytes" if t_bytes >= t_flops else "operations",
            "tolerance": {"rtol": CONV_RTOL, "atol": CONV_ATOL},
            "launches_per_image": sum(counts), **extra, "shapes": shapes}


# The batched path's batch (N = 11) at the main shapes is timed too; the other
# extra shapes are what the persistent 2 x 64 tiles make hard: widths that are
# not multiples of 64, single pixels, and batches of small images whose tile
# walk crosses image boundaries (more tiles than SMs).
RES_CASES = [((1, 512, 960, 64), 1), ((1, 256, 480, 128), 2), ((1, 128, 240, 256), 8),
             ((BATCH, 512, 960, 64), 0), ((BATCH, 256, 480, 128), 0),
             ((BATCH, 128, 240, 256), 0),
             ((2, 10, 18, 128), 0), ((2, 5, 9, 256), 0), ((1, 20, 36, 64), 0),
             ((2, 7, 65, 64), 0), ((1, 9, 130, 128), 0), ((1, 6, 240, 256), 0),
             ((1, 1, 1, 64), 0), ((1, 1, 1, 128), 0), ((1, 1, 1, 256), 0),
             ((3, 91, 130, 64), 0), ((3, 45, 200, 256), 0)]


def _res_operands(gen, c, dev):
    wa, wb = _conv_weights(gen, c // 2, c, 1, dev), _conv_weights(gen, c, c // 2, 3, dev)
    return wa, wb, _conv_bn(gen, c // 2, dev), _conv_bn(gen, c, dev)


def _res_chain(gen, n, dev, flush):
    """The 11 res-block calls of one pass of _fused_early_stages (1 at C=64,
    2 at C=128, 8 at C=256, each on its own weights), queued back to back in
    one CUDA-event window: through the wrappers (cached layouts, as the main
    path calls them) and through _res_launch alone, 10 windows each, L2
    flushed before each window; the median, and the host's time to enqueue
    the 11 wrapper calls (median over the windows)."""
    shapes = [(n, 512, 960, 64)] + [(n, 256, 480, 128)] * 2 + [(n, 128, 240, 256)] * 8
    calls = []
    for shape in shapes:
        x = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
        calls.append((x, *_res_operands(gen, shape[3], dev)))
    launches = [(x, cuda_conv.cached(cuda_conv._res_kernel_weights, wa, wb),
                 cuda_conv.cached(cuda_conv._bn_vector, *bna, *bnb))
                for x, wa, wb, bna, bnb in calls]
    host_s = []

    def wrappers():
        t0 = time.perf_counter()
        for args in calls:
            cuda_conv.fused_res_block(*args)
        host_s.append(time.perf_counter() - t0)

    def kernels():
        for args in launches:
            cuda_conv._res_launch(*args)

    wrappers()
    kernels()
    out = {"shape_of_first": list(shapes[0]),
           "wrappers_ms": event_ms(wrappers, 10, flush), "kernels_ms": event_ms(kernels, 10, flush)}
    out["wrappers_minus_kernels_ms"] = out["wrappers_ms"] - out["kernels_ms"]
    out["host_enqueue_ms"] = float(np.median(host_s)) * 1e3
    return out


PHASE_NAMES = {
    "fused_res_block": ("1x1 waits (x slice, piece, barrier)", "1x1 products", "t epilogue",
                        "3x3 piece waits", "3x3 products and barriers", "output epilogue",
                        "next x slices issue", "skip loads issue"),
    "fused_stem": ("conv1 products", "t1 epilogue", "conv2' issue", "next x tile",
                   "next im2col", "conv2' wait", "output epilogue")}


def _phases(name, launch, tiles):
    """Where a persistent block's time goes: the kernel built with
    -DFCONV_PHASES, whose thread 0 of each block counts clock cycles by phase
    (csrc/hopper_common.cuh), over 3 launches; the share of each phase and
    the cycles per tile (all blocks' counts over the tiles)."""
    read = _build.load(name, ("FCONV_PHASES",)).fconv_phases_read
    read.argtypes, read.restype = [ctypes.c_void_p], ctypes.c_int
    cycles = np.zeros(8, dtype=np.uint64)
    launch()  # builds the measurement library
    check(read(cycles.ctypes.data) == 0, f"{name}: reading the phase counters failed")
    for _ in range(3):
        launch()
    check(read(cycles.ctypes.data) == 0, f"{name}: reading the phase counters failed")
    names = PHASE_NAMES[name]
    total = float(cycles[:len(names)].sum())
    return {"cycles_per_tile": total / (3 * tiles),
            "share": {k: float(v) / total for k, v in zip(names, cycles)}}


def check_res_block(dev, flush):
    gen = torch.Generator(device=dev).manual_seed(2)
    # (shape, launches per 1024x1920 image)
    shapes = []
    for shape, per_img in RES_CASES:
        n, h, w, c = shape
        x = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
        wa, wb, bna, bnb = _res_operands(gen, c, dev)
        got = cuda_conv.fused_res_block(x, wa, wb, bna, bnb)
        want = cuda_conv.fused_res_block_plain(x, wa, wb, bna, bnb)
        rec = {"shape": list(shape), **_conv_agree(f"fused_res_block{shape}", got, want)}
        del got, want
        if per_img or n == BATCH:
            wk = cuda_conv._res_kernel_weights(wa, wb)
            bnk = cuda_conv._bn_vector(*bna, *bnb)
            pa = ({"w": wa, "gamma": bna[0], "beta": bna[1]}, {"w": wb, "gamma": bnb[0], "beta": bnb[1]})
            st = [{"mean": torch.zeros_like(b[0]), "var": torch.ones_like(b[0]) - common.BN_EPS}
                  for b in (bna, bnb)]

            def unfused():  # the conv_block composition: cuDNN bf16 + elementwise passes
                t = common.conv_block(pa[0], st[0], x, compute_dtype=torch.bfloat16)
                return common.conv_block(pa[1], st[1], t, compute_dtype=torch.bfloat16) + x

            if n == 1:
                rec["phases"] = _phases(
                    "fused_res_block",
                    lambda: cuda_conv._res_launch(x, wk, bnk, defines=("FCONV_PHASES",)),
                    -(-h // cuda_conv.RES_TILE[0]) * -(-w // cuda_conv.RES_TILE[1]))
            rec.update(
                ms=event_ms(lambda: cuda_conv.fused_res_block(x, wa, wb, bna, bnb), 10, flush),
                kernel_only_ms=event_ms(lambda: cuda_conv._res_launch(x, wk, bnk), 10, flush),
                plain_ms=event_ms(lambda: cuda_conv.fused_res_block_plain(x, wa, wb, bna, bnb),
                                  3, flush),
                unfused_ms=event_ms(unfused, 5, flush),
                **_bound(2 * x.numel() * 2 + (wa.numel() + wb.numel()) * 2 + 3 * c * 4,
                         n * h * w * 10 * c * c))
        shapes.append(rec)
        del x
    chains = {f"n{n}": _res_chain(gen, n, dev, flush) for n in (1, BATCH)}
    return _per_image(
        "fused_res_block", shapes, [k for _, k in RES_CASES], library_ms=None,
        replaces="bayesian_yolov3_tpu/ops/pallas_conv.py:282", back_to_back=chains,
        note="ms (the wrapper as the main path calls it, cached layouts), "
             "kernel_only_ms, plain_ms, bound_ms, unfused_ms: the 11 launches of one "
             "1024x1920 image summed (1 at C=64, 2 at C=128, 8 at C=256); the N=11 shapes "
             "are timed per batch and not summed; no single PyTorch call computes the "
             "block, so library_ms is null and unfused_ms times the conv_block composition "
             "(cuDNN bf16), which the port never calls for these convs on the card; "
             "back_to_back: the 11 calls of one pass queued in one event window")


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
    library_ms = sum(s["library_ms"] * k for s, k in zip(shapes, counts) if k)
    kernel_only_ms = sum(s["kernel_only_ms"] * k for s, k in zip(shapes, counts) if k)
    return _per_image(
        "fused_downsample", shapes, counts, library_ms=library_ms,
        kernel_only_le_library=kernel_only_ms <= library_ms,
        replaces="bayesian_yolov3_tpu/ops/pallas_conv.py:488",
        also_replaces="bayesian_yolov3_tpu/ops/pallas_conv.py:395",
        note="the 2 launches of one 1024x1920 image summed (64->128 at 512x960, 128->256 "
             "at 256x480); library_ms: one F.conv2d in bf16 channels_last of the same "
             "convolution, WITHOUT the BN / LeakyReLU epilogue; the port never calls it "
             "for these convs on the card")


# (image batch, height, width) of the RGB image; the stem sees (N, H/2, W/2, 12).
# Besides the main shapes (N = 1 and the batched path's 11, timed): widths of
# 65, 130 and 240 at the stem, a single pixel, a batch of 3 whose tile walk
# crosses image boundaries.
STEM_CASES = [((1, 1024, 1920), 1), ((BATCH, 1024, 1920), 0), ((2, 40, 72), 0), ((1, 18, 38), 0),
              ((1, 14, 130), 0), ((2, 10, 260), 0), ((1, 12, 480), 0), ((1, 2, 2), 0),
              ((3, 180, 260), 0)]


def check_stem(dev, flush):
    gen = torch.Generator(device=dev).manual_seed(4)
    p0 = {"w": _conv_weights(gen, 32, 3, 3, dev)}
    p1 = {"w": _conv_weights(gen, 64, 32, 3, dev)}
    k3, k2 = darknet._stem_kernels(p0["w"].to(torch.bfloat16), p1["w"].to(torch.bfloat16))
    s1, b1 = _conv_bn(gen, 32, dev)
    bn1, bn2 = (s1.repeat(4), b1.repeat(4)), _conv_bn(gen, 64, dev)
    shapes = []
    for (n, h, w), per_img in STEM_CASES:
        img = torch.rand((n, h, w, 3), generator=gen, device=dev)
        x = darknet._space_to_depth(img.to(torch.bfloat16))
        got = cuda_conv.fused_stem(x, k3, k2, bn1, bn2)
        want = cuda_conv.fused_stem_plain(x, k3, k2, bn1, bn2)
        rec = {"shape": list(x.shape), **_conv_agree(f"fused_stem{tuple(x.shape)}", got, want)}
        # strided views: channels-first memory, as the host-packed planes give
        # (read as planes where the rows allow 4-byte loads, else element by
        # element), planes whose rows are padded by one (as planes where W/2
        # is odd: the odd last column), and a pixel pitch of 13 (element by
        # element)
        x_cf = x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
        x_pad = torch.zeros((n, 12, h // 2, w // 2 + 1), dtype=x.dtype, device=dev)[..., :w // 2]
        x_pad.copy_(x.permute(0, 3, 1, 2))
        x_pad = x_pad.permute(0, 2, 3, 1)
        x_13 = torch.zeros(x.shape[:3] + (13,), dtype=x.dtype, device=dev)[..., :12]
        x_13.copy_(x)
        rec["read_modes"] = [cuda_conv._stem_mode(v) for v in (x, x_cf, x_pad, x_13)]
        for name, view in (("channels-first", x_cf), ("padded-row planes", x_pad),
                           ("pixel pitch 13", x_13)):
            check(not view.is_contiguous() or x.shape[1] * x.shape[2] == 1,
                  f"the {name} stem input is contiguous")
            check(torch.equal(cuda_conv.fused_stem(view, k3, k2, bn1, bn2), got),
                  f"fused_stem: a {name} view gives other values than the contiguous tensor")
        del got, want, x_cf, x_pad, x_13
        if per_img or n == BATCH:
            wk = cuda_conv._stem_kernel_weights(k3, k2)
            bnk = cuda_conv._bn_vector(*bn1, *bn2)
            params = {"conv_00": {**p0, "gamma": s1, "beta": b1},
                      "conv_01": {**p1, "gamma": bn2[0], "beta": bn2[1]}}
            stats = {k: {"mean": torch.zeros_like(v["gamma"]),
                         "var": torch.ones_like(v["gamma"]) - common.BN_EPS}
                     for k, v in params.items()}
            px = n * (h // 2) * (w // 2)
            if n == 1:
                rec["phases"] = _phases(
                    "fused_stem",
                    lambda: cuda_conv._stem_launch(x, wk, bnk, defines=("FCONV_PHASES",)),
                    -(-(h // 2) // cuda_conv.STEM_TILE[0]) * -(-(w // 2) // cuda_conv.STEM_TILE[1]))
            rec.update(
                ms=event_ms(lambda: cuda_conv.fused_stem(x, k3, k2, bn1, bn2), 10, flush),
                kernel_only_ms=event_ms(lambda: cuda_conv._stem_launch(x, wk, bnk), 10, flush),
                plain_ms=event_ms(lambda: cuda_conv.fused_stem_plain(x, k3, k2, bn1, bn2),
                                  3, flush),
                unfused_ms=event_ms(lambda: darknet._fast_stem(params, stats, img,
                                                               torch.bfloat16), 5, flush),
                **_bound(px * (12 + 64) * 2 + (128 * 108 + 64 * 512) * 2 + 192 * 8,
                         px * 2 * (108 * 128 + 512 * 64)))
        shapes.append(rec)
        del x, img
    return _per_image(
        "fused_stem", shapes, [k for _, k in STEM_CASES], library_ms=None,
        replaces="bayesian_yolov3_tpu/ops/pallas_conv.py:139",
        note="one launch per 1024x1920 image, on its (1, 512, 960, 12) space-to-depth "
             "form; the N=11 shape is timed per batch and not summed; read_modes: the "
             "kernel's x path for the contiguous, channels-first, padded-row-planes and "
             "pitch-13 inputs (1 pixels, 2 planes, 0 elements); no single PyTorch call "
             "computes the stem, "
             "so library_ms is null and unfused_ms times models.darknet._fast_stem in bf16 "
             "(two cuDNN convolutions plus elementwise passes, space-to-depth included)")


# -- the int8 head section ---------------------------------------------------


def _int8_blocks():
    """The 20 conv blocks of the int8 head section at 1024x1920, in the order
    they run: (name, h, w, k, cin, cout, dropout site or None)."""
    out, site = [], 0
    cins = {1: 1024, 2: 256 + 512, 3: 128 + 256}
    for head, (h, w) in zip((1, 2, 3), SCALES):
        if head > 1:
            k, cout = yolov3._TRANS_PLANS[head - 1]
            out.append((f"trans{head - 1}", *SCALES[head - 2], k,
                        yolov3._HEAD_PLANS[head - 1][yolov3._BRANCH_IDX][1], cout, None))
        cin = cins[head]
        for j, (k, cout) in enumerate(yolov3._HEAD_PLANS[head]):
            drop = j <= yolov3._BRANCH_IDX
            out.append((f"head{head}_conv{j}", h, w, k, cin, cout, site if drop else None))
            site += drop
            cin = cout
    return out


INT8_BLOCKS = _int8_blocks()


def check_quant_epilogue(dev, flush):
    """The int8 epilogue kernel against its plain version, torch.equal, at
    the 20 block shapes of one 1024x1920 image: T=30 samples stacked with
    the fixed table's keys on the 15 dropout sites (the epistemic path), and
    a batch of 11 without keys (the batched path); plus a stack of 70
    samples (two launches of 64 and 6 keys).  Accumulators up to 2^27, past
    float32's exact integers.  Each block's wrapper timed after an L2 flush
    (ms), alone behind a spin (device_ms), and its plain version; the sums
    over an image's (or a batch's) 20 launches."""
    gen = torch.Generator(device=dev).manual_seed(6)
    table = yolov3._fixed_key_table(MC_MASKS, 70)
    out = {}
    for label, s, drop_on in (("epistemic_T30", T, True), (f"batched_nb{BATCH}", BATCH, False),
                              ("stack70", 70, True)):
        blocks = INT8_BLOCKS if s != 70 else [("small", 5, 7, 1, 128, 128, 0)]
        recs = []
        for name, h, w, _, _, cout, site in blocks:
            m = s * h * w
            acc = torch.randint(-2 ** 27, 2 ** 27, (m, cout), generator=gen, device=dev,
                                dtype=torch.int32)
            dq = torch.rand(cout, generator=gen, device=dev) * 4e-8 + 2e-8
            bns = torch.rand(cout, generator=gen, device=dev) + 0.5
            bnb = (torch.rand(cout, generator=gen, device=dev) - 0.5) * 0.6
            keys = ([int(k) for k in table[:s, site]] if drop_on and site is not None
                    else None)

            def one():
                return cuda_quant.quant_epilogue(acc, dq, bns, bnb, 30.0, keys=keys)

            before = cuda_quant.launch_count
            got = one()
            check(cuda_quant.launch_count - before == (2 if s == 70 else 1),
                  f"quant_epilogue({label}, {name}): {cuda_quant.launch_count - before} launches")
            want = cuda_quant.quant_epilogue_plain(acc, dq, bns, bnb, 30.0, keys=keys)
            torch.cuda.synchronize()
            n_diff = int((got != want).sum())
            check(n_diff == 0, f"quant_epilogue({label}, {name}): {n_diff} of {got.numel()} "
                               "elements differ from the plain version")
            check(bool((got == 127).any()) and bool((got < 0).any()),
                  f"quant_epilogue({label}, {name}): the test values miss saturation or the "
                  "leaky branch")
            nbytes = acc.numel() * (4 + 1) + 3 * cout * 4
            rec = {"block": name, "shape": [m, cout], "dropout": keys is not None,
                   "bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}
            if s != 70:
                rec.update(ms=event_ms(one, 3, flush),
                           device_ms=event_ms(one, 3, flush, device=True),
                           plain_ms=event_ms(lambda: cuda_quant.quant_epilogue_plain(
                               acc, dq, bns, bnb, 30.0, keys=keys), 1, flush))
            recs.append(rec)
            del acc, got, want
        tot = {k: sum(r[k] for r in recs) for k in ("ms", "device_ms", "plain_ms", "bound_ms",
                                                   "bytes") if k in recs[0]}
        out[label] = {**tot, "launches": len(recs) if s != 70 else 2}
        emit("quant_epilogue_blocks", case=label, blocks=recs)
    main = out["epistemic_T30"]
    return {
        "name": "quant_epilogue", "route": "cuda",
        "source": "bayesian_yolov3_torch/csrc/quant_epilogue.cu",
        "replaces": "bayesian_yolov3_tpu/ops/quant.py:86 (quant_block's epilogue, which XLA "
                    "fused into the int8 conv; no pallas_call)",
        "max_abs_err": 0.0, "ms": main["ms"], "device_ms": main["device_ms"],
        "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"], "bound_by": "bytes",
        "library_ms": None, "tolerance": "bit for bit (torch.equal)",
        "device_ms_over_bound": main["device_ms"] / main["bound_ms"], "cases": out,
        "note": f"ms/device_ms/plain_ms/bound_ms: the 20 launches of one 1024x1920 image at "
                f"T={T} summed (dropout on 15); cases[batched_nb{BATCH}]: the 20 launches of "
                "one batch of 11 without dropout; no single PyTorch call computes the hash "
                "dropout, so library_ms is null",
    }


def int8_gemm(dev, flush):
    """Each int8 head block's convolution at T=30 (the epistemic path's
    stack): ``quant.conv2d_int8`` (int8 im2col + ``torch._int_mm``), its two
    parts alone, and one cuDNN bf16 ``F.conv2d`` of the same shape
    (channels_last); the first sample's int32 output equal to a float64
    product of the same operands (exact below 2^53)."""
    gen = torch.Generator(device=dev).manual_seed(8)
    rows = []
    for name, h, w, k, cin, cout, _ in INT8_BLOCKS:
        x_q = torch.randint(-127, 128, (T, h, w, cin), generator=gen, device=dev,
                            dtype=torch.int8)
        w_q = torch.randint(-127, 128, (cout, cin, k, k), generator=gen, device=dev,
                            dtype=torch.int8)
        got = quant.conv2d_int8(x_q, w_q)
        cols = quant._im2col(x_q[:1], k).double()
        want = cols @ w_q.permute(0, 2, 3, 1).reshape(cout, -1).double().t()
        check(torch.equal(got[:1].reshape(-1, cout).double(), want),
              f"int8_gemm {name}: conv2d_int8 differs from the float64 product")
        del cols, want, got
        cols = quant._im2col(x_q, k)
        wmat = w_q.permute(0, 2, 3, 1).reshape(cout, -1)
        xb = x_q.to(torch.bfloat16).permute(0, 3, 1, 2)  # channels_last view
        wb = w_q.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
        ops = 2 * T * h * w * k * k * cin * cout
        rows.append({
            "block": name, "M": T * h * w, "K": k * k * cin, "N": cout,
            "int8_ms": event_ms(lambda: quant.conv2d_int8(x_q, w_q), 3, flush),
            "im2col_ms": event_ms(lambda: quant._im2col(x_q, k), 2, flush),
            "int_mm_ms": event_ms(lambda: torch._int_mm(cols, wmat.t()), 2, flush),
            "cudnn_bf16_ms": event_ms(lambda: torch.nn.functional.conv2d(
                xb, wb, padding=k // 2), 3, flush),
            "int8_bound_ms": ops / INT8_OPS * 1e3, "bf16_bound_ms": ops / BF16_FLOPS * 1e3})
        del x_q, w_q, cols, xb, wb
    tot = {k: sum(r[k] for r in rows) for k in rows[0] if k.endswith("_ms")}
    return {"T": T, "blocks": rows, "total": tot,
            "int8_over_cudnn_bf16": tot["int8_ms"] / tot["cudnn_bf16_ms"],
            "note": "each block's convolution over the T=30 stack of one 1024x1920 image; "
                    "ms: median of 3 CUDA-event readings after an L2 flush (the two parts "
                    "alone: of 2); int8 = im2col "
                    "+ _int_mm; the bounds at the dense int8 (1979 TOPS) and bf16 "
                    "(989 TFLOP/s) peaks"}


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


def write_records(path, frames, filters=(0,)):
    """The frames as PNG (rows stored with ``filters``, cycled) in one tfrecord."""
    os.makedirs(path, exist_ok=True)
    with tfrecord.TFRecordWriter(os.path.join(path, "smoke-00000-of-00001.tfrecord")) as wr:
        for i, img in enumerate(frames):
            wr.write(proto.encode_example({
                "image/encoded": [pipeline.encode_png(img, level=1, filters=filters)],
                "image/filename": [f"frame_{i:04d}.png".encode()],
            }))
    return os.path.join(path, "smoke-*-of-*.tfrecord")


def write_dataset(path, rng, n, hw):
    frames = [seeded_frame(rng, hw) for _ in range(n)]
    return write_records(path, frames), frames


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


MC_KERNELS = ("epistemic_moments", "epistemic_finalize")  # the mc path's own


@contextlib.contextmanager
def count_collectives():
    """The ``Group`` collectives called inside, by method: (bytes, host
    seconds) of each call — the tensor all-reduced, a rank's part
    all-gathered, the edge rows a rank offers to the halo exchange — timed
    from a drained device to a drained device.  A call made inside another
    (the halo exchange's all-gather) is part of that one."""
    calls = {"all_reduce": [], "all_gather": [], "exchange_edges": []}
    origs = {name: getattr(Group, name) for name in calls}
    inside = []

    def counting(name):
        def counted(self, *tensors, **kw):
            if inside:
                return origs[name](self, *tensors, **kw)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            inside.append(name)
            try:
                out = origs[name](self, *tensors, **kw)
                torch.cuda.synchronize()
            finally:
                inside.pop()
            calls[name].append((sum(t.numel() * t.element_size() for t in tensors
                                    if isinstance(t, torch.Tensor)),
                                time.perf_counter() - t0))
            return out
        return counted

    for name in calls:
        setattr(Group, name, counting(name))
    try:
        yield calls
    finally:
        for name, fn in origs.items():
            setattr(Group, name, fn)


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
    others = ("box_decode", "quant_epilogue", *MC_KERNELS)  # of the other paths
    check(not any(launches[k] for k in others),
          f"the single-device epistemic main path ran one of {others}: {launches}")
    check(all(n > 0 for k, n in launches.items() if k not in others),
          f"the bf16 main path launched no kernel of: "
          f"{[k for k, n in launches.items() if not n and k not in others]}")
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
# the mc-sharded epistemic path
# --------------------------------------------------------------------------

# the split form (moments summed over shards, then finalized) against the
# one-shot decode: the JAX package's own tolerances for that comparison
# (tests/test_pallas.py:151-153) — the same expressions, the sums reordered
SPLIT_TOL = (((0, 12), 1e-4, 1e-5), ((12, 13), 1e-3, 1e-6), ((13, 21 + C), 1e-4, 2e-4))
MC_MASKS = 7  # fixed_mc_masks seed of the mc phases
MC_RANKS = 2
RANKS_TIMEOUT_S = 300  # a rank that hangs fails its phase at this join timeout


def split_agree(name, got, want):
    check(got.shape == want.shape, f"{name}: shapes {tuple(got.shape)} {tuple(want.shape)}")
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite rows")
    check(torch.equal(got[..., 21:], want[..., 21:]), f"{name}: layer / prior ids differ")
    worst = 0.0
    for (lo, hi), rtol, atol in SPLIT_TOL:
        ratio = _err_over_tol(got[..., lo:hi], want[..., lo:hi], rtol, atol)
        check(ratio <= 1.0, f"{name}: columns {lo}:{hi} beyond rtol {rtol} / atol {atol}: "
                            f"max abs {float((got[..., lo:hi] - want[..., lo:hi]).abs().max())}")
        worst = max(worst, ratio)
    return {"max_abs_err": float((got - want).abs().max()), "max_err_over_tolerance": worst,
            "bit_identical": bool(torch.equal(got, want))}


def packed_moments(shard):
    """One shard's moments of the three scales (the three [(raw_cf, (h, w))]
    of mc_forward_cf) in one packed buffer, as the mc pipeline writes them."""
    hws = [hw for _, hw in shard]
    plan = decode.scale_plan(hws, 3)
    packed = torch.empty(plan.rows * (21 + C), device=shard[0][0].device)
    for (raw, _), view in zip(shard, decode.packed_views(packed, plan, 21 + C)):
        cuda_moments.epistemic_moments_cf(raw, cls_cnt=C, out=view)
    return packed, hws


def finalize_shards(runner, shards):
    """The decoded rows of one image (1, N_total, 21+C) from its samples split
    into shards: each shard's packed moments, summed on the card (the
    all-reduce), finalized in one launch."""
    packs = [packed_moments(sh) for sh in shards]
    return cuda_moments.epistemic_finalize_all_scales(
        sum(p for p, _ in packs), runner._priors, T=T, hws=packs[0][1], cls_cnt=C)


def split_rows(runner, params, stats, x, keys, n_shards):
    """The rows of one image as n_shards ranks compute them, on one card:
    each shard's samples through the heads on their own, then
    ``finalize_shards``."""
    per = T // n_shards
    with torch.no_grad():
        shards = [yolov3.mc_forward_cf(params, stats, x, spec=runner.spec, T=per,
                                       rng=keys[k * per:(k + 1) * per],
                                       compute_dtype=runner.model._dtype)
                  for k in range(n_shards)]
    return finalize_shards(runner, shards)


def mc_split(runner, params, stats, frame, dev):
    """The raws of one full-width frame, T=30 (the runner's compute dtype):
    for n_shards 1, 2, 3, 5 the moments of each shard summed on the card and
    finalized, against the one-shot epistemic_decode kernel on the same raws."""
    x = torch.from_numpy(frame[None]).to(dev).float() / 255.0
    keys = yolov3._fixed_key_table(MC_MASKS, T)
    with torch.no_grad():
        outs = yolov3.mc_forward_cf(params, stats, x, spec=runner.spec, T=T, rng=keys,
                                    compute_dtype=runner.model._dtype)
    want = torch.cat([cuda_epistemic.fused_epistemic_decode_cf_batched(
        raw, runner._priors[s], n_imgs=1, h=hw[0], w=hw[1], cls_cnt=C, layer_id=i)
        for i, ((raw, hw), s) in enumerate(zip(outs, (32, 16, 8)))], dim=1)
    out = {"compute_dtype": runner.config.compute_dtype, "T": T}
    for n in (1, 2, 3, 5):
        per = T // n
        shards = [[(raw[:, k * per:(k + 1) * per].contiguous(), hw) for raw, hw in outs]
                  for k in range(n)]
        got = finalize_shards(runner, shards)
        torch.cuda.synchronize()
        out[f"n_shards_{n}"] = split_agree(f"mc_split(n_shards={n})", got, want)
    # one shard adds in the one-shot decode's order (the shared sample split)
    check(out["n_shards_1"]["bit_identical"],
          "mc_split(n_shards=1): the split form is not bit-identical to the one-shot decode")
    return out


def mc_pipeline(runner, group):
    return make_mc_sharded_fused_pipeline(
        runner.model, group, T, priors_by_stride=runner._priors,
        obj_idx=runner.spec.obj_idx(epistemic=True), nms_max_boxes=MAX_OUT,
        fixed_masks=MC_MASKS)


def main_path_mc(tmp, dev, card, runners, params, stats, frames):
    """The fused mc pipeline (``make_mc_sharded_fused_pipeline``) over a
    one-rank NCCL group at 1024x1920, T=30, fixed masks, bf16 and float32:
    kernel launches of its run over the frames, its rows against the
    single-device runner's exact-NMS rows for the same frame and keys, ms per
    frame and a stage breakdown, peak device memory."""
    initialize_distributed("nccl", "file://" + os.path.join(tmp, "nccl_store"), world_size=1,
                           rank=0, device=dev)
    out, launches_bf16 = {}, None
    try:
        group = make_groups({"mc": 1})["mc"]
        for runner in runners:
            dtype = runner.config.compute_dtype
            pipe = mc_pipeline(runner, group)
            imgs = [torch.from_numpy(f[None]).to(dev).float() / 255.0 for f in frames]
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            reset_counters()
            with count_collectives() as coll:
                results = [pipe(params, stats, x) for x in imgs]
            torch.cuda.synchronize()
            launches = {**read_counters(), "all_reduce": len(coll["all_reduce"])}
            peak = torch.cuda.max_memory_allocated() / 1e9
            n = len(frames)
            bf16 = dtype == "bfloat16"
            want = {"epistemic_moments": 3 * n, "epistemic_finalize": n, "greedy_nms": n,
                    "epistemic_decode": 0, "box_decode": 0, "quant_epilogue": 0,
                    "fused_stem": n * bf16,
                    "fused_res_block": 11 * n * bf16, "fused_downsample": 2 * n * bf16,
                    "all_reduce": n}
            check(launches == want, f"main_path_mc {dtype}: launches {launches}, want {want}")
            if bf16:
                launches_bf16 = launches

            # against the single-device runner: exact NMS, the same fixed masks
            ref = InferenceRunner(make_config(tmp, "smoke", IMG, T, "", compute_dtype=dtype,
                                              fixed_mc_masks=MC_MASKS, nms_max_boxes=MAX_OUT,
                                              nms_pre_top_k=0), seed=0)
            agree = []
            for f, (rows, valid) in zip(frames, results):
                want_rows, want_valid = ref.predict(params, stats, f[None])
                check(np.array_equal(valid.cpu().numpy(), want_valid),
                      f"main_path_mc {dtype}: valid masks differ from the single-device runner's")
                agree.append(split_agree(f"main_path_mc {dtype}", rows.cpu(),
                                         torch.from_numpy(want_rows)))

            # ms per frame after the warm-up above, and the stages
            x = imgs[0]
            keys = yolov3._fixed_key_table(MC_MASKS, T)
            bb, bs = params["backbone"], stats["backbone"]
            tdt = runner.model._dtype
            st = {"ms_per_frame": event_ms(lambda: pipe(params, stats, x), 3)}
            with torch.no_grad():
                st["backbone_ms"] = event_ms(lambda: darknet.darknet53(bb, bs, x, compute_dtype=tdt), 3)
                st["backbone_heads_ms"] = event_ms(lambda: yolov3.mc_forward_cf(
                    params, stats, x, spec=runner.spec, T=T, rng=keys, compute_dtype=tdt), 3)
                st["heads_ms"] = st["backbone_heads_ms"] - st["backbone_ms"]
                outs = yolov3.mc_forward_cf(params, stats, x, spec=runner.spec, T=T, rng=keys,
                                            compute_dtype=tdt)
                st["moments_ms"] = event_ms(lambda: packed_moments(outs), 10)
                sums, hws = packed_moments(outs)
                st["all_reduce_ms"] = event_ms(lambda: group.all_reduce(sums), 10)
                st["all_reduce_bytes"] = sums.numel() * 4
                st["finalize_ms"] = event_ms(lambda: cuda_moments.epistemic_finalize_all_scales(
                    sums, runner._priors, T=T, hws=hws, cls_cnt=C), 10)
                flat = pipe.decode(params, stats, x)
                st["nms_exact_ms"] = event_ms(lambda: nms.nms_select(
                    flat, runner.spec.obj_idx(epistemic=True), MAX_OUT, 0.5, pre_top_k=0), 3)
            del outs, sums, flat
            out[dtype] = {"frames": n, "launches": launches,
                          "launches_per_frame": {k: v / n for k, v in launches.items()},
                          "peak_mem_GB": peak, "detections": [int(v.sum()) for _, v in results],
                          "vs_single_device": agree, "timing": st, "card": card}
    finally:
        dist.destroy_process_group()
    return out, launches_bf16


def _mc_rank(rank, store, cfg, res_dir, frame0_path, dev):
    """One spawned rank of ``main_path_mc_2ranks``: run() over the dataset,
    then the decoded rows of frame 0 through the fused pipeline and through
    the all-gather fallback, one fallback predict(), and timings."""
    dev = torch.device(dev)
    res = {}
    initialize_distributed("gloo", f"file://{store}", world_size=MC_RANKS, rank=rank,
                           device=dev)
    runner = InferenceRunner(cfg, seed=0, device=dev)
    writes = []
    write = runner._write_batch
    runner._write_batch = lambda *a: (writes.append(1), write(*a))
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    t0 = time.time()
    with count_collectives() as coll:
        res["out_dir"] = runner.run()
    torch.cuda.synchronize()
    res.update(run_wall_s=time.time() - t0, loop=runner.last_run,
               launches={**read_counters(), "all_reduce": len(coll["all_reduce"])},
               peak_mem_GB=torch.cuda.max_memory_allocated() / 1e9, writes=len(writes),
               retried=runner.retried)

    params, stats, _ = runner.load_state()
    img = torch.from_numpy(np.load(frame0_path)[None]).to(dev)
    keys = runner.draw_keys()  # the fixed table
    rows_fused = runner._decoded_rows(params, stats, img, keys)
    # the all-gather fallback, same frame and keys: the one-shot decode of
    # the gathered samples against the fused split form of the same samples
    fb = InferenceRunner(dataclasses.replace(cfg, use_pallas=False, fixed_mc_masks=None),
                         seed=0, device=dev)
    reset_counters()
    rows_fb = fb._decoded_rows(params, stats, img, keys)
    rows, valid = fb.predict(params, stats, np.load(frame0_path)[None])  # drawn keys
    torch.cuda.synchronize()
    res["fallback"] = {"launches": read_counters(), "detections": int(valid.sum()),
                       "retried": fb.retried, "finite": bool(np.isfinite(rows).all()),
                       "vs_fused": split_agree(f"rank {rank}: fallback against fused",
                                               rows_fb, rows_fused)}
    torch.save(rows_fused.cpu(), os.path.join(res_dir, f"rows{rank}.pt"))

    # ms per frame of the device program (both ranks in step), the gloo
    # all-reduce of one frame's sums on the host clock
    def one():
        return runner._launch(params, stats, img, keys)()

    one()
    torch.cuda.synchronize()
    res["ms_per_frame"] = event_ms(one, 3)
    with torch.no_grad():
        outs = yolov3.mc_forward_cf(params, stats, img.float() / 255.0, spec=runner.spec,
                                    T=cfg.T // MC_RANKS,
                                    rng=local_rows(keys, rank, MC_RANKS),
                                    compute_dtype=runner.model._dtype)
    sums, _ = packed_moments(outs)
    res["all_reduce_wall_ms"] = wall_ms(lambda: runner.group.all_reduce(sums), 3)
    res["all_reduce_bytes"] = sums.numel() * 4
    return res


def _rank_entry(target, rank, res_dir, args):
    """A spawned rank: ``target(rank, *args)``'s result (or its traceback)
    into ``res_dir/rank<r>.json``; the process group destroyed at the end."""
    res = {"rank": rank}
    try:
        res.update(target(rank, *args))
    except BaseException:
        res["error"] = traceback.format_exc()
        raise
    finally:
        with open(os.path.join(res_dir, f"rank{rank}.json"), "w") as f:
            json.dump(res, f)
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_ranks(target, n, res_dir, *args):
    """``target(rank, *args)`` on ``n`` spawned processes, joined under
    RANKS_TIMEOUT_S; a rank still running then is killed and fails the
    phase.  Returns the ranks' results and the phase's wall seconds."""
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_entry, args=(target, r, res_dir, args)) for r in range(n)]
    t0 = time.time()
    for p in procs:
        p.start()
    for p in procs:
        p.join(max(0.0, t0 + RANKS_TIMEOUT_S - time.time()))
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join()
    ranks = []
    for r in range(n):
        path = os.path.join(res_dir, f"rank{r}.json")
        ranks.append(json.load(open(path)) if os.path.exists(path) else {"error": "no result"})
    errors = [r.get("error") for r in ranks if r.get("error")]
    check(not hung, f"{len(hung)} rank(s) still running after {RANKS_TIMEOUT_S} s: {errors}")
    check([p.exitcode for p in procs] == [0] * n, f"a rank failed: {errors}")
    return ranks, time.time() - t0


def _host_s(fn):
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def wall_ms(fn, reps):
    """Median host-clock time of ``fn`` in ms, the device drained before and
    after each reading (for collectives that block the host, as gloo's do)."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def _dets_close(name, got, want):
    """ECP detections of one frame, in NMS order, at the split tolerances
    carried to JSON units (pixels for the corners)."""
    check(len(got) == len(want) > 0, f"{name}: {len(got)} detections, want {len(want)}")
    worst = 0.0
    for g, w in zip(got, want):
        check(g["identity"] == w["identity"] and g["layer_id"] == w["layer_id"]
              and g["prior_id"] == w["prior_id"], f"{name}: another detection picked")
        for k, v in w.items():
            if k in ("identity", "layer_id", "prior_id"):
                continue
            gv, wv = np.asarray(g[k], np.float64), np.asarray(v, np.float64)
            atol = 1e-5 * max(IMG[:2]) if k in ("x0", "y0", "x1", "y1") else 2e-4
            rtol = 1e-3 if k == "total_var_epi" else 1e-4
            ratio = float((np.abs(gv - wv) / (atol + rtol * np.abs(wv))).max())
            check(ratio <= 1.0, f"{name}: {k} {g[k]} against {v}")
            worst = max(worst, ratio)
    return worst


def _dets_paired(name, got, want):
    """ECP detections of one frame from two runs whose rows differ in the
    last bits (sums in another order): each of ``got`` paired with the
    detection of ``want`` at the same anchor (layer, prior, corners within
    the split tolerance in pixels), the other fields held to the split
    tolerances.  Returns the share of ``got`` that pairs up; a near-tie may
    swap two picks of NMS, so not every detection need pair."""
    keys = ("y0", "x0", "y1", "x1")
    wid = np.array([[d["layer_id"], d["prior_id"]] for d in want])
    wbox = np.array([[d[k] for k in keys] for d in want])
    tol = 1e-5 * max(IMG[:2])
    paired = 0
    for g in got:
        same = np.flatnonzero((wid[:, 0] == g["layer_id"]) & (wid[:, 1] == g["prior_id"]))
        if not len(same):
            continue
        d = np.abs(wbox[same] - np.array([g[k] for k in keys])).max(axis=1)
        if d.min() <= tol + 1e-4 * np.abs(wbox[same[d.argmin()]]).max():
            _dets_close(name, [g], [want[same[d.argmin()]]])
            paired += 1
    return paired / max(len(got), 1)


def main_path_mc_2ranks(tmp, dev, card, runner, params, stats):
    """Two spawned ranks on the one card over gloo (NCCL refuses two ranks
    on one device), each running InferenceRunner(mesh_shape={'mc': 2}).run()
    over 2 frames at 1024x1920, T=30, bf16, fixed masks.  Rank 0 writes the
    JSON, rank 1 none.  Rank 0's JSON against the same split computed on one
    card in this process (the same samples per shard: the split tolerance,
    detection by detection), and against the one-rank run (T=30 in one
    batch: detections paired by anchor at the split tolerance, frame 0's
    decoded rows at the bf16 jitter bound); the all-gather fallback on one
    frame."""
    pattern, frames = write_dataset(os.path.join(tmp, "data_mc"), np.random.default_rng(17),
                                    2, IMG[:2])
    cfg = make_config(tmp, "smoke", IMG, T, pattern, fixed_mc_masks=MC_MASKS,
                      mesh_shape={"mc": MC_RANKS}, nms_max_boxes=MAX_OUT,
                      out_path=os.path.join(tmp, "out", "smoke_mc2"))
    res_dir = os.path.join(tmp, "mc_ranks")
    os.makedirs(res_dir)
    frame0 = os.path.join(res_dir, "frame0.npy")
    np.save(frame0, frames[0])
    ranks, wall = spawn_ranks(_mc_rank, MC_RANKS, res_dir, os.path.join(res_dir, "store"), cfg,
                              res_dir, frame0, str(dev))

    r0, r1 = ranks
    check(r0["out_dir"] == r1["out_dir"], "the ranks returned different output directories")
    check(r0["writes"] == 2 and r1["writes"] == 0, f"writes: rank 0 {r0['writes']}, "
                                                   f"rank 1 {r1['writes']}")
    for r in ranks:
        want = {"epistemic_moments": 6, "epistemic_finalize": 2, "greedy_nms": 2,
                "epistemic_decode": 0, "box_decode": 0, "quant_epilogue": 0, "fused_stem": 2,
                "fused_res_block": 22,
                "fused_downsample": 4, "all_reduce": 2}
        check(r["launches"] == want, f"rank {r['rank']}: launches {r['launches']}, want {want}")
        check(r["retried"] == 0, "the fused mc path retried NMS")
        fb = r["fallback"]["launches"]  # the fallback all-gathers: no all-reduce
        check(fb["epistemic_decode"] == 6 and fb["greedy_nms"] >= 1
              and fb["epistemic_moments"] == 0 and r["fallback"]["finite"]
              and r["fallback"]["detections"] > 0, f"rank {r['rank']} fallback: {r['fallback']}")
    got = {os.path.basename(f): json.load(open(f))["children"]
           for f in sorted(glob.glob(os.path.join(r0["out_dir"], "*.json")))}
    check(sorted(got) == ["frame_0000.json", "frame_0001.json"], f"JSON files {sorted(got)}")

    # the same split on this card, frame by frame -> ECP detections
    keys = yolov3._fixed_key_table(MC_MASKS, T)
    obj = runner.spec.obj_idx(epistemic=True)
    json_worst = 0.0
    for i, f in enumerate(frames):
        x = torch.from_numpy(f[None]).to(dev).float() / 255.0
        flat = split_rows(runner, params, stats, x, keys, MC_RANKS)
        rows, valid, _ = nms.nms_select(flat[0], obj, MAX_OUT, 0.5, pre_top_k=0)
        rows, valid = rows.cpu().numpy(), valid.cpu().numpy()
        want = [bbox_to_ecp_format(rows[k], IMG, runner.spec, epistemic=True)
                for k in np.flatnonzero(valid)]
        json_worst = max(json_worst, _dets_close(f"rank 0 frame {i}", got[f"frame_{i:04d}.json"],
                                                 json.loads(json.dumps(want))))
    # against the one-rank run (main_path_mc's pipeline, all 30 samples in one
    # batch): rank 0's JSON paired detection by detection, and frame 0's
    # decoded rows anchor by anchor (bf16 jitter bound)
    initialize_distributed("nccl", "file://" + os.path.join(res_dir, "nccl_store"),
                           world_size=1, rank=0, device=dev)
    try:
        pipe = mc_pipeline(runner, make_groups({"mc": 1})["mc"])
        paired = []
        for i, f in enumerate(frames):
            x = torch.from_numpy(f[None]).to(dev).float() / 255.0
            rows, valid = (a[0].cpu().numpy() for a in pipe(params, stats, x))
            want = json.loads(json.dumps([bbox_to_ecp_format(rows[k], IMG, runner.spec,
                                                             epistemic=True)
                                          for k in np.flatnonzero(valid)]))
            paired.append(_dets_paired(f"rank 0 frame {i} against one rank",
                                       got[f"frame_{i:04d}.json"], want))
            if i == 0:
                one_rank = pipe.decode(params, stats, x)
    finally:
        dist.destroy_process_group()
    check(min(paired) >= 0.99, f"rank 0's detections paired with the one-rank run's: {paired}")
    rows0 = torch.load(os.path.join(res_dir, "rows0.pt"))
    check(torch.equal(rows0, torch.load(os.path.join(res_dir, "rows1.pt"))),
          "the two ranks decoded different rows")
    vs_one_rank = rows_agree_bf16("2 ranks against 1 rank", rows0, one_rank[None].cpu())
    return {"ranks": MC_RANKS, "backend": "gloo", "frames": 2, "phase_wall_s": wall,
            "json_vs_same_split_max_err_over_tolerance": json_worst,
            "json_vs_one_rank_paired_share": paired,
            "rows_vs_one_rank": vs_one_rank, "per_rank": ranks, "card": card}


# --------------------------------------------------------------------------
# the batched standard / aleatoric path
# --------------------------------------------------------------------------


def make_batched_config(tmp, name, model, pattern, **kw):
    """Batched inference as cli/inference_{standard_yolov3,aleatoric}.py set
    it up: batch 11, ECP priors, full images; bf16 unless ``kw`` says."""
    return Config(
        model=model, inference_mode=False, full_img_size=IMG, cls_cnt=C,
        checkpoint_path=os.path.join(tmp, "ckpt"), run_id=name, cpu_thread_cnt=6,
        data=DataConfig(file_pattern=pattern), nms_max_boxes=MAX_OUT,
        nms_pre_top_k=PRE_TOP_K,
        **{"out_path": os.path.join(tmp, "out", name), "batch_size": BATCH, **kw},
    )


def check_batched_launches(name, launches, n_batches, bf16):
    """1 box-decode launch per batch (the three scales in one), no epistemic
    decode, NMS, and the fused conv kernels 1 / 11 / 2 times per batch in
    bf16, never in float32."""
    check(not any(launches[k] for k in MC_KERNELS), f"{name}: an mc kernel ran")
    check(launches["box_decode"] == n_batches,
          f"{name}: {launches['box_decode']} box_decode launches for {n_batches} batches")
    check(launches["epistemic_decode"] == 0, f"{name}: the epistemic decode ran")
    check(launches["quant_epilogue"] == 0, f"{name}: the int8 epilogue ran")
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
    check(launches_d["box_decode"] == 1 and launches_d["greedy_nms"] >= 1,
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
            outs, runner._priors, spec=spec), 10)
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

    # the PNG decoder alone, one thread, one frame: rows stored with filter 0
    # (what encode_png writes by default) and with filters 1-4 in turn, Paeth
    # and Average included (what libpng's adaptive filtering writes)
    encoded = {label: pipeline.encode_png(frames[0], level=1, filters=filters)
               for label, filters in (("filter0", (0,)), ("filters1to4", (1, 2, 3, 4)),
                                      ("paeth", (4,)))}
    for label, data in encoded.items():
        check(np.array_equal(pipeline.decode_png(data), frames[0]), f"PNG {label}: decode")
    times = {label: [] for label in encoded}
    for _ in range(9):  # rounds of the three, so drifting host load hits all alike
        for label, data in encoded.items():
            times[label].append(_host_s(lambda: pipeline.decode_png(data)))
    png = {f"decode_ms_{label}": 1e3 * min(t) for label, t in times.items()}
    png["decode_ratio_filters1to4"] = png["decode_ms_filters1to4"] / png["decode_ms_filter0"]
    png["decode_ratio_paeth"] = png["decode_ms_paeth"] / png["decode_ms_filter0"]

    # run() end to end (warm: kernels built, allocator cache filled), then the
    # loader alone over the same records with the same threads, and over the
    # same frames stored with filters 1-4
    out_dir = runner.run(out_path=os.path.join(os.path.dirname(cfg.out_path), "timing_"
                                               + os.path.basename(cfg.out_path)))
    check(len(glob.glob(os.path.join(out_dir, "*.json"))) == N_BATCHED_FRAMES,
          "timing run(): JSON files missing")
    run_loop = dict(runner.last_run)
    t0 = time.time()
    n = sum(b["image"].shape[0] for b in pipeline.TestLoader(cfg, batch_size=BATCH).batches())
    loader_s = time.time() - t0
    check(n == N_BATCHED_FRAMES, f"loader yielded {n} frames")
    filtered = os.path.join(os.path.dirname(cfg.out_path), "data_filters1to4")
    pattern = write_records(filtered, frames, filters=(1, 2, 3, 4))
    cfg_f = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, file_pattern=pattern))
    t0 = time.time()
    n_f = sum(b["image"].shape[0] for b in pipeline.TestLoader(cfg_f, batch_size=BATCH).batches())
    loader_f_s = time.time() - t0
    check(n_f == N_BATCHED_FRAMES, f"loader yielded {n_f} filtered frames")
    ms_per_batch = sum(batch_ms) / len(batch_ms)
    return {"path": f"batched {cfg.model}", "compute_dtype": cfg.compute_dtype,
            "batch_size": BATCH, "img_per_s": BATCH / (ms_per_batch / 1e3),
            "ms_per_img": ms_per_batch / BATCH, "ms_each_batch": batch_ms,
            "exact_retries": retries, **stage,
            "run_img_per_s": run_loop["images"] / run_loop["seconds"], "run_loop": run_loop,
            "loader_ms_per_frame": loader_s * 1e3 / n, "loader_threads": cfg.cpu_thread_cnt,
            "loader_ms_per_frame_filters1to4": loader_f_s * 1e3 / n_f,
            "png_decoder": pipeline.png_decoder_name(), **png,
            "writer_ms_per_frame": writer_ms,
            "card": card}


# --------------------------------------------------------------------------
# the int8 head section on the three paths
# --------------------------------------------------------------------------

INT8_RAW_TOL = 0.10  # max |int8 - bf16| / max |bf16| per scale (the JAX package's bound)
INT8_CALIB = 2  # quant_calib_images of the int8 runs


def _int8_raws_vs_bf16(name, outs_q, outs_b):
    """int8 raws against the bf16 raws of the same keys: the JAX package's
    bound (tests/test_quant.py:67), per scale."""
    errs, corrs = [], []
    for (q, _), (b, _) in zip(outs_q, outs_b):
        q, b = q.double().flatten(), b.double().flatten()
        errs.append(float((q - b).abs().max() / b.abs().max()))
        corrs.append(float(torch.corrcoef(torch.stack([q, b]))[0, 1]))
    check(all(e < INT8_RAW_TOL for e in errs) and all(math.isfinite(c) for c in corrs),
          f"{name}: int8 raws against bf16: max error over scale {errs} (bound {INT8_RAW_TOL})")
    return {"max_err_over_scale": errs, "corr": corrs}


def _alternate_ms(fns, inputs, imgs_per_input, reps=1):
    """ms per image of each device program in ``fns`` ({label: fn(input)}),
    read in turns a, b, b, a (``reps`` rounds): each reading one pass over
    ``inputs`` after a warm-up, CUDA events; the median per label."""
    for fn in fns.values():
        fn(inputs[0])
    torch.cuda.synchronize()
    order = list(fns) + list(fns)[::-1]
    readings = {k: [] for k in fns}
    for _ in range(reps):
        for label in order:
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            for inp in inputs:
                fns[label](inp)
            end.record()
            torch.cuda.synchronize()
            readings[label].append(start.elapsed_time(end) / (len(inputs) * imgs_per_input))
    return {k: {"ms_per_img": float(np.median(v)), "readings": v} for k, v in readings.items()}


def _peak_gb(fn):
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() / 1e9


def main_path_int8(tmp, dev, card, runner, params, stats, frames):
    """Epistemic inference with the int8 head section at full width —
    bayesian, 1024x1920, T=30, bf16 backbone, fixed masks — through
    InferenceRunner.run() over the main path's 3 frames, calibrating itself
    on the first 2 (launch counters from just before run() to just after);
    its raws against the bf16 raws of the same keys; then the fused mc
    pipeline in int8 over a one-rank NCCL group against the single-device
    int8 rows (exact NMS); ms per image of int8 beside bf16 read in turns,
    the head section of each, and peak memory of one frame."""
    pattern = os.path.join(tmp, "data", "smoke-*-of-*.tfrecord")
    n = len(frames)
    kw = dict(nms_max_boxes=MAX_OUT, fixed_mc_masks=MC_MASKS)
    cfg = make_config(tmp, "smoke", IMG, T, pattern, quantize="int8",
                      quant_calib_images=INT8_CALIB, nms_pre_top_k=PRE_TOP_K,
                      out_path=os.path.join(tmp, "out", "smoke_int8"), **kw)
    q = InferenceRunner(cfg, seed=0)
    _, launches, summary = run_and_check(q, n)
    check(q._qheads is not None, "run() did not calibrate the int8 heads")
    want = {"quant_epilogue": 20 * n, "epistemic_decode": 3 * n, "box_decode": 0,
            "epistemic_moments": 0, "epistemic_finalize": 0,
            # the calibration's bf16 passes run the backbone too
            "fused_stem": n + INT8_CALIB, "fused_res_block": 11 * (n + INT8_CALIB),
            "fused_downsample": 2 * (n + INT8_CALIB)}
    check(all(launches[k] == v for k, v in want.items()) and launches["greedy_nms"] >= n,
          f"main_path_int8: launches {launches}, want {want} and greedy_nms >= {n}")
    qh = q._qheads

    imgs = [torch.from_numpy(f[None]).to(dev) for f in frames]
    x = imgs[0].float() / 255.0
    keys = q.draw_keys()
    spec = q.spec
    bf = torch.bfloat16
    with torch.no_grad():
        outs_q = mquant.mc_forward_cf_q(qh, params, stats, x, spec=spec, T=T, rng=keys,
                                        compute_dtype=bf)
        outs_b = yolov3.mc_forward_cf(params, stats, x, spec=spec, T=T, rng=keys,
                                      compute_dtype=bf)
        summary["raws_vs_bf16"] = _int8_raws_vs_bf16("epistemic int8", outs_q, outs_b)
        del outs_q, outs_b

        def program(r):  # what predict() does, without the copies to the host
            return lambda img: r._select_certified(r._decoded_rows(params, stats, img, keys))

        bf16_runner = InferenceRunner(dataclasses.replace(cfg, quantize=None), seed=0)
        summary["ms_per_img"] = _alternate_ms({"bfloat16": program(bf16_runner),
                                               "int8": program(q)}, imgs, 1)
        bb, bs = params["backbone"], stats["backbone"]
        st = {"backbone_ms": event_ms(lambda: darknet.darknet53(bb, bs, x, compute_dtype=bf), 3),
              "forward_cf_q_ms": event_ms(lambda: mquant.mc_forward_cf_q(
                  qh, params, stats, x, spec=spec, T=T, rng=keys, compute_dtype=bf), 3),
              "forward_cf_bf16_ms": event_ms(lambda: yolov3.mc_forward_cf(
                  params, stats, x, spec=spec, T=T, rng=keys, compute_dtype=bf), 3)}
        st["heads_int8_ms"] = st["forward_cf_q_ms"] - st["backbone_ms"]
        st["heads_bf16_ms"] = st["forward_cf_bf16_ms"] - st["backbone_ms"]
        summary["stages"] = st
        summary["peak_mem_GB_one_frame"] = {
            "int8": _peak_gb(lambda: program(q)(imgs[0])),
            "bfloat16": _peak_gb(lambda: program(bf16_runner)(imgs[0]))}
    summary["mc_one_rank_nccl"] = _mc_int8(tmp, dev, cfg, q, params, stats, imgs)
    return q, launches, {"frames": n, "card": card, **summary}


def _mc_int8(tmp, dev, cfg, q, params, stats, imgs):
    """The fused mc pipeline with the int8 heads over a one-rank NCCL group:
    launches and all-reduces per frame, its rows against the single-device
    int8 runner's exact-NMS rows (SPLIT_TOL), ms per frame."""
    initialize_distributed("nccl", "file://" + os.path.join(tmp, "nccl_store_int8"),
                           world_size=1, rank=0, device=dev)
    try:
        pipe = mc_pipeline(q, make_groups({"mc": 1})["mc"])
        xs = [img.float() / 255.0 for img in imgs]
        n = len(xs)
        torch.cuda.synchronize()
        reset_counters()
        with count_collectives() as coll:
            results = [pipe(params, stats, x, qheads=q._qheads) for x in xs]
        torch.cuda.synchronize()
        launches = {**read_counters(), "all_reduce": len(coll["all_reduce"])}
        want = {"quant_epilogue": 20 * n, "epistemic_moments": 3 * n, "epistemic_finalize": n,
                "greedy_nms": n, "epistemic_decode": 0, "all_reduce": n}
        check(all(launches[k] == v for k, v in want.items()),
              f"mc int8: launches {launches}, want {want}")
        ref = InferenceRunner(dataclasses.replace(cfg, nms_pre_top_k=0), seed=0)
        ref._qheads = q._qheads
        agree = []
        for img, (rows, valid) in zip(imgs, results):
            want_rows, want_valid = ref.predict(params, stats, img.cpu().numpy())
            check(np.array_equal(valid.cpu().numpy(), want_valid),
                  "mc int8: valid masks differ from the single-device int8 runner's")
            agree.append(split_agree("mc int8", rows.cpu(), torch.from_numpy(want_rows)))
        ms = event_ms(lambda: pipe(params, stats, xs[0], qheads=q._qheads), 3)
        peak = _peak_gb(lambda: pipe(params, stats, xs[0], qheads=q._qheads))
    finally:
        dist.destroy_process_group()
    return {"launches_per_frame": {k: v / n for k, v in launches.items()},
            "vs_single_device": agree, "ms_per_frame": ms, "peak_mem_GB_one_frame": peak}


def main_path_batched_int8(tmp, dev, card, b_runner, b_frames):
    """Batched aleatoric and standard inference with the int8 head section,
    1024x1920, batch 11, through run() over the batched path's 13 frames
    (calibrating on the first 2); aleatoric int8 raws against bf16; ms per
    image of the device program, int8 beside bf16 in turns, the head
    section of each, and peak memory of one batch."""
    pattern = os.path.join(tmp, "data_batched", "smoke-*-of-*.tfrecord")
    n_batches = -(-N_BATCHED_FRAMES // BATCH)
    out, runners = {}, {}
    for model, run_id in (("aleatoric", "ale"), ("standard", "std")):
        cfg = make_batched_config(tmp, run_id, model, pattern, quantize="int8",
                                  quant_calib_images=INT8_CALIB,
                                  out_path=os.path.join(tmp, "out", f"{run_id}_int8"))
        r = runners[model] = InferenceRunner(cfg, seed=0)
        _, launches, out[model] = run_and_check(r, N_BATCHED_FRAMES)
        calib = INT8_CALIB  # one bf16 forward per calibration image
        want = {"quant_epilogue": 20 * n_batches, "box_decode": n_batches,
                "epistemic_decode": 0, "epistemic_moments": 0,
                "fused_stem": n_batches + calib, "fused_res_block": 11 * (n_batches + calib),
                "fused_downsample": 2 * (n_batches + calib)}
        check(all(launches[k] == v for k, v in want.items()) and launches["greedy_nms"] > 0,
              f"batched {model} int8: launches {launches}, want {want}")
    r = runners["aleatoric"]
    params, stats, _ = r.load_state()
    x_u8 = torch.from_numpy(np.stack(b_frames[:BATCH])).to(dev)
    x = x_u8.float() / 255.0
    bf = torch.bfloat16
    with torch.no_grad():
        # on the calibration frames, as the JAX package's batched test holds it
        xc = x[:INT8_CALIB]
        outs_q = mquant.forward_cf_q(r._qheads, params, stats, xc, spec=r.spec,
                                     compute_dtype=bf)
        outs_b = yolov3.forward_cf(params, stats, xc, spec=r.spec, compute_dtype=bf)
        out["aleatoric"]["raws_vs_bf16"] = _int8_raws_vs_bf16("batched int8", outs_q, outs_b)
        del outs_q, outs_b

        def program(runner):  # what predict() does, without the copies to the host
            return lambda img: runner._select_certified(
                runner._decoded_rows(params, stats, img, None))

        fns = {"bfloat16": program(b_runner), "int8": program(r)}
        out["ms_per_img"] = _alternate_ms(fns, [x_u8, x_u8], BATCH)
        bb, bs = params["backbone"], stats["backbone"]
        st = {"backbone_ms": event_ms(lambda: darknet.darknet53(bb, bs, x, compute_dtype=bf), 3),
              "forward_cf_q_ms": event_ms(lambda: mquant.forward_cf_q(
                  r._qheads, params, stats, x, spec=r.spec, compute_dtype=bf), 3),
              "forward_cf_bf16_ms": event_ms(lambda: yolov3.forward_cf(
                  params, stats, x, spec=r.spec, compute_dtype=bf), 3)}
        st["heads_int8_ms"] = st["forward_cf_q_ms"] - st["backbone_ms"]
        st["heads_bf16_ms"] = st["forward_cf_bf16_ms"] - st["backbone_ms"]
        out["stages_per_batch"] = st
        out["peak_mem_GB_one_batch"] = {k: _peak_gb(lambda: fn(x_u8)) for k, fn in fns.items()}
    return {"frames": N_BATCHED_FRAMES, "batch_size": BATCH, "card": card, **out}


# --------------------------------------------------------------------------
# the dp and sp axes: ranks spawned on the one card, over gloo
# --------------------------------------------------------------------------


DP_RANKS = 2
DP_BATCH = DP_RANKS * BATCH  # 11 images per rank, the batched CLIs' batch
SP_MC = {"sp": 2, "mc": 2}


def _first_batch(cfg, n, dev=None):
    """The dataset's first ``n`` frames as run() batches them (the last one
    repeated to fill the batch), uint8 on ``dev`` (None: a host array)."""
    images = next(pipeline.TestLoader(cfg, batch_size=n).batches())["image"]
    pad = np.repeat(images[-1:], n - len(images), axis=0)
    images = np.concatenate([images, pad])
    return images if dev is None else torch.from_numpy(images).to(dev)


def _counted_run(runner):
    """run() with the launch counters, the collectives and the peak memory
    read from just before to just after; the batches each rank wrote."""
    writes = []
    write = runner._write_batch
    runner._write_batch = lambda *a: (writes.append(1), write(*a))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    t0 = time.time()
    with count_collectives() as coll:
        out_dir = runner.run()
    torch.cuda.synchronize()
    return out_dir, coll, {
        "run_wall_s": time.time() - t0, "loop": runner.last_run, "launches": read_counters(),
        "peak_mem_GB": torch.cuda.max_memory_allocated() / 1e9, "writes": len(writes),
        "retried": runner.retried}


def _dp_rank(rank, store, cfgs, res_dir, dev):
    """One rank of ``main_path_dp``: run() of each configuration over the
    batched frames (one batch of 22, 11 per rank), then the rank's share of
    that batch (exact NMS, saved for the parent), the whole batch's rows as
    ``_launch`` gathers them (rank 0 saves them), ms per image of the rank's
    device program and the gather of its rows."""
    dev = torch.device(dev)
    initialize_distributed("gloo", f"file://{store}", world_size=DP_RANKS, rank=rank, device=dev)
    out = {}
    for name, cfg in cfgs.items():
        runner = InferenceRunner(cfg, seed=0, device=dev)
        out_dir, coll, res = _counted_run(runner)
        res.update(out_dir=out_dir, all_gathers=len(coll["all_gather"]))
        params, stats, _ = runner.load_state()
        batch = _first_batch(cfg, DP_BATCH)
        x = runner._to_device(batch).float() / 255.0

        def local():
            return runner._dp.local(params, stats, x, None, runner._qheads)

        rows, valid = local()
        torch.save({"rows": rows.cpu(), "valid": valid.cpu()},
                    os.path.join(res_dir, f"{name}_rows{rank}.pt"))

        def launch():  # the host batch's share copied, converted, computed and gathered
            return runner._launch(params, stats, runner._to_device(batch), None)()

        whole, whole_valid, _ = launch()
        if rank == 0:
            torch.save({"rows": whole.cpu(), "valid": whole_valid.cpu()},
                        os.path.join(res_dir, f"{name}_gathered.pt"))
        del whole, whole_valid
        res["ms_per_img"] = event_ms(local, 3) / BATCH
        res["launch_wall_ms_per_img"] = wall_ms(launch, 3) / BATCH
        res["peak_mem_GB_one_batch"] = _peak_gb(launch)
        res["gather_wall_ms"] = wall_ms(lambda: (runner.group.all_gather(rows),
                                                 runner.group.all_gather(valid)), 3)
        res["gather_bytes_per_rank"] = rows.numel() * 4 + valid.numel()
        out[name] = res
    return out


def _rows_paired(name, got, want, spec):
    """Rows of a batch (a dp rank's images, say) against the single-device runner's:
    bit-equal, or else the detections of each image paired by anchor
    (``_dets_paired``) on at least 99 %."""
    if torch.equal(got["rows"], want[0].cpu()) and torch.equal(got["valid"], want[1].cpu()):
        return {"bit_equal": True}
    paired = []
    for b in range(got["rows"].shape[0]):
        dets = [[bbox_to_ecp_format(rows[b, k].numpy(), IMG, spec, epistemic=False)
                 for k in np.flatnonzero(valid[b].numpy())]
                for rows, valid in ((got["rows"], got["valid"]),
                                    (want[0].cpu(), want[1].cpu()))]
        paired.append(_dets_paired(f"{name} image {b}", *json.loads(json.dumps(dets))))
    check(min(paired) >= 0.99, f"{name}: detections paired with the single device's: {paired}")
    return {"bit_equal": False, "paired_share": paired}


def main_path_dp(tmp, dev, card, b_runner):
    """Data-parallel batched aleatoric inference, ``mesh_shape={'dp': 2}``,
    two spawned ranks on the one card over gloo, batch 22 (11 a rank) at
    1024x1920, through run() over the batched path's 13 frames (one batch
    padded to 22), in bf16 and int8 (each rank calibrating on the first 2
    frames): launches per rank, rank 0 alone writing; each rank's rows of
    its 11 images against the single-device runner's (batch 11, exact NMS),
    and the rows gathered on rank 0 equal to each rank's in image order; ms
    per image per rank (the rank's program alone, and from the host batch
    through the gather), the gather, peak memory of one batch per rank."""
    pattern = os.path.join(tmp, "data_batched", "smoke-*-of-*.tfrecord")
    cfgs = {name: make_batched_config(tmp, "ale", "aleatoric", pattern, batch_size=DP_BATCH,
                                      mesh_shape={"dp": DP_RANKS},
                                      out_path=os.path.join(tmp, "out", f"ale_dp_{name}"), **kw)
            for name, kw in (("bfloat16", {}),
                             ("int8", dict(quantize="int8", quant_calib_images=INT8_CALIB)))}
    res_dir = os.path.join(tmp, "dp_ranks")
    os.makedirs(res_dir)
    ranks, wall = spawn_ranks(_dp_rank, DP_RANKS, res_dir, os.path.join(res_dir, "store"), cfgs,
                              res_dir, str(dev))
    out = {"ranks": DP_RANKS, "backend": "gloo", "batch": DP_BATCH,
           "frames": N_BATCHED_FRAMES, "phase_wall_s": wall, "card": card}
    x_u8 = _first_batch(cfgs["bfloat16"], DP_BATCH, dev)
    params, stats, _ = b_runner.load_state()
    single = {"bfloat16": b_runner}
    single["int8"] = InferenceRunner(make_batched_config(tmp, "ale", "aleatoric", pattern,
                                                         quantize="int8"), seed=0)
    single["int8"].calibrate_int8(params, stats, x_u8[:INT8_CALIB].cpu().numpy())
    for name in cfgs:
        per_rank = [r[name] for r in ranks]
        check(len({r["out_dir"] for r in per_rank}) == 1, f"dp {name}: output directories differ")
        check([r["writes"] for r in per_rank] == [1, 0], f"dp {name}: writes {per_rank}")
        files = glob.glob(os.path.join(per_rank[0]["out_dir"], "*.json"))
        check(len(files) == N_BATCHED_FRAMES, f"dp {name}: {len(files)} JSON files")
        calib = INT8_CALIB if name == "int8" else 0
        want = {"box_decode": 1, "epistemic_decode": 0, "epistemic_moments": 0,
                "epistemic_finalize": 0, "quant_epilogue": 20 if calib else 0,
                "fused_stem": 1 + calib, "fused_res_block": 11 * (1 + calib),
                "fused_downsample": 2 * (1 + calib)}
        for r in per_rank:
            got = {k: r["launches"][k] for k in want}
            check(got == want and r["launches"]["greedy_nms"] >= 1,
                  f"dp {name}: launches {r['launches']}, want {want}")
            check(r["all_gathers"] == 2, f"dp {name}: {r['all_gathers']} all-gathers a batch")
        ref = single[name]
        agree = []
        gathered = torch.load(os.path.join(res_dir, f"{name}_gathered.pt"))
        check(gathered["rows"].shape[0] == DP_BATCH,
              f"dp {name}: gathered {tuple(gathered['rows'].shape)}")
        for rank in range(DP_RANKS):
            share = x_u8[rank * BATCH:(rank + 1) * BATCH]
            want_rows = ref._select(ref._decoded_rows(params, stats, share, None), 0)[:2]
            got = torch.load(os.path.join(res_dir, f"{name}_rows{rank}.pt"))
            # the gathered batch holds each rank's rows in image order
            check(all(torch.equal(gathered[k][rank * BATCH:(rank + 1) * BATCH], got[k])
                      for k in ("rows", "valid")),
                  f"dp {name}: gathered rows {rank * BATCH}:{(rank + 1) * BATCH} are not "
                  f"rank {rank}'s")
            agree.append(_rows_paired(f"dp {name} rank {rank}", got, want_rows, ref.spec))
        out[name] = {"vs_single_device": agree, "per_rank": per_rank}
    return out


def _sp_run(rank, name, cfg, res_dir, dev):
    """run() of an sp configuration, then frame 0's decoded rows under the
    key table of a seed-0 generator (saved for the parent), ms per frame
    and peak memory of one frame."""
    runner = InferenceRunner(cfg, seed=0, device=dev)
    out_dir, coll, res = _counted_run(runner)
    n = res["loop"]["images"]
    res["out_dir"] = out_dir
    for label, method in (("halo", "exchange_edges"), ("raw_gather", "all_gather"),
                          ("all_reduce", "all_reduce")):
        calls = coll[method]
        res.update({f"{label}_per_frame": len(calls) / n,
                    f"{label}_bytes_per_frame": sum(b for b, _ in calls) / n,
                    f"{label}_wall_ms_per_frame": 1e3 * sum(t for _, t in calls) / n})
    params, stats, _ = runner.load_state()
    img = _first_batch(cfg, 1, dev)
    keys = runner.draw_keys(torch.Generator().manual_seed(0))
    torch.save(runner._decoded_rows(params, stats, img, keys).cpu(),
               os.path.join(res_dir, f"{name}_rows{rank}.pt"))
    res["ms_per_frame"] = wall_ms(lambda: runner._launch(params, stats, img, keys)(), 3)
    res["peak_mem_GB_one_frame"] = _peak_gb(lambda: runner._launch(params, stats, img, keys)())
    return res


def _sp_rank(rank, stores, cfgs, res_dir, dev):
    """One rank of ``main_path_sp``: four ranks as {'sp': 2, 'mc': 2}, then
    ranks 0 and 1 as {'sp': 2} for the epistemic and batched runs."""
    dev = torch.device(dev)
    initialize_distributed("gloo", f"file://{stores[0]}", world_size=4, rank=rank, device=dev)
    out = {"sp_mc": _sp_run(rank, "sp_mc", cfgs["sp_mc"], res_dir, dev)}
    dist.destroy_process_group()
    if rank < 2:
        initialize_distributed("gloo", f"file://{stores[1]}", world_size=2, rank=rank, device=dev)
        for name in ("epistemic", "batched_float32", "batched_bfloat16"):
            out[name] = _sp_run(rank, name, cfgs[name], res_dir, dev)
    return out


def _f32_rows_agree(name, runner, got_flat, want_flat):
    """float32 decoded rows of one frame against the single device's at the
    whole pipeline's float32 tolerance of tests/test_torch_mc_sharded.py:
    rtol 1e-4 / atol 1e-5, the corner columns (pixels) at atol 1e-5 x the
    image size, as that file holds the corners.  Every anchor's values are
    held to it.  Then exact NMS over both sets of rows: where it picks the
    same anchors, the selected rows are held to the same tolerance; only
    where a near-tie makes it pick other anchors are the detections paired
    by anchor (``_dets_paired``, at least 99 %)."""
    atol = torch.full((got_flat.shape[-1],), 1e-5)
    atol[:4] = 1e-5 * max(IMG[:2])

    def ratio(got, want):
        return (got - want).abs() / (atol.to(want.device) + 1e-4 * want.abs())

    over = ratio(got_flat, want_flat)
    worst = over.amax(dim=(0, 1))
    out = {"corner_atol_px": float(atol[0]),
           "all_anchors_max_err_over_tolerance_by_column": worst.tolist(),
           "all_anchors_share_over_tolerance": float((over > 1).float().mean())}
    check(float(worst.max()) <= 1.0, f"{name}: decoded rows off the float32 tolerance: {out}")
    cfg, obj = runner.config, runner.spec.obj_idx(False)
    picks = [cuda_nms.greedy_nms_cuda(
        flat[:, :, :4].to(runner.device).contiguous(),
        flat[:, :, obj].to(runner.device).contiguous(), cfg.nms_max_boxes,
        cfg.nms_iou_thresh)[0].cpu() for flat in (got_flat, want_flat)]
    (g_rows, g_valid, _), (w_rows, w_valid, _) = (
        runner._select(flat.to(runner.device), 0) for flat in (got_flat, want_flat))
    if torch.equal(*picks):
        err = float(ratio(g_rows.cpu(), w_rows.cpu()).max())
        check(torch.equal(g_valid, w_valid) and err <= 1.0,
              f"{name}: the same picks, selected rows {err} x the tolerance")
        return {**out, "same_picks": True, "selected_max_err_over_tolerance": err}
    got = {"rows": g_rows.cpu(), "valid": g_valid.cpu()}
    return {**out, "same_picks": False,
            **_rows_paired(name, got, (w_rows, w_valid), runner.spec)}


def main_path_sp(tmp, dev, card, b_runner, b_runner32):
    """Spatial sharding at 1024x1920 over the main path's 3 frames, ranks
    spawned on the one card over gloo: epistemic (bayesian, T=30, bf16)
    over {'sp': 2, 'mc': 2} on four ranks and over {'sp': 2}; batched
    aleatoric at batch 1 over {'sp': 2} in float32 and bf16.  Launches,
    collectives and halo traffic per frame and rank; frame 0's decoded rows
    on every rank equal, against the single-device runner's (float32: rtol
    1e-4 / atol 1e-5, corners 1e-5 x the image size, on every anchor and on
    the exact-NMS picks, ``_f32_rows_agree``; bf16: the bf16 jitter bounds,
    since the single device runs the fused chain and sp does not); ms per
    frame, and peak memory of one frame per rank beside the single
    device's."""
    pattern = os.path.join(tmp, "data", "smoke-*-of-*.tfrecord")
    kw = dict(nms_max_boxes=MAX_OUT, nms_pre_top_k=PRE_TOP_K)

    def out_path(name):
        return os.path.join(tmp, "out", f"sp_{name}")

    cfgs = {"sp_mc": make_config(tmp, "smoke", IMG, T, pattern, mesh_shape=SP_MC,
                                 out_path=out_path("sp_mc"), **kw),
            "epistemic": make_config(tmp, "smoke", IMG, T, pattern, mesh_shape={"sp": 2},
                                     out_path=out_path("epistemic"), **kw)}
    for dtype in ("float32", "bfloat16"):
        cfgs[f"batched_{dtype}"] = make_batched_config(
            tmp, "ale", "aleatoric", pattern, batch_size=1, mesh_shape={"sp": 2},
            compute_dtype=dtype, out_path=out_path(f"batched_{dtype}"))
    res_dir = os.path.join(tmp, "sp_ranks")
    os.makedirs(res_dir)
    stores = [os.path.join(res_dir, f"store{n}") for n in (4, 2)]
    ranks, wall = spawn_ranks(_sp_rank, 4, res_dir, stores, cfgs, res_dir, str(dev))

    # the single-device references, on frame 0 under the same keys
    epi = InferenceRunner(make_config(tmp, "smoke", IMG, T, pattern, **kw), seed=0)
    singles = {"sp_mc": epi, "epistemic": epi, "batched_float32": b_runner32,
               "batched_bfloat16": b_runner}
    out = {"phase_wall_s": wall, "backend": "gloo", "frames": 3, "card": card}
    frames = 3
    for name, cfg in cfgs.items():
        n_ranks = 4 if name == "sp_mc" else 2
        per_rank = [r[name] for r in ranks[:n_ranks]]
        check(len({r["out_dir"] for r in per_rank}) == 1, f"sp {name}: output directories differ")
        check([r["writes"] for r in per_rank] == [frames] + [0] * (n_ranks - 1),
              f"sp {name}: writes {[r['writes'] for r in per_rank]}")
        check(len(glob.glob(os.path.join(per_rank[0]["out_dir"], "*.json"))) == frames,
              f"sp {name}: JSON files")
        epistemic = name in ("sp_mc", "epistemic")
        want = {"box_decode": 0 if epistemic else frames,
                "epistemic_decode": 3 * frames if name == "epistemic" else 0,
                "epistemic_moments": 3 * frames if name == "sp_mc" else 0,
                "epistemic_finalize": frames if name == "sp_mc" else 0,
                "quant_epilogue": 0, "fused_stem": 0, "fused_res_block": 0,
                "fused_downsample": 0}
        for r in per_rank:
            got = {k: r["launches"][k] for k in want}
            check(got == want and r["launches"]["greedy_nms"] >= frames,
                  f"sp {name}: launches {r['launches']}, want {want}")
            check(r["halo_per_frame"] == 38 and r["raw_gather_per_frame"] == 3
                  and r["all_reduce_per_frame"] == (name == "sp_mc"),
                  f"sp {name}: collectives per frame {r}")
        rows = [torch.load(os.path.join(res_dir, f"{name}_rows{r}.pt")) for r in range(n_ranks)]
        check(all(torch.equal(rows[0], r) for r in rows[1:]), f"sp {name}: ranks' rows differ")
        ref = singles[name]
        params, stats, _ = ref.load_state()
        img = _first_batch(cfg, 1, dev)
        keys = ref.draw_keys(torch.Generator().manual_seed(0))
        want_rows = ref._decoded_rows(params, stats, img, keys).cpu()
        if name == "batched_float32":
            agree = _f32_rows_agree(f"sp {name}", ref, rows[0], want_rows)
        else:
            agree = rows_agree_bf16(f"sp {name}", rows[0], want_rows,
                                    layout=EPI_COLS if epistemic else ALE_COLS)
        single_peak = _peak_gb(lambda: ref._launch(params, stats, img, keys)())
        del params, stats
        out[name] = {"vs_single_device": agree, "single_device_peak_mem_GB_one_frame": single_peak,
                     "per_rank": per_rank}
    return out


# --------------------------------------------------------------------------
# training
# --------------------------------------------------------------------------

TRAIN_STEPS, TRAIN_INTERVAL, WARM_STEPS = 6, 3, 3
TRAIN_FRAMES = 16  # two batches of 8 an epoch
# the frozen backbone's fused conv kernels: launches a training step
TRAIN_LAUNCHES = {"fused_stem": 1, "fused_res_block": 11, "fused_downsample": 2}
# step 1 through the fused kernels against the plain cuDNN bf16 step: loss
# rtol (tests/test_train_oracle.py:247's bf16 bound), the backbone's three
# outputs at relative L2 (small_ref's fused-chain bound), and the detection
# convs' gradients at relative L2 (tests/test_train_oracle.py:242's bound
# across implementations) with the heads in float32
TRAIN_FUSED_TOL = {"loss": 5e-3, "backbone": 1e-2, "det_grad": 2.5e-2}
# the card's step against the CPU's at 64x96: in float32 the loss rtol and
# every trainable leaf's gradient at relative L2 (tests/test_torch_train.py's
# float32 bounds); in float64 the same at the bounds of that file's float64
# test
TRAIN_F32_TOL = {"loss": 1e-5, "grad": 1e-4}
TRAIN_F64_TOL = {"loss": 1e-12, "grad": 1e-10}
# fused vs plain bf16, all head leaves with the heads in float32: the median
# and 90th percentile of the leaves' gradient gaps at most this many times
# those of the control (the plain bf16 backbone against the plain float32
# one: the spread that bf16 rounding of the backbone alone gives)
TRAIN_SPREAD_RATIO = 2.0
DET_LEAVES = tuple(f"det{i}/{k}" for i in (1, 2, 3) for k in ("w", "b"))
TIMED_STEPS = 6


def train_frame(rng, hw):
    """A seeded frame with 1-8 upright boxes painted on it: (image, boxes
    [ymin, xmin, ymax, xmax] normalized, labels 1..C before the background
    shift)."""
    h, w = hw
    img = seeded_frame(rng, hw)
    n = int(rng.integers(1, 9))
    bh = rng.uniform(0.05, 0.4, n)
    bw = bh * rng.uniform(0.3, 0.5, n) * h / w
    y0, x0 = rng.uniform(0, 1 - bh), rng.uniform(0, 1 - bw)
    boxes = np.stack([y0, x0, y0 + bh, x0 + bw], axis=1).astype(np.float32)
    for b in boxes:
        r0, c0, r1, c1 = (b * [h, w, h, w]).astype(int)
        img[r0:r1, c0:c1] = rng.integers(160, 256, 3, dtype=np.uint8)
    return img, boxes, rng.integers(1, C + 1, n)


def write_train_records(path, rng, n, hw, shards=1):
    """n annotated frames as PNG in ``shards`` tfrecords (the TF Object
    Detection API fields the train loader parses)."""
    os.makedirs(path, exist_ok=True)
    for s in range(shards):
        name = f"train-{s:05d}-of-{shards:05d}.tfrecord"
        with tfrecord.TFRecordWriter(os.path.join(path, name)) as wr:
            for i in range(s * n // shards, (s + 1) * n // shards):
                img, boxes, labels = train_frame(rng, hw)
                wr.write(proto.encode_example({
                    "image/encoded": [pipeline.encode_png(img, level=1)],
                    "image/filename": [f"train_{i:04d}.png".encode()],
                    "image/object/bbox/ymin": boxes[:, 0], "image/object/bbox/xmin": boxes[:, 1],
                    "image/object/bbox/ymax": boxes[:, 2], "image/object/bbox/xmax": boxes[:, 3],
                    "image/object/class/label": labels.astype(np.int64),
                }))
    return os.path.join(path, "train-*-of-*.tfrecord")


def train_config(tmp, defaults, pattern, **kw):
    """A training CLI's DEFAULTS with the smoke's paths, data and steps."""
    split = {"file_pattern": pattern}
    return Config.from_dict({
        **defaults, "run_id": "smoke_train", "darknet53_weights": "", "cpu_thread_cnt": 6,
        "checkpoint_path": os.path.join(tmp, "ckpt_train"), "ckp_max_to_keep": 2,
        "tensorboard_path": os.path.join(tmp, "tb"), "log_path": os.path.join(tmp, "log"),
        "train": {**defaults["train"], **split}, "val": {**defaults["val"], **split}, **kw})


def _rel_l2(got, want):
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def _named_leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _named_leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _step1(step_fn, state, imgs, gts, keys):
    """Step 1's total loss and gradients of the trainable leaves, no update."""
    total, _ = step_fn.loss_fn(state["params"], state["frozen"], state["stats"], imgs, gts,
                               keys)
    grads = torch.autograd.grad(total, train_loop.leaves(state["params"]))
    names = [n for n, _ in _named_leaves(state["params"])]
    return float(total.detach()), dict(zip(names, grads))


def _grads_agree(name, got, want, bound, bounded=DET_LEAVES):
    """Relative L2 of every trainable leaf's gradient, each leaf of
    ``bounded`` (None: every leaf) within ``bound``; the detection convs',
    the worst leaf, the median and the 90th percentile over all leaves
    reported."""
    rels = {k: _rel_l2(got[k], want[k]) for k in want}
    worst = max(rels, key=rels.get)
    det = {k: rels[k] for k in DET_LEAVES}
    out = {"det_grad_rel_l2": det, "max_det_grad_rel_l2": max(det.values()),
           "all_leaves_max_grad_rel_l2": rels[worst], "all_leaves_max_leaf": worst,
           "all_leaves_median_grad_rel_l2": float(np.median(list(rels.values()))),
           "all_leaves_p90_grad_rel_l2": float(np.percentile(list(rels.values()), 90))}
    bad = {k: rels[k] for k in (rels if bounded is None else bounded) if not rels[k] <= bound}
    check(not bad, f"{name}: gradients at relative L2 {bad} > {bound}")
    return out


@contextlib.contextmanager
def float64_casts():
    """The port's training step in float64, for the precision comparison
    only: its ``.float()`` casts (BN statistics, the decode, the loss) read
    as ``.double()`` and ``compute_dtype="float64"`` is known."""
    cast = torch.Tensor.float
    torch.Tensor.float = torch.Tensor.double
    yolov3._DTYPES["float64"] = torch.float64
    try:
        yield
    finally:
        torch.Tensor.float = cast
        del yolov3._DTYPES["float64"]


def parity_weights(seed, spec):
    """The CPU tests' seeded weights (``tests/torch_parity.py:numpy_weights``,
    copied: the smoke imports nothing of the tests), drawn in the same order
    from the same numpy generator: variance-preserving kernels (gain 2),
    damped residual branches in the backbone (gain 0.6), gamma and var
    uniform in [0.8, 1.2], beta, mean and biases N(0, 0.01).  CPU tensors,
    kernels OIHW."""
    rng = np.random.default_rng(seed)
    straight = {"conv_00", "conv_01", "conv_04", "conv_09", "conv_26", "conv_43"}

    def leaf(block, name, t):
        if name == "w":
            o, i, kh, kw = t.shape
            gain = 0.6 if block.startswith("conv_") and block not in straight else 2.0
            a = rng.standard_normal((kh, kw, i, o)).astype(np.float32) * np.float32(
                np.sqrt(gain / (kh * kw * i)))
            return torch.from_numpy(np.ascontiguousarray(a.transpose(3, 2, 0, 1)))
        if name in ("gamma", "var"):
            return torch.from_numpy(rng.uniform(0.8, 1.2, t.shape).astype(np.float32))
        return torch.from_numpy((rng.standard_normal(t.shape) * 0.1).astype(np.float32))

    def walk(tree, block=""):
        return {k: walk(v, k) if isinstance(v, dict) else leaf(block, k, v)
                for k, v in tree.items()}

    params, stats = yolov3.init_yolov3(torch.Generator(), spec, "meta")
    return walk(params), walk(stats)


def _loss_agree(name, got, want, rtol):
    rel = abs(got - want) / abs(want)
    check(np.isfinite(got) and rel <= rtol, f"{name}: step-1 loss {got} vs {want} (rtol {rtol})")
    return {"loss": got, "loss_ref": want, "loss_rel_err": rel}


def _train_launches(name, launches, steps):
    for k, per in TRAIN_LAUNCHES.items():
        check(launches[k] == per * steps,
              f"{name}: {k} launched {launches[k]} times in {steps} steps, want {per} a step")
    return {k: launches[k] / steps for k in TRAIN_LAUNCHES}


def train_small_reference(dev):
    """64x96, batch 2, bayesian with the aleatoric loss: step 1 on the card
    (cuDNN, TF32 off) against step 1 on the CPU, the same preprocessed batch
    and dropout keys.

    * float32 with the CPU tests' weights (``parity_weights(0)``): the loss
      and every trainable leaf's gradient at ``TRAIN_F32_TOL``.
    * float64 with the smoke's seeded weights (``random_state(3)``): the loss
      and every leaf at ``TRAIN_F64_TOL``.  In float32 these weights put
      LeakyReLU inputs next to 0, where two float32 steps take different
      slopes; their float32 card-vs-CPU gaps and the CPU's own float32
      against float64 are reported beside (``float32_kinks``)."""
    cfg = Config(model="bayesian", full_img_size=(64, 96, 3), batch_size=2,
                 max_boxes_per_img=8, compute_dtype="float32", aleatoric_loss=True,
                 darknet53_weights="", lr=1e-5)
    model = yolov3.YoloV3.from_config(cfg)
    tables = encode.build_prior_tables(model.blueprint)
    step, _, _ = train_loop.make_train_step(model, cfg, tables)
    rng = np.random.default_rng(12)
    frames = [train_frame(rng, (64, 96)) for _ in range(2)]
    batch = {"image": np.stack([f[0] for f in frames])}
    for k, v in zip(("bbox", "label", "valid"), zip(*(encode.pad_boxes(f[1], f[2] - 1, 8)
                                                       for f in frames))):
        batch[k] = np.stack(v)
    imgs, gts = step.preprocess({k: torch.from_numpy(v) for k, v in batch.items()}, 0)
    keys = train_loop.dropout_keys(0, 0)

    def step1(d, weights, dtype):
        params, stats = weights
        cast = (lambda t: t.double()) if dtype == "float64" else (lambda t: t)
        tree = lambda t: {k: tree(v) if isinstance(v, dict) else cast(v.detach().to(d))
                          for k, v in t.items()}
        trainable, frozen = train_loop.partition_params(tree(params), True)
        for leaf in train_loop.leaves(trainable):
            leaf.requires_grad_(True)
        state = {"params": trainable, "frozen": frozen, "stats": tree(stats)}
        model.compute_dtype = dtype
        with float64_casts() if dtype == "float64" else contextlib.nullcontext():
            return _step1(step, state, cast(imgs.to(d)),
                          [{k: v.to(d) for k, v in g.items()} for g in gts], keys)

    card = str(dev)
    parity = parity_weights(0, cfg.variant_spec)
    f32 = {d: step1(d, parity, "float32") for d in ("cpu", card)}
    name = "train small_ref float32"
    out = {**_loss_agree(name, f32[card][0], f32["cpu"][0], TRAIN_F32_TOL["loss"]),
           **_grads_agree(name, f32[card][1], f32["cpu"][1], TRAIN_F32_TOL["grad"], None)}
    seeded = random_state(3, cfg.variant_spec, "cpu")
    runs = {(d, t): step1(d, seeded, t) for d in ("cpu", card) for t in ("float32", "float64")}
    name = "train small_ref float64"
    out["float64"] = {
        **_loss_agree(name, runs[card, "float64"][0], runs["cpu", "float64"][0],
                      TRAIN_F64_TOL["loss"]),
        **_grads_agree(name, runs[card, "float64"][1], runs["cpu", "float64"][1],
                       TRAIN_F64_TOL["grad"], None)}
    inf = float("inf")
    out["float32_kinks"] = {
        "card_vs_cpu": _grads_agree("", runs[card, "float32"][1], runs["cpu", "float32"][1], inf),
        "cpu_float32_vs_float64": _grads_agree("", runs["cpu", "float32"][1],
                                               runs["cpu", "float64"][1], inf)}
    model.compute_dtype = "float32"
    return out


def train_fused_vs_plain(trainer, cfg, state, imgs, gts, keys):
    """Step 1 with the frozen backbone through the fused conv kernels against
    the same step through the plain cuDNN bf16 convolutions (``fused_early
    =False``): the bf16 step's loss; the backbone's three outputs; and, with
    the heads in float32 on each backbone's outputs, the gradients — the
    detection convs' each at ``TRAIN_FUSED_TOL``, and the median and 90th
    percentile over every head leaf within ``TRAIN_SPREAD_RATIO`` times
    those of the control, the plain bf16 backbone against the plain float32
    one under the same float32 heads."""
    out, grads, feats = {}, {}, {}
    losses = {}
    for fused in (None, False):
        step, _, _ = train_loop.make_train_step(trainer.model, cfg, trainer.tables,
                                                fused_early=fused)
        losses[fused], grads[fused] = _step1(step, state, imgs, gts, keys)
    inf = float("inf")
    out["bf16_step"] = {**_loss_agree("train fused vs plain", losses[None], losses[False],
                                      TRAIN_FUSED_TOL["loss"]),
                        **_grads_agree("", grads[None], grads[False], inf)}
    params = train_loop.merge_params(state["params"], state["frozen"])
    names = [n for n, _ in _named_leaves(state["params"])]
    for fused, dtype in ((True, torch.bfloat16), (False, torch.bfloat16),
                         ("float32", torch.float32)):
        with torch.no_grad():
            o32, s16, s8, _ = darknet.darknet53(
                params["backbone"], state["stats"]["backbone"], imgs,
                compute_dtype=dtype, fused_early=fused is True)
        feats[fused] = [t.float() for t in (o32, s16, s8)]
        raws, _ = yolov3._heads_train(params, state["stats"], *feats[fused], site_keys=None,
                                      compute_dtype=torch.float32)
        dets = [decode.split_detection(raw, trainer.model.spec) for raw in raws]
        total, _ = loss_ops.total_loss(dets, gts, params, bool(cfg.aleatoric_loss))
        grads[fused] = dict(zip(names, torch.autograd.grad(total, train_loop.leaves(
            state["params"]))))
    out["backbone_rel_l2"] = [_rel_l2(a, b) for a, b in zip(feats[True], feats[False])]
    check(max(out["backbone_rel_l2"]) <= TRAIN_FUSED_TOL["backbone"],
          f"train fused vs plain: backbone outputs at relative L2 {out['backbone_rel_l2']}")
    out["float32_heads"] = _grads_agree("train fused vs plain (float32 heads)", grads[True],
                                        grads[False], TRAIN_FUSED_TOL["det_grad"])
    out["control_backbone_rel_l2"] = [_rel_l2(a, b) for a, b in
                                      zip(feats[False], feats["float32"])]
    out["control_float32_heads"] = _grads_agree("", grads[False], grads["float32"], inf)
    for q in ("median", "p90"):
        key = f"all_leaves_{q}_grad_rel_l2"
        got, ctl = out["float32_heads"][key], out["control_float32_heads"][key]
        check(got <= TRAIN_SPREAD_RATIO * ctl,
              f"train fused vs plain (float32 heads): the {q} of the head leaves' gradient "
              f"gaps {got} > {TRAIN_SPREAD_RATIO} x the bf16-vs-float32 control's {ctl}")
    return out


def main_path_train(tmp, dev, card):
    """Training at full width through ``Trainer.run()``: the pretraining
    configuration (aleatoric, no aleatoric loss, crops of 768x1440 from
    1024x1920 frames, batch 8, bf16, frozen backbone on the fused conv
    kernels) for 6 steps with a checkpoint every 3, one val step, then the
    uncertainty configuration (bayesian, aleatoric loss, batch 2) warm-started
    from its last checkpoint for 3 steps; launches, losses, the frozen
    backbone and the moved heads checked; step 1 through the fused kernels
    against the plain cuDNN bf16 step; times."""
    from bayesian_yolov3_torch.cli import pretraining, uncertainty_training

    pattern = write_train_records(os.path.join(tmp, "train_data"), np.random.default_rng(21),
                                  TRAIN_FRAMES, IMG[:2])
    cfg = train_config(tmp, pretraining.DEFAULTS, pattern, train_steps=TRAIN_STEPS,
                       checkpoint_interval=TRAIN_INTERVAL)
    check(cfg.crop and cfg.img_size == (768, 1440, 3) and cfg.batch_size == 8
          and cfg.compute_dtype == "bfloat16" and cfg.freeze_darknet53
          and cfg.model == "aleatoric" and not cfg.aleatoric_loss,
          f"the pretraining configuration changed: {cfg}")
    trainer = train_loop.Trainer(cfg, device=dev)
    fresh = trainer.fresh_state()  # the run's own init (same seed)
    out = {"config": {"model": cfg.model, "crop": list(cfg.img_size), "batch": cfg.batch_size,
                      "compute_dtype": cfg.compute_dtype, "steps": TRAIN_STEPS}}

    reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = trainer.run()
    torch.cuda.synchronize()
    out["run_wall_s"] = time.perf_counter() - t0
    launches = read_counters()
    out["launches_per_step"] = _train_launches("pretraining run", launches, TRAIN_STEPS)
    out["losses"] = res["losses"]
    check(res["step"] == TRAIN_STEPS and len(res["losses"]) == TRAIN_STEPS
          and all(np.isfinite(res["losses"])), f"pretraining run: {res['step']} steps, "
                                              f"losses {res['losses']}")
    check(trainer.store.all_steps() == [TRAIN_INTERVAL, TRAIN_STEPS],
          f"checkpoints {trainer.store.all_steps()}")
    state = res["state"]
    for (name, a), (_, b) in zip(_named_leaves(fresh["frozen"]), _named_leaves(state["frozen"])):
        check(torch.equal(a, b), f"frozen backbone {name} changed")
    for (name, a), (_, b) in zip(_named_leaves(fresh["stats"]["backbone"]),
                                 _named_leaves(state["stats"]["backbone"])):
        check(torch.equal(a, b), f"frozen backbone statistics {name} changed")
    still = [n for (n, a), (_, b) in zip(_named_leaves(fresh["params"]),
                                          _named_leaves(state["params"])) if torch.equal(a, b)]
    check(not still, f"head leaves that did not move: {still}")
    out["heads_moved"] = len(train_loop.leaves(state["params"]))
    val_loader = pipeline.TrainLoader(cfg, "val", seed=2)
    try:
        vm = trainer.eval_step_fn(state, trainer._place_batch(next(val_loader.batches())))
    finally:
        val_loader.close()
    out["val"] = {k: float(v) for k, v in vm.items()}
    check(all(np.isfinite(v) for v in out["val"].values()), f"val metrics {out['val']}")

    # the uncertainty run: bayesian, aleatoric loss, batch 2, warm-started
    cfg2 = train_config(tmp, uncertainty_training.DEFAULTS, pattern,
                        train_steps=TRAIN_STEPS + WARM_STEPS)
    check(cfg2.resume_training and cfg2.model == "bayesian" and cfg2.aleatoric_loss
          and cfg2.batch_size == 2, f"the uncertainty configuration changed: {cfg2}")
    reset_counters()
    res2 = train_loop.Trainer(cfg2, device=dev).run()
    torch.cuda.synchronize()
    out["warm_start"] = {"losses": res2["losses"], "launches_per_step": _train_launches(
        "uncertainty run", read_counters(), WARM_STEPS)}
    check(res2["step"] == TRAIN_STEPS + WARM_STEPS and len(res2["losses"]) == WARM_STEPS
          and all(np.isfinite(res2["losses"])) and res2["state"]["opt"]["count"] ==
          TRAIN_STEPS + WARM_STEPS, f"uncertainty run: step {res2['step']}, {res2['losses']}")
    del res2

    # step 1 through the fused kernels against the plain cuDNN bf16 step
    batches = trainer_batches(cfg)
    host = next(batches)
    batches.close()
    batch = trainer._place_batch(host)
    imgs, gts = trainer.train_step_fn.preprocess(batch, 0)
    keys = train_loop.dropout_keys(0, 0)
    out["fused_vs_plain"] = train_fused_vs_plain(trainer, cfg, fresh, imgs, gts, keys)
    out["cpu_vs_card"] = train_small_reference(dev)
    out["timing"] = train_timing(trainer, cfg, state, batch, host, keys)
    return out


def trainer_batches(cfg):
    """The first host batches of the train loader (closed after)."""
    loader = pipeline.TrainLoader(cfg, "train", seed=1)
    try:
        yield from loader.batches()
    finally:
        loader.close()


def train_timing(trainer, cfg, state, batch, host, keys):
    """ms per step by CUDA events (the median of the steps after the first),
    img/s, each part of the step timed alone — the preprocess, the forward
    with the loss, the backward, Adam — the host loader's time per batch
    and the peak memory of one step."""
    step = trainer.train_step_fn
    out = {"card_batch": cfg.batch_size}
    times = []
    for _ in range(TIMED_STEPS + 1):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        step(state, batch)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    out["ms_per_step"] = float(np.median(times[1:]))
    out["step_readings_ms"] = times
    out["img_per_s"] = cfg.batch_size / (out["ms_per_step"] / 1e3)
    imgs, gts = step.preprocess(batch, 0)
    out["preprocess_ms"] = event_ms(lambda: step.preprocess(batch, 0), 5)

    def fwd():
        return step.loss_fn(state["params"], state["frozen"], state["stats"], imgs, gts, keys)

    out["forward_loss_ms"] = event_ms(fwd, 5)
    leaves = train_loop.leaves(state["params"])
    bwd, adam = [], []
    for _ in range(5):
        total, _ = fwd()
        torch.cuda.synchronize()
        bwd.append(event_ms(lambda: torch.autograd.grad(total, leaves), 1))
        grads = torch.autograd.grad(fwd()[0], leaves)
        adam.append(event_ms(lambda: trainer.optimizer.update(grads, state["opt"],
                                                              state["params"]), 1))
    out["backward_ms"], out["adam_ms"] = float(np.median(bwd)), float(np.median(adam))
    # the host's time to enqueue each part (the card drained before, not
    # after): a part whose enqueue takes as long as its events read is
    # bound by the host
    torch.cuda.synchronize()
    out["preprocess_host_ms"] = _host_s(lambda: step.preprocess(batch, 0)) * 1e3
    torch.cuda.synchronize()
    total, _ = fwd()
    out["forward_loss_host_ms"] = _host_s(fwd) * 1e3
    torch.cuda.synchronize()
    out["backward_host_ms"] = _host_s(lambda: torch.autograd.grad(total, leaves)) * 1e3
    torch.cuda.synchronize()
    out["step_host_ms"] = _host_s(lambda: step(state, batch)) * 1e3
    torch.cuda.synchronize()
    parts = out["preprocess_ms"] + out["forward_loss_ms"] + out["backward_ms"] + out["adam_ms"]
    out["share"] = {k: out[f"{k}_ms"] / parts
                    for k in ("preprocess", "forward_loss", "backward", "adam")}
    out["peak_mem_GB_one_step"] = _peak_gb(lambda: step(state, batch))
    loader = trainer_batches(cfg)
    next(loader)
    lt = [_host_s(lambda: next(loader)) * 1e3 for _ in range(4)]
    loader.close()
    out["loader_ms_per_batch"] = float(np.median(lt))
    out["loader_threads"] = cfg.cpu_thread_cnt
    return out


# --------------------------------------------------------------------------
# dp training
# --------------------------------------------------------------------------

DP_TRAIN_RANKS, DP_TRAIN_STEPS = 2, 3
# Two ranks against one rank on the same global batch, draws and keys.  In
# float64, the dp arithmetic itself: loss rtol 1e-12, the new moving
# statistics rtol 1e-10, every trainable leaf's gradient at relative L2
# 1e-10 (the CPU test's float64 bounds, tests/test_torch_train_dp.py).  In
# float32 the sums of the BN statistics and of the gradients run in another
# order (two halves all-reduced) and cuDNN may take other algorithms for 4
# images than for 8: the loss and the statistics at rtol 1e-5 (a statistic
# also within 1e-7 absolute: a moving mean near 0 takes a batch mean whose
# float32 sum over 138 240 positions cancels); the head leaves' gradients,
# whose batch-statistics BN leaves small differences of large terms (a
# 5.6e-3 relative L2 on head1_conv0/beta in the first chip run), with their
# median and 90th percentile within DP_TRAIN_SPREAD_RATIO times those of a
# control, one rank's own float32 step against its float64 step.
DP_TRAIN_TOL = {"loss": 1e-5, "stats": 1e-5, "stats_atol": 1e-7}
DP_TRAIN_F64_TOL = {"loss": 1e-12, "stats": 1e-10, "grad": 1e-10}
DP_TRAIN_SPREAD_RATIO = 2.0


def _state_digest(state):
    """sha256 of every tensor of a training state (params, frozen, stats,
    the Adam moments) and the Adam count."""
    import hashlib

    h = hashlib.sha256()
    for key in ("params", "frozen", "stats"):
        for t in train_loop.leaves(state[key]):
            h.update(t.detach().cpu().contiguous().view(torch.uint8).numpy().tobytes())
    for key in ("mu", "nu"):
        for t in train_loop.leaves(state["opt"][key]):
            h.update(t.cpu().contiguous().view(torch.uint8).numpy().tobytes())
    h.update(str(state["opt"]["count"]).encode())
    return h.hexdigest()


def _global_batch(cfg):
    """The first host batch of a one-host train loader: the same ``batch_size``
    frames wherever it runs."""
    loader = pipeline.TrainLoader(cfg, "train", seed=1)
    try:
        return next(loader.batches())
    finally:
        loader.close()


def _one_step(trainer, host, dtype="float32"):
    """One step of ``trainer`` on ``host`` (the rank's share of the batch),
    from its fresh state: the float32 preprocessing, then the forward,
    backward and Adam in ``dtype`` ("float64": the state and the images
    cast, ``float64_casts``): the loss, the gradients Adam received
    (averaged over the ranks), the heads' new statistics, all on the
    host."""
    seen = {}
    update = trainer.optimizer.update
    trainer.optimizer.update = lambda g, *a: (seen.setdefault("g", [t.cpu() for t in g]),
                                              update(g, *a))[1]
    state = trainer.fresh_state()
    if dtype == "float64":
        cast = lambda t: {k: cast(v) if isinstance(v, dict) else v.detach().double()  # noqa
                          for k, v in t.items()}
        params = cast(state["params"])
        for p in train_loop.leaves(params):
            p.requires_grad_(True)
        state = {**state, "params": params, "frozen": cast(state["frozen"]),
                 "stats": cast(state["stats"]), "opt": trainer.optimizer.init(params)}
    step = trainer.train_step_fn
    imgs, gts = step.preprocess(trainer._place_batch(host), state["step"])  # float32 draws
    trainer.model.compute_dtype = dtype
    try:
        with float64_casts() if dtype == "float64" else contextlib.nullcontext():
            state, metrics = step.apply(state, imgs.to(getattr(torch, dtype)), gts)
    finally:
        trainer.optimizer.update = update
        trainer.model.compute_dtype = "float32"
    names = [n for n, _ in _named_leaves(state["params"])]
    return {"loss": float(metrics["total"]), "grads": dict(zip(names, seen["g"])),
            "stats": {n: t.cpu() for n, t in _named_leaves(
                {k: v for k, v in state["stats"].items() if k != "backbone"})}}


def _steps_agree(name, got, want, tol):
    """Loss, statistics and gradients of two steps: the worst of each, and
    the loss and the statistics held at ``tol``."""
    loss_rel = abs(got["loss"] - want["loss"]) / abs(want["loss"])
    grad_rel = {k: _rel_l2(got["grads"][k], w) for k, w in want["grads"].items()}
    stat_abs = {k: float((got["stats"][k] - w).abs().max()) for k, w in want["stats"].items()}
    stat_rel = {k: float(((got["stats"][k] - w).abs() / w.abs().clamp_min(1e-30)).max())
                for k, w in want["stats"].items()}
    over = {k: float(((got["stats"][k] - w).abs() - tol["stats"] * w.abs()).max())
            for k, w in want["stats"].items()}
    worst_grad, worst_stat = max(grad_rel, key=grad_rel.get), max(stat_rel, key=stat_rel.get)
    check(loss_rel <= tol["loss"], f"{name}: loss {got['loss']} vs {want['loss']}")
    check(max(over.values()) <= tol.get("stats_atol", 0.0),
          f"{name}: statistics beyond rtol {tol['stats']} + atol {tol.get('stats_atol', 0)}: "
          f"{sorted(over.items(), key=lambda x: -x[1])[:3]}")
    return {"loss": got["loss"], "loss_ref": want["loss"], "loss_rel_err": loss_rel,
            "worst_grad_rel_l2": grad_rel[worst_grad], "worst_grad_leaf": worst_grad,
            "median_grad_rel_l2": float(np.median(list(grad_rel.values()))),
            "p90_grad_rel_l2": float(np.percentile(list(grad_rel.values()), 90)),
            "worst_stat_rel_err": stat_rel[worst_stat], "worst_stat": worst_stat,
            "worst_stat_abs_err": max(stat_abs.values())}


@contextlib.contextmanager
def counted_all_reduces():
    """Every ``torch.distributed.all_reduce`` inside: (elements, host ms), timed
    from a drained card to a drained card — the BN statistics' (forward and
    backward) and the packed gradients'."""
    calls = []
    orig = dist.all_reduce

    def counted(t, *a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig(t, *a, **kw)
        torch.cuda.synchronize()
        calls.append((t.numel(), (time.perf_counter() - t0) * 1e3))
        return out

    dist.all_reduce = counted
    try:
        yield calls
    finally:
        dist.all_reduce = orig


def _dp_train_rank(rank, store, cfgs, res_dir, dev):
    """One rank of ``main_path_train_dp``: float32, one step on the rank's 4
    images of the global batch; bf16, ``Trainer.run()`` for 3 steps with the
    launches counted, then the rank's step timed, its peak memory, the
    packed gradient all-reduce and the BN all-reduces of one step."""
    dev = torch.device(dev)
    initialize_distributed("gloo", f"file://{store}", world_size=DP_TRAIN_RANKS, rank=rank,
                           device=dev)
    out = {}
    trainer = train_loop.Trainer(cfgs["float32"], device=dev)
    check(trainer.group is not None and trainer.group.size == DP_TRAIN_RANKS
          and trainer.rank == rank, f"rank {rank}: no data group of {DP_TRAIN_RANKS}")
    host = _global_batch(cfgs["float32"])
    per = cfgs["float32"].batch_size // DP_TRAIN_RANKS
    local = {k: v[rank * per:(rank + 1) * per] for k, v in host.items()}
    for dtype in ("float32", "float64"):
        torch.save(_one_step(trainer, local, dtype),
                   os.path.join(res_dir, f"{dtype}_rank{rank}.pt"))
    del trainer

    saves = []
    for name in ("save", "save_config_snapshot"):
        orig = getattr(CheckpointStore, name)
        setattr(CheckpointStore, name,
                lambda *a, _o=orig, _n=name: (saves.append(_n), _o(*a))[1])
    cfg = cfgs["bfloat16"]
    trainer = train_loop.Trainer(cfg, device=dev)
    reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = trainer.run()
    torch.cuda.synchronize()
    out["run_wall_s"] = time.perf_counter() - t0
    out["launches_per_step"] = _train_launches(f"dp training rank {rank}", read_counters(),
                                               DP_TRAIN_STEPS)
    out["losses"], out["saves"] = res["losses"], saves
    check(res["step"] == DP_TRAIN_STEPS and len(res["losses"]) == DP_TRAIN_STEPS
          and all(np.isfinite(res["losses"])), f"dp rank {rank}: {res['step']} steps, "
                                              f"losses {res['losses']}")
    state = res["state"]
    out["state_digest"] = _state_digest(state)

    loader = pipeline.TrainLoader(cfg, "train", seed=1, host_index=rank,
                                  host_count=DP_TRAIN_RANKS)
    try:
        batch = trainer._place_batch(next(loader.batches()))
    finally:
        loader.close()
    step = trainer.train_step_fn
    times = []
    for _ in range(TIMED_STEPS + 1):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        step(state, batch)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    out["ms_per_step"] = float(np.median(times[1:]))
    out["step_readings_ms"] = times
    out["peak_mem_GB_one_step"] = _peak_gb(lambda: step(state, batch))
    grads = [torch.zeros_like(p) for p in train_loop.leaves(state["params"])]
    grads += [torch.zeros((), device=dev) for _ in train_loop.METRIC_KEYS]
    out["grad_all_reduce_MB"] = sum(g.numel() for g in grads) * 4 / 1e6
    out["grad_all_reduce_wall_ms"] = wall_ms(
        lambda: trainer.group.all_reduce_mean_packed(grads), 3)
    packed = sum(g.numel() for g in grads)
    with counted_all_reduces() as calls:
        step(state, batch)
    bn = [ms for n, ms in calls if n != packed]
    out["all_reduces_per_step"] = len(calls)
    out["bn_all_reduces_per_step"] = len(bn)
    out["bn_all_reduce_wall_ms_per_step"] = float(sum(bn))
    out["packed_all_reduces_per_step"] = len(calls) - len(bn)
    return out


def main_path_train_dp(tmp, dev, card):
    """Data-parallel training, ``mesh_shape={'data': 2}``: two spawned ranks
    on the one card over gloo (NCCL will not put two ranks on one card), the
    pretraining configuration (aleatoric, crops of 768x1440 from 1024x1920
    frames, global batch 8 — 4 a rank —, frozen backbone).  One step of
    the two ranks against one rank on the same global batch, in float64
    (``DP_TRAIN_F64_TOL``) and float32 (``DP_TRAIN_TOL``, the gradients
    against a control); the worst of each printed.  bf16, 3 steps through
    ``Trainer.run()``: launches a step and rank (stem 1, res block 11,
    downsample 2), finite losses, the ranks' params, Adam state and
    statistics bit-equal, rank 0 alone writing the config snapshot and the
    checkpoints.  Times: ms a step per rank (the ranks time-slice the one
    card), the packed gradient all-reduce, the BN all-reduces, peak memory."""
    from bayesian_yolov3_torch.cli import pretraining

    pattern = write_train_records(os.path.join(tmp, "train_dp_data"),
                                  np.random.default_rng(23), TRAIN_FRAMES, IMG[:2], shards=2)
    cfgs = {dtype: train_config(tmp, pretraining.DEFAULTS, pattern, run_id=f"smoke_dp_{dtype}",
                                train_steps=DP_TRAIN_STEPS, checkpoint_interval=DP_TRAIN_STEPS,
                                compute_dtype=dtype, mesh_shape={"data": DP_TRAIN_RANKS})
            for dtype in ("float32", "bfloat16")}
    check(cfgs["bfloat16"].batch_size == 8 and cfgs["bfloat16"].img_size == (768, 1440, 3),
          f"the pretraining configuration changed: {cfgs['bfloat16']}")
    res_dir = os.path.join(tmp, "train_dp_ranks")
    os.makedirs(res_dir)
    ranks, wall = spawn_ranks(_dp_train_rank, DP_TRAIN_RANKS, res_dir,
                              os.path.join(res_dir, "store"), cfgs, res_dir, str(dev))
    out = {"ranks": DP_TRAIN_RANKS, "backend": "gloo", "global_batch": 8, "crop": [768, 1440],
           "steps": DP_TRAIN_STEPS, "phase_wall_s": wall, "card": card,
           "note": "the two ranks time-slice one card"}

    # one step: the ranks' against one rank's on the whole global batch
    cfg1 = dataclasses.replace(cfgs["float32"], mesh_shape={})
    single = train_loop.Trainer(cfg1, device=dev)
    host = _global_batch(cfg1)
    agree = {}
    for dtype in ("float64", "float32"):
        got = [torch.load(os.path.join(res_dir, f"{dtype}_rank{r}.pt"))
               for r in range(DP_TRAIN_RANKS)]
        for r in got[1:]:  # the gradients and the statistics are the group's, on every rank
            check(r["loss"] == got[0]["loss"]
                  and all(torch.equal(r["grads"][k], got[0]["grads"][k]) for k in r["grads"])
                  and all(torch.equal(r["stats"][k], got[0]["stats"][k]) for k in r["stats"]),
                  f"dp {dtype}: the ranks' losses, gradients or statistics differ")
        one = _one_step(single, host, dtype)
        tol = DP_TRAIN_F64_TOL if dtype == "float64" else DP_TRAIN_TOL
        agree[dtype] = _steps_agree(f"dp {dtype}", got[0], one, tol)
        agree[dtype]["tolerance"] = tol
        if dtype == "float64":
            check(agree[dtype]["worst_grad_rel_l2"] <= tol["grad"],
                  f"dp float64: gradient of {agree[dtype]['worst_grad_leaf']} at relative L2 "
                  f"{agree[dtype]['worst_grad_rel_l2']}")
            one64 = one
    # the control: one rank's float32 step against its float64 step
    control = _steps_agree("dp control", one, one64, {"loss": 1.0, "stats": 1.0})
    agree["float32_control_one_rank_vs_float64"] = control
    for q in ("median", "p90"):
        got, ctl = agree["float32"][f"{q}_grad_rel_l2"], control[f"{q}_grad_rel_l2"]
        check(got <= DP_TRAIN_SPREAD_RATIO * ctl,
              f"dp float32: the {q} of the leaves' gradient gaps {got} > "
              f"{DP_TRAIN_SPREAD_RATIO} x the control's {ctl}")
    out["two_ranks_vs_one"] = agree
    del single, one, one64

    # bf16 through Trainer.run(): every rank alike, rank 0 alone writing
    check(len({r["state_digest"] for r in ranks}) == 1,
          "dp bf16: the ranks' params, Adam state or statistics differ after the run")
    check(ranks[0]["losses"] == ranks[1]["losses"], "dp bf16: the ranks read other losses")
    check(sorted(ranks[0]["saves"]) == ["save", "save", "save_config_snapshot"]
          and ranks[1]["saves"] == [], f"dp bf16: writes {[r['saves'] for r in ranks]}")
    store_dir = os.path.join(cfgs["bfloat16"].checkpoint_path, cfgs["bfloat16"].run_id)
    check(CheckpointStore(cfgs["bfloat16"].checkpoint_path,
                          cfgs["bfloat16"].run_id).all_steps() == [DP_TRAIN_STEPS]
          and os.path.exists(os.path.join(store_dir, "metrics.jsonl")),
          f"dp bf16: checkpoints / metrics in {os.listdir(store_dir)}")
    out["bfloat16"] = {"per_rank": [{k: v for k, v in r.items() if k not in ("saves",)}
                                    for r in ranks]}
    return out


# --------------------------------------------------------------------------
# the tools
# --------------------------------------------------------------------------

VIS_KEYS, VIS_PNGS = 11, 99  # 11 keys x 3 scales x 3 priors a frame
# the hand-written kernels a trace should show by their CUDA function names
TRACED_KERNELS = ("stem_kernel", "res_block_kernel", "downsample_kernel")


def _png_hw(path):
    """(height, width, colour type) from a PNG's IHDR chunk."""
    with open(path, "rb") as f:
        head = f.read(26)
    return (int.from_bytes(head[20:24], "big"), int.from_bytes(head[16:20], "big"), head[25])


def _gt_records(path, names, rng):
    """GT tfrecords for the frames ``names``: 2-5 seeded boxes of both
    classes each (the weights are random, so the metrics measure nothing
    but that the tool runs)."""
    os.makedirs(path, exist_ok=True)
    with tfrecord.TFRecordWriter(os.path.join(path, "gt-00000-of-00001.tfrecord")) as wr:
        for i, name in enumerate(names):
            n = int(rng.integers(2, 6))
            yx = rng.uniform(0, 0.7, (n, 2))
            boxes = np.concatenate([yx, yx + rng.uniform(0.05, 0.3, (n, 2))], 1).astype(np.float32)
            labels = (np.arange(n) + i) % C + 1
            wr.write(proto.encode_example({
                "image/encoded": [pipeline.encode_png(np.zeros((8, 8, 3), np.uint8))],
                "image/filename": [f"{name}.png".encode()],
                "image/object/bbox/ymin": boxes[:, 0], "image/object/bbox/xmin": boxes[:, 1],
                "image/object/bbox/ymax": boxes[:, 2], "image/object/bbox/xmax": boxes[:, 3],
                "image/object/class/label": labels.astype(np.int64)}))
    return os.path.join(path, "gt-*-of-*.tfrecord")


def _qualitative(cli, argv, frames, qdir, n_copies, dev):
    """A training CLI with ``--set training=false`` (the qualitative eval)
    run in ``qdir`` with its launches counted; each PNG's pixels against
    ``draw_boxes`` of ``filter_and_score`` of ``runner.predict`` on the same
    copies under the same key tables."""
    from bayesian_yolov3_torch.cli._common import build_config
    from bayesian_yolov3_torch.infer.detect import center_crop, draw_boxes, filter_and_score
    from bayesian_yolov3_torch.infer.qualitative import eval_config

    os.makedirs(qdir)
    reset_counters()
    t0 = time.perf_counter()
    with contextlib.chdir(qdir):
        written = [os.path.join(qdir, p) for p in cli.main(["--set", "training=false"] + argv)]
    torch.cuda.synchronize()
    res = {"wall_s": time.perf_counter() - t0, "launches": read_counters(),
           "pngs": len(written)}
    check(len(written) == len(frames) * n_copies,
          f"qualitative eval: {len(written)} PNGs for {len(frames)} frames x {n_copies}")
    cfg = build_config(cli.DEFAULTS, ["--set", "training=false"] + argv)
    runner = InferenceRunner(eval_config(cfg), seed=0, device=dev)
    params, stats, _ = runner.load_state()
    gen = torch.Generator().manual_seed(0)
    boxes_n = []
    for i, frame in enumerate(frames):
        img = frame.astype(np.float32) / 255.0
        if cfg.crop:
            img = center_crop(img, cfg.crop_img_size)
        rows, valid = runner.predict(params, stats, np.repeat((img[None] * 255).astype(np.uint8),
                                                              n_copies, axis=0),
                                     runner.draw_keys(gen))
        for b in range(n_copies):
            boxes = filter_and_score(rows[b], valid[b], runner.spec, runner.epistemic,
                                     cfg.thresh, img.shape[:2])
            boxes_n.append(len(boxes))
            with open(written[i * n_copies + b], "rb") as f:
                png = pipeline.decode_png(f.read())
            check(np.array_equal(png, draw_boxes(img, boxes)),
                  f"qualitative eval: {written[i * n_copies + b]} is not the drawing of "
                  "predict's boxes")
    res["boxes_per_copy"] = boxes_n
    res["model"], res["epistemic"], res["crop"] = cfg.model, runner.epistemic, cfg.crop
    return res


def _citypersons(root, rng):
    """A tiny CityPersons tree — one 1024x2048 frame a split and the .mat
    annotations written by scipy — through ``process_dataset``, read back."""
    import scipy.io

    from bayesian_yolov3_torch.data import citypersons

    img_root = os.path.join(root, "cityscapes", "leftImg8bit_trainvaltest", "leftImg8bit")
    anno_dir = os.path.join(root, "citypersons", "annotations")
    os.makedirs(anno_dir)
    dt = np.dtype([("cityname", "O"), ("im_name", "O"), ("bbs", "O")])
    frames = {}
    for split in ("train", "val"):
        city, name = "smokecity", f"smokecity_{split}_000000.png"
        os.makedirs(os.path.join(img_root, split, city))
        frames[split] = seeded_frame(rng, (1024, 2048))
        with open(os.path.join(img_root, split, city, name), "wb") as f:
            f.write(pipeline.encode_png(frames[split], level=1))
        rec = np.zeros((1, 1), dtype=dt)
        rec[0, 0] = (np.asarray([city]), np.asarray([name]), np.asarray(
            [[1, 100, 200, 50, 120, 1, 0, 0, 0, 0], [2, 400, 300, 40, 100, 2, 0, 0, 0, 0],
             [0, 0, 0, 10, 10, 3, 0, 0, 0, 0], [3, 700, 100, 20, 60, 4, 0, 0, 0, 0]], np.uint16))
        arr = np.empty((1, 1), object)
        arr[0, 0] = rec
        scipy.io.savemat(os.path.join(anno_dir, f"anno_{split}.mat"),
                         {f"anno_{split}_aligned": arr})
    out_dir = os.path.join(root, "records")
    t0 = time.perf_counter()
    citypersons.process_dataset(out_dir=out_dir, dataset_name="cp",
                                anno_dir=os.path.join(root, "citypersons"),
                                img_dir=os.path.join(root, "cityscapes"), train_shards=1,
                                val_shards=1, shuffle=True)
    wall = time.perf_counter() - t0
    for split in ("train", "val"):
        recs = list(tfrecord.read_records(os.path.join(out_dir, f"cp-{split}-00001-of-00001"),
                                          verify=True))
        check(len(recs) == 1, f"citypersons {split}: {len(recs)} records")
        feats = proto.decode_example(recs[0])
        check(sorted(feats["image/object/class/label"]) == [1, 1, 2]
              and int(feats["image/object/cnt"][0]) == 3,
              f"citypersons {split}: labels {feats['image/object/class/label']}")
        check(np.array_equal(pipeline.decode_png(feats["image/encoded"][0]), frames[split]),
              f"citypersons {split}: the re-encoded frame's pixels differ")
    sizes = np.load(os.path.join(out_dir, "cp-train-box_sizes.npy"))
    check(sizes.shape == (3, 2), f"citypersons box sizes {sizes.shape}")
    return {"wall_s": wall, "records": 2, "box_sizes": sizes.tolist()}


def _trace_step(root, train_pattern, dev):
    """One pretraining step (bf16, the fused chain) inside ``trace`` with
    ``annotate`` around it: the Chrome trace's annotation, its CUDA events,
    and whether the kernels launched through ctypes appear by name."""
    from bayesian_yolov3_torch.cli import pretraining
    from bayesian_yolov3_torch.utils.profiling import annotate, trace

    cfg = train_config(root, pretraining.DEFAULTS, train_pattern, run_id="smoke_trace")
    trainer = train_loop.Trainer(cfg, device=dev)
    state = trainer.fresh_state()
    batch = trainer._place_batch(_global_batch(cfg))
    trainer.train_step_fn(state, batch)  # warm
    log_dir = os.path.join(root, "trace")
    with trace(log_dir) as prof:
        with annotate("smoke_train_step"):
            trainer.train_step_fn(state, batch)
    with open(os.path.join(log_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    names = {e.get("name", "") for e in kernels}
    seen = {k: any(k in n for n in names) for k in TRACED_KERNELS}
    check(any(e.get("name") == "smoke_train_step" for e in events),
          "trace: the annotation is missing")
    check(kernels, f"trace: no CUDA kernel event among {len(events)} events")
    device_us = sum(e.get("dur", 0) for e in kernels)
    return {"events": len(events), "cuda_kernel_events": len(kernels),
            "ctypes_kernels_in_trace": seen, "kernel_us_in_step": device_us,
            "trace_bytes": os.path.getsize(os.path.join(log_dir, "trace.json")),
            "key_averages_device_ms": sum(
                getattr(a, "device_time_total", getattr(a, "cuda_time_total", 0))
                for a in prof.key_averages()) / 1e3}


def main_path_tools(tmp, dev, card, json_dir=None, train_pattern=None):
    """The tools on the card's machine, without PIL, matplotlib or
    tensorflow: ``cli/vis_uncertainty.py`` on one seeded 1024x1920 PNG
    (bayesian, T=30, bf16, random weights from a checkpoint) — 99 PNGs, 3
    epistemic decode launches, the maps equal to the columns of the
    runner's decoded rows; the qualitative eval through
    ``cli/uncertainty_training.py`` and ``cli/yolov3_training.py`` with
    ``--set training=false`` on 2 frames; ``cli/evaluate_detections.py``
    on ``json_dir`` (None: a run of the epistemic runner over the 2 frames)
    against GT records of its frames; ``data/citypersons.py`` on a tiny
    tree; ``trace`` / ``annotate`` around one training step."""
    from bayesian_yolov3_torch.cli import (evaluate_detections, uncertainty_training,
                                           vis_uncertainty, yolov3_training)
    from bayesian_yolov3_torch.cli._common import build_config
    from bayesian_yolov3_torch.infer import vis as vis_mod
    from bayesian_yolov3_torch.infer.detect import load_img
    from bayesian_yolov3_torch.ops.decode import scale_plan

    root = os.path.join(tmp, "tools")
    rng = np.random.default_rng(31)
    frames = [seeded_frame(rng, IMG[:2]) for _ in range(2)]
    val_pattern = write_records(os.path.join(root, "val"), frames)
    ckpt = os.path.join(root, "ckpt")
    for run_id, model, seed in (("tools_bayes", "bayesian", 0), ("tools_std", "standard", 1)):
        cfg = Config(model=model, cls_cnt=C, checkpoint_path=ckpt, run_id=run_id)
        save_checkpoint(cfg, *random_state(seed, cfg.variant_spec, "cpu"), step=1)
    out = {"card": card}

    # the heatmaps, through the CLI
    png = os.path.join(root, "frame.png")
    with open(png, "wb") as f:
        f.write(pipeline.encode_png(frames[0], level=1))
    vis_dir = os.path.join(root, "vis")
    argv = ["--set", f"checkpoint_path={ckpt}", "--set", "run_id=tools_bayes"]
    reset_counters()
    t0 = time.perf_counter()
    written = vis_uncertainty.main([png, "--out-dir", vis_dir] + argv)
    torch.cuda.synchronize()
    launches = read_counters()
    res = {"cli_wall_s": time.perf_counter() - t0, "launches": launches, "pngs": len(written)}
    check(len(written) == VIS_PNGS == len(set(written)), f"vis: {len(written)} PNGs")
    check(all(_png_hw(p) == (IMG[0], IMG[1], 2) for p in written),
          "vis: a PNG is not 1024x1920 RGB")
    check(launches["epistemic_decode"] == 3 and launches["fused_stem"] == 1
          and launches["fused_res_block"] == 11 and launches["fused_downsample"] == 2
          and not launches["greedy_nms"], f"vis: launches {launches}")
    vis = vis_mod.UncertaintyVisualizer(build_config(vis_uncertainty.DEFAULTS, argv), device=dev)
    check(vis.config.T == T and vis.config.compute_dtype == "bfloat16",
          f"vis: T {vis.config.T}, {vis.config.compute_dtype}, not T={T} in bf16")
    img = load_img(png)
    maps = vis.maps(img)
    u8 = vis.runner._to_device(frames[0][None])
    rows = vis.runner._decoded_rows(vis.params, vis.stats, u8, vis.keys)[0].cpu().numpy()
    plan = scale_plan(vis.hws)
    for key, col in vis_mod.map_columns(C).items():
        for s, (off, (h, w)) in enumerate(zip(plan.row_off, plan.hws)):
            for p in range(3):
                want = rows[off + p * h * w:off + (p + 1) * h * w, col].reshape(h, w)
                check(np.array_equal(maps[key][s][..., p], want),
                      f"vis: map {key} scale {s} prior {p} differs from the rows' column {col}")
    res["maps_equal_rows"] = True
    res["device_ms"] = wall_ms(lambda: vis.maps(img), 3)
    render_ms = wall_ms(lambda: vis.render(img, os.path.join(root, "vis2"), tag="t"), 1)
    res["png_writing_ms"] = render_ms - res["device_ms"]
    out["vis_uncertainty"] = res
    del vis, rows, maps

    # the qualitative eval: bayesian (epistemic, T=20, crop) and batched standard (crop, 8
    # copies), each through its training CLI
    common = [f"checkpoint_path={ckpt}", f"val.file_pattern={val_pattern}",
              f"log_path={os.path.join(root, 'log')}", "cpu_thread_cnt=2"]
    qual = {}
    for name, cli, run_id, copies in (("bayesian", uncertainty_training, "tools_bayes", 2),
                                      ("standard", yolov3_training, "tools_std", 8)):
        argv = [a for kv in common + [f"run_id={run_id}"] for a in ("--set", kv)]
        q = _qualitative(cli, argv, frames, os.path.join(root, f"qual_{name}"), copies, dev)
        n = len(frames)  # one predict a frame: every copy in one batched call
        lk = q["launches"]
        decode = ({"epistemic_decode": 3 * n, "box_decode": 0} if q["epistemic"]
                  else {"epistemic_decode": 0, "box_decode": n})
        check(all(lk[k] == v for k, v in decode.items()) and lk["fused_stem"] == n
              and lk["fused_res_block"] == 11 * n and lk["fused_downsample"] == 2 * n
              and lk["greedy_nms"] >= n, f"qualitative {name}: launches {lk}")
        qual[name] = q
    check(qual["bayesian"]["epistemic"] and qual["standard"]["crop"],
          "qualitative: the eval configurations changed")
    out["qualitative"] = qual

    # evaluate_detections on the epistemic main path's JSON
    if json_dir is None:
        cfg = make_config(root, "tools_bayes", IMG, T, val_pattern,  # ckpt: root/ckpt
                          out_path=os.path.join(root, "out", "eval"))
        json_dir = InferenceRunner(cfg, seed=0, device=dev).run()
    names = sorted(os.path.splitext(f)[0] for f in os.listdir(json_dir) if f.endswith(".json"))
    gt = _gt_records(os.path.join(root, "gt"), names, rng)
    t0 = time.perf_counter()
    metrics = evaluate_detections.main([json_dir, "--set", f"data.file_pattern={gt}"])
    check(set(metrics) == {"per_class", "mAP"} and set(metrics["per_class"]) == set(range(C))
          and all(set(m) == {"ap", "lamr"} and all(np.isfinite(list(m.values())))
                  for m in metrics["per_class"].values()) and np.isfinite(metrics["mAP"]),
          f"evaluate_detections: {metrics}")
    out["evaluate_detections"] = {"wall_s": time.perf_counter() - t0, "frames": len(names),
                                  **metrics}

    out["citypersons"] = _citypersons(os.path.join(root, "citypersons"), rng)
    if train_pattern is None:
        train_pattern = write_train_records(os.path.join(root, "train"),
                                            np.random.default_rng(21), 8, IMG[:2])
    out["trace"] = _trace_step(root, train_pattern, dev)
    return out


# -- accuracy parity, the entry points, the multi-rank dry run --------------

PARITY_SHORT_STEPS = 10
# one production predict of one 1024x1920 frame: the fused early backbone
# (stem, 11 res blocks, 2 downsamples) and the epistemic decode a scale; NMS
# once, and once more where the certificate fails and the exact retry runs
PREDICT_LAUNCHES = {"fused_stem": 1, "fused_res_block": 11, "fused_downsample": 2,
                    "epistemic_decode": 3}
DRYRUN_RANKS = 4
# the dry run's float32 compositions on the card: the mc fused pipeline's
# moments and finalize, its int8 epilogue, the dp batched box decode, NMS
DRYRUN_KERNELS = ("epistemic_moments", "epistemic_finalize", "quant_epilogue", "box_decode",
                  "greedy_nms")


def _predict_launches(name, launches, nms_launches=None):
    """One predict's launches: PREDICT_LAUNCHES, no other kernel but NMS,
    which ran ``nms_launches`` times (None: at least once)."""
    others = {k: v for k, v in launches.items() if k != "greedy_nms"}
    check(others == {**dict.fromkeys(others, 0), **PREDICT_LAUNCHES}
          and (launches["greedy_nms"] >= 1 if nms_launches is None
               else launches["greedy_nms"] == nms_launches),
          f"{name}: launches {launches}, want {PREDICT_LAUNCHES} and greedy_nms "
          f"{nms_launches or '>= 1'}")


def _with_peak_gb(fn):
    """(fn(), peak device memory in GB while it ran)."""
    out = []
    gb = _peak_gb(lambda: out.append(fn()))
    return out[0], gb


def parity_short(dev):
    """The accuracy-parity flow of parity_fullres_torch.py at its geometry
    and inputs for PARITY_SHORT_STEPS steps: unfrozen float32 training
    (finite losses, every backbone leaf moved, no kernel launched: the
    training forward runs the plain convolutions), one production bf16
    predict (its launches) and one f32 twin pass on those weights (finite
    rows); ms a step, peak memory."""
    batch, gt = parity_fullres_torch.inputs(np.random.default_rng(0))
    cfg = eval_parity.overfit_config(IMG, 1, parity_fullres_torch.N_BOXES)
    init, _ = yolov3.YoloV3.from_config(cfg).init(torch.Generator().manual_seed(0), dev)
    losses, events = [], []

    def on_step(i, metrics):
        losses.append(metrics["total"].detach())
        events.append(torch.cuda.Event(enable_timing=True))
        events[-1].record()

    reset_counters()
    t0 = time.time()
    (params, stats, _), train_gb = _with_peak_gb(lambda: eval_parity.overfit(
        cfg, batch, PARITY_SHORT_STEPS, dev, on_step=on_step))
    train_s = time.time() - t0
    train_launches = read_counters()
    check(not any(train_launches.values()), f"parity_short training launched {train_launches}")
    losses = [float(v) for v in losses]
    check(len(losses) == PARITY_SHORT_STEPS and all(np.isfinite(losses)),
          f"parity_short losses {losses}")
    still = [n for (n, a), (_, b) in zip(_named_leaves(init["backbone"]),
                                          _named_leaves(params["backbone"])) if torch.equal(a, b)]
    check(not still, f"parity_short: backbone leaves that did not move: {still}")
    del init
    step_ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]

    runner = InferenceRunner(parity_fullres_torch.production_config(), device=dev)
    keys = runner.draw_keys()
    reset_counters()
    t1 = time.time()
    (rows, valid), predict_gb = _with_peak_gb(
        lambda: runner.predict(params, stats, batch["image"], keys))
    predict_s = time.time() - t1
    launches = read_counters()
    _predict_launches("parity_short predict", launches)
    t2 = time.time()
    ref, twin_gb = _with_peak_gb(
        lambda: eval_parity.reference_twin(params, stats, batch["image"], keys, dev))
    twin_s = time.time() - t2
    for name, (r, v) in (("production", (rows[0], valid[0])), ("twin", ref)):
        check(v.any() and np.isfinite(r[v]).all(), f"parity_short {name}: rows not finite")
    cmp = eval_parity.compare({0: (rows[0], valid[0])}, {0: ref}, gt, runner.spec, geometry=IMG,
                              T=T, train_steps=PARITY_SHORT_STEPS)
    return {"steps": PARITY_SHORT_STEPS, "losses": losses,
            "ms_per_step_median": float(np.median(step_ms)), "step_ms": step_ms,
            "peak_mem_GB_train": train_gb, "peak_mem_GB_predict_bf16": predict_gb,
            "peak_mem_GB_twin_f32": twin_gb, "train_s": train_s, "predict_s": predict_s,
            "twin_s": twin_s, "train_launches": train_launches, "predict_launches": launches,
            "backbone_leaves_moved": len(list(_named_leaves(params["backbone"]))),
            "rows": {"production": int(valid.sum()), "twin": int(ref[1].sum())},
            **{k: cmp[k] for k in ("mAP_production_bf16", "mAP_reference_f32", "abs_dmAP",
                                   "matched_confident_detections")}}


def entry_phase():
    """``dryrun.entry()`` on the card: its pipeline called twice on its
    example arguments, the outputs bit-equal; the first call's launches."""
    fn, args = dryrun.entry()
    reset_counters()
    first = fn(*args)
    torch.cuda.synchronize()
    launches = read_counters()
    _predict_launches("entry", launches, nms_launches=1)
    again = fn(*args)
    rows, valid, count = first
    check(rows.shape == (1000, 23) and valid.dtype == torch.bool and int(count) >= 0
          and bool(torch.isfinite(rows[valid]).all()), f"entry: rows {tuple(rows.shape)}")
    check(all(torch.equal(a, b) for a, b in zip(first, again)),
          "entry: a second call differs from the first")
    return {"launches": launches, "detections": int(count),
            "ms": event_ms(lambda: fn(*args), 5)}


def dryrun_phase():
    """``dryrun.dryrun_multichip(DRYRUN_RANKS)`` on the one card over gloo:
    every rank ran the mc, int8, dp batched and NMS kernels."""
    torch.cuda.empty_cache()
    t0 = time.time()
    ranks = dryrun.dryrun_multichip(DRYRUN_RANKS)
    wall = time.time() - t0
    for r in ranks:
        idle = [k for k in DRYRUN_KERNELS if not r["launches"][k]]
        check(not idle, f"dryrun rank {r['rank']}: no launch of {idle}")
    return {"wall_s": wall, "ranks": DRYRUN_RANKS, "per_rank": ranks}


def _numbers(d):
    """The flat numbers of a phase's result (no nested dicts, lists or flags)."""
    return {k: v for k, v in d.items()
            if isinstance(v, (int, float)) and not isinstance(v, bool)}


def _peaks(summary):
    return {name: run["peak_mem_GB"] for name, run in summary.items()
            if isinstance(run, dict) and "peak_mem_GB" in run}


def summarize(main_summary, timings, split, mc, mc2, b_summary, b_timings, gemm, int8, dp, sp,
              train, train_dp, tools, short, ent, dry):
    """One compact line of the numbers each phase measured (ms per frame,
    stages, all-reduce, peak memory of every run, launches per frame),
    printed just before the kernels line so that the end of the output
    holds it."""
    out = {"peak_mem_GB": {"epistemic": _peaks(main_summary), "batched": _peaks(b_summary)},
           "epistemic": {t["compute_dtype"]: _numbers(t) for t in timings}}
    out["mc_split_max_err_over_tolerance"] = {
        k: v["max_err_over_tolerance"] for k, v in split.items() if k.startswith("n_shards")}
    out["mc_one_rank_nccl"] = {dtype: {
        **r["timing"], "peak_mem_GB": r["peak_mem_GB"],
        "launches_per_frame": r["launches_per_frame"],
        "max_err_over_tolerance": max(a["max_err_over_tolerance"]
                                      for a in r["vs_single_device"])}
        for dtype, r in mc.items() if isinstance(r, dict) and "timing" in r}
    out["mc_two_ranks_gloo"] = {
        "phase_wall_s": mc2["phase_wall_s"],
        "json_vs_same_split_max_err_over_tolerance":
            mc2["json_vs_same_split_max_err_over_tolerance"],
        "json_vs_one_rank_paired_share": mc2["json_vs_one_rank_paired_share"],
        "per_rank": [{**_numbers(r), "run_loop": r["loop"]} for r in mc2["per_rank"]]}
    out["batched"] = [{"path": t["path"], "compute_dtype": t["compute_dtype"],
                       "png_decoder": t["png_decoder"], **_numbers(t)} for t in b_timings]
    epi, bat = int8["epistemic"], int8["batched"]
    out["int8"] = {
        "gemm_total_ms": gemm["total"], "int8_over_cudnn_bf16": gemm["int8_over_cudnn_bf16"],
        "epistemic": {"ms_per_img": {k: v["ms_per_img"] for k, v in epi["ms_per_img"].items()},
                      **epi["stages"], "peak_mem_GB_one_frame": epi["peak_mem_GB_one_frame"],
                      "peak_mem_GB_run": epi["peak_mem_GB"], "launches": epi["launches"],
                      "raws_max_err_over_scale": epi["raws_vs_bf16"]["max_err_over_scale"]},
        "mc_one_rank_nccl": {k: v for k, v in epi["mc_one_rank_nccl"].items()
                             if k != "vs_single_device"},
        "batched_aleatoric": {
            "ms_per_img": {k: v["ms_per_img"] for k, v in bat["ms_per_img"].items()},
            **bat["stages_per_batch"], "peak_mem_GB_one_batch": bat["peak_mem_GB_one_batch"],
            "launches": bat["aleatoric"]["launches"],
            "raws_max_err_over_scale": bat["aleatoric"]["raws_vs_bf16"]["max_err_over_scale"]}}
    out["dp"], out["sp"] = _ranks_summary(dp), _ranks_summary(sp)
    t = train["timing"]
    out["train"] = {
        **{k: t[k] for k in ("ms_per_step", "img_per_s", "preprocess_ms", "forward_loss_ms",
                             "backward_ms", "adam_ms", "loader_ms_per_batch",
                             "peak_mem_GB_one_step")},
        "run_wall_s": train["run_wall_s"], "launches_per_step": train["launches_per_step"],
        "fused_vs_plain": {
            "loss_rel_err": train["fused_vs_plain"]["bf16_step"]["loss_rel_err"],
            "backbone_rel_l2": train["fused_vs_plain"]["backbone_rel_l2"],
            **{f"{k}_grad_rel_l2": train["fused_vs_plain"]["float32_heads"][
                f"{k}_grad_rel_l2"] for k in ("max_det", "all_leaves_median", "all_leaves_p90")},
            "control_backbone_rel_l2": train["fused_vs_plain"]["control_backbone_rel_l2"],
            **{f"control_{k}_grad_rel_l2": train["fused_vs_plain"]["control_float32_heads"][
                f"{k}_grad_rel_l2"] for k in ("all_leaves_median", "all_leaves_p90")}},
        "cpu_vs_card_float32": {k: train["cpu_vs_card"][k]
                                for k in ("loss_rel_err", "all_leaves_max_grad_rel_l2")},
        "cpu_vs_card_float64": {k: train["cpu_vs_card"]["float64"][k]
                                for k in ("loss_rel_err", "all_leaves_max_grad_rel_l2")}}
    out["train_dp"] = {
        "phase_wall_s": train_dp["phase_wall_s"],
        "two_ranks_vs_one": {d: {k: v for k, v in a.items() if k != "tolerance"}
                             for d, a in train_dp["two_ranks_vs_one"].items()},
        "per_rank": [{k: r[k] for k in ("ms_per_step", "peak_mem_GB_one_step",
                                        "grad_all_reduce_MB", "grad_all_reduce_wall_ms",
                                        "bn_all_reduces_per_step",
                                        "bn_all_reduce_wall_ms_per_step", "launches_per_step",
                                        "run_wall_s")}
                     for r in train_dp["bfloat16"]["per_rank"]]}
    v, q = tools["vis_uncertainty"], tools["qualitative"]
    out["tools"] = {
        "vis": {k: v[k] for k in ("device_ms", "png_writing_ms", "cli_wall_s", "pngs")},
        "qualitative": {k: {"wall_s": r["wall_s"], "pngs": r["pngs"]} for k, r in q.items()},
        "evaluate_detections_mAP": tools["evaluate_detections"]["mAP"],
        "citypersons_wall_s": tools["citypersons"]["wall_s"],
        "trace": tools["trace"]}
    out["parity_short"] = {k: short[k] for k in (
        "ms_per_step_median", "peak_mem_GB_train", "peak_mem_GB_predict_bf16",
        "peak_mem_GB_twin_f32", "train_s", "predict_s", "twin_s", "predict_launches")}
    out["entry"] = {"ms": ent["ms"], "launches": ent["launches"]}
    out["dryrun"] = {"wall_s": dry["wall_s"],
                     "per_rank_s": [r["seconds"] for r in dry["per_rank"]]}
    return out


RANK_NUMBERS = ("ms_per_img", "launch_wall_ms_per_img", "peak_mem_GB_one_batch",
                "gather_wall_ms", "gather_bytes_per_rank", "peak_mem_GB", "run_wall_s", "ms_per_frame", "peak_mem_GB_one_frame",
                *(f"{label}_{k}_per_frame" for label in ("halo", "raw_gather", "all_reduce")
                  for k in ("bytes", "wall_ms")))


def _ranks_summary(phase):
    """A multi-rank phase's numbers by configuration: the agreement with the
    single device, its peak memory where read, each rank's numbers."""
    out = {"phase_wall_s": phase["phase_wall_s"]}
    for name, run in phase.items():
        if isinstance(run, dict) and "per_rank" in run:
            out[name] = {k: v for k, v in run.items() if k != "per_rank"}
            out[name]["per_rank"] = [{k: r[k] for k in RANK_NUMBERS if k in r}
                                     for r in run["per_rank"]]
    return out


def main():
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    kernels = []  # the kernel checks, as they pass
    error = None
    try:
        return smoke(card, kernels)
    except BaseException:
        error = traceback.format_exc()
        raise
    finally:
        write_record(card, kernels, error)


def smoke(card, kernels):
    t_start = time.time()
    dev = torch.device("cuda:0")
    emit("device", card=card, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.time()
    libs = _build.build_all(verbose=True)
    for name in libs:
        _build.load(name)
    emit("build", seconds=time.time() - t0, kernels=sorted(libs), flags=_build.NVCC_FLAGS)
    # registers, spills and static shared memory of the kernels redesigned for
    # Hopper, and any ptxas warning (a serialized wgmma, say); repeated in the
    # summary line, which the end of the output holds
    ptxas = {name: [ln.split(":", 1)[-1].strip()
                    for ln in _build.build_logs.get(name, "").splitlines()
                    if any(k in ln for k in ("registers", "spill", "entry function", "arning"))]
             for name in ("fused_stem", "fused_res_block", "fused_downsample", "greedy_nms",
                          "epistemic_decode", "epistemic_moments", "box_decode",
                          "epistemic_finalize", "quant_epilogue")}
    emit("ptxas", **ptxas)

    if sys.argv[1:] == ["--train"]:  # the training phase alone: no result line
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            emit("main_path_train", card=card, **main_path_train(tmp, dev, card))
        return 0
    if sys.argv[1:] == ["--train-dp"]:  # the dp training phase alone: no result line
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            emit("main_path_train_dp", **main_path_train_dp(tmp, dev, card))
        return 0
    if sys.argv[1:] == ["--tools"]:  # the tools phase alone: no result line
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            emit("main_path_tools", **main_path_tools(tmp, dev, card))
        return 0
    if sys.argv[1:] == ["--parity"]:  # parity_fullres_torch.py alone: no result line
        return parity_fullres_torch.main([])

    flush = torch.empty(128 * 1024 * 1024, dtype=torch.uint8, device=dev)  # > 50 MB L2
    kernels.extend([check_epistemic(dev, flush), check_nms(dev), check_stem(dev, flush),
                    check_res_block(dev, flush), check_downsample(dev, flush),
                    check_box_decode(dev, flush), check_epistemic_moments(dev, flush),
                    check_epistemic_finalize(dev, flush), check_quant_epilogue(dev, flush)])
    emit("kernels", card=card, kernels=kernels)
    gemm = int8_gemm(dev, flush)
    emit("int8_gemm", card=card, **gemm)
    del flush
    if sys.argv[1:] == ["--kernels"]:  # the kernel checks alone: no result line
        return 0

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        for dtype in ("float32", "bfloat16"):
            emit("small_ref", **small_reference(tmp, dev, dtype))
        runner, runner32, params, stats, frames, launches, summary = main_path(tmp, dev)
        emit("main_path", card=card, **summary)
        timings = [timing(r, params, stats, frames, dev, card) for r in (runner32, runner)]
        for t in timings:
            emit("timing", **t)
        q_runner, int8_launches, int8_epi = main_path_int8(tmp, dev, card, runner, params,
                                                           stats, frames)
        del q_runner
        split = mc_split(runner, params, stats, frames[0], dev)
        emit("mc_split", card=card, **split)
        mc_summary, mc_launches = main_path_mc(tmp, dev, card, (runner, runner32), params,
                                               stats, frames)
        emit("main_path_mc", **mc_summary)
        mc2 = main_path_mc_2ranks(tmp, dev, card, runner, params, stats)
        emit("main_path_mc_2ranks", **mc2)
        del runner, runner32, params, stats
        b_runner, b_runner32, b_frames, b_launches, b_summary = main_path_batched(tmp, dev)
        emit("main_path_batched", card=card, **b_summary)
        b_timings = [timing_batched(r, b_frames, dev, card) for r in (b_runner32, b_runner)]
        for t in b_timings:
            emit("timing", **t)
        int8_batched = main_path_batched_int8(tmp, dev, card, b_runner, b_frames)
        int8 = {"epistemic": int8_epi, "batched": int8_batched}
        emit("main_path_int8", card=card, **int8)
        dp = main_path_dp(tmp, dev, card, b_runner)
        emit("main_path_dp", **dp)
        sp = main_path_sp(tmp, dev, card, b_runner, b_runner32)
        emit("main_path_sp", **sp)
        del b_runner, b_runner32
        train = main_path_train(tmp, dev, card)
        emit("main_path_train", card=card, **train)
        t0 = time.time()
        train_dp = main_path_train_dp(tmp, dev, card)
        emit("main_path_train_dp", seconds=time.time() - t0, **train_dp)
        t0 = time.time()
        tools = main_path_tools(tmp, dev, card, json_dir=os.path.join(tmp, "out", "smoke_1"),
                                train_pattern=os.path.join(tmp, "train_data",
                                                           "train-*-of-*.tfrecord"))
        emit("main_path_tools", seconds=time.time() - t0, **tools)
    t0 = time.time()
    short = parity_short(dev)
    emit("parity_short", card=card, seconds=time.time() - t0, **short)
    t0 = time.time()
    ent = entry_phase()
    emit("entry", card=card, seconds=time.time() - t0, **ent)
    dry = dryrun_phase()
    emit("dryrun", card=card, **dry)

    # launches: each kernel's count from its own path's run — the epistemic
    # bf16 main path; for box_decode the batched aleatoric bf16 run; for the
    # moments and finalize kernels the bf16 run of the mc pipeline; for the
    # int8 epilogue the epistemic int8 run
    for k in kernels:
        path = {"box_decode": b_launches, "quant_epilogue": int8_launches,
                **{m: mc_launches for m in MC_KERNELS}}
        k["launches"] = path.get(k["name"], launches)[k["name"]]
    emit("summary", card=card, ptxas=ptxas, smoke_wall_s=time.time() - t_start,
         **summarize(summary, timings, split, mc_summary, mc2, b_summary, b_timings, gemm,
                     int8, dp, sp, train, train_dp, tools, short, ent, dry))
    emit("done", seconds=time.time() - t_start)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
