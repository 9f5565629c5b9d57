#!/usr/bin/env python3
"""Accuracy parity at production geometry, on an NVIDIA GPU, for the
PyTorch/CUDA port — the twin of parity_fullres.py.

The project's accuracy contract (BASELINE.json): the production bf16
pipeline and an f32 reference-strategy twin give the same mAP (|dmAP| <=
1e-3) on trained weights.  The CPU suite shows it at 64x96
(tests/test_torch_accuracy_parity.py); this script shows it at ECP's
1024x1920, T=30, with the harness of ``bayesian_yolov3_torch/eval/parity.py``:

1. overfit the bayesian variant on ONE synthetic 1024x1920 image for 2000
   production train steps (aleatoric loss, unfrozen backbone with batch
   statistics through all 52 Darknet convs, true float32, lr 3e-3, batch
   1), then recover the final parameters' batch statistics;
2. run the same weights, image and (T, 15) key table through
   (a) ``InferenceRunner.predict`` in bf16 (the fused stem, res-block and
       downsample kernels, the epistemic decode kernel, the NMS kernel), and
   (b) the f32 twin (``mc_forward``, per-scale decode, exact NMS);
3. score both against the synthetic ground truth and compare the variance
   columns of matched detections.

The inputs are parity_fullres.py's, drawn in its order from
``np.random.default_rng(0)``: a uniform image and 3 pedestrian-shaped boxes
(height 0.15-0.3, width 0.04-0.08 of the image) at 0.05-0.6.

The run is deterministic (``deterministic``: cuDNN's deterministic
algorithms and ``torch.use_deterministic_algorithms``), so the same code
on the same card repeats it bit for bit.  Two witnesses on the trained
weights locate a failure of the comparison:

* the runner in float32 (the plain convolutions, the epistemic decode and
  NMS kernels) against the twin: the same masks and correct kernels give
  the same detections;
* the bf16 predict with every kernel replaced by its plain PyTorch version
  (``plain_kernels``; no kernel launches) against the bf16 predict: the
  same mAP means the gap to the twin is bf16 rounding, not a kernel.

Writes PARITY_FULLRES_TORCH.json (``--out``): parity_fullres.py's keys, the
witnesses, each pipeline's selected rows with an overflowing column, the
loss terms every 100 steps with that step's augmentation draws, the trained
weights' loss terms on the served image and on its mirror image, a
checksum of the trained weights,
the card's name and power limit, ms a training step (CUDA events, the
median after the first step), peak GB (``max_memory_allocated``) of the
training and of each pipeline, the seconds of each part; and
``chiprun_out/parity_fullres_torch.npz``: every pipeline's rows, the key
table, the ground truth and the recovered statistics.  Exits non-zero
unless the comparison passes and is non-vacuous.  Imports only the port,
torch and numpy; needs a CUDA device.

    python3 parity_fullres_torch.py [--out PATH]
"""

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch

from bayesian_yolov3_torch.config import Config
from bayesian_yolov3_torch.data import augment, encode
from bayesian_yolov3_torch.eval import parity
from bayesian_yolov3_torch.infer import runner as runner_module
from bayesian_yolov3_torch.infer.runner import InferenceRunner
from bayesian_yolov3_torch.ops import cuda_conv, cuda_epistemic, cuda_nms, launches
from bayesian_yolov3_torch.models.yolov3 import YoloV3
from bayesian_yolov3_torch.ops import nms as nms_module
from bayesian_yolov3_torch.train.loop import (dropout_keys, leaves, make_train_step,
                                              step_generator)

FULL = (1024, 1920, 3)
T = 30
STEPS = 2000
N_BOXES = 3
ROWS_OUT = os.path.join("chiprun_out", "parity_fullres_torch.npz")
SCORED = 0.05  # an anchor whose boxes the witnesses compare: scored this high by either side


def inputs(rng):
    """One image and its boxes, drawn as parity_fullres.py draws them.
    Returns (batch of 1 for ``parity.overfit``, ground truth {0: (boxes,
    labels + 1)})."""
    img = rng.uniform(0, 1, (1, *FULL)).astype(np.float32)
    yx = rng.uniform(0.05, 0.6, (1, N_BOXES, 2)).astype(np.float32)
    h = rng.uniform(0.15, 0.3, (1, N_BOXES, 1)).astype(np.float32)
    w = rng.uniform(0.04, 0.08, (1, N_BOXES, 1)).astype(np.float32)
    bbox = np.concatenate([yx, np.minimum(yx + np.concatenate([h, w], axis=2), 0.98)], axis=2)
    label = rng.integers(0, 2, (1, N_BOXES)).astype(np.int32)
    batch = {"image": (img * 255).astype(np.uint8), "bbox": bbox, "label": label,
             "valid": np.ones((1, N_BOXES), bool)}
    return batch, {0: (bbox[0], label[0] + 1)}


def production_config(compute_dtype: str = "bfloat16") -> Config:
    return Config(model="bayesian", full_img_size=FULL, T=T, inference_mode=True,
                  compute_dtype=compute_dtype, darknet53_weights="",
                  nms_max_boxes=parity.MAX_OUT)


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def deterministic() -> None:
    """Deterministic algorithms for every op of the run (cuDNN's among
    them; an op without one raises), so that a run repeats bit for bit.
    Call it before the first CUDA op."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True


@contextlib.contextmanager
def plain_kernels():
    """Inside, the bf16 predict runs every kernel's plain PyTorch version
    on the card's tensors in place of the kernel: the stem, residual and
    downsample wrappers, the epistemic decode and the greedy NMS."""
    with contextlib.ExitStack() as stack:
        for module, name, plain in (
                (cuda_conv, "fused_stem", cuda_conv.fused_stem_plain),
                (cuda_conv, "fused_res_block", cuda_conv.fused_res_block_plain),
                (cuda_conv, "fused_downsample", cuda_conv.fused_downsample_plain),
                (runner_module, "fused_epistemic_decode_cf_batched",
                 cuda_epistemic.epistemic_decode_plain),
                (nms_module, "greedy_nms_cuda", cuda_nms.greedy_nms_plain)):
            stack.enter_context(mock.patch.object(module, name, plain))
        yield


def _peak_gb(dev, fn):
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    out = fn()
    torch.cuda.synchronize(dev)
    return out, torch.cuda.max_memory_allocated(dev) / 1e9


def log(msg):
    print(msg, flush=True)


def _pipeline(name, dev, fn):
    """``fn() -> ((rows, valid), decoded rows of every anchor)`` of one
    pipeline, timed: its seconds, peak GB and kernel launches."""
    launches.reset()
    t0 = time.time()
    ((rows, valid), decoded), gb = _peak_gb(dev, fn)
    info = {"seconds": time.time() - t0, "peak_GB": gb,
            "launches": {k: v for k, v in launches.read().items() if v}}
    log(f"{name}: {int(valid.sum())} rows ({info['seconds']:.1f} s, {gb:.2f} GB, "
        f"launches {info['launches']})")
    rows, valid = (rows[0], valid[0]) if rows.ndim == 3 else (rows, valid)
    return (rows, valid, decoded.reshape(-1, decoded.shape[-1]).cpu().numpy()), info


def _runner_outputs(runner, params, stats, image, keys):
    """A runner's predict and the decoded rows of every anchor that its NMS
    selects from (the same device program, without the selection, run a
    second time: the pipeline's launches count both passes)."""
    decoded = runner._decoded_rows(params, stats, runner._to_device(image), keys)
    return runner.predict(params, stats, image, keys), decoded


def _detection_score(rows, spec):
    """Objectness mean x the largest class mean: what ``parity.score`` ranks."""
    cls0 = spec.cls_start_idx(epistemic=True)
    return rows[:, spec.obj_idx(epistemic=True)] * rows[:, cls0:cls0 + spec.cls_cnt].max(axis=1)


def witness(a, b, gt, spec) -> dict:
    """Two pipelines' (rows, valid, decoded) of the one image: ``a`` scored
    as the production side of ``parity.compare`` and ``b`` as the twin; and
    their decoded rows paired by anchor, before NMS: the largest difference
    of the detection score over every anchor, and of the box corners over
    the anchors that either pipeline scores >= SCORED and both decode to
    finite corners (an overflowing box size decodes to inf; those are
    counted)."""
    out = parity.compare({0: a[:2]}, {0: b[:2]}, gt, spec, geometry=FULL, T=T,
                         train_steps=STEPS)
    sa, sb = _detection_score(a[2], spec), _detection_score(b[2], spec)
    scored = np.maximum(sa, sb) >= SCORED
    finite = np.isfinite(a[2][:, :4]).all(axis=1) & np.isfinite(b[2][:, :4]).all(axis=1)
    return {"mAP_a": out["mAP_production_bf16"], "mAP_b": out["mAP_reference_f32"],
            "abs_dmAP": out["abs_dmAP"], "rows_a": int(a[1].sum()), "rows_b": int(b[1].sum()),
            "matched_confident_detections": out["matched_confident_detections"],
            "worst_matched_variance_rel_delta": out["worst_matched_variance_rel_delta"],
            "anchor_max_abs_score_delta": float(np.abs(sa - sb).max()),
            "anchors_scored": int(scored.sum()),
            "anchors_scored_with_infinite_box": int((scored & ~finite).sum()),
            "anchor_max_abs_box_delta_scored": (
                float(np.abs(a[2][scored & finite, :4] - b[2][scored & finite, :4]).max())
                if (scored & finite).any() else None)}


def _augmentation(step: int) -> dict:
    """Which augmentations training step ``step`` drew (``parity.overfit``'s
    seed 0; no crop)."""
    draw = augment.draw_batch(step_generator(0, step), 1, None, True)[0]["augment"]
    return {k: draw[k] is not None if k != "flip" else draw[k] for k in draw}


@torch.no_grad()
def orientation_losses(cfg, params, stats, batch, dev) -> dict:
    """The trained weights' loss terms (one training-mode forward with the
    last step's dropout keys) on the image as the pipelines serve it and on
    its mirror image, the one augmentation of the last step: which of the
    two the training fitted."""
    model = YoloV3.from_config(cfg)
    tables = encode.build_prior_tables(model.blueprint)
    step, _, _ = make_train_step(model, cfg, tables)
    img = torch.as_tensor(batch["image"][0]).to(dev).float() / 255.0
    bbox, label, valid = (torch.as_tensor(batch[k]).to(dev) for k in ("bbox", "label", "valid"))
    out = {}
    for flip in (False, True):
        x, b, lab = augment.augment(img, bbox[0], label[0],
                                    {"flip": flip, "blur": None, "color": None, "noise": None})
        gts = encode.encode_boxes(b[None], lab[None], valid, tables, cfg.ign_thresh,
                                  columns=tables.to(dev))
        _, (metrics, _) = step.loss_fn(params, {}, stats, x[None], gts, dropout_keys(0, STEPS))
        out["mirrored" if flip else "as_served"] = {k: float(v) for k, v in metrics.items()}
    return out


def run() -> dict:
    """Train the recipe, run the pipelines, compare; the result dict."""
    dev = torch.device("cuda")
    batch, gt = inputs(np.random.default_rng(0))
    cfg = parity.overfit_config(FULL, 1, N_BOXES)
    events, losses = [], {}
    t0 = time.time()

    def on_step(i, metrics):
        events.append(torch.cuda.Event(enable_timing=True))
        events[-1].record()
        if i % 100 == 0:
            losses[i] = {**{k: float(v) for k, v in metrics.items()},
                         "augmentation": _augmentation(i)}
            log(f"  step {i}: loss {losses[i]['total']:.2f} ({time.time() - t0:.0f} s)")

    start = torch.cuda.Event(enable_timing=True)
    start.record()
    (params, stats, metrics), train_gb = _peak_gb(
        dev, lambda: parity.overfit(cfg, batch, STEPS, dev, on_step=on_step))
    train_s = time.time() - t0
    step_ms = [a.elapsed_time(b) for a, b in zip([start] + events[:-1], events)]
    loss = float(metrics["total"])
    log(f"trained {STEPS} steps in {train_s:.0f} s, loss {loss:.3f}")

    by_orientation = orientation_losses(cfg, params, stats, batch, dev)
    log(f"final loss terms by orientation: {by_orientation}")
    image = batch["image"]
    prod = InferenceRunner(production_config(), device=dev)
    f32 = InferenceRunner(production_config("float32"), device=dev)
    keys = prod.draw_keys()
    runs = {
        "production_bf16": lambda: _runner_outputs(prod, params, stats, image, keys),
        "reference_f32": lambda: (
            parity.reference_twin(params, stats, image, keys, dev),
            parity.reference_decoded(params, stats, image, keys, dev)),
        "runner_f32": lambda: _runner_outputs(f32, params, stats, image, keys),
    }
    out_of, info = {}, {}
    for name, fn in runs.items():
        out_of[name], info[name] = _pipeline(name, dev, fn)
    with plain_kernels():
        out_of["plain_bf16"], info["plain_bf16"] = _pipeline(
            "plain_bf16", dev, lambda: _runner_outputs(prod, params, stats, image, keys))
    if info["plain_bf16"]["launches"]:
        raise RuntimeError(f"the plain pipeline launched {info['plain_bf16']['launches']}")

    spec = prod.spec
    out = parity.compare({0: out_of["production_bf16"][:2]}, {0: out_of["reference_f32"][:2]},
                         gt, spec, geometry=FULL, T=T, train_steps=STEPS)
    pairs = {"runner_f32_vs_twin": ("runner_f32", "reference_f32"),
             "plain_bf16_vs_kernel_bf16": ("plain_bf16", "production_bf16"),
             "plain_bf16_vs_twin": ("plain_bf16", "reference_f32"),
             "kernel_bf16_vs_twin": ("production_bf16", "reference_f32")}
    out.update({
        **{f"witness_{k}": witness(out_of[a], out_of[b], gt, spec) for k, (a, b) in pairs.items()},
        "pipelines": info,
        "card": card(), "device": torch.cuda.get_device_name(dev),
        "deterministic": torch.are_deterministic_algorithms_enabled(),
        "final_train_loss": loss, "train_losses_every_100": losses,
        "final_loss_terms_by_orientation": by_orientation,
        # selected rows with an overflowing column (an inf box side or variance)
        "nonfinite_rows": {k: int((~np.isfinite(o[0][o[1]])).any(axis=1).sum())
                           for k, o in out_of.items()},
        "weights_abs_sum": float(sum(float(w.double().abs().sum()) for w in leaves(params))),
        "ms_per_train_step_median": float(np.median(step_ms[1:] or step_ms)),
        "ms_first_train_step": step_ms[0],
        "peak_GB_train": train_gb, "peak_GB_predict_bf16": info["production_bf16"]["peak_GB"],
        "peak_GB_twin_f32": info["reference_f32"]["peak_GB"],
        "seconds": {"train": train_s, **{k: v["seconds"] for k, v in info.items()},
                    "total": time.time() - t0},
    })
    os.makedirs(os.path.dirname(ROWS_OUT), exist_ok=True)
    np.savez(ROWS_OUT, keys=np.asarray(keys), gt_boxes=gt[0][0], gt_labels=gt[0][1],
             **{f"{k}_rows": o[0] for k, o in out_of.items()},
             **{f"{k}_valid": o[1] for k, o in out_of.items()},
             **{f"{k}_anchor_scores": _detection_score(o[2], spec) for k, o in out_of.items()},
             **{f"stats/{n}": t.cpu().numpy() for n, t in _named(stats)})
    return out


def _named(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _named(v, f"{prefix}{k}/")
        else:
            yield prefix + k, v


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="PARITY_FULLRES_TORCH.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("parity_fullres_torch.py needs a CUDA device: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    deterministic()
    log(f"training at {FULL} on {torch.cuda.get_device_name(0)} ({card()})")
    out = run()
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out, indent=1))
    return 0 if (out["pass"] and out["nonvacuous"]) else 1


if __name__ == "__main__":
    sys.exit(main())
