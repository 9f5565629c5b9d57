"""Accuracy parity of one trained model under two inference pipelines.

The project's accuracy contract: the production bf16 pipeline and an f32
reference-strategy twin give the same mAP (|dmAP| <= 1e-3) on trained
weights.  This module is the harness that shows it, at any geometry:

1. ``overfit``: train the bayesian variant on one fixed batch with the
   production train step (aleatoric loss, unfrozen backbone, float32,
   lr 3e-3), then recover the final parameters' exact BN batch statistics
   (``batch_statistics``): moving statistics at momentum 0.99 are far from
   converged after a few hundred steps, and inference on them is noise.
2. The same weights, images and (T, 15) key tables through
   (a) the production pipeline, ``InferenceRunner.predict`` in bf16 (on the
       card the fused conv, epistemic decode and NMS kernels), and
   (b) ``reference_twin``: float32, batch 1, ``mc_forward``, the per-scale
       decode of ``ops.decode`` and ``nms_select`` — the structure of the
       reference's inference_epistemic.py.
3. ``score`` and ``compare``: AP / LAMR of both against the ground truth
   (``eval.detection_metrics``), and the variance columns of matched
   detections; ``compare_orientations`` scores the served image and its
   mirror image (``mirrored``, the other orientation that the training's
   flip draws) pooled, with each orientation's result beside.

The dropout masks are a hash of (key, flat index) (``ops.common.hash_keep``),
so with one key table both pipelines draw the same masks: they differ in
conv precision only, which is the claim under test.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..config import Config
from ..core.blueprint import Variant, VariantSpec
from ..core.priors import priors_as_array
from ..data import encode
from ..models.yolov3 import YoloV3
from ..ops import decode, nms
from ..ops.common import BN_MOMENTUM
from ..train.loop import detached, dropout_keys, init_state, make_train_step, merge_params
from .detection_metrics import _iou_matrix, evaluate_detections

MATCH_IOU = 0.7  # a production detection matches its twin's at this IoU
MATCH_SCORE = 0.5  # and counts only when confident
DMAP_BOUND = 1e-3  # the contract's |dmAP|
NONVACUOUS_MAP = 0.05  # the twin must detect for the comparison to mean anything
MAX_OUT = 64  # boxes kept by either pipeline's NMS
ORIENTATIONS = ("served", "mirrored")  # image b of a scored set is ORIENTATIONS[b]


def overfit_config(img_size, batch_size: int, n_boxes: int) -> Config:
    """The harness's training configuration: the bayesian variant with the
    aleatoric loss, unfrozen backbone, float32, lr 3e-3, no Darknet file."""
    return Config(model="bayesian", full_img_size=tuple(img_size), batch_size=batch_size,
                  aleatoric_loss=True, max_boxes_per_img=n_boxes, lr=3e-3,
                  compute_dtype="float32", darknet53_weights="", freeze_darknet53=False)


def batch_statistics(stats_before: Dict, stats_after: Dict) -> Dict:
    """The batch statistics b of one update ``s' = 0.99 s + 0.01 b``:
    ``b = (s' - 0.99 s) / 0.01``, each ``var`` clamped at 1e-8."""
    out = {}
    for k, old in stats_before.items():
        new = stats_after[k]
        if isinstance(old, dict):
            out[k] = batch_statistics(old, new)
        else:
            b = (new - BN_MOMENTUM * old) / (1.0 - BN_MOMENTUM)
            out[k] = b.clamp_min(1e-8) if k == "var" else b
    return out


def overfit(config: Config, batch: Dict, steps: int, device, seed: int = 0,
            on_step=None):
    """Train ``steps`` production steps (``train.loop.make_train_step``) on
    the one fixed ``batch`` ({image uint8 NHWC, bbox, label, valid}, numpy
    or tensors) from the seeded init, then recover the final parameters'
    batch statistics from one more forward with batch statistics on the
    same batch (no update: the step's preprocessing and dropout draws, the
    parameters untouched).  ``on_step(i, metrics)`` is called after each
    step.  Returns (params, stats, metrics of the last step)."""
    model = YoloV3.from_config(config)
    tables = encode.build_prior_tables(model.blueprint)
    train_step, _, optimizer = make_train_step(model, config, tables, seed=seed)
    state = init_state(model, config, torch.Generator().manual_seed(seed), optimizer, device)
    batch = {k: torch.as_tensor(np.asarray(v)).to(device) for k, v in batch.items()}
    metrics = None
    for i in range(steps):
        state, metrics = train_step(state, batch)
        if on_step is not None:
            on_step(i, metrics)
    with torch.no_grad():
        imgs, gts = train_step.preprocess(batch, state["step"])
        _, (_, after) = train_step.loss_fn(state["params"], state["frozen"], state["stats"],
                                           imgs, gts, dropout_keys(seed, state["step"]))
        stats = batch_statistics(state["stats"], after)
        params = detached(merge_params(state["params"], state["frozen"]))
    return params, stats, metrics


@torch.no_grad()
def reference_decoded(params, stats, image_u8, keys, device) -> torch.Tensor:
    """The f32 reference-strategy decode of one uint8 NHWC image (1, H, W,
    3): ``mc_forward`` (batch 1) with the (T, 15) ``keys``, per scale
    ``split_detection`` -> ``decode_epistemic_stats`` ->
    ``decode_bbox_epistemic``, then ``concat_all_scales``: the rows of every
    anchor (N, 21+C), in the order of the runner's decoded rows."""
    keys = np.asarray(keys)
    image = torch.as_tensor(np.asarray(image_u8)).to(device)
    model = YoloV3.from_config(Config(model="bayesian", full_img_size=tuple(image.shape[1:]),
                                      T=keys.shape[0], inference_mode=True,
                                      compute_dtype="float32", darknet53_weights=""))
    priors = priors_as_array(model.priors)
    raws = model.mc_forward(params, stats, image.float() / 255.0, T=keys.shape[0], rng=keys)
    per_scale = []
    for i, (raw, stride) in enumerate(zip(raws, (32, 16, 8))):
        st = decode.decode_epistemic_stats(decode.split_detection(raw, model.spec))
        per_scale.append(decode.decode_bbox_epistemic(
            st, torch.from_numpy(priors[stride]).to(device), layer_id=i))
    return decode.concat_all_scales(per_scale)


@torch.no_grad()
def reference_twin(params, stats, image_u8, keys, device):
    """The f32 reference-strategy pipeline: ``reference_decoded``, then
    exact ``nms_select`` of MAX_OUT boxes.  Returns numpy (rows (MAX_OUT,
    21+C), valid)."""
    flat = reference_decoded(params, stats, image_u8, keys, device)
    obj = VariantSpec(Variant.BAYESIAN, flat.shape[1] - 21).obj_idx(epistemic=True)
    rows, valid, _ = nms.nms_select(flat, obj, max_out=MAX_OUT)
    return rows.cpu().numpy(), valid.cpu().numpy()


def score(rows_by_img: Dict, spec):
    """{image: (rows, valid)} -> (predictions for ``evaluate_detections``,
    variance columns).  Score = objectness mean x the largest class mean,
    label = that class + 1 (the implicit background), variances = columns
    4:14 (epistemic and aleatoric box variances, their totals)."""
    obj = spec.obj_idx(epistemic=True)
    cls0 = spec.cls_start_idx(epistemic=True)
    cls_cnt = spec.cls_cnt
    preds, variances = {}, {}
    for b, (rows, valid) in rows_by_img.items():
        r = rows[valid]
        cls_scores = r[:, cls0:cls0 + cls_cnt]
        preds[b] = (r[:, :4], r[:, obj] * cls_scores.max(axis=1),
                    cls_scores.argmax(axis=1) + 1)
        variances[b] = r[:, 4:14]
    return preds, variances


def compare(prod: Dict, ref: Dict, gt: Dict, spec, *, geometry, T: int,
            train_steps: int) -> Dict:
    """Score both pipelines' {image: (rows, valid)} against ``gt`` ({image:
    (boxes, labels)}), and hold the variance columns of every confident
    production detection (score >= 0.5) to its best-overlapping twin
    detection (IoU >= 0.7), relative to |twin| + 1e-7.  Returns the keys
    of the JAX package's PARITY_FULLRES.json, with each class's LAMR."""
    preds_prod, var_prod = score(prod, spec)
    preds_ref, var_ref = score(ref, spec)
    cls_ids = list(range(1, spec.cls_cnt + 1))
    m_prod = evaluate_detections(preds_prod, gt, cls_ids)
    m_ref = evaluate_detections(preds_ref, gt, cls_ids)
    n_matched, worst_rel = 0, 0.0
    for b in prod:
        bp, br = preds_prod[b][0], preds_ref[b][0]
        if not (len(bp) and len(br)):
            continue
        iou = _iou_matrix(bp, br)
        for i in range(len(bp)):
            j = int(iou[i].argmax())
            if iou[i, j] < MATCH_IOU or preds_prod[b][1][i] < MATCH_SCORE:
                continue
            n_matched += 1
            vp, vr = var_prod[b][i], var_ref[b][j]
            worst_rel = max(worst_rel, float(np.max(np.abs(vp - vr) / (np.abs(vr) + 1e-7))))
    delta = abs(m_prod["mAP"] - m_ref["mAP"])
    top = [float(p[1].max()) for p in preds_ref.values() if len(p[1])]
    return {
        "geometry": list(geometry), "T": T, "train_steps": train_steps,
        "mAP_production_bf16": m_prod["mAP"], "mAP_reference_f32": m_ref["mAP"],
        "abs_dmAP": delta,
        "ref_top_score": max(top) if top else 0.0,
        "ref_top_score_per_image": {str(b): float(p[1].max()) if len(p[1]) else 0.0
                                    for b, p in preds_ref.items()},
        "lamr_production_bf16": {str(c): v["lamr"] for c, v in m_prod["per_class"].items()},
        "lamr_reference_f32": {str(c): v["lamr"] for c, v in m_ref["per_class"].items()},
        "matched_confident_detections": n_matched,
        "worst_matched_variance_rel_delta": worst_rel,
        "nonvacuous": bool(m_ref["mAP"] > NONVACUOUS_MAP and n_matched >= 1),
        "pass": bool(delta <= DMAP_BOUND),
    }


def mirrored(image_u8, boxes):
    """An (N, H, W, 3) image batch flipped along its width, and its [y0, x0,
    y1, x1] boxes with x -> 1 - x (``data.augment.flip_lr``): the image in
    the other orientation that the training's flip draws."""
    b = np.asarray(boxes)
    flipped = np.stack([b[..., 0], 1.0 - b[..., 3], b[..., 2], 1.0 - b[..., 1]], axis=-1)
    return np.ascontiguousarray(np.asarray(image_u8)[:, :, ::-1]), flipped.astype(b.dtype)


def compare_orientations(prod: Dict, ref: Dict, gt: Dict, spec, **kw) -> Dict:
    """``compare`` of the pooled images ({b: ...}, image b in orientation
    ``ORIENTATIONS[b]``), with each orientation's own ``compare`` under
    ``by_orientation``; ``nonvacuous`` and ``pass`` are the pooled set's."""
    out = compare(prod, ref, gt, spec, **kw)
    out["by_orientation"] = {ORIENTATIONS[b]: compare({b: prod[b]}, {b: ref[b]}, {b: gt[b]},
                                                      spec, **kw) for b in sorted(prod)}
    return out
