"""Detection metrics: AP@IoU and log-average miss rate (LAMR / MR-2) —
the counterpart of the JAX package's ``eval/detection_metrics.py``, the
same numpy arithmetic.

The runners write ECP-format JSON, which the external ECP benchmark
toolkit scores; this module scores it in-framework:

* ``average_precision`` — PASCAL-style AP with all-point interpolation,
  greedy matching of score-sorted detections to the highest-IoU unmatched
  GT (match threshold IoU >= 0.5 by default).
* ``log_average_miss_rate`` — the Caltech/ECP pedestrian metric: miss rate
  averaged in log space over 9 FPPI anchors 10^-2 .. 10^0 (MR-2).
* ``evaluate_detections`` — per-class AP/LAMR + mAP over a dataset of
  {image: (boxes, scores, labels)} predictions and GT.

Boxes are [y0, x0, y1, x1] in any consistent coordinate scale.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np


def _iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(N,4) x (M,4) -> (N,M) IoU."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)))
    y0 = np.maximum(a[:, None, 0], b[None, :, 0])
    x0 = np.maximum(a[:, None, 1], b[None, :, 1])
    y1 = np.minimum(a[:, None, 2], b[None, :, 2])
    x1 = np.minimum(a[:, None, 3], b[None, :, 3])
    inter = np.clip(y1 - y0, 0, None) * np.clip(x1 - x0, 0, None)
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    union = area_a[:, None] + area_b[None, :] - inter
    return np.where(union > 0, inter / union, 0.0)


def _match_dataset(
    predictions: Dict, ground_truth: Dict, iou_thresh: float
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Greedy per-image matching.  Returns (scores, tp_flags, n_gt)."""
    scores: List[float] = []
    tps: List[bool] = []
    n_gt = 0
    for img_id, (gt_boxes,) in ((k, (np.asarray(v),)) for k, v in ground_truth.items()):
        n_gt += len(gt_boxes)
        boxes, det_scores = predictions.get(img_id, (np.zeros((0, 4)), np.zeros(0)))
        boxes = np.asarray(boxes, float).reshape(-1, 4)
        det_scores = np.asarray(det_scores, float)
        order = np.argsort(-det_scores, kind="stable")
        iou = _iou_matrix(boxes, gt_boxes.reshape(-1, 4))
        taken = np.zeros(len(gt_boxes), bool)
        for i in order:
            scores.append(det_scores[i])
            if len(gt_boxes) == 0:
                tps.append(False)
                continue
            j = int(np.argmax(np.where(taken, -1.0, iou[i])))
            if iou[i, j] >= iou_thresh and not taken[j]:
                taken[j] = True
                tps.append(True)
            else:
                tps.append(False)
    return np.asarray(scores), np.asarray(tps, bool), n_gt


def average_precision(
    predictions: Dict, ground_truth: Dict, iou_thresh: float = 0.5
) -> float:
    """predictions: {img_id: (boxes (N,4), scores (N,))};
    ground_truth: {img_id: boxes (M,4)}."""
    scores, tps, n_gt = _match_dataset(predictions, ground_truth, iou_thresh)
    if n_gt == 0:
        return float("nan")
    order = np.argsort(-scores, kind="stable")
    tps = tps[order]
    tp_cum = np.cumsum(tps)
    fp_cum = np.cumsum(~tps)
    recall = tp_cum / n_gt
    precision = tp_cum / np.maximum(tp_cum + fp_cum, 1)
    # all-point interpolation
    mrec = np.concatenate([[0.0], recall, [recall[-1] if len(recall) else 0.0]])
    mpre = np.concatenate([[1.0], precision, [0.0]])
    for i in range(len(mpre) - 2, -1, -1):
        mpre[i] = max(mpre[i], mpre[i + 1])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def log_average_miss_rate(
    predictions: Dict, ground_truth: Dict, iou_thresh: float = 0.5
) -> float:
    """MR-2: miss rate log-averaged over FPPI in [1e-2, 1e0] (9 points)."""
    scores, tps, n_gt = _match_dataset(predictions, ground_truth, iou_thresh)
    n_images = len(ground_truth)
    if n_gt == 0 or n_images == 0:
        return float("nan")
    order = np.argsort(-scores, kind="stable")
    tps = tps[order]
    tp_cum = np.cumsum(tps)
    fp_cum = np.cumsum(~tps)
    miss_rate = 1.0 - tp_cum / n_gt
    fppi = fp_cum / n_images

    anchors = np.logspace(-2.0, 0.0, 9)
    mrs = []
    for a in anchors:
        idx = np.where(fppi <= a)[0]
        mrs.append(miss_rate[idx[-1]] if len(idx) else 1.0)
    mrs = np.maximum(np.asarray(mrs), 1e-10)
    return float(np.exp(np.mean(np.log(mrs))))


def evaluate_detections(
    predictions: Dict, ground_truth: Dict, cls_ids: Sequence[int],
    iou_thresh: float = 0.5,
) -> Dict:
    """Per-class metrics + mAP.

    predictions: {img_id: (boxes (N,4), scores (N,), labels (N,))}
    ground_truth: {img_id: (boxes (M,4), labels (M,))}
    """
    out = {"per_class": {}}
    aps = []
    for c in cls_ids:
        preds_c = {}
        gts_c = {}
        for img_id, (gb, gl) in ground_truth.items():
            gb, gl = np.asarray(gb).reshape(-1, 4), np.asarray(gl)
            gts_c[img_id] = gb[gl == c]
        for img_id, (b, s, l) in predictions.items():
            b, s, l = np.asarray(b).reshape(-1, 4), np.asarray(s), np.asarray(l)
            keep = l == c
            preds_c[img_id] = (b[keep], s[keep])
        ap = average_precision(preds_c, gts_c, iou_thresh)
        lamr = log_average_miss_rate(preds_c, gts_c, iou_thresh)
        out["per_class"][int(c)] = {"ap": ap, "lamr": lamr}
        if not np.isnan(ap):
            aps.append(ap)
    out["mAP"] = float(np.mean(aps)) if aps else float("nan")
    return out
