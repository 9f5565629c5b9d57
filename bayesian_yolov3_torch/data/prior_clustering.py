"""IoU k-means anchor clustering from training box sizes — the counterpart
of the JAX package's ``data/prior_clustering.py``, the same numpy
arithmetic and draws (the same centres from the same seed).

The dataset creator (``data/citypersons.py``) saves the training boxes'
pixel sizes "for prior/anchor clustering"; this is the standard YOLO
k-means with 1 - IoU(h, w) distance over them, emitting the structure of
``core.priors`` (9 anchors, 3 a stride, largest first).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ..core.priors import Prior, PriorSet


def _wh_iou(boxes_hw: np.ndarray, centers_hw: np.ndarray) -> np.ndarray:
    """(N,2) x (K,2) IoU of corner-anchored (h,w) boxes."""
    inter = np.minimum(boxes_hw[:, None, 0], centers_hw[None, :, 0]) * np.minimum(
        boxes_hw[:, None, 1], centers_hw[None, :, 1]
    )
    area_b = boxes_hw[:, 0] * boxes_hw[:, 1]
    area_c = centers_hw[:, 0] * centers_hw[:, 1]
    return inter / (area_b[:, None] + area_c[None, :] - inter)


def kmeans_iou(
    boxes_hw: np.ndarray, k: int = 9, iters: int = 100, seed: int = 0
) -> np.ndarray:
    """YOLO anchor k-means with distance 1 - IoU.  Returns (k, 2) h,w
    sorted by area descending (the reference's prior ordering)."""
    boxes_hw = np.asarray(boxes_hw, np.float64)
    boxes_hw = boxes_hw[(boxes_hw > 0).all(axis=1)]
    if len(boxes_hw) < k:
        raise ValueError(f"need at least k={k} boxes of positive size, got {len(boxes_hw)}")
    rng = np.random.default_rng(seed)
    centers = boxes_hw[rng.choice(len(boxes_hw), k, replace=False)]
    assign = None
    for _ in range(iters):
        new_assign = np.argmax(_wh_iou(boxes_hw, centers), axis=1)
        if assign is not None and np.array_equal(new_assign, assign):
            break
        assign = new_assign
        for j in range(k):
            members = boxes_hw[assign == j]
            if len(members):
                centers[j] = np.median(members, axis=0)
    order = np.argsort(-(centers[:, 0] * centers[:, 1]))
    return centers[order]


def cluster_priors(
    box_sizes_px: np.ndarray, img_size_hw: Tuple[int, int], k: int = 9,
    seed: int = 0,
) -> PriorSet:
    """Pixel (h, w) training boxes -> normalized 9-anchor PriorSet.

    ``box_sizes_px`` is the ``<dataset>-train-box_sizes.npy`` artifact the
    dataset creator writes; ``img_size_hw`` the matching
    ``<dataset>-img_size_height_width.npy``.
    """
    norm = np.asarray(box_sizes_px, np.float64) / np.asarray(img_size_hw, np.float64)
    centers = kmeans_iou(norm, k=k, seed=seed)
    priors = [Prior(h=float(h), w=float(w)) for h, w in centers]
    third = k // 3
    return {32: priors[:third], 16: priors[third : 2 * third], 8: priors[2 * third :]}


def mean_best_iou(boxes_hw: np.ndarray, centers_hw: np.ndarray) -> float:
    """Clustering quality: average best-anchor IoU (YOLO's 'avg IoU')."""
    return float(np.mean(np.max(_wh_iou(np.asarray(boxes_hw, np.float64),
                                        np.asarray(centers_hw, np.float64)), axis=1)))
