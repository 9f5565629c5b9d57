"""Class-agnostic greedy NMS with fixed output shapes and an exactness
certificate for the pre-top-k restriction.

The greedy loop itself lives in ``ops.cuda_nms``: the CUDA kernel for CUDA
tensors, its plain PyTorch version for CPU tensors.  Selection order and
suppression semantics are TF's ``non_max_suppression``: suppress when IoU
is strictly greater than the threshold, ties toward the lower index.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..utils.profiling import annotate
from .cuda_nms import greedy_nms_cuda, greedy_nms_plain


def greedy_nms(boxes: torch.Tensor, scores: torch.Tensor, max_out: int = 1000,
               iou_thresh: float = 0.5) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain single-image greedy NMS (the kernel's reference).

    boxes (N, 4) [y0, x0, y1, x1], scores (N,) -> (indices (max_out,) int32,
    -1 padded past ``count``; count)."""
    idx, cnt = greedy_nms_plain(boxes.float()[None], scores.float()[None],
                                max_out, iou_thresh)
    return idx[0], cnt[0]


def nms_select_batch(
    decoded: torch.Tensor,
    obj_idx: int,
    max_out: int = 1000,
    iou_thresh: float = 0.5,
    pre_top_k: int = 0,
    with_certificate: bool = False,
):
    """NMS over flattened decoded rows (NB, N, width), scored by the
    objectness column; boxes are columns [0:4].

    ``pre_top_k > 0`` restricts the greedy loop to the top-k anchors by
    score.  ``with_certificate=True`` additionally returns a per-image
    boolean PROOF that the restricted selection equals exact full-anchor
    NMS:

        cert = (count == max_out) and (min selected score >= max excluded
               score)

    Soundness: by induction, at every greedy step the full-set argmax over
    alive candidates coincides with the restricted-set argmax — any
    excluded candidate scores <= the max excluded score <= every selected
    score, so it can only become the argmax after max_out selections have
    already been emitted.  Ties are safe only because the pre-top-k keeps
    the LOWEST indices among equal scores (a tied excluded candidate then
    has a higher index than its tied included peers, and greedy argmax
    breaks ties toward the lower index).  ``torch.topk`` gives no such
    order, so the top-k here is a STABLE descending sort.

    Returns (rows (NB, max_out, width) zero-padded, valid (NB, max_out)
    bool, count (NB,)[, cert (NB,) bool]).
    """
    nb, n, _ = decoded.shape
    excluded_max = None
    if pre_top_k and pre_top_k < n:
        top_scores, top_idx = torch.sort(decoded[:, :, obj_idx], dim=1,
                                         descending=True, stable=True)
        excluded_max = top_scores[:, pre_top_k]
        decoded = torch.gather(
            decoded, 1,
            top_idx[:, :pre_top_k, None].expand(nb, pre_top_k, decoded.shape[2]))
    boxes = decoded[:, :, :4].float().contiguous()
    scores = decoded[:, :, obj_idx].float().contiguous()
    indices, count = greedy_nms_cuda(boxes, scores, max_out, iou_thresh)
    valid = indices >= 0
    gather_idx = indices.clamp(min=0).long()[:, :, None].expand(nb, max_out, decoded.shape[2])
    rows = torch.gather(decoded, 1, gather_idx)
    rows = torch.where(valid[:, :, None], rows, torch.zeros_like(rows))
    if not with_certificate:
        return rows, valid, count
    if excluded_max is None:
        cert = torch.ones(nb, dtype=torch.bool, device=decoded.device)
    else:
        # a host scalar copied to the device blocks until the stream drains
        with annotate("byolo.wait.nms_scalar"):
            inf = torch.tensor(float("inf"), device=decoded.device)
        min_sel = torch.where(valid, rows[:, :, obj_idx], inf).min(dim=1).values
        cert = (count == max_out) & (min_sel >= excluded_max)
    return rows, valid, count, cert


def nms_select(
    decoded: torch.Tensor,
    obj_idx: int,
    max_out: int = 1000,
    iou_thresh: float = 0.5,
    pre_top_k: int = 0,
    with_certificate: bool = False,
):
    """Single-image ``nms_select_batch``: decoded (N, width) -> (rows
    (max_out, width), valid (max_out,), count[, cert])."""
    out = nms_select_batch(decoded[None], obj_idx, max_out, iou_thresh,
                           pre_top_k=pre_top_k, with_certificate=with_certificate)
    return tuple(o[0] for o in out)


def per_class_nms(
    decoded: torch.Tensor,
    obj_idx: int,
    cls_start_idx: int,
    cls_cnt: int,
    max_out: int = 1000,
    iou_thresh: float = 0.5,
):
    """Per-class NMS (the paper's variant).

    Boxes are partitioned by argmax class score; NMS runs per class with
    non-member scores masked to -inf; results are concatenated.

    Returns (selected (cls_cnt*max_out, width), valid, count).
    """
    winner = decoded[:, cls_start_idx:cls_start_idx + cls_cnt].argmax(dim=-1)
    boxes = decoded[None, :, :4].float().contiguous()
    neg_inf = torch.tensor(float("-inf"), device=decoded.device)
    all_rows, all_valid = [], []
    total = torch.zeros((), dtype=torch.int32, device=decoded.device)
    for c in range(cls_cnt):
        scores = torch.where(winner == c, decoded[:, obj_idx].float(), neg_inf)
        indices, count = greedy_nms_cuda(boxes, scores[None].contiguous(),
                                         max_out, iou_thresh)
        valid = indices[0] >= 0
        rows = decoded[indices[0].clamp(min=0).long()]
        all_rows.append(torch.where(valid[:, None], rows, torch.zeros_like(rows)))
        all_valid.append(valid)
        total = total + count[0]
    return torch.cat(all_rows), torch.cat(all_valid), total
