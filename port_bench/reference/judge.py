"""How the program's selected rows are judged against the reference's
decoded rows of the same image.  Plain PyTorch; it imports nothing of the
program and reads the program's rows only to judge them.

Every gap is measured twice: for the program's rows, and for the
yardstick's -- the same plain reference with each layer's output stored in
bf16, the configuration's compute dtype -- at the same anchors.  A number
is the program's gap over the yardstick's: about 1 for a program that
computes what the configuration states in the precision it states, and
several times that in a lower precision.  (The gaps themselves scale with
the magnitude of each seed's raw outputs, which varies threefold between
seeds; their ratio does not.)

Gaps, each a mean over an image's picks:

* ``box``: of a pick's corners from the reference's corners of the same
  anchor, in pixels over the box's extent plus one pixel;
* ``prob``: the widest absolute gap of the row's probability, entropy and
  mutual-information columns;
* ``var``: the widest gap of a variance column over the reference's value
  (plus a thousandth of that column's median over the picks);
* ``det``: the same for the covariance determinant (epistemic rows);
* ``pick``: greedy NMS replayed on the reference's scores and boxes in the
  pick order -- at each step, by how much the best candidate still alive
  outscores the pick.  A candidate counts as suppressed by a pick once their
  reference IoU exceeds the threshold less ``iou_slack``, so that a box pair
  on the threshold itself does not decide the number.  The yardstick's
  picks are its own exact greedy NMS.

``box``, ``prob``, ``var`` and ``det`` compare per image (the worst image
counts); ``pick``, whose gaps are zero at most steps, pools the images
checked: the sum of the program's gaps over the sum of the yardstick's.

A pick is matched to its anchor by its layer and prior columns and the cell
its centre lies in (of the 3x3 cells around it, the anchor whose reference
centre is nearest); a row whose id columns are not ids reads ``BAD``."""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

BAD = 1e30  # reading of a row that cannot be matched to an anchor


def columns(epistemic: bool, cls_cnt: int) -> Dict[str, list]:
    """Column groups of a decoded row (see the reference's decodes)."""
    c = cls_cnt
    if epistemic:  # width 21 + C
        return {"box": [0, 1, 2, 3], "var": list(range(4, 12)) + [13], "det": [12],
                "prob": [14, 15, 16] + list(range(17, 17 + c)) + [17 + c, 18 + c],
                "obj": 14}
    return {"box": [0, 1, 2, 3], "var": [4, 5, 6, 7, 8], "det": [],
            "prob": [9, 10] + list(range(11, 11 + c)) + [11 + c], "obj": 9}


def iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(n, 4) x (m, 4) corner boxes -> (n, m) IoU, as greedy NMS takes it."""
    area_a = (a[:, 2] - a[:, 0]).clamp(min=0) * (a[:, 3] - a[:, 1]).clamp(min=0)
    area_b = (b[:, 2] - b[:, 0]).clamp(min=0) * (b[:, 3] - b[:, 1]).clamp(min=0)
    iy0 = torch.maximum(a[:, None, 0], b[None, :, 0])
    ix0 = torch.maximum(a[:, None, 1], b[None, :, 1])
    iy1 = torch.minimum(a[:, None, 2], b[None, :, 2])
    ix1 = torch.minimum(a[:, None, 3], b[None, :, 3])
    inter = (iy1 - iy0).clamp(min=0) * (ix1 - ix0).clamp(min=0)
    return inter / (area_a[:, None] + area_b[None, :] - inter)


def match_anchors(ref: torch.Tensor, picks: torch.Tensor,
                  hws: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """Anchor index of every pick (K,), or None when an id column is no id."""
    width = ref.shape[1]
    layer, prior = picks[:, width - 2], picks[:, width - 1]
    if not (torch.isfinite(layer).all() and torch.isfinite(prior).all()):
        return None
    layer, prior = layer.round().long(), prior.round().long()
    if bool(((layer < 0) | (layer >= len(hws)) | (prior < 0) | (prior >= 3)).any()):
        return None
    dev = ref.device
    hs = torch.tensor([h for h, _ in hws], device=dev)[layer]
    ws = torch.tensor([w for _, w in hws], device=dev)[layer]
    offs = np.cumsum([0] + [3 * h * w for h, w in hws])[:-1]
    off = torch.tensor(offs, device=dev)[layer]
    cy = torch.nan_to_num((picks[:, 0] + picks[:, 2]) / 2, nan=0.0)
    cx = torch.nan_to_num((picks[:, 1] + picks[:, 3]) / 2, nan=0.0)
    row = (cy * hs).floor().long().clamp(min=0) + torch.tensor([-1, 0, 1], device=dev)[:, None, None]
    col = (cx * ws).floor().long().clamp(min=0) + torch.tensor([-1, 0, 1], device=dev)[None, :, None]
    row = torch.minimum(row.clamp(min=0), hs - 1)  # (3, 1, K)
    col = torch.minimum(col.clamp(min=0), ws - 1)  # (1, 3, K)
    cand = (off + prior * hs * ws + row * ws + col).reshape(9, -1)  # (9, K)
    # by the centre: it moves less than a cell, where a large box's corners
    # move by more than a cell between two precisions
    got = torch.stack([cy, cx], dim=-1)
    want = (ref[cand, 0:2] + ref[cand, 2:4]) / 2
    gap = (want - got[None]).abs().sum(dim=-1).nan_to_num(nan=float("inf"))
    return cand.gather(0, gap.argmin(dim=0, keepdim=True))[0]


def _rel(got, want):
    floor = 1e-3 * want.abs().median(dim=0).values + 1e-30
    return (got - want).abs() / (want.abs() + floor)


def replay_gaps(ref_boxes, ref_scores, anchors, max_out: int, thresh: float,
                slack: float) -> torch.Tensor:
    """Greedy NMS replayed on the reference's numbers in the program's pick
    order: the gap of every step (see the module's ``pick``)."""
    n, k = ref_scores.shape[0], anchors.shape[0]
    dev = ref_scores.device
    scores = ref_scores.nan_to_num(nan=float("-inf"))
    first = torch.full((n,), k, dtype=torch.long, device=dev)  # first suppressing pick
    for k0 in range(0, k, 256):
        a = anchors[k0:k0 + 256]
        hit = iou(ref_boxes[a], ref_boxes) > thresh - slack
        hit[torch.arange(a.shape[0], device=dev), a] = False
        steps = torch.arange(k0, k0 + a.shape[0], device=dev)[:, None]
        first = torch.minimum(first, torch.where(hit, steps, k).min(dim=0).values)
    picked = torch.full((n,), k, dtype=torch.long, device=dev)
    picked[anchors] = torch.arange(k, device=dev)
    last = torch.minimum(first, picked)  # alive at steps 0..last
    best = torch.full((k + 1,), float("-inf"), device=dev)
    best.scatter_reduce_(0, last, scores, "amax")
    best = best.flip(0).cummax(dim=0).values.flip(0)  # best alive score at each step
    gaps = (best[:k] - scores[anchors]).clamp(min=0)
    if k < max_out and bool(best[k] > float("-inf")):
        # stopped with a candidate alive: a step missed by the whole score range
        gaps = torch.cat([gaps, gaps.new_ones(1)])
    return gaps


def _errors(got, want, cols, img_hw):
    """Per-pick gaps of ``got`` from ``want`` (rows at the same anchors)."""
    h, w = img_hw
    px = torch.tensor([h, w, h, w], dtype=torch.float32, device=want.device)
    extent = torch.stack([want[:, 2] - want[:, 0], want[:, 3] - want[:, 1]] * 2, dim=1)
    out = {
        "box": ((got[:, :4] - want[:, :4]).abs() * px / (extent.abs() * px + 1.0)).amax(1),
        "prob": (got[:, cols["prob"]] - want[:, cols["prob"]]).abs().amax(1),
        "var": _rel(got[:, cols["var"]], want[:, cols["var"]]).amax(1),
    }
    if cols["det"]:
        out["det"] = _rel(got[:, cols["det"]], want[:, cols["det"]]).amax(1)
    return {k: torch.nan_to_num(v.float(), nan=BAD, posinf=BAD).clamp(max=BAD)
            for k, v in out.items()}


def greedy_nms(boxes: torch.Tensor, scores: torch.Tensor, max_out: int,
               thresh: float) -> torch.Tensor:
    """Exact greedy NMS over every candidate: the highest score left (ties
    to the lower index), then every candidate whose IoU with it exceeds
    ``thresh`` is suppressed; up to ``max_out`` picks.  Indices in pick
    order."""
    masked = torch.where(torch.isfinite(scores), scores, torch.full_like(scores, float("-inf")))
    picks = []
    for _ in range(max_out):
        i = int(torch.argmax(masked))  # the first of the maximal scores
        if masked[i] == float("-inf"):
            break
        picks.append(i)
        hit = iou(boxes[i:i + 1], boxes)[0] > thresh
        hit[i] = True
        masked = masked.masked_fill(hit, float("-inf"))
    return torch.tensor(picks, dtype=torch.long, device=scores.device)


@torch.no_grad()
def judge_image(ref: torch.Tensor, twin: torch.Tensor, rows: np.ndarray, valid: np.ndarray,
                *, epistemic: bool, cls_cnt: int, img_hw: Tuple[int, int], hws, max_out: int,
                thresh: float, slack: float) -> Dict[str, float]:
    """One image: ``ref`` (N, width) the float32 reference's rows of every
    anchor, ``twin`` the yardstick's, ``rows``/``valid`` the program's
    selection (max_out, width) in pick order.  Returns the image's gaps:
    ``<gap>`` the program's, ``<gap>_tw`` the yardstick's."""
    cols = columns(epistemic, cls_cnt)
    fams = ["box", "prob", "var"] + (["det"] if cols["det"] else [])
    picks = torch.as_tensor(np.asarray(rows)[np.asarray(valid, bool)], dtype=torch.float32,
                            device=ref.device)
    anchors = match_anchors(ref, picks, hws) if picks.shape[0] else None
    twin_picks = greedy_nms(twin[:, :4], twin[:, cols["obj"]], max_out, thresh)
    boxes, scores = ref[:, :4], ref[:, cols["obj"]]
    out = {"pick_tw": float(replay_gaps(boxes, scores, twin_picks, max_out, thresh,
                                        slack).sum())}
    if anchors is None:
        return {**out, **{f: BAD for f in fams}, **{f + "_tw": 1.0 for f in fams},
                "pick": BAD}
    want = ref[anchors]
    got = _errors(picks, want, cols, img_hw)
    yard = _errors(twin[anchors], want, cols, img_hw)
    for f in fams:
        out[f] = float(got[f].mean())
        out[f + "_tw"] = float(yard[f].mean())
    out["pick"] = float(replay_gaps(boxes, scores, anchors, max_out, thresh, slack).sum())
    return {k: min(v, BAD) for k, v in out.items()}


def numbers(readings: Sequence[Dict[str, float]]) -> Dict[str, float]:
    """The compared numbers over the images checked (see the module), and
    the gaps they come from (``<gap>_gap``, ``<gap>_tw``: the worst image's)."""
    out = {}
    for f in [k for k in readings[0] if k + "_tw" in readings[0] and k != "pick"]:
        out[f] = max(min(r[f] / max(r[f + "_tw"], 1e-30), BAD) for r in readings)
        out[f + "_gap"] = max(r[f] for r in readings)
        out[f + "_tw"] = max(r[f + "_tw"] for r in readings)
    got, yard = sum(r["pick"] for r in readings), sum(r["pick_tw"] for r in readings)
    out["pick"] = min(got / max(yard, 1e-30), BAD)
    out["pick_gap"], out["pick_tw"] = got, yard
    return {k: v if math.isfinite(v) else BAD for k, v in out.items()}
