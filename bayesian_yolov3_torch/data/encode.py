"""Vectorized ground-truth encoding for the YOLO loss, batched on the device.

PyTorch counterpart of the JAX package's ``data/encode.py`` (which encodes
one example under ``vmap``); the semantics are the reference encoder's:

* per GT box, the responsible anchors are those that (a) lie in the grid
  cell containing the box center — ``0 <= lw*(x - cx) <= 1`` per axis —
  AND (b) achieve the globally best IoU across ALL anchors of ALL three
  scales (``iou >= max(iou)``, ties included);
* targets at responsible anchors::

      tx = logit(clip(lw*(x - cx), 1e-7, 1 - 1e-7))   (ty likewise)
      tw = log(max(w / prior.w, 1e-7))                (th likewise)

* anchors whose prior-grid IoU with ANY GT box >= ``ign_thresh`` get
  ``ign = 0`` (their objectness loss is masked), then ``ign = max(ign,
  obj)`` so responsible anchors always contribute;
* ORDER-DEPENDENT OVERWRITE: later boxes overwrite earlier ones at shared
  anchors — each anchor resolves to the highest-index claiming box.

Everything is one (batch, max_boxes, anchors) claims computation: at
768x1440 that is (60, 68 040) per crop.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..core.blueprint import ModelBlueprint

EPS = 1e-7

_COLUMNS = ("bboxes", "areas", "cx", "cy", "pw", "ph", "lw", "lh")


@dataclasses.dataclass(frozen=True)
class PriorTables:
    """Flattened per-anchor constants over all three scales: per scale
    row-major over (h, w, B), scales concatenated 32 -> 16 -> 8."""

    bboxes: np.ndarray  # (N, 4) [ymin, xmin, ymax, xmax] prior grid boxes
    areas: np.ndarray  # (N,) prior areas (h*w of the prior)
    cx: np.ndarray  # (N,) cell left edge / lw
    cy: np.ndarray  # (N,) cell top edge / lh
    pw: np.ndarray  # (N,)
    ph: np.ndarray  # (N,)
    lw: np.ndarray  # (N,) grid width of the anchor's scale
    lh: np.ndarray  # (N,)
    layer_sizes: Tuple[int, ...]  # anchors per scale
    layer_shapes: Tuple[Tuple[int, int, int], ...]  # (h, w, B) per scale

    def to(self, device) -> Dict[str, torch.Tensor]:
        """The per-anchor columns as float32 tensors on ``device``."""
        return {k: torch.from_numpy(getattr(self, k)).to(device) for k in _COLUMNS}


def build_prior_tables(blueprint: ModelBlueprint) -> PriorTables:
    """Numpy construction of the prior tables."""
    cols = {k: [] for k in _COLUMNS}
    sizes, shapes = [], []
    for scale in blueprint.det_scales:
        h, w, B = scale.h, scale.w, scale.boxes_per_cell
        rows = np.arange(h, dtype=np.float32)
        colsx = np.arange(w, dtype=np.float32)
        yc = ((rows + 0.5) / h)[:, None, None]  # (h,1,1)
        xc = ((colsx + 0.5) / w)[None, :, None]  # (1,w,1)
        ph = np.asarray([p.h for p in scale.priors], np.float32)[None, None, :]
        pw = np.asarray([p.w for p in scale.priors], np.float32)[None, None, :]
        shape = (h, w, B)
        bb = np.stack(
            [
                np.broadcast_to(yc - ph / 2, shape),
                np.broadcast_to(xc - pw / 2, shape),
                np.broadcast_to(yc + ph / 2, shape),
                np.broadcast_to(xc + pw / 2, shape),
            ],
            axis=-1,
        )
        cols["bboxes"].append(bb.reshape(-1, 4))
        cols["areas"].append(np.broadcast_to(ph * pw, shape).reshape(-1))
        cols["cx"].append(np.broadcast_to((colsx / w)[None, :, None], shape).reshape(-1))
        cols["cy"].append(np.broadcast_to((rows / h)[:, None, None], shape).reshape(-1))
        cols["pw"].append(np.broadcast_to(pw, shape).reshape(-1))
        cols["ph"].append(np.broadcast_to(ph, shape).reshape(-1))
        cols["lw"].append(np.full(h * w * B, w, np.float32))
        cols["lh"].append(np.full(h * w * B, h, np.float32))
        sizes.append(h * w * B)
        shapes.append(shape)
    return PriorTables(
        **{k: np.ascontiguousarray(np.concatenate(v).astype(np.float32))
           for k, v in cols.items()},
        layer_sizes=tuple(sizes),
        layer_shapes=tuple(shapes),
    )


def _logit(x):
    return -torch.log(1.0 / x - 1.0)


def encode_boxes(
    bboxes: torch.Tensor,
    labels: torch.Tensor,
    valid: torch.Tensor,
    tables: PriorTables,
    ign_thresh: float = 0.7,
    columns: Dict[str, torch.Tensor] = None,
) -> List[Dict[str, torch.Tensor]]:
    """Encode a batch of padded GT boxes into per-scale training targets.

    Args:
      bboxes: (NB, M, 4) float32, [ymin, xmin, ymax, xmax] normalized.
      labels: (NB, M) integer class ids (already background-shifted).
      valid: (NB, M) bool mask over the static padding.
      tables: the ``PriorTables`` of the model blueprint.
      ign_thresh: IoU ignore threshold (0.7).
      columns: ``tables.to(device)``, to skip the copy on every call.

    Returns one dict per scale with 'loc' (NB,h,w,B,4), 'obj'/'ign'
    (NB,h,w,B) float32 and 'cls' (NB,h,w,B) int32.
    """
    dev = bboxes.device
    t = columns if columns is not None else tables.to(dev)
    bboxes = bboxes.float()
    labels = labels.to(torch.int32)
    valid = valid.bool()

    w = bboxes[..., 3] - bboxes[..., 1]  # (NB, M)
    h = bboxes[..., 2] - bboxes[..., 0]
    x = (bboxes[..., 3] + bboxes[..., 1]) / 2.0
    y = (bboxes[..., 2] + bboxes[..., 0]) / 2.0

    # (NB, M, N) distances of box centers to each anchor's cell origin
    dist_x = t["lw"] * (x[..., None] - t["cx"])
    dist_y = t["lh"] * (y[..., None] - t["cy"])
    cell_mask = (dist_x >= 0.0) & (dist_x <= 1.0) & (dist_y >= 0.0) & (dist_y <= 1.0)

    # (NB, M, N) IoU of each GT box against the full prior grid; the union
    # uses the PRIOR area table
    bb = t["bboxes"]
    iy0 = torch.maximum(bb[:, 0], bboxes[..., 0:1])
    ix0 = torch.maximum(bb[:, 1], bboxes[..., 1:2])
    iy1 = torch.minimum(bb[:, 2], bboxes[..., 2:3])
    ix1 = torch.minimum(bb[:, 3], bboxes[..., 3:4])
    inter = torch.clamp(iy1 - iy0, min=0.0) * torch.clamp(ix1 - ix0, min=0.0)
    del iy0, ix0, iy1, ix1
    union = t["areas"] - inter + (h * w)[..., None]
    iou = inter / union
    del inter, union

    best = iou >= torch.amax(iou, dim=-1, keepdim=True)  # global argmax, ties kept
    claims = best & cell_mask & valid[..., None]
    ign_hit = ((iou >= ign_thresh) & valid[..., None]).any(dim=1)
    del best, cell_mask, iou

    # later boxes overwrite earlier ones: the winner is the highest
    # claiming index, a one-hot selector over M (all zero without a claim)
    m = bboxes.shape[-2]
    rank = torch.arange(1, m + 1, dtype=torch.int32, device=dev)[:, None] * claims.to(torch.int32)
    rank_max = torch.amax(rank, dim=-2, keepdim=True)
    sel = (rank == rank_max) & (rank_max > 0)
    obj = claims.any(dim=-2)  # (NB, N)
    del rank, claims

    self_f = sel.to(torch.float32)
    dx = torch.sum(dist_x * self_f, dim=-2)
    dy = torch.sum(dist_y * self_f, dim=-2)
    w_sel = torch.sum(w[..., None] * self_f, dim=-2)
    h_sel = torch.sum(h[..., None] * self_f, dim=-2)
    tx = _logit(torch.clamp(dx, EPS, 1.0 - EPS))
    ty = _logit(torch.clamp(dy, EPS, 1.0 - EPS))
    tw = torch.log(torch.clamp(w_sel / t["pw"], min=EPS))
    th = torch.log(torch.clamp(h_sel / t["ph"], min=EPS))

    objf = obj.to(torch.float32)
    loc = torch.stack([tx, ty, tw, th], dim=-1) * objf[..., None]
    cls = torch.sum(labels[..., None] * sel.to(torch.int32), dim=-2, dtype=torch.int32)
    ign = torch.maximum(1.0 - ign_hit.to(torch.float32), objf)

    nb = bboxes.shape[0]
    out = []
    off = 0
    for (gh, gw, gB), size in zip(tables.layer_shapes, tables.layer_sizes):
        sl = slice(off, off + size)
        out.append({
            "loc": loc[:, sl].reshape(nb, gh, gw, gB, 4),
            "cls": cls[:, sl].reshape(nb, gh, gw, gB),
            "obj": objf[:, sl].reshape(nb, gh, gw, gB),
            "ign": ign[:, sl].reshape(nb, gh, gw, gB),
        })
        off += size
    return out


def pad_boxes(bboxes: np.ndarray, labels: np.ndarray, max_boxes: int):
    """Pad variable-length GT to static (max_boxes, ...) + validity mask."""
    m = min(len(bboxes), max_boxes)
    out_b = np.zeros((max_boxes, 4), np.float32)
    out_l = np.zeros((max_boxes,), np.int32)
    out_v = np.zeros((max_boxes,), bool)
    if m:
        out_b[:m] = bboxes[:m]
        out_l[:m] = labels[:m]
        out_v[:m] = True
    return out_b, out_l, out_v
