"""Anchor decode, entropy / mutual-information math, epistemic reducers.

PyTorch counterparts of the JAX package's ``ops/decode.py``; the column
layouts are documented in core.blueprint.VariantSpec.

* box decode (identical in all three decoders)::

      x = (col + sigmoid(tx)) / lw        y = (row + sigmoid(ty)) / lh
      w = exp(tw) * prior.w               h = exp(th) * prior.h
      -> corners [y0, x0, y1, x1], normalized [0,1] image fractions.

* entropies use ``xlogy`` so a probability saturated to exactly 0/1 in
  float32 contributes exactly 0 (the correct limit) and not NaN.

All math runs in float32 regardless of the conv compute dtype.
"""

from __future__ import annotations

import functools
from typing import Dict, NamedTuple, Sequence, Tuple

import torch

from ..core.blueprint import VariantSpec


def split_detection(raw: torch.Tensor, spec: VariantSpec, boxes_per_cell: int = 3) -> Dict:
    """Split a raw head tensor (..., h, w, B*chpp) into named fields.

    Returns dict of (..., h, w, B, .) tensors: ``loc``, ``obj``, ``cls`` and
    for aleatoric heads also ``log_loc_var``, ``log_obj_stddev``,
    ``log_cls_stddev``.
    """
    C = spec.cls_cnt
    chpp = spec.head_channels_per_prior
    *lead, h, w, ch = raw.shape
    if ch != boxes_per_cell * chpp:
        raise ValueError(f"{ch} channels != {boxes_per_cell} priors x {chpp}")
    x = raw.reshape(*lead, h, w, boxes_per_cell, chpp).float()

    det = {"loc": x[..., 0:4]}
    if spec.aleatoric_head:
        det["log_loc_var"] = x[..., 4:8]
        det["obj"] = x[..., 8]
        det["log_obj_stddev"] = x[..., 9]
        det["cls"] = x[..., 10:10 + C]
        det["log_cls_stddev"] = x[..., 10 + C:10 + 2 * C]
    else:
        det["obj"] = x[..., 4]
        det["cls"] = x[..., 5:5 + C]
    return det


def _xlogx(p: torch.Tensor) -> torch.Tensor:
    return torch.special.xlogy(p, p)  # exactly 0 at p == 0


def logistic_entropy(p):
    """Binary entropy of a probability."""
    return -(_xlogx(p) + _xlogx(1.0 - p))


def softmax_entropy(p):
    """Categorical entropy over the last axis."""
    return -torch.sum(_xlogx(p), dim=-1)


def _decode_corners(loc: torch.Tensor, priors_hw: torch.Tensor) -> torch.Tensor:
    """loc (..., h, w, B, 4) -> corners (..., h, w, B, 4) as [y0,x0,y1,x1]."""
    h, w = loc.shape[-4], loc.shape[-3]
    ys = torch.arange(h, dtype=torch.float32, device=loc.device)[:, None, None]
    xs = torch.arange(w, dtype=torch.float32, device=loc.device)[None, :, None]
    ph = priors_hw[:, 0]  # (B,)
    pw = priors_hw[:, 1]

    x = (xs + torch.sigmoid(loc[..., 0])) / w
    y = (ys + torch.sigmoid(loc[..., 1])) / h
    bw = torch.exp(loc[..., 2]) * pw
    bh = torch.exp(loc[..., 3]) * ph

    w2, h2 = bw / 2.0, bh / 2.0
    return torch.stack([y - h2, x - w2, y + h2, x + w2], dim=-1)


def _prior_id_like(ones: torch.Tensor) -> torch.Tensor:
    """(..., h, w, B, 1) tensor holding the prior index along B."""
    B = ones.shape[-2]
    pid = torch.arange(B, dtype=torch.float32, device=ones.device)[:, None]
    return pid.expand_as(ones)


def decode_bbox_standard(det: Dict, priors_hw, layer_id: int = 0) -> torch.Tensor:
    """(..., h, w, B, 7+C): [y0,x0,y1,x1, obj, cls..., layer_id, prior_id]."""
    corners = _decode_corners(det["loc"], priors_hw)
    obj = torch.sigmoid(det["obj"])[..., None]
    cls = torch.softmax(det["cls"], dim=-1)
    ones = torch.ones_like(obj)
    return torch.cat([corners, obj, cls, layer_id * ones, _prior_id_like(ones)], dim=-1)


def decode_bbox_aleatoric(det: Dict, priors_hw, layer_id: int) -> torch.Tensor:
    """(..., h, w, B, 14+C) per VariantSpec layout."""
    corners = _decode_corners(det["loc"], priors_hw)
    loc_var = torch.exp(det["log_loc_var"])
    total_ale_var = torch.prod(loc_var, dim=-1, keepdim=True)
    obj = torch.sigmoid(det["obj"])
    cls = torch.softmax(det["cls"], dim=-1)
    ones = torch.ones_like(obj[..., None])
    return torch.cat(
        [
            corners,
            loc_var,
            total_ale_var,
            obj[..., None],
            logistic_entropy(obj)[..., None],
            cls,
            softmax_entropy(cls)[..., None],
            layer_id * ones,
            _prior_id_like(ones),
        ],
        dim=-1,
    )


def decode_epistemic_stats(det: Dict) -> Dict:
    """Reduce T MC samples (leading axis) to epistemic statistics.

    Input fields have shape (T, ..., h, w, B, .); outputs drop the T axis.
    """
    loc = det["loc"]
    loc_var = torch.exp(det["log_loc_var"])
    obj = torch.sigmoid(det["obj"])
    cls = torch.softmax(det["cls"], dim=-1)

    ev_loc = loc.mean(dim=0)
    # E[x x^T] - E[x] E[x]^T, per anchor (4x4)
    ev_xxT = (loc[..., :, None] * loc[..., None, :]).mean(dim=0)
    epi_covar_loc = ev_xxT - ev_loc[..., :, None] * ev_loc[..., None, :]

    obj_mean = obj.mean(dim=0)
    obj_pred_ent = logistic_entropy(obj_mean)
    obj_post_ent = logistic_entropy(obj).mean(dim=0)

    cls_mean = cls.mean(dim=0)
    cls_pred_ent = softmax_entropy(cls_mean)
    cls_post_ent = softmax_entropy(cls).mean(dim=0)

    return {
        "ev_loc": ev_loc,
        "epi_covar_loc": epi_covar_loc,
        "ale_var_loc": loc_var.mean(dim=0),
        "obj_mean": obj_mean,
        "obj_mutual_info": obj_pred_ent - obj_post_ent,
        "obj_entropy": obj_pred_ent,
        "cls_mean": cls_mean,
        "cls_mutual_info": cls_pred_ent - cls_post_ent,
        "cls_entropy": cls_pred_ent,
    }


def _det4(m: torch.Tensor) -> torch.Tensor:
    """Determinant of (..., 4, 4) by cofactor expansion along row 0 — the
    same expansion the epistemic decode kernel uses, elementwise, so no
    batched LU call is needed for millions of tiny matrices."""

    def det3(rows, cols):
        a = [[m[..., r, c] for c in cols] for r in rows]
        return (
            a[0][0] * (a[1][1] * a[2][2] - a[1][2] * a[2][1])
            - a[0][1] * (a[1][0] * a[2][2] - a[1][2] * a[2][0])
            + a[0][2] * (a[1][0] * a[2][1] - a[1][1] * a[2][0])
        )

    total = None
    for j in range(4):
        term = m[..., 0, j] * det3((1, 2, 3), [c for c in range(4) if c != j])
        signed = -term if j % 2 else term
        total = signed if total is None else total + signed
    return total


def decode_bbox_epistemic(stats: Dict, priors_hw, layer_id: int) -> torch.Tensor:
    """(..., h, w, B, 21+C) per VariantSpec layout."""
    corners = _decode_corners(stats["ev_loc"], priors_hw)
    epi_loc_var = torch.diagonal(stats["epi_covar_loc"], dim1=-2, dim2=-1)
    total_var_epi = _det4(stats["epi_covar_loc"])[..., None]
    ale_var_loc = stats["ale_var_loc"]
    total_var_ale = ale_var_loc.sum(dim=-1, keepdim=True)
    ones = torch.ones_like(stats["obj_mean"][..., None])
    return torch.cat(
        [
            corners,
            epi_loc_var,
            ale_var_loc,
            total_var_epi,
            total_var_ale,
            stats["obj_mean"][..., None],
            stats["obj_mutual_info"][..., None],
            stats["obj_entropy"][..., None],
            stats["cls_mean"],
            stats["cls_mutual_info"][..., None],
            stats["cls_entropy"][..., None],
            layer_id * ones,
            _prior_id_like(ones),
        ],
        dim=-1,
    )


def concat_all_scales(decoded: Sequence[torch.Tensor]) -> torch.Tensor:
    """Flatten per-scale decoded tensors to one (N_total, width) tensor.

    Row order: layer-major, then prior-major, then row-major cells — each
    per-prior (h, w, width) grid is flattened before the next prior is
    appended.
    """
    flat = []
    for d in decoded:
        h, w, B, width = d.shape
        flat.append(d.permute(2, 0, 1, 3).reshape(B * h * w, width))
    return torch.cat(flat, dim=0)


def concat_all_scales_batched(decoded: Sequence[torch.Tensor]) -> torch.Tensor:
    """Batched ``concat_all_scales``: [(NB, h, w, B, width), ...] ->
    (NB, N_total, width), same per-image row order."""
    flat = []
    for d in decoded:
        nb, h, w, B, width = d.shape
        flat.append(d.permute(0, 3, 1, 2, 4).reshape(nb, B * h * w, width))
    return torch.cat(flat, dim=1)


# cells of one (image, prior, scale) that a block of the one-launch decode
# kernels covers: SCALE_BLOCK of csrc/scale_table.cuh (both libraries export
# theirs, checked against this one when they load)
SCALE_BLOCK = 128


class ScalePlan(NamedTuple):
    """Where each scale's rows lie in one image's concatenated rows, and
    which blocks of a one-launch kernel's grid cover them."""

    hws: Tuple[Tuple[int, int], ...]  # (h, w) of each scale, in concat order
    n_priors: int
    row_off: Tuple[int, ...]  # first row of each scale in an image's rows
    rows: int  # rows of one image: n_priors * sum(h * w)
    first_block: Tuple[int, ...]  # first grid block of each scale, then the grid's extent


def scale_plan(hws: Sequence[Tuple[int, int]], n_priors: int = 3) -> ScalePlan:
    """The plan of ``concat_all_scales_batched``'s row order over scales of
    (h, w) ``hws``: per image, scale after scale, each prior-major then
    row-major cells; each scale's cells in blocks of ``SCALE_BLOCK``, a
    ragged last block per scale.  The finalize's packed sums use the same
    offsets times its row width (``packed_views``).  Cached: the kernels'
    wrappers ask for it at every call."""
    return _scale_plan(tuple((int(h), int(w)) for h, w in hws), int(n_priors))


@functools.lru_cache(maxsize=64)
def _scale_plan(hws, n_priors):
    row_off, first_block, rows, blocks = [], [], 0, 0
    for h, w in hws:
        row_off.append(rows)
        first_block.append(blocks)
        rows += n_priors * h * w
        blocks += -(-h * w // SCALE_BLOCK)
    return ScalePlan(hws, n_priors, tuple(row_off), rows, (*first_block, blocks))


def packed_views(packed: torch.Tensor, plan: ScalePlan, width: int, n_imgs: int = 1):
    """The per-scale (n_priors, width, n_imgs*h*w) blocks of a flat buffer of
    ``plan.rows * width * n_imgs`` elements, one after the other: scale s
    starts at element ``plan.row_off[s] * width * n_imgs``."""
    return [packed[off * width * n_imgs:(off + plan.n_priors * h * w) * width * n_imgs]
            .view(plan.n_priors, width, n_imgs * h * w)
            for off, (h, w) in zip(plan.row_off, plan.hws)]
