"""Training loss: localization + objectness + class, with aleatoric
attenuation and L2 weight regularization.

PyTorch counterpart of the JAX package's ``ops/loss.py``:

* localization: squared error ``(gt.loc - det.loc)^2``; when
  ``aleatoric_loss`` it is attenuated Kendall-style with the predicted
  log-variance clipped to [-40, 40]::

      se * exp(-clip(log_var)) + clip(log_var)

  masked by ``gt.obj``; reduced ``sum / (2 * batch)``.
* objectness: sigmoid BCE on logits masked by the ignore mask ``gt.ign``;
  ``sum / batch``.
* class: sparse softmax cross-entropy masked by ``gt.obj``; ``sum / batch``.
* regularization: L2 (``scale * 0.5 * sum(w^2)``, scale 5e-4) over conv
  kernels and detection-head kernels+biases; BN params excluded.

The (disabled) Kendall logit-sampling obj/cls attenuation is provided as
``aleatoric_obj_loss`` / ``aleatoric_cls_loss``, with the normal draws as an
argument, and is not wired into ``total_loss`` (nor is it in the JAX
package).
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

L2_SCALE = 5e-4
LOG_VAR_CLIP = 40.0


def sigmoid_bce_with_logits(labels: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """Sigmoid cross-entropy as softplus(x) - x*z, written ``logaddexp(0, x)
    - x*z``: the value of TF's max(x,0) - x*z + log1p(exp(-|x|)) with the
    gradient sigmoid(x) - z everywhere, x == 0 included."""
    return torch.logaddexp(torch.zeros_like(logits), logits) - logits * labels


def sparse_softmax_ce_with_logits(labels: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """Sparse softmax cross-entropy over the last axis, as a one-hot
    contraction (an out-of-range label gives 0, as in the JAX package)."""
    logp = torch.log_softmax(logits, dim=-1)
    c = logits.shape[-1]
    in_range = (labels >= 0) & (labels < c)
    one_hot = F.one_hot(torch.where(in_range, labels, 0).long(), c).to(logp.dtype)
    one_hot = one_hot * in_range[..., None].to(logp.dtype)
    return -torch.sum(one_hot * logp, dim=-1)


def detection_layer_loss(det: Dict, gt: Dict, aleatoric_loss: bool = False) -> Dict:
    """Loss of one detection scale.

    det: dict of f32 tensors (b, h, w, B, ...) from ``ops.decode.split_detection``
    gt:  dict with 'loc' (b,h,w,B,4), 'obj' (b,h,w,B), 'cls' (b,h,w,B int),
         'ign' (b,h,w,B)
    """
    batch = float(det["loc"].shape[0])

    loc_loss = (gt["loc"] - det["loc"]) ** 2
    if aleatoric_loss:
        log_var = torch.clamp(det["log_loc_var"], -LOG_VAR_CLIP, LOG_VAR_CLIP)
        loc_loss = loc_loss * torch.exp(-log_var) + log_var
    loc_loss = loc_loss * gt["obj"][..., None]
    loc = torch.sum(loc_loss) / (2.0 * batch)

    obj_loss = sigmoid_bce_with_logits(gt["obj"], det["obj"]) * gt["ign"]
    obj = torch.sum(obj_loss) / batch

    cls_loss = sparse_softmax_ce_with_logits(gt["cls"], det["cls"]) * gt["obj"]
    cls = torch.sum(cls_loss) / batch

    return {"loc": loc, "obj": obj, "cls": cls}


def l2_regularization(params: Dict) -> torch.Tensor:
    """0.5 * L2_SCALE * sum of squares over conv kernels (+ det biases):
    every block's ``w``, the detection convs' ``w`` and ``b``; BN's gamma
    and beta excluded.  Includes the frozen backbone's kernels, constant
    with respect to the optimizer."""
    return L2_SCALE * 0.5 * _sumsq_conv_params(params)


def _sumsq_conv_params(tree: Dict) -> torch.Tensor:
    total = None
    for block in tree.values():
        if not isinstance(block, dict):
            continue
        if "w" in block or "b" in block:
            parts = [torch.sum(torch.square(block[k].float())) for k in ("w", "b") if k in block]
        else:
            parts = [_sumsq_conv_params(block)]
        for p in parts:
            total = p if total is None else total + p
    return total


def total_loss(
    dets: Sequence[Dict],
    gts: Sequence[Dict],
    params: Dict,
    aleatoric_loss: bool = False,
) -> Tuple[torch.Tensor, Dict]:
    """Aggregate across the three scales.  Returns (total, metrics) with the
    metric keys loc / obj / cls / detection / l2_weight_reg / total."""
    loc = obj = cls = None
    for det, gt in zip(dets, gts):
        part = detection_layer_loss(det, gt, aleatoric_loss)
        if loc is None:
            loc, obj, cls = part["loc"], part["obj"], part["cls"]
        else:
            loc, obj, cls = loc + part["loc"], obj + part["obj"], cls + part["cls"]
    detection = loc + obj + cls
    reg = l2_regularization(params)
    tot = detection + reg
    return tot, {
        "loc": loc,
        "obj": obj,
        "cls": cls,
        "detection": detection,
        "l2_weight_reg": reg,
        "total": tot,
    }


# --------------------------------------------------------------------------
# Kendall logit-sampling attenuation (implemented but disabled, as in the
# JAX package and the reference).  ``eps``: (T, *shape) standard normals.
# --------------------------------------------------------------------------


def aleatoric_obj_loss(det: Dict, gt: Dict, eps: torch.Tensor) -> torch.Tensor:
    stddev = torch.exp(torch.clamp(det["log_obj_stddev"], -40.0, 40.0))
    s = torch.sigmoid(det["obj"][None] + stddev[None] * eps)
    p = torch.where(gt["obj"][None] > 0.5, s, 1.0 - s)
    return -torch.log(torch.mean(p, dim=0))


def aleatoric_cls_loss(det: Dict, gt: Dict, eps: torch.Tensor) -> torch.Tensor:
    c = det["cls"].shape[-1]
    one_hot = F.one_hot(gt["cls"].long(), c).to(det["cls"].dtype)
    stddev = torch.exp(torch.clamp(det["log_cls_stddev"], -40.0, 40.0))
    s = torch.softmax(det["cls"][None] + stddev[None] * eps, dim=-1)
    p = torch.sum(s * one_hot[None], dim=-1)
    return -torch.log(torch.mean(p, dim=0))
