"""Quantized (int8) head-section forwards.

PyTorch counterpart of the JAX package's ``models/quant.py``: two int8
twins sharing one quantized-head dict (``ops.quant.quantize_heads``):

* ``mc_forward_cf_q`` — the T-sample epistemic forward
  (``yolov3.mc_forward_cf``);
* ``forward_cf_q`` — the batched standard / aleatoric forward
  (``yolov3.forward_cf``).

Both walk the float heads' topology (``yolov3._walk_heads``), draw the same
dropout masks for the same key tables, and return the same channels-first
raw heads for the decode kernels; only the head convs' operands are int8.
The backbone stays in the compute dtype (it runs once per image); its three
outputs quantize at the calibrated entry scales.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..core.blueprint import Variant, VariantSpec
from ..ops.quant import quant_block, quant_detection_cf, quantize_act
from ..utils.profiling import annotate
from . import darknet
from .yolov3 import DROP_PROB, _batch_keys, _key_table, _walk_heads


def _heads_q(qh: Dict, q32: torch.Tensor, qs16: torch.Tensor, qs8: torch.Tensor, *,
             site_keys: Optional[np.ndarray] = None):
    """The int8 head section: the three int8 pre-detection feature maps.
    ``site_keys``: a (T, 15) dropout key table (T samples stacked
    sample-major) or None (one dropout-free pass), as ``yolov3._heads``."""

    def block(name, x, keys):
        return quant_block(qh[name], x, drop_rate=DROP_PROB if keys is not None else None,
                           drop_keys=keys)

    return _walk_heads(q32, qs16, qs8, site_keys, block)


def _backbone(params: Dict, stats: Dict, imgs, compute_dtype, fused_early, packed_hw):
    """The backbone's three outputs (stride 32, 16, 8)."""
    return darknet.darknet53(params["backbone"], stats["backbone"], imgs,
                             compute_dtype=compute_dtype, fused_early=fused_early,
                             packed_hw=packed_hw)[:3]


def _entry(qh: Dict, out32, skip16, skip8):
    """The backbone's three outputs quantized at the entry scales."""
    entry = qh["entry"]
    return (quantize_act(out32, entry["out32"]), quantize_act(skip16, entry["skip16"]),
            quantize_act(skip8, entry["skip8"]))


@torch.no_grad()
def forward_cf_q(qh: Dict, params: Dict, stats: Dict, imgs: torch.Tensor, *, spec: VariantSpec,
                 rng=None, standard_test_dropout: bool = False, compute_dtype=torch.bfloat16,
                 fused_early=None, packed_hw=None):
    """Quantized twin of ``yolov3.forward_cf``, the batched inference
    forward: the backbone once over the batch, entry quantization, the int8
    heads (dropout as ``forward_cf`` runs it), one int8 channels-first
    detection product per scale.  Returns [(raw_cf (ch, NB, h*w) float32,
    (h, w)), ...]."""
    outs = _backbone(params, stats, imgs, compute_dtype, fused_early, packed_hw)
    with annotate("byolo.heads"):
        feats = _heads_q(qh, *_entry(qh, *outs),
                         site_keys=_batch_keys(spec, rng, standard_test_dropout))
        return [(quant_detection_cf(qh[f"det{head}"], f), tuple(f.shape[1:3]))
                for head, f in enumerate(feats, start=1)]


@torch.no_grad()
def mc_forward_cf_q(qh: Dict, params: Dict, stats: Dict, img: torch.Tensor, *,
                    spec: VariantSpec, T: int, rng=None, compute_dtype=torch.bfloat16,
                    fused_early=None, packed_hw=None, fixed_masks=None):
    """Quantized twin of ``yolov3.mc_forward_cf`` (the same arguments and
    ``qh``): the backbone once, entry quantization, T stacked int8 head
    samples, one int8 channels-first detection product per scale.  Returns
    [(raw_cf (ch, T, NB*h*w) float32, (h, w)), ...]."""
    if spec.variant != Variant.BAYESIAN:
        raise ValueError("mc_forward_cf_q needs the bayesian variant")
    outs = _backbone(params, stats, img, compute_dtype, fused_early, packed_hw)
    nb = img.shape[0]
    out = []
    with annotate("byolo.heads"):
        feats = _heads_q(qh, *_entry(qh, *outs), site_keys=_key_table(rng, fixed_masks, T))
        for head, f in enumerate(feats, start=1):
            h, w, c = f.shape[1:]
            out.append((quant_detection_cf(qh[f"det{head}"], f.reshape(T, nb, h, w, c)),
                        (h, w)))
    return out
