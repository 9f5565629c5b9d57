"""Model FLOPs counted from the configuration's conv shapes: 2 * H_out *
W_out * C_in * C_out * k^2 a conv (a multiply and an add per weight and
output pixel; batch norm, activations and the decode are not counted)."""

from __future__ import annotations

from typing import Dict

from reference import arch


def conv_flops(cfg: Dict, hw) -> Dict[str, float]:
    """FLOPs of one image's pass by section: ``backbone`` and ``heads`` (the
    head convs, transitions and detection convs) at image size ``hw``."""
    h, w = int(hw[0]), int(hw[1])
    out = {"backbone": 0.0, "heads": 0.0}
    for c in arch.convs(cfg["variant"], cfg["cls_cnt"]):
        f = 2.0 * (h // c.scale) * (w // c.scale) * c.cin * c.cout * c.k * c.k
        out["backbone" if c.section == "backbone" else "heads"] += f
    return out


def inference_per_image(cfg: Dict, hw=None) -> float:
    """The backbone once and the head section T times (T = 1 batched)."""
    f = conv_flops(cfg, hw or cfg["full_img_size"])
    return f["backbone"] + (cfg["T"] if cfg.get("epistemic") else 1) * f["heads"]


def training_per_image(cfg: Dict, hw) -> float:
    """The frozen backbone's forward, and the heads' forward and backward
    (the backward twice the forward: the input's gradient and the weights')."""
    f = conv_flops(cfg, hw)
    return f["backbone"] + 3.0 * f["heads"]
