"""Plain float32 reference of the configurations' whole inference path, in
PyTorch with TF32 off: Darknet-53, the three heads with MC hash dropout,
the 1x1 detection convs, the box / aleatoric / epistemic decode, all
written from the published description (YOLOv3, arXiv:1804.02767; the
Bayesian and aleatoric heads and their decoded outputs, arXiv:1905.10296).

It imports nothing of the program and takes nothing the program made: the
benchmark hands it the same seeded weights, frames and dropout keys it
hands the program, and it works out again what the program derives from
them (folded batch norm, the dropout masks, the decoded rows).  Layout is
NCHW throughout; only the dropout hash indexes the per-sample NHWC order,
which is the masks' definition.

The dropout divides by 1 - rate in the configuration's compute dtype
(``keep_divisor``): a constant of the configured function, as the weights
are.  Departures from the program, on purpose: the
epistemic covariance is the centred mean of products (the program forms
E[xx^T] - E[x]E[x]^T), and its determinant is ``torch.linalg.det``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from . import arch

BN_EPS = 1e-5
LEAKY = 0.1
_M32 = 0xFFFFFFFF
_MUL1 = 0x7FEB352D
_MUL2 = 0x846CA68B - (1 << 32)  # signed: congruent mod 2**32, products stay in int64


def exact_float32() -> None:
    """Float32 products in float32: cuDNN and cuBLAS would use TF32 otherwise."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def hash_keep(idx: torch.Tensor, key: int, thresh: int) -> torch.Tensor:
    """Keep iff a lowbias32-style hash of (flat index, key) has its low 16
    bits under ``thresh``; uint32 arithmetic written out on int64."""
    key = int(key) & _M32
    h = idx ^ key
    h = h ^ (h >> 16)
    h = (h * _MUL1) & _M32
    h = (h + key) & _M32
    h = h ^ (h >> 15)
    h = (h * _MUL2) & _M32
    h = h ^ (h >> 16)
    return (h & 0xFFFF) < thresh


def dropout(y: torch.Tensor, keys: Sequence[int], rate: float, keep: float) -> torch.Tensor:
    """Inverted hash dropout of S samples stacked sample-major on the batch
    axis of ``y`` (S*NB, C, h, w), one key a sample; the mask of an element
    is drawn at its flat index in the per-sample (NB, h, w, C) order, a kept
    element divided by ``keep``."""
    s = len(keys)
    nb, c, h, w = y.shape[0] // s, y.shape[1], y.shape[2], y.shape[3]
    idx = torch.arange(nb * h * w * c, dtype=torch.int64, device=y.device)
    idx = idx.view(nb, h, w, c).permute(0, 3, 1, 2)
    thresh = min(round((1.0 - rate) * 65536.0), 65535)
    out = torch.empty_like(y)
    for i, key in enumerate(keys):
        part = y[i * nb:(i + 1) * nb]
        out[i * nb:(i + 1) * nb] = torch.where(hash_keep(idx, key, thresh),
                                               part / keep, torch.zeros_like(part))
    return out


def conv_block(x, p, s, *, k: int, stride: int = 1, drop=None):
    """conv -> [dropout] -> batch norm on the moving statistics -> LeakyReLU,
    in ``x``'s dtype (float32, or the bf16 yardstick: products accumulated in
    float32, each layer's output rounded to bf16; batch norm in float32)."""
    y = F.conv2d(x, p["w"].to(x.dtype), stride=stride, padding=(k - 1) // 2)
    if drop is not None:
        y = drop(y)
    scale = p["gamma"].float() / torch.sqrt(s["var"].float() + BN_EPS)
    bias = p["beta"].float() - s["mean"].float() * scale
    y = y.float() * scale[:, None, None] + bias[:, None, None]
    return torch.where(y >= 0, y, LEAKY * y).to(x.dtype)


def backbone(params: Dict, stats: Dict, x: torch.Tensor):
    """x (N, 3, H, W) float32 in [0, 1] -> (out32, skip16, skip8)."""
    bp, bs = params["backbone"], stats["backbone"]
    specs = arch.backbone_specs()
    skips = {}

    def block(i, h):
        k, _, stride = specs[i]
        return conv_block(h, bp[f"conv_{i:02d}"], bs[f"conv_{i:02d}"], k=k, stride=stride)

    h, i = block(0, x), 1
    while i < len(specs):
        h, i = block(i, h), i + 1  # the stage's stride-2 conv
        while i < len(specs) and specs[i][2] == 1:
            h, i = h + block(i + 1, block(i, h)), i + 2
            skips[i - 1] = h
    return h, skips[arch.SKIP16_IDX], skips[arch.SKIP8_IDX]


def heads(params: Dict, stats: Dict, out32, skip16, skip8,
          site_keys: Optional[np.ndarray], rate: float, keep: float) -> List[torch.Tensor]:
    """The three heads; with a (T, 15) key table the backbone outputs are
    stacked T times sample-major and convs 0..4 of every head drop out.
    Returns the raw detection outputs (T*N, 3*chpp, h, w) per scale."""
    t = 1 if site_keys is None else site_keys.shape[0]

    def stacked(v):
        return v if t == 1 else v.repeat(t, 1, 1, 1)

    site, feats, x = 0, [], stacked(out32)
    for head, skip in ((1, None), (2, skip16), (3, skip8)):
        if skip is not None:
            x = conv_block(x, params[f"trans{head - 1}"], stats[f"trans{head - 1}"], k=1)
            x = x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
            x = torch.cat([x, stacked(skip)], dim=1)
        for j, (k, _) in enumerate(arch.HEAD_PLANS[head]):
            drop = None
            if site_keys is not None and j <= arch.BRANCH_IDX:
                keys = [int(v) for v in site_keys[:, site]]
                site += 1
                drop = lambda y, keys=keys: dropout(y, keys, rate, keep)  # noqa: E731
            name = f"head{head}_conv{j}"
            x = conv_block(x, params[name], stats[name], k=k, drop=drop)
            if j == arch.BRANCH_IDX:
                branch = x
        feats.append(x)
        x = branch
    # the detection convs' products of the inputs and weights as rounded to
    # the layers' dtype, in float32: float32 raw outputs
    return [F.conv2d(f.float(), params[f"det{h}"]["w"].to(f.dtype).float())
            + params[f"det{h}"]["b"].float()[:, None, None]
            for h, f in zip((1, 2, 3), feats)]


def _xlogx(p):
    return torch.special.xlogy(p, p)


def _corners(loc, priors_hw):
    """loc (..., B, 4, h, w) raw tx, ty, tw, th -> (..., B, h, w, 4) corners
    [y0, x0, y1, x1] as image fractions."""
    h, w = loc.shape[-2], loc.shape[-1]
    rows = torch.arange(h, dtype=torch.float32, device=loc.device)[:, None]
    cols = torch.arange(w, dtype=torch.float32, device=loc.device)[None, :]
    ph, pw = priors_hw[:, 0, None, None], priors_hw[:, 1, None, None]
    x = (cols + torch.sigmoid(loc[..., 0, :, :])) / w
    y = (rows + torch.sigmoid(loc[..., 1, :, :])) / h
    bw = torch.exp(loc[..., 2, :, :]) * pw
    bh = torch.exp(loc[..., 3, :, :]) * ph
    return torch.stack([y - bh / 2, x - bw / 2, y + bh / 2, x + bw / 2], dim=-1)


def _rows(cols: List[torch.Tensor], layer_id: int) -> torch.Tensor:
    """Columns (NB, B, h, w[, k]) -> rows (NB, B*h*w, width), prior-major then
    row-major cells, with the layer and prior id columns appended."""
    nb, b, h, w = cols[0].shape[:4]
    cols = [c if c.dim() == 5 else c[..., None] for c in cols]
    pid = torch.arange(b, dtype=torch.float32, device=cols[0].device)
    cols.append(torch.full((nb, b, h, w, 1), float(layer_id), device=cols[0].device))
    cols.append(pid[None, :, None, None, None].expand(nb, b, h, w, 1))
    return torch.cat(cols, dim=-1).reshape(nb, b * h * w, -1)


def decode_aleatoric(raw, priors_hw, cls_cnt: int, layer_id: int) -> torch.Tensor:
    """raw (NB, B*chpp, h, w) -> (NB, B*h*w, 14+C): corners, loc variances,
    their product, objectness and its entropy, class probabilities and their
    entropy, layer id, prior id."""
    nb, _, h, w = raw.shape
    r = raw.reshape(nb, arch.N_PRIORS, -1, h, w)
    loc_var = torch.exp(r[:, :, 4:8]).permute(0, 1, 3, 4, 2)
    obj = torch.sigmoid(r[:, :, 8])
    cls = torch.softmax(r[:, :, 10:10 + cls_cnt], dim=2).permute(0, 1, 3, 4, 2)
    return _rows([_corners(r[:, :, 0:4], priors_hw), loc_var, loc_var.prod(dim=-1),
                  obj, -(_xlogx(obj) + _xlogx(1 - obj)), cls, -_xlogx(cls).sum(dim=-1)],
                 layer_id)


def decode_epistemic(raw, t: int, priors_hw, cls_cnt: int, layer_id: int) -> torch.Tensor:
    """raw (T*NB, B*chpp, h, w) of T MC samples -> (NB, B*h*w, 21+C): corners
    of the mean location, the epistemic location variances (the diagonal of
    the samples' covariance), the mean aleatoric variances, the covariance's
    determinant, the variances' sum, mean objectness with its mutual
    information and entropy, mean class probabilities with theirs."""
    _, _, h, w = raw.shape
    r = raw.reshape(t, -1, arch.N_PRIORS, raw.shape[1] // arch.N_PRIORS, h, w)
    loc = r[:, :, :, 0:4]  # (T, NB, B, 4, h, w)
    ev = loc.mean(dim=0)
    d = (loc - ev).permute(0, 1, 2, 4, 5, 3)  # (T, NB, B, h, w, 4)
    cov = (d[..., :, None] * d[..., None, :]).mean(dim=0)
    ale = torch.exp(r[:, :, :, 4:8]).mean(dim=0).permute(0, 1, 3, 4, 2)
    obj = torch.sigmoid(r[:, :, :, 8])
    cls = torch.softmax(r[:, :, :, 10:10 + cls_cnt], dim=3).permute(0, 1, 2, 4, 5, 3)

    def h_bin(p):
        return -(_xlogx(p) + _xlogx(1 - p))

    def h_cat(p):
        return -_xlogx(p).sum(dim=-1)

    obj_m, cls_m = obj.mean(dim=0), cls.mean(dim=0)
    return _rows([_corners(ev, priors_hw), torch.diagonal(cov, dim1=-2, dim2=-1), ale,
                  torch.linalg.det(cov), ale.sum(dim=-1),
                  obj_m, h_bin(obj_m) - h_bin(obj).mean(dim=0), h_bin(obj_m),
                  cls_m, h_cat(cls_m) - h_cat(cls).mean(dim=0), h_cat(cls_m)], layer_id)


def keep_divisor(cfg: Dict, rate: float) -> float:
    """The dropout's divisor 1 - rate as the configuration states it: in its
    compute dtype (bf16(0.9) = 0.8984375 for a bfloat16 configuration, the
    scale the JAX package's ``x / keep`` takes for bf16 activations)."""
    dtype = getattr(torch, cfg.get("compute_dtype", "float32"))
    return float(torch.tensor(1.0 - rate, dtype=dtype))


def priors_by_stride(cfg: Dict, device) -> Dict[int, torch.Tensor]:
    return {s: torch.tensor(cfg["priors"][str(s)], dtype=torch.float32, device=device)
            for s in arch.STRIDES}


@torch.no_grad()
def decoded_rows(cfg: Dict, params: Dict, stats: Dict, images: torch.Tensor,
                 keys: Optional[np.ndarray], dtype=torch.float32):
    """uint8 NHWC images on the device (+ a (T, 15) key table for the
    epistemic configuration: batch 1) -> the decoded rows of every anchor,
    (NB, N_anchors, width), scale after scale (strides 32, 16, 8).
    ``dtype=torch.bfloat16`` gives the yardstick: the same function with
    every layer's output stored in bf16, the rounding that the
    configuration's compute dtype admits."""
    exact_float32()
    x = (images.permute(0, 3, 1, 2).float() / 255.0).to(dtype)
    out32, skip16, skip8 = backbone(params, stats, x)
    epistemic = bool(cfg.get("epistemic"))
    rate = cfg.get("drop_rate", 0.0)
    raws = heads(params, stats, out32, skip16, skip8, keys if epistemic else None,
                 rate, keep_divisor(cfg, rate))
    del out32, skip16, skip8
    pri = priors_by_stride(cfg, images.device)
    c = cfg["cls_cnt"]
    if epistemic:
        t = keys.shape[0]
        rows = [decode_epistemic(r, t, pri[s], c, i)
                for i, (r, s) in enumerate(zip(raws, arch.STRIDES))]
    else:
        rows = [decode_aleatoric(r, pri[s], c, i)
                for i, (r, s) in enumerate(zip(raws, arch.STRIDES))]
    return torch.cat(rows, dim=1)
