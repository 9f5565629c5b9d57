"""Post-training int8 quantization of the detection-head section.

PyTorch counterpart of the JAX package's ``ops/quant.py``, with weights
OIHW as this package keeps them:

* **weights**: per-output-channel symmetric int8 (the scale reduces over
  dims 1.. of OIHW).  The incoming activation scale is folded into the
  float weight first, over its cin axis (axis 1 of OIHW), so per-input-
  channel activation scales cost nothing — the two regions of the
  upsample + skip concat quantize exactly.
* **activations**: per-tensor symmetric int8 at scales calibrated from the
  per-site absolute maxima (or a percentile) of a few images
  (``calibrate_mc_amax``, ``calibrate_forward_amax``).
* **conv**: im2col of the int8 NHWC input (SAME padding, stride 1) and one
  int8 x int8 -> int32 matrix product, ``torch._int_mm`` (the JAX package
  left this conv to XLA; it is no Pallas kernel).
* **epilogue**: dequant -> hash dropout (the same ``hash_keep`` masks as the
  bf16 / float32 blocks for the same keys) -> BN affine -> LeakyReLU, in
  float32, then requant: one hand-written kernel on the card
  (``ops.cuda_quant``).

Scales and inverse scales that the kernels take by value are Python floats
holding float32 values.  Only the head section quantizes; the backbone runs
once per image in bf16 and its three outputs quantize at the entry scales.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch

from .common import _bn_affine
from .cuda_quant import quant_epilogue

QMAX = 127.0


def _f32(x: float) -> float:
    """``x`` rounded to float32, as a Python float."""
    return float(np.float32(x))


def quantize_weight_per_channel(w: torch.Tensor):
    """float (cout, ...) -> (int8 of the same shape, float32 (cout,) dequant
    scales): s[co] = max |w[co]| / 127, symmetric."""
    w = w.float()
    amax = w.abs().amax(dim=tuple(range(1, w.dim())))
    scale = torch.clamp(amax, min=1e-12) / QMAX
    wq = torch.clamp(torch.round(w / scale.view(-1, *[1] * (w.dim() - 1))), -QMAX, QMAX)
    return wq.to(torch.int8), scale


def quantize_act(x: torch.Tensor, inv_scale: float) -> torch.Tensor:
    """float / bf16 activations -> int8 at a per-tensor inverse scale."""
    return torch.clamp(torch.round(x.float() * inv_scale), -QMAX, QMAX).to(torch.int8)


def _im2col(x: torch.Tensor, k: int) -> torch.Tensor:
    """NHWC (n, h, w, c) -> (n*h*w, k*k*c), SAME zero padding, stride 1; the
    columns in (kh, kw, cin) order, as an OIHW kernel permuted to (O, kh,
    kw, I) flattens.  Where c % 8 == 0 the copies move the channels as
    int64 words, eight at a time (a strided byte copy is several times
    slower)."""
    n, h, w, c = x.shape
    if k == 1:
        return x.reshape(n * h * w, c)
    p = (k - 1) // 2
    xw = x.contiguous().view(torch.int64) if c % 8 == 0 else x
    xp = xw.new_zeros((n, h + 2 * p, w + 2 * p, xw.shape[-1]))
    xp[:, p:p + h, p:p + w] = xw
    cols = torch.cat([xp[:, i:i + h, j:j + w] for i in range(k) for j in range(k)], dim=-1)
    return cols.view(torch.int8).reshape(n * h * w, k * k * c)


def conv2d_int8(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """int8 NHWC x int8 OIHW -> int32 NHWC, SAME padding, stride 1 (the head
    section has no stride-2 convs).  Exact: im2col, then one int32-
    accumulating matrix product."""
    n, h, w, _ = x_q.shape
    cout, _, k, _ = w_q.shape
    wmat = w_q.permute(0, 2, 3, 1).reshape(cout, -1)  # (cout, k*k*cin)
    return torch._int_mm(_im2col(x_q, k), wmat.t()).reshape(n, h, w, cout)


def quant_block(qp: Dict, x_q: torch.Tensor, *, drop_rate: Optional[float] = None,
                drop_keys=None) -> torch.Tensor:
    """int8 twin of ``ops.common.conv_block`` (conv -> dropout -> BN ->
    leaky), int8 NHWC in and out.  ``qp``: {"wq" int8 OIHW, "dq" (cout,),
    "bns" / "bnb" folded BN, "inv_out" requant scale}; ``drop_keys``: one
    uint32 key per sample stacked on the leading axis."""
    drop = {}
    if drop_rate is not None and drop_rate > 0.0:
        if drop_keys is None:
            raise ValueError("dropout requires a key")
        drop = dict(keys=drop_keys, rate=drop_rate)
    acc = conv2d_int8(x_q, qp["wq"])
    n, h, w, cout = acc.shape
    y = quant_epilogue(acc.reshape(-1, cout), qp["dq"], qp["bns"], qp["bnb"], qp["inv_out"],
                       **drop)
    return y.reshape(n, h, w, cout)


def detection_acc_int8(wq: torch.Tensor, feats_q: torch.Tensor) -> torch.Tensor:
    """(ch, cin) int8 x (T, ..., cin) int8 -> int32 (ch, T, prod(...)), a
    strided view: one int8 product with the weight's rows zero-padded to a
    multiple of 8 (what the card's int8 product takes)."""
    t, cin = feats_q.shape[0], feats_q.shape[-1]
    m = math.prod(feats_q.shape[1:-1])
    ch = wq.shape[0]
    pad = -ch % 8
    w = torch.cat([wq, wq.new_zeros((pad, cin))]) if pad else wq
    acc = torch._int_mm(feats_q.reshape(t * m, cin), w.t())  # (T*M, ch + pad)
    return acc[:, :ch].t().reshape(ch, t, m)


def quant_detection_cf(qp: Dict, feats_q: torch.Tensor) -> torch.Tensor:
    """int8 twin of ``ops.common.detection_conv_cf``: feats (T, ..., cin)
    int8 -> (ch, T, prod(...)) float32, contiguous — the decode kernels'
    channels-first layout.  ``qp``: {"wq" (ch, cin) int8, "dq", "b"}."""
    acc = detection_acc_int8(qp["wq"], feats_q)
    out = torch.empty(acc.shape, dtype=torch.float32, device=acc.device)
    out.copy_(acc)
    return out.mul_(qp["dq"][:, None, None]).add_(qp["b"][:, None, None])


def quantize_heads(params: Dict, stats: Dict, spec, amax: Dict[str, float]) -> Dict:
    """The quantized-head dict from float params + calibration maxima.

    ``amax``: per-site absolute maxima — "out32" / "skip16" / "skip8" (the
    backbone outputs, the head section's entries) and one per head /
    transition block name (its post-LeakyReLU output, the next conv's
    input).  Returns per conv block {"wq" OIHW int8, "dq", "bns", "bnb",
    "inv_out"}, per detection conv {"wq" (ch, cin) int8, "dq", "b"}, and
    {"entry": {"out32", "skip16", "skip8"}} inverse entry scales; tensors on
    the params' device, scales Python floats."""
    from ..models.yolov3 import _BRANCH_IDX, _HEAD_PLANS, _TRANS_PLANS

    def s_of(name):
        return max(float(amax[name]), 1e-12) / QMAX

    qh: Dict = {"entry": {k: _f32(1.0 / s_of(k)) for k in ("out32", "skip16", "skip8")}}
    skip_scales = {2: s_of("skip16"), 3: s_of("skip8")}
    in_scale_vec = np.full((1024,), s_of("out32"), np.float32)
    prev_branch_scale = None
    for head in (1, 2, 3):
        if head > 1:
            tname = f"trans{head - 1}"
            branch_c = _HEAD_PLANS[head - 1][_BRANCH_IDX][1]
            qh[tname] = _quant_one(params[tname], stats[tname],
                                   np.full((branch_c,), prev_branch_scale, np.float32),
                                   s_of(tname))
            skip_c = {2: 512, 3: 256}[head]
            in_scale_vec = np.concatenate([
                np.full((_TRANS_PLANS[head - 1][1],), s_of(tname), np.float32),
                np.full((skip_c,), skip_scales[head], np.float32),
            ])
        for j, (_, cout) in enumerate(_HEAD_PLANS[head]):
            name = f"head{head}_conv{j}"
            qh[name] = _quant_one(params[name], stats[name], in_scale_vec, s_of(name))
            in_scale_vec = np.full((cout,), s_of(name), np.float32)
            if j == _BRANCH_IDX:
                prev_branch_scale = s_of(name)
        det = params[f"det{head}"]
        w = det["w"].float()[:, :, 0, 0]  # (ch, cin)
        wq, dq = quantize_weight_per_channel(
            w * torch.from_numpy(in_scale_vec).to(w.device)[None, :])
        qh[f"det{head}"] = {"wq": wq, "dq": dq, "b": det["b"].float()}
    return qh


def _quant_one(p: Dict, s: Dict, in_scale_vec: np.ndarray, out_scale: float) -> Dict:
    w = p["w"].float()
    wq, dq = quantize_weight_per_channel(
        w * torch.from_numpy(in_scale_vec).to(w.device)[None, :, None, None])
    bns, bnb = _bn_affine(p["gamma"].float(), p["beta"].float(), s["mean"].float(),
                          s["var"].float())
    return {"wq": wq, "dq": dq, "bns": bns, "bnb": bnb, "inv_out": _f32(1.0 / out_scale)}


def _percentile(a: torch.Tensor, percentile: float) -> torch.Tensor:
    """``jnp.percentile(a, percentile)`` of a flat tensor: linear
    interpolation between the two nearest order statistics, the position
    and weights in float32 as the JAX package computes them.  By
    ``kthvalue``, which takes tensors of any size (``torch.quantile`` stops
    at 2^24 elements)."""
    n = a.numel()
    pos = np.float32(np.float32(percentile) / np.float32(100.0)) * np.float32(n - 1)
    lo, hi = int(np.floor(pos)), int(np.ceil(pos))
    w_hi = np.float32(pos - np.float32(lo))
    w_lo = np.float32(1.0) - w_hi
    v_lo = torch.kthvalue(a, lo + 1).values
    v_hi = v_lo if hi == lo else torch.kthvalue(a, hi + 1).values
    return v_lo * float(w_lo) + v_hi * float(w_hi)


def _site_reduce(x: torch.Tensor, percentile: Optional[float]) -> torch.Tensor:
    """|x| -> a calibration scalar (0-dim tensor): the max, or the given
    percentile of |x| (e.g. 99.9: outliers beyond it saturate at +-127 and
    the bulk gets a finer grid)."""
    if percentile is None:
        return x.abs().max().float()
    return _percentile(x.float().abs().flatten(), percentile)


def _merge(amax: Dict[str, float], vals: Dict[str, torch.Tensor]):
    for n, v in vals.items():
        amax[n] = max(amax.get(n, 0.0), float(v))


@torch.no_grad()
def calibrate_forward_amax(params: Dict, stats: Dict, images: torch.Tensor, *, spec, rng=None,
                           compute_dtype=torch.float32, standard_test_dropout: bool = False,
                           fused_early=None, percentile=None) -> Dict[str, float]:
    """Per-site |activation| maxima for the BATCHED forwards: one forward per
    image (dropout as the batched path runs it: only the bayesian variant
    without ``standard_test_dropout``, keys from ``rng`` — a CPU
    ``torch.Generator`` that draws a (1, 15) table per image, or one table
    for every image), the three backbone outputs and every head / trans
    block's post-LeakyReLU output.  ``images``: (N, H, W, 3) float in [0, 1]
    on the params' device."""
    from ..models import darknet
    from ..models.yolov3 import _batch_keys, _heads

    amax: Dict[str, float] = {}
    for i in range(images.shape[0]):
        out32, skip16, skip8, _ = darknet.darknet53(
            params["backbone"], stats["backbone"], images[i:i + 1],
            compute_dtype=compute_dtype, fused_early=fused_early)
        cap: Dict[str, torch.Tensor] = {}
        _heads(params, stats, out32, skip16, skip8,
               site_keys=_batch_keys(spec, rng, standard_test_dropout),
               compute_dtype=compute_dtype, return_features=True, capture=cap)
        cap.update(out32=out32, skip16=skip16, skip8=skip8)
        _merge(amax, {n: _site_reduce(v, percentile) for n, v in cap.items()})
    return amax


@torch.no_grad()
def calibrate_mc_amax(params: Dict, stats: Dict, images: torch.Tensor, *, spec, T: int, rng,
                      compute_dtype=torch.float32, fused_early=None,
                      percentile=None) -> Dict[str, float]:
    """Per-site |activation| maxima over the MC sample distribution: per
    image the backbone once and the head section on T samples with dropout
    ACTIVE (the masks' 1/keep inflation is part of what is quantized); each
    sample's post-LeakyReLU outputs reduce on their own (max, or
    ``percentile``), then the max over samples and images.  ``rng``: a CPU
    ``torch.Generator`` that draws a (T, 15) key table per image, or one
    table for every image.  ``images``: (N, H, W, 3) float in [0, 1]."""
    from ..models import darknet
    from ..models.yolov3 import _heads, _key_table

    amax: Dict[str, float] = {}
    for i in range(images.shape[0]):
        out32, skip16, skip8, _ = darknet.darknet53(
            params["backbone"], stats["backbone"], images[i:i + 1],
            compute_dtype=compute_dtype, fused_early=fused_early)
        cap: Dict[str, torch.Tensor] = {}
        _heads(params, stats, out32, skip16, skip8, site_keys=_key_table(rng, None, T),
               compute_dtype=compute_dtype, return_features=True, capture=cap)
        # the max over samples of each sample's reduction (for max-abs: the max)
        vals = {n: _site_reduce(v, None) if percentile is None else
                torch.stack([_site_reduce(s, percentile) for s in v.reshape(T, -1)]).max()
                for n, v in cap.items()}
        vals.update({n: _site_reduce(v, percentile)
                     for n, v in (("out32", out32), ("skip16", skip16), ("skip8", skip8))})
        _merge(amax, vals)
    return amax
