"""Darknet-53 backbone and the darknet53.conv.74 binary weight importer.

Topology: conv32 then five downsample stages (64, 128, 256, 512, 1024)
with 1/2/8/8/4 residual blocks.  Skip activations are surfaced at stride 8
and stride 16 for the detection heads.  The backbone is a static spec list
of 52 convs; parameters are a flat dict keyed ``conv_00 .. conv_51`` in
weight-file order, the same names as the JAX package's pytrees.

Activations are NHWC at the function boundaries, kernels OIHW.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from ..ops.common import (
    _bn_affine, conv2d, conv_block, conv_block_train, init_conv_block, leaky_relu)
from ..utils.profiling import annotate

# (kernel_size, out_channels, stride); residual adds are implied by the
# stage structure below and applied in ``darknet53``.
_STAGES: Tuple[Tuple[int, int], ...] = ((64, 1), (128, 2), (256, 8), (512, 8), (1024, 4))


def _build_specs() -> List[Tuple[int, int, int]]:
    specs = [(3, 32, 1)]
    for cout, blocks in _STAGES:
        specs.append((3, cout, 2))
        for _ in range(blocks):
            specs.append((1, cout // 2, 1))
            specs.append((3, cout, 1))
    return specs


DARKNET53_CONV_SPECS: List[Tuple[int, int, int]] = _build_specs()
assert len(DARKNET53_CONV_SPECS) == 52

# conv indices whose (post-residual) activation feeds the det heads
SKIP8_IDX = 25
SKIP16_IDX = 42


def _conv_name(i: int) -> str:
    return f"conv_{i:02d}"


def init_darknet53(gen: torch.Generator, device="cpu") -> Tuple[Dict, Dict]:
    params, stats = {}, {}
    cin = 3
    for i, (k, cout, _) in enumerate(DARKNET53_CONV_SPECS):
        p, s = init_conv_block(gen, k, cin, cout, device)
        params[_conv_name(i)] = p
        stats[_conv_name(i)] = s
        cin = cout
    return params, stats


def _space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) -> (N, H/2, W/2, 4C); channel index (pi*2+pj)*C + c."""
    n, h, w, c = x.shape
    x = x.reshape(n, h // 2, 2, w // 2, 2, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(n, h // 2, w // 2, 4 * c)


def _stem_onehots():
    """Constant one-hot fold tensors (numpy, static).

    M3[di,dj,pi,pj,a,b,r,s] = 1 iff full-res tap (pi+di-1, pj+dj-1) lands in
    s2d block offset (a-1, b-1) at phase (r, s).  M2[di,dj,a,b,p,q] likewise
    for the stride-2 conv (block offsets {-1, 0} -> index a in {0, 1}).
    """
    m3 = np.zeros((3, 3, 2, 2, 3, 3, 2, 2), np.float32)
    for pi in range(2):
        for pj in range(2):
            for di in range(3):
                for dj in range(3):
                    ai, r = divmod(pi + di - 1, 2)
                    aj, s = divmod(pj + dj - 1, 2)
                    m3[di, dj, pi, pj, ai + 1, aj + 1, r, s] = 1.0
    fold = {0: (0, 1), 1: (1, 0), 2: (1, 1)}  # di -> (A+1, phase)
    m2 = np.zeros((3, 3, 2, 2, 2, 2), np.float32)
    for di in range(3):
        ai, p = fold[di]
        for dj in range(3):
            aj, q = fold[dj]
            m2[di, dj, ai, aj, p, q] = 1.0
    return m3, m2


_M3, _M2 = _stem_onehots()


def _stem_kernels(w1: torch.Tensor, w2: torch.Tensor):
    """Fold [conv1 3x3/s1 (cin->c1), conv2 3x3/s2 darknet-pad (c1->c2)] into
    space-to-depth-domain kernels (OIHW in, OIHW out).

    In the 2x2 space-to-depth domain the same math is one 3x3 conv
    (4*cin -> 4*c1, output channel (pi*2+pj)*c1+co = the phase-packed
    full-res conv1 output) and one 2x2 front-padded conv (4*c1 -> c2,
    consuming exactly the rows/cols the darknet-padded stride-2 conv
    reads).  Kernel entries that would read outside the original 3x3
    window stay zero, so results are equal up to float reduction order.
    """
    c1, cin = w1.shape[0], w1.shape[1]
    c2 = w2.shape[0]
    m3 = torch.as_tensor(_M3, dtype=w1.dtype, device=w1.device)
    m2 = torch.as_tensor(_M2, dtype=w2.dtype, device=w2.device)
    # out channel (pi, pj, o), in channel (r, s, c), taps (a, b)
    k3 = torch.einsum("ijpqabrs,ocij->pqorscab", m3, w1).reshape(4 * c1, 4 * cin, 3, 3)
    # out channel o, in channel (p, q, c), taps (a, b)
    k2 = torch.einsum("ijabpq,ocij->opqcab", m2, w2).reshape(c2, 4 * c1, 2, 2)
    return k3, k2


def _fast_stem(params, stats, x, compute_dtype):
    """conv_00 + conv_01 evaluated in the space-to-depth domain.

    Inference/frozen-BN only.  Returns the (N, H/2, W/2, c2) activation
    that the plain path's second conv block produces.
    """
    p0, s0 = params[_conv_name(0)], stats[_conv_name(0)]
    p1, s1 = params[_conv_name(1)], stats[_conv_name(1)]
    k3, k2 = _stem_kernels(p0["w"].to(compute_dtype), p1["w"].to(compute_dtype))
    xs = _space_to_depth(x.to(compute_dtype))
    y = conv2d(xs, k3, stride=1).float()
    scale, bias = _bn_affine(p0["gamma"], p0["beta"], s0["mean"], s0["var"])
    y = leaky_relu(y * scale.repeat(4) + bias.repeat(4))
    h = conv2d(y.to(compute_dtype), k2, padding=((1, 0), (1, 0))).float()
    scale, bias = _bn_affine(p1["gamma"], p1["beta"], s1["mean"], s1["var"])
    return leaky_relu(h * scale + bias).to(compute_dtype)


# 1/255 rounded to bf16: the packed input's scale, as the JAX package's
# ``x.astype(bf16) * bf16(1/255)`` takes it
_INV255_BF16 = float(torch.tensor(1.0 / 255.0, dtype=torch.bfloat16))


def _fused_early_stages(params, stats, x, compute_dtype, packed_hw=None):
    """Convs 0-25 — space-to-depth stem, res64, stride-2 64->128, res128 x2,
    stride-2 128->256, res256 x8 — through the fused conv kernels of
    ``ops.cuda_conv`` (hand-written CUDA on a CUDA tensor, their plain
    versions on a CPU tensor).  Inference / frozen BN only, bf16 activations
    with float32 accumulation whatever ``compute_dtype`` is; the result is
    cast to ``compute_dtype``.

    Returns ``(h, next_conv_index, skip8)``: ``h`` is the stride-8 skip
    activation (N, H/8, W/8, 256) == ``skip8`` and ``next_conv_index`` is 26,
    for every geometry (the kernels mask ragged tiles themselves).

    ``packed_hw=(H, W)``: ``x`` is the host-packed space-to-depth
    channels-first uint8 planes (N, 16, (H/2+16)*wp) of
    ``data.pipeline.pack_planes_host``.  They are cast and scaled on the
    device (``u8 -> bf16``, times ``bf16(1/255)``: not the rounding of
    ``float/255 -> bf16``), and a strided view of the 12 image planes feeds
    the same stem kernel.
    """
    from ..data.pipeline import PACK_PAD, packed_row_pitch
    from ..ops import cuda_conv as cc

    bf16 = torch.bfloat16
    if packed_hw is not None:
        H, W = packed_hw
        h2, w2 = H // 2, W // 2
        rows, wp = h2 + 2 * PACK_PAD, packed_row_pitch(W)
        if x.dtype != torch.uint8 or x.dim() != 3 or tuple(x.shape[1:]) != (16, rows * wp):
            raise ValueError(
                f"packed input {tuple(x.shape)} {x.dtype}: want uint8 (N, 16, {rows * wp}) "
                f"for a {H}x{W} image")
        planes = x.to(bf16) * _INV255_BF16  # bf16 x bf16, rounded once to bf16
        xs = planes.reshape(-1, 16, rows, wp)[:, :12, PACK_PAD:PACK_PAD + h2, :w2]
        xs = xs.permute(0, 2, 3, 1)  # (N, H/2, W/2, 12), a view
    else:
        xs = _space_to_depth(x.to(bf16))

    def bn_args(i):
        p, s = params[_conv_name(i)], stats[_conv_name(i)]
        return p["gamma"], p["beta"], s["mean"], s["var"]

    def bn_of(i):  # folded once per set of parameter tensors (``cc.cached``)
        return cc.cached(cc.fold_bn, *bn_args(i))

    def w_of(i):
        return params[_conv_name(i)]["w"]

    def res(h, i):
        return cc.fused_res_block(h, w_of(i), w_of(i + 1), bn_of(i), bn_of(i + 1))

    k3, k2 = cc.cached(_stem_kernels_bf16, w_of(0), w_of(1))
    h = cc.fused_stem(xs, k3, k2, cc.cached(_stem_bn1, *bn_args(0)), bn_of(1))
    h = res(h, 2)
    h = cc.fused_downsample_packed(h, w_of(4), bn_of(4))
    h = res(res(h, 5), 7)
    h = cc.fused_downsample_packed(h, w_of(9), bn_of(9))
    for i in range(10, 26, 2):  # the eight 256-wide blocks
        h = res(h, i)
    skip8 = h.to(compute_dtype)
    return skip8, 26, skip8


def _stem_kernels_bf16(w0: torch.Tensor, w1: torch.Tensor):
    return _stem_kernels(w0.to(torch.bfloat16), w1.to(torch.bfloat16))


def _stem_bn1(gamma, beta, mean, var):
    """conv_00's folded BN tiled over the four pixel phases of its 128
    space-to-depth channels."""
    from ..ops.cuda_conv import fold_bn

    return tuple(v.repeat(4) for v in fold_bn(gamma, beta, mean, var))


def _fused_early_auto(x: torch.Tensor, compute_dtype) -> bool:
    """Auto-gate for the fused early stages of a moving-statistics backbone
    (the kernels fold BN; batch statistics never reach the gate, see
    ``darknet53``): bf16 on the card.  A CPU tensor keeps the plain
    convolutions unless the caller passes ``fused_early=True``."""
    return compute_dtype == torch.bfloat16 and x.is_cuda


@annotate("byolo.backbone")
def darknet53(
    params: Dict,
    stats: Dict,
    x: torch.Tensor,
    *,
    training: bool = False,
    compute_dtype=torch.float32,
    fast_stem: bool = True,
    fused_early=None,
    packed_hw=None,
    band=None,
    group=None,
):
    """Run the backbone.  Returns (out_s32, skip_s16, skip_s8, new_stats).

    ``training`` is the backbone's BN mode: True (an unfrozen backbone in
    training) runs every block with batch statistics through the plain
    convolutions (``conv_block_train``) and returns the advanced moving
    statistics; False (inference, or a frozen backbone in training) uses
    the moving statistics and returns ``stats`` unchanged.  ``group`` (with
    ``training``): ``x`` is a data-parallel rank's share of the batch and the
    batch statistics are the group's (``ops.common.conv_block_train``).

    ``fast_stem`` (inference only): the first two convs run in the 2x2
    space-to-depth domain (see ``_stem_kernels``) — numerically the same
    function.

    ``fused_early`` (None = auto: bf16 on a CUDA tensor): convs 0-25 run
    through the fused conv kernels (``_fused_early_stages``) — numerically
    the plain bf16 path up to rounding boundaries (the fused residual adds
    its skip in float32 before the one rounding).  ``fused_early=True`` on a
    CPU tensor takes the kernels' plain versions; ``fused_early=False`` runs
    bf16 through the plain convolutions.

    ``packed_hw=(H, W)``: ``x`` is host-packed space-to-depth channels-first
    uint8 planes (``data.pipeline.pack_planes_host``) instead of an NHWC
    image; implies the fused branch.

    ``band`` (``parallel.spatial.Band``): ``x`` is an sp rank's band of
    image rows and every conv block exchanges its halo rows with the
    neighbouring ranks (``ops.common.conv_block``).  The backbone then runs
    the plain stem and no fused kernel, which assume the whole image (the
    JAX package's sp path runs unfused too); the result is the band's rows
    of each map.
    """
    if training:
        if band is not None or packed_hw is not None or fused_early:
            raise ValueError("batch-statistics BN runs the plain backbone on NHWC images")
        fused_early = fast_stem = False
    elif band is not None:
        if fused_early or packed_hw is not None:
            raise ValueError("an sp band runs the unfused backbone on NHWC images")
        fused_early = fast_stem = False
    elif packed_hw is not None:
        fused_early = True
    elif fused_early is None:
        fused_early = _fused_early_auto(x, compute_dtype)

    new_stats = {}

    def block(i, h, stride):
        name = _conv_name(i)
        if training:
            y, new_stats[name] = conv_block_train(params[name], stats[name], h, stride=stride,
                                                  compute_dtype=compute_dtype, group=group)
            return y
        return conv_block(params[name], stats[name], h, stride=stride,
                          compute_dtype=compute_dtype, band=band)

    skip8 = skip16 = None
    if fused_early:
        h, i, skip8 = _fused_early_stages(params, stats, x, compute_dtype,
                                          packed_hw=packed_hw)
        remaining = list(_STAGES)[3:]  # the 512 and 1024 stages
    elif fast_stem:
        h = _fast_stem(params, stats, x, compute_dtype)
        i = 2
        stages = list(_STAGES)
        # stage 0's downsample is folded into the stem; run its residuals
        for _ in range(stages[0][1]):
            shortcut = h
            h = block(i, h, 1)
            i += 1
            h = block(i, h, 1)
            i += 1
            h = h + shortcut
        remaining = stages[1:]
    else:
        h = block(0, x, 1)
        i = 1
        remaining = list(_STAGES)
    for _cout, blocks in remaining:
        h = block(i, h, 2)
        i += 1
        for _ in range(blocks):
            shortcut = h
            h = block(i, h, 1)
            i += 1
            h = block(i, h, 1)
            i += 1
            h = h + shortcut
        if i - 1 == SKIP8_IDX:
            skip8 = h
        elif i - 1 == SKIP16_IDX:
            skip16 = h
    assert skip8 is not None and skip16 is not None
    return h, skip16, skip8, new_stats if training else stats


def load_darknet53_weights(weightfile: str, params: Dict, stats: Dict) -> Tuple[Dict, Dict]:
    """Import the original darknet53.conv.74 binary into the param dicts.

    Binary format: a 5-int32 header, then per conv [beta, gamma,
    moving_mean, moving_variance] followed by the kernel as (n, c, h, w)
    float32 — already OIHW.  Raises unless the file is fully consumed.
    """
    with open(weightfile, "rb") as f:
        np.fromfile(f, dtype=np.int32, count=5)
        blob = np.fromfile(f, dtype=np.float32)

    params = dict(params)
    stats = dict(stats)
    ptr = 0

    def take(cnt):
        nonlocal ptr
        out = blob[ptr:ptr + cnt]
        ptr += cnt
        return out

    for i, (k, cout, _) in enumerate(DARKNET53_CONV_SPECS):
        name = _conv_name(i)
        w = params[name]["w"]
        n, cin, kh, kw = w.shape
        if kh != k or n != cout:
            raise ValueError(f"{name}: kernel {tuple(w.shape)} does not match the spec")
        dev = w.device
        beta, gamma, mean, var = take(cout), take(cout), take(cout), take(cout)
        kernel = take(n * cin * kh * kw).reshape(n, cin, kh, kw)
        params[name] = {
            "w": torch.from_numpy(kernel.copy()).to(dev),
            "gamma": torch.from_numpy(gamma.copy()).to(dev),
            "beta": torch.from_numpy(beta.copy()).to(dev),
        }
        stats[name] = {"mean": torch.from_numpy(mean.copy()).to(dev),
                       "var": torch.from_numpy(var.copy()).to(dev)}
    if ptr != len(blob):
        raise ValueError(f"weight file not fully consumed: {ptr} != {len(blob)}")
    return params, stats


def export_darknet53_weights(params: Dict, stats: Dict) -> bytes:
    """Inverse of ``load_darknet53_weights`` (used by round-trip tests)."""
    chunks = [np.zeros(5, dtype=np.int32).tobytes()]
    for i in range(len(DARKNET53_CONV_SPECS)):
        name = _conv_name(i)
        p, s = params[name], stats[name]
        for arr in (p["beta"], p["gamma"], s["mean"], s["var"], p["w"]):
            chunks.append(arr.detach().cpu().numpy().astype(np.float32).tobytes())
    return b"".join(chunks)
