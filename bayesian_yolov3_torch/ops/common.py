"""Primitive NN blocks: conv + (dropout) + batch-norm + LeakyReLU.

PyTorch counterparts of the JAX package's ``ops/common.py``.  Activations
are NHWC at every function boundary (the JAX package's layout); inside,
``x.permute(0, 3, 1, 2)`` of an NHWC-contiguous tensor IS a channels-last
NCHW tensor, so the convolutions run without a relayout copy.  Kernels are
stored OIHW (``convert.params_from_jax`` turns HWIO into that).

Stride-2 convs use an explicit (1,1)x(1,1) zero pad then VALID — the
darknet/caffe padding, which for k=3 equals torch ``padding=1, stride=2``
and differs from TF 'SAME' on even inputs; ``darknet_pad=False`` takes TF
'SAME' (the total pad split with the extra row and column at the end).

float32 compute means true float32: every float32 conv / matmul here first
sets ``torch.backends.cudnn.allow_tf32`` and
``torch.backends.cuda.matmul.allow_tf32`` to False (cuDNN's default would
run float32 convolutions in TF32, about three decimal digits).  The JAX
side forces ``Precision.HIGHEST`` for the same reason.

Parameters live in plain dicts of tensors::

    params[name] = {'w': (cout,cin,kh,kw), 'gamma': (c,), 'beta': (c,)}
    stats[name]  = {'mean': (c,), 'var': (c,)}          # BN moving stats
    params[det]  = {'w': (cout,cin,1,1), 'b': (cout,)}  # detection head

``conv_block`` is the inference block (moving statistics, in place);
``conv_block_train`` is the training block (batch statistics, out of place
so that autograd can take the gradient through it).
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Sequence, Union

import torch
import torch.nn.functional as F

BN_EPS = 1e-5
BN_MOMENTUM = 0.99
LEAKY_ALPHA = 0.1

KEEP_THRESH_16 = 58982  # = min(round(0.9 * 65536), 65535); keep-prob 0.9 quantized

_M32 = 0xFFFFFFFF
_MUL1 = 0x7FEB352D
# 0x846CA68B as a signed 32-bit value: congruent mod 2**32, and small enough
# that (h < 2**32) * _MUL2 never leaves the int64 range
_MUL2 = 0x846CA68B - (1 << 32)


def _true_float32() -> None:
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def leaky_relu(x: torch.Tensor, alpha: float = LEAKY_ALPHA) -> torch.Tensor:
    return torch.where(x >= 0, x, alpha * x)


def _same_pad(size: int, k: int, stride: int = 2):
    """TF "SAME" padding of one axis: (before, after), the odd row after."""
    total = max((-(-size // stride) - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv2d(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
           darknet_pad: bool = True, padding=None) -> torch.Tensor:
    """2D conv, no bias.  x NHWC, w OIHW -> NHWC.

    stride-1: SAME padding.  stride-2: explicit (1,1)x(1,1) zero pad then
    VALID (darknet semantics), or with ``darknet_pad=False`` TF "SAME"
    (``_same_pad``).  ``padding`` — ((top, bottom), (left, right)) —
    overrides them.  float32 operands run in true float32.
    """
    k = w.shape[2]
    if padding is None:
        if stride == 2 and not darknet_pad:
            padding = (_same_pad(x.shape[1], k), _same_pad(x.shape[2], k))
        elif stride == 2 and k != 3:
            raise ValueError("stride-2 darknet conv requires a 3x3 kernel")
        else:
            p = (k - 1) // 2
            padding = ((p, p), (p, p))
    (pt, pb), (pl, pr) = padding
    if x.dtype == torch.float32:
        _true_float32()
    xc = x.permute(0, 3, 1, 2)
    if pt == pb and pl == pr:
        y = F.conv2d(xc, w.to(x.dtype), stride=stride, padding=(pt, pl))
    else:
        y = F.conv2d(F.pad(xc, (pl, pr, pt, pb)), w.to(x.dtype), stride=stride)
    return y.permute(0, 2, 3, 1)


def hash_keep(idx: torch.Tensor, key: int, thresh: int) -> torch.Tensor:
    """The dropout Bernoulli draw: keep iff lowbias32-style
    hash(idx, key) & 0xFFFF < thresh — bit-equal to the JAX package's
    uint32 ``hash_keep``.

    torch has no uint32 arithmetic, so the uint32 wrap-around is written
    out: ``idx`` is int64 holding values in [0, 2**32), and every multiply
    and add is followed by ``& 0xFFFFFFFF``.  The key enters twice (xor at
    entry, add between the finalizer rounds), so distinct keys give
    distinct functions and not index permutations of one mask.
    """
    key = int(key) & _M32
    h = idx ^ key
    h ^= h >> 16
    h *= _MUL1
    h &= _M32
    h += key
    h &= _M32
    h ^= h >> 15
    h *= _MUL2
    h &= _M32
    h ^= h >> 16
    h &= 0xFFFF
    return h < thresh


def dropout(x: torch.Tensor, rate: float,
            keys: Union[int, Sequence[int]], origin=None) -> torch.Tensor:
    """Inverted hash dropout (``impl="hash"`` of the JAX package), in place.

    ``x`` is (S*NB, h, w, c): S MC samples of an NB-image batch stacked on
    the leading axis; ``keys`` holds one uint32 key per sample (an int for
    S=1).  The mask index is the flat row-major NHWC index of the
    PER-SAMPLE tensor (NB, h, w, c) — the sample axis does not enter it —
    whatever memory layout ``x`` has.  Masks are built one sample at a
    time so the int64 temporaries stay at one sample's size.

    ``origin=(r0, H)``: ``x`` holds rows [r0, r0+h) of a map H rows high
    (an sp rank's band, ``parallel.spatial``); element (n, r, j, k) then
    takes the index of its place in the whole map, ((n*H + r0 + r)*w +
    j)*c + k, so a band draws exactly its rows of the whole map's mask.
    ``origin=(r0, H, n0)``: the batch also starts at image n0 of a larger
    batch (a rank's share of a data-parallel batch), and element (n, r, j,
    k) takes (((n0 + n)*H + r0 + r)*w + j)*c + k.
    """
    keys = [keys] if isinstance(keys, int) else [int(k) for k in keys]
    s = len(keys)
    if x.shape[0] % s:
        raise ValueError(f"leading dim {x.shape[0]} is not a multiple of {s} samples")
    thresh, keep = _keep(rate, x.dtype)
    nb = x.shape[0] // s
    per_sample = (nb,) + tuple(x.shape[1:])
    if origin is None:
        idx = torch.arange(math.prod(per_sample), dtype=torch.int64,
                           device=x.device).reshape(per_sample)
    else:
        r0, height, *n0 = origin
        idx = _band_index(per_sample, r0, height, x.device, *n0)
    for i, key in enumerate(keys):
        xs = x[i * nb:(i + 1) * nb]
        mask = hash_keep(idx, key, thresh)
        xs.div_(keep).masked_fill_(~mask, 0.0)
    return x


def _keep(rate: float, dtype):
    """(16-bit keep threshold, divisor) of a dropout rate; the divisor in the
    activations' own type, as the JAX package's ``x / keep`` takes it (a
    weakly typed scalar): 0.8984375 for bf16, not 0.9."""
    keep = 1.0 - rate
    return min(round(keep * 65536.0), 65535), torch.tensor(keep, dtype=dtype).item()


def _band_index(shape, r0: int, height: int, device, n0: int = 0) -> torch.Tensor:
    """int64 flat NHWC indices of rows [r0, r0+h) of images [n0, n0+n) of an
    (N, height, w, c) map, shaped (n, h, w, c)."""
    n, h, w, c = shape
    if not 0 <= r0 <= height - h:
        raise ValueError(f"rows [{r0}, {r0 + h}) outside a map {height} rows high")
    if n0 < 0:
        raise ValueError(f"image offset {n0} < 0")
    ar = functools.partial(torch.arange, dtype=torch.int64, device=device)
    rows = (n0 + ar(n))[:, None] * height + r0 + ar(h)  # (n, h): the rows' global row index
    return (rows[..., None] * w + ar(w))[..., None] * c + ar(c)


def _bn_affine(gamma, beta, mean, var):
    """Fold BN into per-channel scale/bias (inference / frozen mode)."""
    scale = gamma * torch.rsqrt(var + BN_EPS)
    bias = beta - mean * scale
    return scale, bias


def conv_block(params: Dict, stats: Dict, x: torch.Tensor, *, stride: int = 1,
               training: bool = False, drop_rate: Optional[float] = None,
               drop_keys=None, compute_dtype=torch.float32, band=None) -> torch.Tensor:
    """conv -> [dropout] -> batch_norm -> LeakyReLU(0.1), NHWC in and out.

    Dropout runs BEFORE batch norm (reference ordering).  ``drop_keys``:
    one uint32 hash key per MC sample stacked on the leading axis (see
    ``dropout``).  Batch norm uses the moving statistics.

    ``band`` (None: ``x`` is the whole map): ``x`` is an sp rank's band of
    rows (``parallel.spatial.Band``); the conv takes its halo rows from the
    neighbouring ranks (``band.conv``) and the dropout mask is the band's
    rows of the whole map's mask (``band.origin``).

    The block works in place on the conv's output, which autograd cannot
    differentiate; batch statistics (``training``) are ``conv_block_train``.
    """
    if training:
        raise ValueError("conv_block is the inference block: batch-statistics BN is "
                         "conv_block_train, which also returns the new statistics")
    conv = conv2d if band is None else band.conv
    y = conv(x.to(compute_dtype), params["w"].to(compute_dtype), stride=stride)
    if drop_rate is not None and drop_rate > 0.0:
        if drop_keys is None:
            raise ValueError("dropout requires a key")
        y = dropout(y, drop_rate, drop_keys,
                    origin=None if band is None else band.origin(y.shape[1]))
    y = y.float()  # the conv's own fresh output: updated in place below
    scale, bias = _bn_affine(params["gamma"], params["beta"], stats["mean"], stats["var"])
    y.mul_(scale).add_(bias)
    return F.leaky_relu_(y, LEAKY_ALPHA).to(compute_dtype)


def conv_block_train(params: Dict, stats: Dict, x: torch.Tensor, *, stride: int = 1,
                     drop_rate: Optional[float] = None, drop_key=None,
                     compute_dtype=torch.float32, group=None):
    """conv -> [dropout] -> batch-statistics BN -> LeakyReLU(0.1), NHWC,
    out of place.  Returns ``(y, new_stats)``.

    Mean and biased variance over (N, H, W) in float32; the new moving
    statistics are ``old * 0.99 + batch * 0.01`` (TF semantics; neither
    ``F.batch_norm`` nor ``nn.BatchNorm2d``, which advance the variance with
    the unbiased estimate).  ``drop_key``: the site's one uint32 key for the
    whole batch (``dropout`` with one key: the mask indexes the flat NHWC
    index of the whole batch, as the JAX package's training dropout does).
    Dropout works in place on the conv's output, which the conv's backward
    does not save; BN and the activation are out of place.

    The statistics take two passes: the sums and the count give the mean,
    the sum of squared deviations from it over the count the biased
    variance.  ``group`` (``parallel.mesh.Group`` of the ``data`` axis;
    None: one device): ``x`` is the rank's share of a global batch split
    evenly over the group, images [rank*n, (rank+1)*n).  Both passes' sums
    are then all-reduced through ``Group.all_reduce_autograd``, whose
    backward all-reduces the gradient, so the statistics are the global
    batch's; the dropout mask is the rows of the global batch's
    (``dropout(origin=(0, h, rank*n))``).
    """
    y = conv2d(x.to(compute_dtype), params["w"].to(compute_dtype), stride=stride)
    if drop_rate is not None and drop_rate > 0.0:
        if drop_key is None:
            raise ValueError("dropout requires a key")
        origin = None if group is None else (0, y.shape[1], group.rank * y.shape[0])
        y = dropout(y, drop_rate, drop_key, origin=origin)
    y = y.float()
    c = y.shape[-1]
    count = y.new_full((1,), float(math.prod(y.shape[:3])))
    sums = torch.cat([y.sum(dim=(0, 1, 2)), count])
    if group is not None:
        sums = group.all_reduce_autograd(sums)
    mean = sums[:c] / sums[c]
    sq = (y - mean).square().sum(dim=(0, 1, 2))
    if group is not None:
        sq = group.all_reduce_autograd(sq)
    var = sq / sums[c]
    with torch.no_grad():
        new_stats = {"mean": stats["mean"] * BN_MOMENTUM + mean * (1.0 - BN_MOMENTUM),
                     "var": stats["var"] * BN_MOMENTUM + var * (1.0 - BN_MOMENTUM)}
    scale, bias = _bn_affine(params["gamma"], params["beta"], mean, var)
    return leaky_relu(y * scale + bias).to(compute_dtype), new_stats


def detection_conv(params: Dict, x: torch.Tensor, *, compute_dtype=torch.float32):
    """1x1 linear detection head with bias, NHWC.  Output float32."""
    y = conv2d(x.to(compute_dtype), params["w"].to(compute_dtype), stride=1)
    return y.float() + params["b"].float()


def detection_conv_cf(params: Dict, feats: torch.Tensor, *, compute_dtype=torch.float32):
    """Channels-first detection head over stacked MC samples.

    feats: (T, ..., cin) -> (ch, T, prod(...)) float32, contiguous: the
    middle dims (image batch x h x w) flatten onto the anchor axis, which
    is the minor axis — the layout the epistemic decode kernel reads with
    coalesced loads.  One (ch, cin) x (cin, T*M) matrix product.
    """
    t, cin = feats.shape[0], feats.shape[-1]
    m = math.prod(feats.shape[1:-1])
    x = feats.reshape(t * m, cin).to(compute_dtype)
    kernel = params["w"].reshape(-1, cin).to(compute_dtype)  # (ch, cin)
    if compute_dtype == torch.float32:
        _true_float32()
        out = torch.matmul(kernel, x.t())  # (ch, T*M)
    elif x.is_cuda:
        # bf16 operands, float32 accumulator AND output (the JAX package's
        # preferred_element_type): the logits are never rounded to bf16
        out = torch.mm(kernel, x.t(), out_dtype=torch.float32)
    else:
        # CPU: no mixed-type product; bf16 x bf16 products are exact in float32
        out = torch.matmul(kernel.float(), x.float().t())
    out = out + params["b"].float()[:, None]
    return out.reshape(-1, t, m)


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample, NHWC."""
    n, h, w, c = x.shape
    y = x[:, :, None, :, None, :].expand(n, h, 2, w, 2, c)
    return y.reshape(n, 2 * h, 2 * w, c)


# --------------------------------------------------------------------------
# initializers (TF defaults: glorot_uniform kernels, zero bias, BN gamma=1 beta=0)
# --------------------------------------------------------------------------


def _glorot_uniform(gen: torch.Generator, k: int, cin: int, cout: int, device):
    if torch.device(device).type == "meta":  # shapes only, nothing drawn
        return torch.empty((cout, cin, k, k), device="meta")
    limit = math.sqrt(6.0 / (k * k * cin + k * k * cout))
    w = torch.rand((cout, cin, k, k), generator=gen, dtype=torch.float32)
    return ((w * 2.0 - 1.0) * limit).to(device)


def init_conv_block(gen: torch.Generator, k: int, cin: int, cout: int, device="cpu"):
    """``gen`` is a CPU generator; tensors are created on ``device``
    (``"meta"`` gives the shapes alone and draws nothing)."""
    params = {
        "w": _glorot_uniform(gen, k, cin, cout, device),
        "gamma": torch.ones(cout, device=device),
        "beta": torch.zeros(cout, device=device),
    }
    stats = {"mean": torch.zeros(cout, device=device),
             "var": torch.ones(cout, device=device)}
    return params, stats


def init_detection_conv(gen: torch.Generator, cin: int, cout: int, device="cpu"):
    return {"w": _glorot_uniform(gen, 1, cin, cout, device),
            "b": torch.zeros(cout, device=device)}
