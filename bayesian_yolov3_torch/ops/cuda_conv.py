"""The fused early backbone (convs 0-25): three hand-written CUDA kernels,
their wrappers and their plain PyTorch versions.

Replaces the TPU kernels of ``bayesian_yolov3_tpu/ops/pallas_conv.py``:

====================  =======================================  ======================
wrapper here          TPU wrapper -> kernel                    source
====================  =======================================  ======================
fused_stem            fused_stem_cf -> _stem_kernel            csrc/fused_stem.cu
fused_res_block       fused_res_block_cf -> _res_kernel        csrc/fused_res_block.cu
fused_downsample_packed  fused_downsample_packed_cf ->         csrc/fused_downsample.cu
                      _down_packed_kernel
fused_downsample      fused_downsample_cf -> _down_kernel      (the same kernel)
====================  =======================================  ======================

Every wrapper takes and returns **NHWC bf16** activations, like
``ops.common.conv_block``, kernels in OIHW and folded BN affines as float32
``(scale, bias)`` pairs (``fold_bn``).  The TPU's flat ``(C, rows*WP)`` layout,
its pad rows, dead columns, lane rolls and phase packing are layout rules of
that chip and are not carried over: ``fused_res_block`` has no
``pack_phases`` argument, and the two downsample wrappers take the same plain
tensor (the TPU pair differed only in the column order of their input).

Rounding points are part of each function (see the ``*_plain`` versions,
which spell them out): operands are bf16, every product sum accumulates in
float32, the BN affine and LeakyReLU run in float32, and an activation is
rounded to bf16 once.

On a CUDA tensor a wrapper launches its kernel or raises; the plain version
runs only for tensors that lie on the CPU (and where a caller asks for it by
name, to compare).  The kernels' weight layouts are made from the OIHW
tensors by ``_*_kernel_weights`` once per set of weight tensors and kept
(``cached``, which also serves the folded BN affines of
``models.darknet._fused_early_stages``): a source tensor that is replaced,
or written in place, gets a fresh layout on its next call.
"""

from __future__ import annotations

import ctypes
import weakref
from typing import Callable, Dict, Tuple

import torch
import torch.nn.functional as F

from . import _build
from .common import BN_EPS, LEAKY_ALPHA, _true_float32

BF16 = torch.bfloat16
MAX_IMAGES = 65535  # the image batch is the kernels' grid z
MAX_ROWS = 4 * 65535  # the downsample's tile rows are grid y; its tile reads 4 rows
# output tiles (rows, columns) of the persistent kernels, which walk the tiles
# (image, row tile, column tile) of a batch in steps of their grid
STEM_TILE, RES_TILE = (2, 64), (2, 62)

# kernel launches made by this module's wrappers, by kernel
launch_counts = {"fused_stem": 0, "fused_res_block": 0, "fused_downsample": 0}

BN = Tuple[torch.Tensor, torch.Tensor]


_derived: Dict[tuple, tuple] = {}


def _signature(t: torch.Tensor) -> tuple:
    # the version counter moves on every in-place write; data_ptr and shape
    # catch a swapped ``.data``
    return t._version, t.data_ptr(), tuple(t.shape), t.dtype, t.device


def cached(fn: Callable, *tensors: torch.Tensor):
    """``fn(*tensors)``, computed once for these tensor objects in their
    current contents and kept while they live.

    A hit needs the very same objects (weak references, not ids that a new
    tensor could reuse) with unchanged version counters, data pointers and
    shapes; anything else recomputes, so a model that loads other weights,
    into new tensors or in place, never gets a stale layout.  Inference-mode
    tensors have no version counter and are never cached."""
    if any(t.is_inference() for t in tensors):
        return fn(*tensors)
    key = (fn, *map(id, tensors))
    sig = tuple(map(_signature, tensors))
    hit = _derived.get(key)
    if hit is not None and hit[1] == sig and all(r() is t for r, t in zip(hit[0], tensors)):
        return hit[2]
    out = fn(*tensors)
    holder = []

    def drop(_ref):  # a source died: forget the entry, if it is still this one
        if holder and _derived.get(key) is holder[0]:
            del _derived[key]

    entry = (tuple(weakref.ref(t, drop) for t in tensors), sig, out)
    holder.append(entry)
    _derived[key] = entry
    return out


def fold_bn(gamma, beta, mean, var) -> BN:
    """BN moving-statistics affine (inference / frozen mode) as (scale, bias)."""
    scale = gamma * torch.rsqrt(var + BN_EPS)
    return scale, beta - mean * scale


# --------------------------------------------------------------------------
# checks
# --------------------------------------------------------------------------


def _check_act(name: str, x: torch.Tensor, channels) -> None:
    if x.dtype != BF16:
        raise TypeError(f"{name} takes bf16 activations, got {x.dtype}")
    if x.dim() != 4 or x.shape[3] not in channels:
        raise ValueError(f"{name}: activation shape {tuple(x.shape)}, "
                         f"want (N, H, W, C) with C in {tuple(channels)}")
    # the kernels index global memory in 64 bits; only the grid has limits
    if min(x.shape) < 1 or x.shape[0] > MAX_IMAGES or x.shape[1] > MAX_ROWS:
        raise ValueError(f"{name}: activation shape {tuple(x.shape)}")


def _check_weight(name: str, w: torch.Tensor, shape, dev) -> None:
    if tuple(w.shape) != tuple(shape):
        raise ValueError(f"{name}: kernel shape {tuple(w.shape)}, want {tuple(shape)} (OIHW)")
    if not w.is_floating_point():
        raise TypeError(f"{name}: kernel dtype {w.dtype}")
    if w.device != dev:
        raise ValueError(f"{name}: kernel and activation lie on different devices")


def _check_bn(name: str, bn: BN, c: int, dev) -> None:
    for v in bn:
        if v.dtype != torch.float32 or tuple(v.shape) != (c,):
            raise TypeError(f"{name}: BN scale/bias must be float32 of shape ({c},), "
                            f"got {v.dtype} {tuple(v.shape)}")
        if v.device != dev:
            raise ValueError(f"{name}: BN affine and activation lie on different devices")


def _contiguous_or_raise(name: str, x: torch.Tensor) -> None:
    if not x.is_contiguous():
        raise ValueError(f"the {name} kernel takes a contiguous NHWC activation")
    if x.data_ptr() % 16:
        raise ValueError(f"the {name} kernel reads 16 bytes at a time: alignment needed")


def _lib(name: str, head: list, n_int: int, defines=()):
    """The launch function of ``csrc/<name>.cu``, typed: ``head`` (pointers
    and, for the stem, strides), then ``n_int`` ints, then the stream."""
    lib = _build.load(name, defines)
    fn = getattr(lib, name + "_launch")
    if not fn.argtypes:
        fn.argtypes = head + [ctypes.c_int] * n_int + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _swizzled(wk: torch.Tensor) -> torch.Tensor:
    """(..., rows, 64) -> the same shape in bf16, in the 128-byte swizzle of
    the kernels' shared memory: the 16-byte chunk k (8 values) of row o sits
    at chunk k ^ (o & 7).  Every piece of a kernel weight layout starts at a
    multiple of 8 rows, so the rows here count from the piece's first."""
    shape, rows = wk.shape, wk.shape[-2]
    chunk = torch.arange(8, device=wk.device)[None, :] ^ \
        (torch.arange(rows, device=wk.device)[:, None] & 7)
    wk = wk.reshape(-1, rows, 8, 8)
    wk = torch.gather(wk, 2, chunk[None, :, :, None].expand(wk.shape[0], -1, -1, 8))
    return wk.reshape(shape).to(BF16)


def _launched(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed (cudaError {rc})")
    launch_counts[name] += 1


def _leaky(y: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(y, LEAKY_ALPHA)


def _conv_f32(x_nchw: torch.Tensor, w: torch.Tensor, **kw) -> torch.Tensor:
    """bf16-rounded operands, true float32 accumulation (TF32 off)."""
    _true_float32()
    return F.conv2d(x_nchw.float(), w.to(BF16).float(), **kw)


def _affine(y_nchw: torch.Tensor, bn: BN) -> torch.Tensor:
    scale, bias = bn
    return y_nchw * scale[None, :, None, None] + bias[None, :, None, None]


# --------------------------------------------------------------------------
# residual block
# --------------------------------------------------------------------------

RES_CHANNELS = (64, 128, 256)


def _check_res(x, wa, wb, bna, bnb):
    _check_act("fused_res_block", x, RES_CHANNELS)
    c = x.shape[3]
    _check_weight("fused_res_block", wa, (c // 2, c, 1, 1), x.device)
    _check_weight("fused_res_block", wb, (c, c // 2, 3, 3), x.device)
    _check_bn("fused_res_block", bna, c // 2, x.device)
    _check_bn("fused_res_block", bnb, c, x.device)


def fused_res_block_plain(x, wa, wb, bna: BN, bnb: BN) -> torch.Tensor:
    """The same function in plain PyTorch, rounding points spelled out."""
    _check_res(x, wa, wb, bna, bnb)
    xc = x.permute(0, 3, 1, 2).float()
    t = _leaky(_affine(_conv_f32(xc, wa), bna)).to(BF16)       # rounding 1: t
    acc = _conv_f32(t, wb, padding=1)                           # zero-pads t itself
    y = _leaky(_affine(acc, bnb)) + xc                          # skip added in float
    return y.to(BF16).permute(0, 2, 3, 1).contiguous()          # rounding 2: y


def fused_res_block(x, wa, wb, bna: BN, bnb: BN) -> torch.Tensor:
    """One darknet residual block: 1x1 C->C/2, BN, leaky, round to bf16;
    3x3 C/2->C SAME, BN, leaky; ``+ x`` in float32; one rounding to bf16.

    x (N, H, W, C) bf16 with C in {64, 128, 256}; wa (C/2, C, 1, 1) and wb
    (C, C/2, 3, 3) OIHW; bna / bnb folded (scale, bias).  Any H and W.  There
    is no ``pack_phases`` argument: the phase-packed column order was a TPU
    layout for its stride-2 consumer, which here reads the plain tensor.
    """
    _check_res(x, wa, wb, bna, bnb)
    if not x.is_cuda:
        return fused_res_block_plain(x, wa, wb, bna, bnb)
    return _res_launch(x, cached(_res_kernel_weights, wa, wb),
                       cached(_bn_vector, *bna, *bnb))


def _res_kernel_weights(wa, wb):
    """OIHW -> the kernel's weight pieces, flat bf16, each piece the
    swizzled shared-memory image of one bulk copy (``_swizzled``):

    * ``C/64`` pieces of wa: piece s is (C/2 t channels, 64 input channels
      64s ..);
    * then, for each block h of ``min(C, 128)`` output channels and each
      64-wide K slice s of the 3x3 (K index ``(di*3 + dj)*C/2 + c``, zero
      past ``9*C/2``), one piece (those channels, the slice's 64 K values),
      in the order (h, s)."""
    c = wb.shape[0]
    cm, rb = c // 2, min(c, 128)
    nks = -(-9 * cm // 64)
    pa = wa.reshape(cm, c // 64, 64).permute(1, 0, 2)
    kb = F.pad(wb.permute(0, 2, 3, 1).reshape(c, 9 * cm), (0, 64 * nks - 9 * cm))
    pb = kb.reshape(c // rb, rb, nks, 64).permute(0, 2, 1, 3).reshape(-1, rb, 64)
    return torch.cat([_swizzled(pa).flatten(), _swizzled(pb).flatten()]).contiguous()


def _bn_vector(*vs: torch.Tensor) -> torch.Tensor:
    """Folded BN vectors, one float32 tensor as the kernels read them."""
    return torch.cat(vs).to(torch.float32).contiguous()


def _res_launch(x, w_k, bn_k, defines=()) -> torch.Tensor:
    """The kernel on the cached weight pieces and BN vector
    ``[scale_a, bias_a, scale_b, bias_b]``; ``defines``: a measurement build
    of the kernel (``_build.load``)."""
    _contiguous_or_raise("fused_res_block", x)
    n, h, w, c = x.shape
    out = torch.empty_like(x)
    fn = _lib("fused_res_block", [ctypes.c_void_p] * 4, 4, defines)
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), w_k.data_ptr(), bn_k.data_ptr(), out.data_ptr(), n, h, w, c,
                torch.cuda.current_stream().cuda_stream)
    _launched("fused_res_block", rc)
    return out


# --------------------------------------------------------------------------
# stride-2 downsample
# --------------------------------------------------------------------------

DOWN_CHANNELS = (64, 128)


def _check_down(x, w, bn):
    _check_act("fused_downsample", x, DOWN_CHANNELS)
    c = x.shape[3]
    _check_weight("fused_downsample", w, (2 * c, c, 3, 3), x.device)
    _check_bn("fused_downsample", bn, 2 * c, x.device)


def fused_downsample_plain(x, w, bn: BN) -> torch.Tensor:
    """The same function in plain PyTorch."""
    _check_down(x, w, bn)
    acc = _conv_f32(x.permute(0, 3, 1, 2), w, stride=2, padding=1)  # darknet pad
    return _leaky(_affine(acc, bn)).to(BF16).permute(0, 2, 3, 1).contiguous()


def fused_downsample(x, w, bn: BN) -> torch.Tensor:
    """3x3 stride-2 conv with darknet (1,1)x(1,1) zero padding, BN, leaky,
    one rounding to bf16.  x (N, H, W, C) bf16 with C in {64, 128}; w
    (2C, C, 3, 3) OIHW -> (N, (H-1)//2+1, (W-1)//2+1, 2C) bf16."""
    _check_down(x, w, bn)
    if not x.is_cuda:
        return fused_downsample_plain(x, w, bn)
    return _down_launch(x, cached(_down_kernel_weights, w), bn)


DOWN_KC = 64  # input channels of one K slice of the downsample kernel


def _down_kernel_weights(w):
    """OIHW (2C, C, 3, 3) -> (9*C/64, 2C, 64) bf16: K slice s = cb*9 + di*3 +
    dj holds ``w[:, 64*cb:64*cb + 64, di, dj]``, each 128 output channels one
    contiguous 16 KB block that the kernel copies into shared memory as it
    stands.  So it is stored as the kernel reads it, 128-byte swizzled: the
    16-byte chunk k (8 input channels) of output channel o sits at chunk
    k ^ (o & 7)."""
    o, c = w.shape[:2]
    wk = w.reshape(o, c // DOWN_KC, DOWN_KC, 3, 3).permute(1, 3, 4, 0, 2)
    return _swizzled(wk.reshape(9 * (c // DOWN_KC), o, DOWN_KC)).contiguous()


def _down_launch(x, w_k, bn: BN) -> torch.Tensor:
    _contiguous_or_raise("fused_downsample", x)
    n, h, wd, c = x.shape
    scale, bias = (v.contiguous() for v in bn)
    out = torch.empty((n, (h - 1) // 2 + 1, (wd - 1) // 2 + 1, 2 * c),
                      dtype=BF16, device=x.device)
    fn = _lib("fused_downsample", [ctypes.c_void_p] * 5, 4)
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), w_k.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                out.data_ptr(), n, h, wd, c, torch.cuda.current_stream().cuda_stream)
    _launched("fused_downsample", rc)
    return out


def fused_downsample_packed(x, w, bn: BN) -> torch.Tensor:
    """The stride-2 conv under the name of the TPU's phase-packed variant.
    The TPU pair differed only in the column order of the input; here both
    names take the plain NHWC tensor and reach the same kernel."""
    return fused_downsample(x, w, bn)


# --------------------------------------------------------------------------
# stem
# --------------------------------------------------------------------------

STEM_CIN, STEM_C1, STEM_C2 = 12, 128, 64


def _check_stem(x, k3, k2, bn1, bn2):
    _check_act("fused_stem", x, (STEM_CIN,))
    _check_weight("fused_stem", k3, (STEM_C1, STEM_CIN, 3, 3), x.device)
    _check_weight("fused_stem", k2, (STEM_C2, STEM_C1, 2, 2), x.device)
    _check_bn("fused_stem", bn1, STEM_C1, x.device)
    _check_bn("fused_stem", bn2, STEM_C2, x.device)


def fused_stem_plain(x, k3, k2, bn1: BN, bn2: BN) -> torch.Tensor:
    """The same function in plain PyTorch."""
    _check_stem(x, k3, k2, bn1, bn2)
    acc1 = _conv_f32(x.permute(0, 3, 1, 2), k3, padding=1)
    t1 = _leaky(_affine(acc1, bn1)).to(BF16)                    # rounding 1: t1
    acc2 = _conv_f32(F.pad(t1, (1, 0, 1, 0)), k2)               # front pad of t1: zeros
    return _leaky(_affine(acc2, bn2)).to(BF16).permute(0, 2, 3, 1).contiguous()


def fused_stem(x, k3, k2, bn1: BN, bn2: BN) -> torch.Tensor:
    """conv_00 + conv_01 in the 2x2 space-to-depth domain: 3x3 conv 12->128,
    BN, leaky, round to bf16; 2x2 front-padded conv 128->64, BN, leaky, one
    rounding to bf16.

    x: the space-to-depth image (N, H/2, W/2, 12) bf16, channel
    ``(pi*2 + pj)*3 + c`` — contiguous or any strided view (the kernel takes
    the four strides, so a view into host-packed channels-first planes needs
    no copy).  k3 (128, 12, 3, 3) and k2 (64, 128, 2, 2): the folded kernels
    of ``models.darknet._stem_kernels``; bn1 is BN 1 tiled x4.
    -> (N, H/2, W/2, 64) bf16 NHWC.
    """
    _check_stem(x, k3, k2, bn1, bn2)
    if not x.is_cuda:
        return fused_stem_plain(x, k3, k2, bn1, bn2)
    return _stem_launch(x, cached(_stem_kernel_weights, k3, k2),
                        cached(_bn_vector, *bn1, *bn2))


def _stem_kernel_weights(k3, k2):
    """OIHW -> both weights as the kernel's shared memory holds them, one
    flat bf16 tensor (one bulk copy), each piece swizzled (``_swizzled``):
    w1 as 2 K planes x 128 output channels x 64, K index ``(di*3 + dj)*12 +
    c`` zero-padded from 108 to 128; then w2 as 8 slices (tap ``a*2 + b``,
    t1 channel plane) x 64 output channels x 64 t1 channels."""
    w1 = F.pad(k3.permute(0, 2, 3, 1).reshape(STEM_C1, 9 * STEM_CIN), (0, 128 - 9 * STEM_CIN))
    w1 = w1.reshape(STEM_C1, 2, 64).permute(1, 0, 2)
    w2 = k2.permute(2, 3, 0, 1).reshape(4, STEM_C2, 2, 64).permute(0, 2, 1, 3)
    return torch.cat([_swizzled(w1).flatten(), _swizzled(w2.reshape(8, STEM_C2, 64)).flatten()])


def _stem_mode(x) -> int:
    """How the kernel reads x, from its strides (elements) and alignment:
    1 = pixels of 12 contiguous channels, 8-byte loads; 2 = channel planes
    with contiguous rows (the packed planes' view), 4-byte loads; 0 = any
    other strides, element by element."""
    sn, sh, sw, sc = x.stride()
    p = x.data_ptr()
    if sc == 1 and sw == STEM_CIN and p % 8 == 0 and sh % 4 == 0 and sn % 4 == 0:
        return 1
    if sw == 1 and p % 4 == 0 and sh % 2 == 0 and sc % 2 == 0 and sn % 2 == 0:
        return 2
    return 0


def _stem_launch(x, w_k, bn_k, defines=()) -> torch.Tensor:
    """The kernel on the cached weights and BN vector ``[scale1, bias1,
    scale2, bias2]``; ``defines``: a measurement build of the kernel
    (``_build.load``)."""
    if min(x.stride()) < 0:
        raise ValueError("fused_stem: negative strides")
    n, h2, w2, _ = x.shape
    out = torch.empty((n, h2, w2, STEM_C2), dtype=BF16, device=x.device)
    fn = _lib("fused_stem",
              [ctypes.c_void_p] + [ctypes.c_longlong] * 4 + [ctypes.c_void_p] * 3, 4, defines)
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), *x.stride(), w_k.data_ptr(), bn_k.data_ptr(), out.data_ptr(),
                n, h2, w2, _stem_mode(x), torch.cuda.current_stream().cuda_stream)
    _launched("fused_stem", rc)
    return out
