"""Epistemic statistics + bbox decode: the hand-written CUDA kernel, its
wrapper and its plain PyTorch version.

Replaces the TPU kernel ``bayesian_yolov3_tpu/ops/pallas_epistemic.py:_kernel``
(behind ``fused_epistemic_decode_cf_batched`` / ``fused_epistemic_decode_cf``).
The kernel source is ``csrc/epistemic_decode.cu``: each anchor's T samples
are split over G warps (``frame_parts``), read with coalesced loads along
the anchor axis, summed in registers and combined in a fixed tree; one
thread of each anchor writes its (21+C)-wide row through shared memory.  It
is bound by bytes: every element it reads is read once.

The split (``csrc/decode_common.cuh:reduce_anchor_samples``) is shared with
the partial-moments kernel (``ops/cuda_moments.py``): part g of G sums
samples [g T / G, (g+1) T / G) in increasing order, then for d = 1, 2, 4, ..
part g (g % 2d == 0) adds part g + d.  G depends on T and one frame's
anchor rows alone (``frame_parts``), so both kernels add in one order at
the same frame shape, and a frame's rows do not depend on its batch.

On a CUDA tensor the wrappers launch the kernel or raise; the plain version
runs only for tensors that lie on the CPU (and where a caller asks for it
by name, to compare).
"""

from __future__ import annotations

import ctypes

import torch

from ..core.blueprint import Variant, VariantSpec
from . import _build, decode

MAX_CLASSES = 8  # EPI_MAX_C of csrc/epistemic_decode.cu

# the sample split of csrc/decode_common.cuh: a block of SPLIT_WARPS warps
# holds SPLIT_WARPS / G anchor warps of G parts each (both libraries export
# their own, checked against this one when they load)
SPLIT_WARPS = 8
# 16 warps on each of an H100's 132 SMs.  A constant, not read from the
# device: the order of the sums is the same on every card.
SPLIT_MIN_WARPS = 16 * 132

launch_count = 0  # kernel launches made by this module


def sample_parts(T: int, rows: int) -> int:
    """G, the parts (warps) each anchor's T samples are split over, for
    ``rows`` anchor rows (priors x anchors): the least power of two whose
    grid of ceil(rows / 32) * G warps holds ``SPLIT_MIN_WARPS``, at most
    ``SPLIT_WARPS`` (the parts of an anchor share a block) and at most T
    rounded up to a power of two.  At T = 30 the three ECP scales of
    1024x1920 take 8, 4 and 1."""
    g = 1
    while g < min(T, SPLIT_WARPS) and -(-rows // 32) * g < SPLIT_MIN_WARPS:
        g *= 2
    return g


def frame_parts(T: int, n_priors: int, h: int, w: int) -> int:
    """G for T samples of frames of ``n_priors`` x h x w anchor rows: taken
    from ONE frame's rows, so a frame's sums do not depend on how many
    frames share a launch.  Both wrappers pick G here."""
    return sample_parts(T, n_priors * h * w)


def check_split_warps(lib, name: str) -> None:
    """The library's SPLIT_WARPS (csrc/decode_common.cuh) is this module's."""
    got = getattr(lib, f"{name}_split_warps")()
    if got != SPLIT_WARPS:
        raise RuntimeError(f"{name}: the library splits over {got} warps, "
                           f"ops/cuda_epistemic.py over {SPLIT_WARPS}")


def _lib():
    lib = _build.load("epistemic_decode")
    fn = lib.epistemic_decode_launch
    if not fn.argtypes:
        check_split_warps(lib, "epistemic_decode")
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _check(raw_cf, priors_hw, n_imgs, h, w, cls_cnt):
    if raw_cf.dtype != torch.float32 or priors_hw.dtype != torch.float32:
        raise TypeError("epistemic decode takes float32 raws and priors")
    if raw_cf.dim() != 3 or priors_hw.dim() != 2 or priors_hw.shape[1] != 2:
        raise ValueError(f"shapes {tuple(raw_cf.shape)}, {tuple(priors_hw.shape)}")
    B = priors_hw.shape[0]
    chpp = 2 * (5 + cls_cnt)
    if raw_cf.shape[0] != B * chpp:
        raise ValueError(f"{raw_cf.shape[0]} channels != {B} priors x {chpp}")
    if raw_cf.shape[2] != n_imgs * h * w:
        raise ValueError(f"anchor axis {raw_cf.shape[2]} != {n_imgs}*{h}*{w}")
    if not 1 <= cls_cnt <= MAX_CLASSES:
        raise ValueError(f"cls_cnt {cls_cnt} outside [1, {MAX_CLASSES}]")
    if priors_hw.device != raw_cf.device:
        raise ValueError("priors and raws lie on different devices")


def epistemic_decode_plain(raw_cf, priors_hw, *, n_imgs: int, h: int, w: int,
                           cls_cnt: int, layer_id: int) -> torch.Tensor:
    """The same function in plain PyTorch: relayout to (T, NB, h, w, B*chpp),
    then split_detection -> decode_epistemic_stats -> decode_bbox_epistemic
    -> concat, as the JAX package's unfused path does."""
    _check(raw_cf, priors_hw, n_imgs, h, w, cls_cnt)
    ch, T, _ = raw_cf.shape
    spec = VariantSpec(Variant.BAYESIAN, cls_cnt)
    raw = raw_cf.reshape(ch, T, n_imgs, h, w).permute(1, 2, 3, 4, 0)
    det = decode.split_detection(raw, spec, boxes_per_cell=priors_hw.shape[0])
    stats = decode.decode_epistemic_stats(det)
    rows = decode.decode_bbox_epistemic(stats, priors_hw, layer_id)  # (NB,h,w,B,width)
    return decode.concat_all_scales_batched([rows])


def fused_epistemic_decode_cf_batched(raw_cf, priors_hw, *, n_imgs: int, h: int,
                                      w: int, cls_cnt: int, layer_id: int):
    """raw_cf (B*chpp, T, NB*h*w) f32 -> (NB, B*h*w, 21+C) f32, rows in the
    reference concat order per image (prior-major, then row-major cells)."""
    _check(raw_cf, priors_hw, n_imgs, h, w, cls_cnt)
    if not raw_cf.is_cuda:
        return epistemic_decode_plain(raw_cf, priors_hw, n_imgs=n_imgs, h=h, w=w,
                                      cls_cnt=cls_cnt, layer_id=layer_id)
    if not raw_cf.is_contiguous():
        raise ValueError("the epistemic decode kernel takes a contiguous raw_cf")
    return _decode_launch(raw_cf, priors_hw, n_imgs, h, w, cls_cnt, layer_id,
                          frame_parts(raw_cf.shape[1], priors_hw.shape[0], h, w))


def _decode_launch(raw_cf, priors_hw, n_imgs, h, w, cls_cnt, layer_id, parts):
    """The kernel with each anchor's samples split over ``parts`` warps (the
    wrapper passes ``frame_parts``; a measurement may pass another)."""
    global launch_count
    B = priors_hw.shape[0]
    pri = priors_hw.contiguous()
    out = torch.empty((n_imgs, B * h * w, 21 + cls_cnt), dtype=torch.float32,
                      device=raw_cf.device)
    with torch.cuda.device(raw_cf.device):
        rc = _lib().epistemic_decode_launch(
            raw_cf.data_ptr(), pri.data_ptr(), out.data_ptr(),
            B, raw_cf.shape[1], n_imgs, h, w, cls_cnt, layer_id, parts,
            torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"epistemic_decode kernel launch failed (cudaError {rc})")
    launch_count += 1
    return out


def fused_epistemic_decode_cf(raw_cf, priors_hw, *, h: int, w: int, cls_cnt: int,
                              layer_id: int):
    """Single image: raw_cf (B*chpp, T, h*w) -> (h, w, B, 21+C).  A thin
    relayout over the batched wrapper (same kernel)."""
    rows = fused_epistemic_decode_cf_batched(
        raw_cf, priors_hw, n_imgs=1, h=h, w=w, cls_cnt=cls_cnt, layer_id=layer_id)
    B = priors_hw.shape[0]
    return rows.reshape(B, h, w, -1).permute(1, 2, 0, 3)
