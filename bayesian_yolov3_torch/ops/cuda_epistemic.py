"""Epistemic statistics + bbox decode: the hand-written CUDA kernel, its
wrapper and its plain PyTorch version.

Replaces the TPU kernel ``bayesian_yolov3_tpu/ops/pallas_epistemic.py:_kernel``
(behind ``fused_epistemic_decode_cf_batched`` / ``fused_epistemic_decode_cf``).
The kernel source is ``csrc/epistemic_decode.cu``: one thread per (prior,
anchor) reduces the T samples in registers with coalesced loads along the
anchor axis and writes the (21+C)-wide rows through shared memory.  It is
bound by bytes: every input element is read once.

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

launch_count = 0  # kernel launches made by this module's wrappers


def _lib():
    lib = _build.load("epistemic_decode")
    fn = lib.epistemic_decode_launch
    if not fn.argtypes:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
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
    global launch_count
    B = priors_hw.shape[0]
    T = raw_cf.shape[1]
    pri = priors_hw.contiguous()
    out = torch.empty((n_imgs, B * h * w, 21 + cls_cnt), dtype=torch.float32,
                      device=raw_cf.device)
    with torch.cuda.device(raw_cf.device):
        rc = _lib().epistemic_decode_launch(
            raw_cf.data_ptr(), pri.data_ptr(), out.data_ptr(),
            B, T, n_imgs, h, w, cls_cnt, layer_id,
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
