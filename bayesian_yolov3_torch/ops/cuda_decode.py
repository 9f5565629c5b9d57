"""Per-sample box decode of the batched standard / aleatoric heads: the
hand-written CUDA kernel, its wrappers and its plain PyTorch version.

Replaces the TPU kernel ``bayesian_yolov3_tpu/ops/pallas_decode.py:_kernel``
(behind ``fused_box_decode_cf`` / ``fused_box_decode_all_scales``).  The
kernel source is ``csrc/box_decode.cu``: one thread per (image, prior,
cell) reads the channels-first raw heads with coalesced loads and a block
writes its rows back through shared memory as one contiguous run.  It is
bound by bytes.

On a CUDA tensor the wrappers launch the kernel or raise; the plain version
runs only for tensors that lie on the CPU (and where a caller asks for it
by name, to compare).
"""

from __future__ import annotations

import ctypes

import torch

from ..core.blueprint import Variant, VariantSpec
from . import _build, decode

MAX_CLASSES = 8  # BOX_MAX_C of csrc/box_decode.cu

launch_count = 0  # kernel launches made by this module's wrappers


def _lib():
    lib = _build.load("box_decode")
    fn = lib.box_decode_launch
    if not fn.argtypes:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _check(raw_cf, priors_hw, h, w, cls_cnt, aleatoric):
    if raw_cf.dtype != torch.float32 or priors_hw.dtype != torch.float32:
        raise TypeError("box decode takes float32 raws and priors")
    if raw_cf.dim() != 3 or priors_hw.dim() != 2 or priors_hw.shape[1] != 2:
        raise ValueError(f"shapes {tuple(raw_cf.shape)}, {tuple(priors_hw.shape)}")
    if not 1 <= cls_cnt <= MAX_CLASSES:
        raise ValueError(f"cls_cnt {cls_cnt} outside [1, {MAX_CLASSES}]")
    B = priors_hw.shape[0]
    chpp = 2 * (5 + cls_cnt) if aleatoric else 5 + cls_cnt
    if raw_cf.shape[0] != B * chpp:
        raise ValueError(f"{raw_cf.shape[0]} channels != {B} priors x {chpp}")
    if raw_cf.shape[2] != h * w:
        raise ValueError(f"cell axis {raw_cf.shape[2]} != {h}*{w}")
    if priors_hw.device != raw_cf.device:
        raise ValueError("priors and raws lie on different devices")


def box_decode_plain(raw_cf, priors_hw, *, h: int, w: int, cls_cnt: int,
                     layer_id: int, aleatoric: bool) -> torch.Tensor:
    """The same function in plain PyTorch: relayout to (nb, h, w, B*chpp),
    then split_detection -> decode_bbox_standard / decode_bbox_aleatoric ->
    concat, as the JAX package's unfused path does."""
    _check(raw_cf, priors_hw, h, w, cls_cnt, aleatoric)
    ch, nb, _ = raw_cf.shape
    spec = VariantSpec(Variant.ALEATORIC if aleatoric else Variant.STANDARD, cls_cnt)
    raw = raw_cf.reshape(ch, nb, h, w).permute(1, 2, 3, 0)
    det = decode.split_detection(raw, spec, boxes_per_cell=priors_hw.shape[0])
    fn = decode.decode_bbox_aleatoric if aleatoric else decode.decode_bbox_standard
    return decode.concat_all_scales_batched([fn(det, priors_hw, layer_id)])


def fused_box_decode_cf(raw_cf, priors_hw, *, h: int, w: int, cls_cnt: int,
                        layer_id: int, aleatoric: bool) -> torch.Tensor:
    """raw_cf (B*chpp, nb, h*w) f32 -> (nb, B*h*w, 7+C or 14+C) f32, rows in
    the reference concat order per image (prior-major, then row-major
    cells)."""
    _check(raw_cf, priors_hw, h, w, cls_cnt, aleatoric)
    if not raw_cf.is_cuda:
        return box_decode_plain(raw_cf, priors_hw, h=h, w=w, cls_cnt=cls_cnt,
                                layer_id=layer_id, aleatoric=aleatoric)
    if not raw_cf.is_contiguous():
        raise ValueError("the box decode kernel takes a contiguous raw_cf")
    global launch_count
    B = priors_hw.shape[0]
    nb = raw_cf.shape[1]
    pri = priors_hw.contiguous()
    out = torch.empty((nb, B * h * w, (14 if aleatoric else 7) + cls_cnt),
                      dtype=torch.float32, device=raw_cf.device)
    with torch.cuda.device(raw_cf.device):
        rc = _lib().box_decode_launch(
            raw_cf.data_ptr(), pri.data_ptr(), out.data_ptr(),
            B, nb, h, w, cls_cnt, layer_id, int(aleatoric),
            torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"box_decode kernel launch failed (cudaError {rc})")
    launch_count += 1
    return out


def fused_box_decode_all_scales(outs, priors_by_stride, *, spec: VariantSpec):
    """All-scales batched decode. ``outs``: [(raw_cf (ch, nb, h*w), (h, w)),
    ...] from ``models.yolov3.forward_cf``, scale order 32/16/8 (layer ids
    0/1/2); ``priors_by_stride``: {stride: (B, 2) tensor}.  Returns (nb,
    N_total, width) flat decoded rows in the reference concat order."""
    return torch.cat(
        [
            fused_box_decode_cf(
                raw_cf, priors_by_stride[stride], h=hw[0], w=hw[1],
                cls_cnt=spec.cls_cnt, layer_id=i, aleatoric=spec.aleatoric_head,
            )
            for i, ((raw_cf, hw), stride) in enumerate(zip(outs, (32, 16, 8)))
        ],
        dim=1,
    )
