"""Greedy class-agnostic NMS: the hand-written CUDA kernel, its wrapper and
its plain PyTorch version.

Replaces the TPU kernels ``bayesian_yolov3_tpu/ops/pallas_nms.py:_imgvec_kernel``
(``greedy_nms_pallas_imgvec``) and ``:_kernel`` (``greedy_nms_pallas_batched``,
``greedy_nms_pallas``) — one CUDA kernel for both, any candidate count.
The source is ``csrc/greedy_nms.cu``: one thread block per image runs the
whole selection loop; what bounds it is the serial chain of ``max_out``
dependent block-wide argmax steps, not bytes or flops.

Selection rules (both versions, index for index): suppress IoU > thresh
(strict); a NaN IoU (zero-area boxes) keeps the candidate alive; ties go to
the lower index; a -inf score is never picked.  Scores and coordinates must
not be NaN.

On a CUDA tensor the wrapper launches the kernel or raises; the plain
version runs only for tensors that lie on the CPU (and where a caller asks
for it by name, to compare).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build

launch_count = 0  # kernel launches made by this module's wrapper


def _lib():
    lib = _build.load("greedy_nms")
    fn = lib.greedy_nms_launch
    if not fn.argtypes:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.greedy_nms_smem_limit.restype = ctypes.c_int
    return lib


def _check(boxes, scores, max_out):
    if boxes.dtype != torch.float32 or scores.dtype != torch.float32:
        raise TypeError("greedy NMS takes float32 boxes and scores")
    if boxes.dim() != 3 or boxes.shape[2] != 4 or scores.shape != boxes.shape[:2]:
        raise ValueError(f"shapes {tuple(boxes.shape)}, {tuple(scores.shape)}")
    if boxes.device != scores.device:
        raise ValueError("boxes and scores lie on different devices")
    if max_out < 1 or boxes.shape[1] < 1:
        raise ValueError("max_out and the candidate count must be positive")


def greedy_nms_plain(boxes, scores, max_out: int = 1000,
                     iou_thresh: float = 0.5) -> Tuple[torch.Tensor, torch.Tensor]:
    """The greedy loop in plain PyTorch, all images advancing one step per
    iteration.  (NB, K, 4) [y0,x0,y1,x1], (NB, K) -> indices (NB, max_out)
    int32, -1 padded past count (NB,) int32."""
    _check(boxes, scores, max_out)
    nb, k = scores.shape
    dev = boxes.device
    y0, x0, y1, x1 = boxes.unbind(dim=2)
    areas = (y1 - y0).clamp(min=0.0) * (x1 - x0).clamp(min=0.0)
    ids = torch.arange(k, device=dev)
    img = torch.arange(nb, device=dev)
    neg_inf = torch.tensor(float("-inf"), device=dev)
    alive = torch.ones((nb, k), dtype=torch.bool, device=dev)
    out = torch.full((nb, max_out), -1, dtype=torch.int32, device=dev)
    count = torch.zeros(nb, dtype=torch.int32, device=dev)
    for t in range(max_out):
        masked = torch.where(alive, scores, neg_inf)
        m = masked.max(dim=1).values
        ok = m > neg_inf
        if not bool(ok.any()):
            break
        # lowest index among the maximal scores
        idx = torch.where(masked == m[:, None], ids, k).min(dim=1).values
        b = boxes[img, idx]  # (NB, 4)
        iy0 = torch.maximum(y0, b[:, 0:1])
        ix0 = torch.maximum(x0, b[:, 1:2])
        iy1 = torch.minimum(y1, b[:, 2:3])
        ix1 = torch.minimum(x1, b[:, 3:4])
        inter = (iy1 - iy0).clamp(min=0.0) * (ix1 - ix0).clamp(min=0.0)
        iou = inter / (areas + areas[img, idx][:, None] - inter)
        nxt = alive & ~(iou > iou_thresh)  # NaN IoU compares False: stays alive
        nxt[img, idx] = False
        alive = torch.where(ok[:, None], nxt, alive)
        out[:, t] = torch.where(ok, idx.to(torch.int32), -1)
        count += ok.to(torch.int32)
    return out, count


def greedy_nms_cuda(boxes, scores, max_out: int = 1000,
                    iou_thresh: float = 0.5) -> Tuple[torch.Tensor, torch.Tensor]:
    """(NB, K, 4) boxes + (NB, K) scores -> (indices (NB, max_out) int32,
    -1 padded; count (NB,) int32), picks in selection order."""
    _check(boxes, scores, max_out)
    if not boxes.is_cuda:
        return greedy_nms_plain(boxes, scores, max_out, iou_thresh)
    if not (boxes.is_contiguous() and scores.is_contiguous()):
        raise ValueError("the NMS kernel takes contiguous boxes and scores")
    if boxes.data_ptr() % 16:
        raise ValueError("the NMS kernel reads boxes as float4: 16-byte alignment needed")
    global launch_count
    nb, k = scores.shape
    dev = boxes.device
    lib = _lib()
    out = torch.full((nb, max_out), -1, dtype=torch.int32, device=dev)
    count = torch.empty(nb, dtype=torch.int32, device=dev)
    in_smem = k * 20 <= lib.greedy_nms_smem_limit()
    scratch = None if in_smem else torch.empty((nb, k), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.greedy_nms_launch(
            boxes.data_ptr(), scores.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            out.data_ptr(), count.data_ptr(), nb, k, max_out, float(iou_thresh),
            torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"greedy_nms kernel launch failed (cudaError {rc})")
    launch_count += 1
    return out, count
