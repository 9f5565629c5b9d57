"""Greedy class-agnostic NMS: the hand-written CUDA kernel, its wrapper and
its plain PyTorch version.

Replaces the TPU kernels ``bayesian_yolov3_tpu/ops/pallas_nms.py:_imgvec_kernel``
(``greedy_nms_pallas_imgvec``) and ``:_kernel`` (``greedy_nms_pallas_batched``,
``greedy_nms_pallas``) — one CUDA source for both, any candidate count.
The source is ``csrc/greedy_nms.cu``: the wrapper sorts the candidates by
(score desc, index asc); greedy argmax is then a scan in that order, which
the kernels run chunk by chunk (``CHUNK`` sorted candidates): suppression by
the boxes kept in earlier chunks and the chunk's upper-triangular IoU
bitmask spread over all SMs, then one warp scans the chunk's bits.
``greedy_nms_chunked`` is that algorithm in plain PyTorch, step for step, so
the CPU tests can hold it against the greedy loop at a small chunk.

Selection rules (every version, index for index): suppress IoU > thresh
(strict); a NaN IoU (zero-area or infinite boxes, a NaN corner) keeps the
candidate alive; ties go to the lower index; a -inf score is never picked;
a NaN score ends the selection (no pick), as in the JAX package.

On a CUDA tensor the wrapper launches the kernels or raises; the plain
version runs only for tensors that lie on the CPU (and where a caller asks
for it by name, to compare).  ``launch_count`` counts wrapper calls that
launched the kernels (one NMS: three kernels per chunk).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build

launch_count = 0  # NMS runs launched on the card by this module's wrapper
CHUNK = 4096  # sorted candidates per chunk: NMS_CHUNK of csrc/greedy_nms.cu


def _lib():
    lib = _build.load("greedy_nms")
    fn = lib.greedy_nms_launch
    if not fn.argtypes:
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 3
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.greedy_nms_scratch_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.greedy_nms_scratch_bytes.restype = ctypes.c_size_t
        lib.greedy_nms_chunk.restype = ctypes.c_int
        if lib.greedy_nms_chunk() != CHUNK:
            raise RuntimeError("csrc/greedy_nms.cu and ops/cuda_nms.py disagree on CHUNK")
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
        # lowest index among the maximal scores (any index where the max is
        # NaN, an image whose step is void)
        idx = torch.where(masked == m[:, None], ids, k).min(dim=1).values.clamp(max=k - 1)
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


def _sorted(boxes, scores):
    """Candidates in (score desc, index asc) order: the greedy loop's priority.
    -> (order (NB, K) int64, boxes, scores), the last two contiguous."""
    order = torch.sort(scores, dim=1, descending=True, stable=True).indices
    sboxes = torch.gather(boxes, 1, order[:, :, None].expand(-1, -1, 4)).contiguous()
    return order, sboxes, torch.gather(scores, 1, order).contiguous()


def _iou(a, b):
    """(n, 4) x (m, 4) -> (n, m) IoU in the plain loop's arithmetic."""
    area_a = (a[:, 2] - a[:, 0]).clamp(min=0.0) * (a[:, 3] - a[:, 1]).clamp(min=0.0)
    area_b = (b[:, 2] - b[:, 0]).clamp(min=0.0) * (b[:, 3] - b[:, 1]).clamp(min=0.0)
    iy0 = torch.maximum(a[:, None, 0], b[None, :, 0])
    ix0 = torch.maximum(a[:, None, 1], b[None, :, 1])
    iy1 = torch.minimum(a[:, None, 2], b[None, :, 2])
    ix1 = torch.minimum(a[:, None, 3], b[None, :, 3])
    inter = (iy1 - iy0).clamp(min=0.0) * (ix1 - ix0).clamp(min=0.0)
    return inter / (area_a[:, None] + area_b[None, :] - inter)


def greedy_nms_chunked(boxes, scores, max_out: int = 1000, iou_thresh: float = 0.5,
                       chunk: int = CHUNK) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernels' algorithm in plain PyTorch, step for step (the CPU tests
    run it at a small ``chunk``, so picks cross chunk boundaries).  Per image,
    per chunk of sorted candidates: (1) suppressed by a box kept in an earlier
    chunk; (2) the chunk's upper-triangular IoU > thresh mask; (3) the serial
    scan — kept iff valid and suppressed by neither, stopping at ``max_out``
    picks or the first -inf.  Same outputs as ``greedy_nms_plain``."""
    _check(boxes, scores, max_out)
    nb, k = scores.shape
    order, sboxes, sscores = _sorted(boxes, scores)
    out = torch.full((nb, max_out), -1, dtype=torch.int32, device=boxes.device)
    count = torch.zeros(nb, dtype=torch.int32, device=boxes.device)
    for b in range(nb):
        kept = []  # sorted positions
        done = False
        for c0 in range(0, k, chunk):
            if done:
                break
            cb = sboxes[b, c0:c0 + chunk]
            valid = (sscores[b, c0:c0 + chunk] > float("-inf")).tolist()
            pre = ((_iou(cb, sboxes[b, kept]) > iou_thresh).any(dim=1) if kept
                   else torch.zeros(len(cb), dtype=torch.bool)).tolist()
            mask = torch.triu(_iou(cb, cb) > iou_thresh, diagonal=1)
            removed = torch.zeros(len(cb), dtype=torch.bool)
            for i in range(len(cb)):
                if not valid[i]:
                    done = True
                    break
                if pre[i] or bool(removed[i]):
                    continue
                kept.append(c0 + i)
                if len(kept) == max_out:
                    done = True
                    break
                removed |= mask[i]
        out[b, :len(kept)] = order[b, kept].to(torch.int32)
        count[b] = len(kept)
    return out, count


def greedy_nms_cuda(boxes, scores, max_out: int = 1000,
                    iou_thresh: float = 0.5) -> Tuple[torch.Tensor, torch.Tensor]:
    """(NB, K, 4) boxes + (NB, K) scores -> (indices (NB, max_out) int32,
    -1 padded; count (NB,) int32), picks in selection order."""
    _check(boxes, scores, max_out)
    if not boxes.is_cuda:
        return greedy_nms_plain(boxes, scores, max_out, iou_thresh)
    global launch_count
    nb, k = scores.shape
    if nb > 65535:
        raise ValueError(f"the NMS kernels take at most 65535 images, got {nb}")
    dev = boxes.device
    lib = _lib()
    order, sboxes, sscores = _sorted(boxes, scores)
    out = torch.full((nb, max_out), -1, dtype=torch.int32, device=dev)
    count = torch.empty(nb, dtype=torch.int32, device=dev)
    scratch = torch.empty(lib.greedy_nms_scratch_bytes(nb, max_out), dtype=torch.uint8,
                          device=dev)
    with torch.cuda.device(dev):
        rc = lib.greedy_nms_launch(
            sboxes.data_ptr(), sscores.data_ptr(), order.data_ptr(), out.data_ptr(),
            count.data_ptr(), scratch.data_ptr(), nb, k, max_out, float(iou_thresh),
            torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"greedy_nms kernel launch failed (cudaError {rc})")
    launch_count += 1
    return out, count
