"""Per-sample box decode of the batched standard / aleatoric heads: the
hand-written CUDA kernel, its wrappers and its plain PyTorch versions.

Replaces the TPU kernel ``bayesian_yolov3_tpu/ops/pallas_decode.py:_kernel``
(behind ``fused_box_decode_cf`` / ``fused_box_decode_all_scales``).  The
kernel source is ``csrc/box_decode.cu``: ONE launch decodes every scale of
a batch, walking a table of up to three scales (``csrc/scale_table.cuh``,
passed by value; ``ScaleTable`` below mirrors it, filled from
``decode.scale_plan``) and writing each scale's rows where they lie in the
concatenated output, so no ``torch.cat`` follows.  One thread per (image,
prior, cell) reads the channels-first raw heads with coalesced loads and a
block writes its rows back through shared memory as one contiguous run.  It
is bound by bytes.  ``fused_box_decode_cf`` launches the same kernel over a
one-scale table.

On a CUDA tensor the wrappers launch the kernel or raise; the plain
versions run only for tensors that lie on the CPU (and where a caller asks
for them by name, to compare).
"""

from __future__ import annotations

import ctypes

import torch

from ..core.blueprint import Variant, VariantSpec
from ..core.priors import STRIDES  # the scales of forward_cf, in concat order (layer ids 0, 1, 2)
from . import _build, decode

MAX_CLASSES = 8  # BOX_MAX_C of csrc/box_decode.cu
MAX_SCALES = 3  # MAX_SCALES of csrc/scale_table.cuh

launch_count = 0  # kernel launches made by this module's wrappers


class ScaleTable(ctypes.Structure):
    """``struct ScaleTable`` of csrc/scale_table.cuh, field for field."""

    _fields_ = [("x", ctypes.c_void_p * MAX_SCALES), ("pri", ctypes.c_void_p * MAX_SCALES),
                ("h", ctypes.c_int * MAX_SCALES), ("w", ctypes.c_int * MAX_SCALES),
                ("layer_id", ctypes.c_int * MAX_SCALES),
                ("first_block", ctypes.c_int * (MAX_SCALES + 1)),
                ("row_off", ctypes.c_int * MAX_SCALES), ("n_scales", ctypes.c_int),
                ("rows", ctypes.c_int)]


def scale_table(plan: decode.ScalePlan, x_ptrs, pri_ptrs, layer_ids) -> ScaleTable:
    """The kernel parameter of one launch: the plan's offsets and blocks,
    each scale's input and priors (addresses of contiguous float32 data on
    the card, which the caller keeps alive until the launch is queued)."""
    n = len(plan.hws)
    t = ScaleTable(n_scales=n, rows=plan.rows)
    t.x[:n], t.pri[:n], t.layer_id[:n] = x_ptrs, pri_ptrs, layer_ids
    t.h[:n], t.w[:n] = [h for h, _ in plan.hws], [w for _, w in plan.hws]
    t.row_off[:n], t.first_block[:n + 1] = plan.row_off, plan.first_block
    return t


def load_table_kernel(name: str):
    """The launch function of ``csrc/<name>.cu``, a one-launch kernel over a
    ``ScaleTable``: (table, out, four ints, stream).  The library's table
    size and block are checked against this module's on the first load."""
    lib = _build.load(name)
    fn = getattr(lib, f"{name}_launch")
    if not fn.argtypes:
        size = getattr(lib, f"{name}_table_bytes")()
        block = getattr(lib, f"{name}_scale_block")()
        if size != ctypes.sizeof(ScaleTable) or block != decode.SCALE_BLOCK:
            raise RuntimeError(f"{name}: the library's scale table ({size} bytes, blocks of "
                               f"{block} cells) is not ops/cuda_decode.py's "
                               f"({ctypes.sizeof(ScaleTable)}, {decode.SCALE_BLOCK})")
        fn.argtypes = ([ctypes.POINTER(ScaleTable), ctypes.c_void_p] + [ctypes.c_int] * 4
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _lib():  # table, out, B, nb, C, aleatoric, stream
    return load_table_kernel("box_decode")


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


def _width(cls_cnt, aleatoric):
    return (14 if aleatoric else 7) + cls_cnt


def fused_box_decode_cf(raw_cf, priors_hw, *, h: int, w: int, cls_cnt: int,
                        layer_id: int, aleatoric: bool) -> torch.Tensor:
    """raw_cf (B*chpp, nb, h*w) f32 -> (nb, B*h*w, 7+C or 14+C) f32, rows in
    the reference concat order per image (prior-major, then row-major
    cells): the kernel over a one-scale table."""
    _check(raw_cf, priors_hw, h, w, cls_cnt, aleatoric)
    if not raw_cf.is_cuda:
        return box_decode_plain(raw_cf, priors_hw, h=h, w=w, cls_cnt=cls_cnt,
                                layer_id=layer_id, aleatoric=aleatoric)
    return _decode_launch([raw_cf], [priors_hw], [layer_id], [(h, w)], cls_cnt,
                          aleatoric)


def _decode_launch(raws, priors, layer_ids, hws, cls_cnt, aleatoric):
    """One launch over the scales ``raws`` (checked by the caller)."""
    global launch_count
    if not all(r.is_contiguous() for r in raws):
        raise ValueError("the box decode kernel takes a contiguous raw_cf")
    B, nb = priors[0].shape[0], raws[0].shape[1]
    plan = decode.scale_plan(hws, B)
    pris = [p.contiguous() for p in priors]
    out = torch.empty((nb, plan.rows, _width(cls_cnt, aleatoric)), dtype=torch.float32,
                      device=raws[0].device)
    table = scale_table(plan, [r.data_ptr() for r in raws], [p.data_ptr() for p in pris],
                        layer_ids)
    with torch.cuda.device(out.device):
        rc = _lib()(ctypes.byref(table), out.data_ptr(), B, nb, cls_cnt, int(aleatoric),
                    torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"box_decode kernel launch failed (cudaError {rc})")
    launch_count += 1
    return out


def _check_all_scales(outs, priors_by_stride, spec):
    if not 1 <= len(outs) <= MAX_SCALES:
        raise ValueError(f"{len(outs)} scales; the decode takes 1 to {MAX_SCALES}")
    raw0, pri0 = outs[0][0], priors_by_stride[STRIDES[0]]
    for i, ((raw_cf, (h, w)), stride) in enumerate(zip(outs, STRIDES)):
        pri = priors_by_stride[stride]
        _check(raw_cf, pri, h, w, spec.cls_cnt, spec.aleatoric_head)
        if raw_cf.shape[1] != raw0.shape[1] or pri.shape[0] != pri0.shape[0]:
            raise ValueError(f"scale {i}: {raw_cf.shape[1]} images and {pri.shape[0]} priors, "
                             f"scale 0: {raw0.shape[1]} and {pri0.shape[0]}")
        if raw_cf.device != raw0.device:
            raise ValueError("the scales lie on different devices")


def box_decode_all_scales_plain(outs, priors_by_stride, *, spec: VariantSpec) -> torch.Tensor:
    """The same function in plain PyTorch: each scale's plain rows written
    at ``decode.scale_plan``'s offsets."""
    _check_all_scales(outs, priors_by_stride, spec)
    B, nb = priors_by_stride[STRIDES[0]].shape[0], outs[0][0].shape[1]
    plan = decode.scale_plan([hw for _, hw in outs], B)
    out = torch.empty((nb, plan.rows, _width(spec.cls_cnt, spec.aleatoric_head)),
                      dtype=torch.float32, device=outs[0][0].device)
    for i, ((raw_cf, (h, w)), stride) in enumerate(zip(outs, STRIDES)):
        off = plan.row_off[i]
        out[:, off:off + B * h * w] = box_decode_plain(
            raw_cf, priors_by_stride[stride], h=h, w=w, cls_cnt=spec.cls_cnt, layer_id=i,
            aleatoric=spec.aleatoric_head)
    return out


def fused_box_decode_all_scales(outs, priors_by_stride, *, spec: VariantSpec):
    """All-scales batched decode. ``outs``: [(raw_cf (ch, nb, h*w), (h, w)),
    ...] from ``models.yolov3.forward_cf``, scale order 32/16/8 (layer ids
    0/1/2); ``priors_by_stride``: {stride: (B, 2) tensor}.  Returns (nb,
    N_total, width) flat decoded rows in the reference concat order, from
    one kernel launch on the card."""
    _check_all_scales(outs, priors_by_stride, spec)
    if not outs[0][0].is_cuda:
        return box_decode_all_scales_plain(outs, priors_by_stride, spec=spec)
    return _decode_launch([raw for raw, _ in outs],
                          [priors_by_stride[s] for s in STRIDES[:len(outs)]],
                          list(range(len(outs))), [hw for _, hw in outs], spec.cls_cnt,
                          spec.aleatoric_head)
