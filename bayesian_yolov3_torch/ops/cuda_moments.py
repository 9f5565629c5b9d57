"""The split form of the epistemic decode, for MC samples sharded over
ranks: the partial-moments and the finalize kernels, their wrappers and
their plain PyTorch versions.

Replace the TPU kernels ``bayesian_yolov3_tpu/ops/pallas_epistemic.py``
``_moments_kernel`` (behind ``epistemic_moments_cf``) and
``_finalize_kernel`` (behind ``epistemic_finalize``).  Each rank reduces
its own samples to unscaled sums (``csrc/epistemic_moments.cu``), the sums
are all-reduced (``parallel/epistemic.py``), and the global sums become
the (21+C)-wide rows of the one-shot epistemic decode
(``csrc/epistemic_finalize.cu``).  On the mc path a frame's three scales
travel in ONE packed buffer (``decode.packed_views``: scale after scale,
each a contiguous (B, 21+C, h*w) block that ``epistemic_moments_cf(...,
out=view)`` fills): one all-reduce, then one finalize launch over a
three-scale table (``cuda_decode.ScaleTable``) that writes the rows
concatenated (``epistemic_finalize_all_scales``).  Both kernels share the
per-sample sums and the row finalization with ``csrc/epistemic_decode.cu``
(``csrc/decode_common.cuh``), and the moments kernel splits and combines
each anchor's samples as the one-shot kernel does (``reduce_anchor_samples``,
G from ``cuda_epistemic.frame_parts``): at T_local = T the split form of a
frame gives the one-shot kernel's rows bit for bit; over several ranks it
differs only in the order of the sums.  Both are bound by bytes.

Moment row layout, M = 21+C rows per prior, anchors minor (the JAX
package's order exactly, since the all-reduce adds it across ranks):

    [0:4)      sum loc (tx, ty, tw, th)
    [4:14)     sum loc_i * loc_j, upper triangle in (i <= j) row-major order
    [14:18)    sum exp(log_loc_var)
    [18]       sum sigmoid(obj)
    [19]       sum logistic entropy of sigmoid(obj)
    [20:20+C)  sum softmax(cls)
    [20+C]     sum softmax entropy

On a CUDA tensor the wrappers launch the kernel or raise; the plain
versions run only for tensors that lie on the CPU (and where a caller asks
for them by name, to compare).
"""

from __future__ import annotations

import ctypes

import torch

from ..core.priors import STRIDES
from . import _build, decode
from .cuda_decode import load_table_kernel, scale_table
from .cuda_epistemic import check_split_warps, frame_parts

MAX_CLASSES = 8  # MOM_MAX_C / FIN_MAX_C of the two sources

TRIU = [(i, j) for i in range(4) for j in range(i, 4)]

# kernel launches made by this module, by kernel
launch_counts = {"epistemic_moments": 0, "epistemic_finalize": 0}


def _moments_lib():
    lib = _build.load("epistemic_moments")
    fn = lib.epistemic_moments_launch
    if not fn.argtypes:  # x, out, B, T, total, C, G, stream
        check_split_warps(lib, "epistemic_moments")
        fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
                       + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _finalize_lib():  # table, out, B, n_imgs, T, C, stream
    return load_table_kernel("epistemic_finalize")


def _check_classes(cls_cnt):
    if not 1 <= cls_cnt <= MAX_CLASSES:
        raise ValueError(f"cls_cnt {cls_cnt} outside [1, {MAX_CLASSES}]")


def _check_moments(raw_cf, cls_cnt, n_priors):
    if raw_cf.dtype != torch.float32:
        raise TypeError("the epistemic moments take float32 raws")
    if raw_cf.dim() != 3:
        raise ValueError(f"raw_cf has shape {tuple(raw_cf.shape)}, want (B*chpp, T, total)")
    _check_classes(cls_cnt)
    chpp = 2 * (5 + cls_cnt)
    if raw_cf.shape[0] != n_priors * chpp:
        raise ValueError(f"{raw_cf.shape[0]} channels != {n_priors} priors x {chpp}")
    if raw_cf.shape[1] < 1:
        raise ValueError("no MC samples")


def _check_finalize(moments, priors_hw, T, h, w, cls_cnt, n_imgs):
    if moments.dtype != torch.float32 or priors_hw.dtype != torch.float32:
        raise TypeError("epistemic finalize takes float32 moments and priors")
    if moments.dim() != 3 or priors_hw.dim() != 2 or priors_hw.shape[1] != 2:
        raise ValueError(f"shapes {tuple(moments.shape)}, {tuple(priors_hw.shape)}")
    _check_classes(cls_cnt)
    B, M, total = moments.shape
    if B != priors_hw.shape[0]:
        raise ValueError(f"{B} priors of moments != {priors_hw.shape[0]} priors")
    if M != 21 + cls_cnt:
        raise ValueError(f"{M} moment rows != 21 + {cls_cnt}")
    if total != n_imgs * h * w:
        raise ValueError(f"anchor axis {total} != {n_imgs}*{h}*{w}")
    if T < 1:
        raise ValueError(f"T = {T}")
    if priors_hw.device != moments.device:
        raise ValueError("priors and moments lie on different devices")


def epistemic_moments_plain(raw_cf, *, cls_cnt: int, n_priors: int = 3) -> torch.Tensor:
    """The same function in plain PyTorch, over the whole sample axis."""
    _check_moments(raw_cf, cls_cnt, n_priors)
    ch, t_local, total = raw_cf.shape
    x = raw_cf.reshape(n_priors, ch // n_priors, t_local, total)
    loc = x[:, 0:4]  # (B, 4, T, total)
    obj = torch.sigmoid(x[:, 8])  # (B, T, total)
    probs = torch.softmax(x[:, 10:10 + cls_cnt], dim=1)  # (B, C, T, total)
    sums = [
        loc.sum(dim=2),
        torch.stack([(loc[:, i] * loc[:, j]).sum(dim=1) for i, j in TRIU], dim=1),
        torch.exp(x[:, 4:8]).sum(dim=2),
        obj.sum(dim=1)[:, None],
        decode.logistic_entropy(obj).sum(dim=1)[:, None],
        probs.sum(dim=2),
        (-decode._xlogx(probs).sum(dim=1)).sum(dim=1)[:, None],
    ]
    return torch.cat(sums, dim=1)  # (B, 21+C, total)


def _check_out(out, raw_cf, cls_cnt, n_priors):
    want = (n_priors, 21 + cls_cnt, raw_cf.shape[2])
    if tuple(out.shape) != want:
        raise ValueError(f"out has shape {tuple(out.shape)}, want {want}")
    if out.dtype != torch.float32:
        raise TypeError(f"out is {out.dtype}, want float32")
    if out.device != raw_cf.device:
        raise ValueError("out and raws lie on different devices")
    if not out.is_contiguous():
        raise ValueError("out is not contiguous")


def epistemic_moments_cf(raw_cf, *, cls_cnt: int, n_priors: int = 3,
                         out: torch.Tensor = None) -> torch.Tensor:
    """Partial epistemic moment sums over the LOCAL sample axis:
    raw_cf (B*chpp, T_local, total) f32 (the ``detection_conv_cf`` layout)
    -> (B, 21+C, total) f32.  All-reduce these across the ranks to get the
    global sums for ``epistemic_finalize``.  ``out``: a contiguous float32
    (B, 21+C, total) tensor (a scale's view of a frame's packed buffer) that
    is filled and returned, in place of a new one."""
    _check_moments(raw_cf, cls_cnt, n_priors)
    if out is not None:
        _check_out(out, raw_cf, cls_cnt, n_priors)
    if not raw_cf.is_cuda:
        sums = epistemic_moments_plain(raw_cf, cls_cnt=cls_cnt, n_priors=n_priors)
        return sums if out is None else out.copy_(sums)
    if not raw_cf.is_contiguous():
        raise ValueError("the epistemic moments kernel takes a contiguous raw_cf")
    # the anchor axis is one frame on the mc path: G as the decode takes it
    # for that frame
    _, t_local, total = raw_cf.shape
    return _moments_launch(raw_cf, cls_cnt, n_priors, out,
                           frame_parts(t_local, n_priors, 1, total))


def _moments_launch(raw_cf, cls_cnt, n_priors, out, parts):
    """The kernel with each anchor's samples split over ``parts`` warps (the
    wrapper passes ``frame_parts``; a measurement may pass another), into
    ``out`` (checked by the caller) or, if None, a new tensor."""
    _, t_local, total = raw_cf.shape
    if out is None:
        out = torch.empty((n_priors, 21 + cls_cnt, total), dtype=torch.float32,
                          device=raw_cf.device)
    with torch.cuda.device(raw_cf.device):
        rc = _moments_lib()(
            raw_cf.data_ptr(), out.data_ptr(), n_priors, t_local, total, cls_cnt, parts,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"epistemic_moments kernel launch failed (cudaError {rc})")
    launch_counts["epistemic_moments"] += 1
    return out


def epistemic_finalize_plain(moments, priors_hw, *, T: int, h: int, w: int, cls_cnt: int,
                             layer_id: int, n_imgs: int = 1) -> torch.Tensor:
    """The same function in plain PyTorch: the sums scaled by 1/T, the
    covariance E[xx^T] - E[x]E[x]^T and the predictive entropies, then
    decode_bbox_epistemic -> concat, as the one-shot plain version ends."""
    _check_finalize(moments, priors_hw, T, h, w, cls_cnt, n_imgs)
    B, M, _ = moments.shape
    m = (moments * (1.0 / T)).reshape(B, M, n_imgs, h, w).permute(2, 3, 4, 0, 1)
    ev = m[..., 0:4]  # (n_imgs, h, w, B, 4)
    cov = torch.empty((*ev.shape, 4), dtype=torch.float32, device=m.device)
    for k, (i, j) in enumerate(TRIU):
        cij = m[..., 4 + k] - ev[..., i] * ev[..., j]
        cov[..., i, j] = cij
        cov[..., j, i] = cij
    obj_mean = m[..., 18]
    obj_pred_ent = decode.logistic_entropy(obj_mean)
    cls_mean = m[..., 20:20 + cls_cnt]
    cls_pred_ent = decode.softmax_entropy(cls_mean)
    stats = {
        "ev_loc": ev,
        "epi_covar_loc": cov,
        "ale_var_loc": m[..., 14:18],
        "obj_mean": obj_mean,
        "obj_mutual_info": obj_pred_ent - m[..., 19],
        "obj_entropy": obj_pred_ent,
        "cls_mean": cls_mean,
        "cls_mutual_info": cls_pred_ent - m[..., 20 + cls_cnt],
        "cls_entropy": cls_pred_ent,
    }
    rows = decode.decode_bbox_epistemic(stats, priors_hw, layer_id)  # (n, h, w, B, W)
    return decode.concat_all_scales_batched([rows])


def epistemic_finalize(moments, priors_hw, *, T: int, h: int, w: int, cls_cnt: int,
                       layer_id: int, n_imgs: int = 1) -> torch.Tensor:
    """Global moment sums (B, 21+C, n_imgs*h*w) f32 -> (n_imgs, B*h*w, 21+C)
    f32 rows in the reference concat order per image, the output of
    ``fused_epistemic_decode_cf_batched``.  ``T`` is the GLOBAL sample count
    (every rank's samples), which scales the sums.  On the card: the kernel
    over a one-scale table."""
    _check_finalize(moments, priors_hw, T, h, w, cls_cnt, n_imgs)
    if not moments.is_cuda:
        return epistemic_finalize_plain(moments, priors_hw, T=T, h=h, w=w, cls_cnt=cls_cnt,
                                        layer_id=layer_id, n_imgs=n_imgs)
    if not moments.is_contiguous():
        raise ValueError("the epistemic finalize kernel takes contiguous moments")
    return _finalize_launch([moments.data_ptr()], [priors_hw], [layer_id],
                            decode.scale_plan([(h, w)], priors_hw.shape[0]), T, cls_cnt, n_imgs,
                            moments.device)


def _finalize_launch(x_ptrs, priors, layer_ids, plan, T, cls_cnt, n_imgs, device):
    """One launch over the scales whose sums lie at ``x_ptrs`` (checked by
    the caller)."""
    pris = [p.contiguous() for p in priors]
    out = torch.empty((n_imgs, plan.rows, 21 + cls_cnt), dtype=torch.float32, device=device)
    table = scale_table(plan, x_ptrs, [p.data_ptr() for p in pris], layer_ids)
    with torch.cuda.device(device):
        rc = _finalize_lib()(ctypes.byref(table), out.data_ptr(), plan.n_priors, n_imgs, T,
                             cls_cnt, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"epistemic_finalize kernel launch failed (cudaError {rc})")
    launch_counts["epistemic_finalize"] += 1
    return out


def _check_packed(packed, priors_by_stride, T, hws, cls_cnt, n_imgs):
    """What ``epistemic_finalize`` checks of each scale's sums, checked
    once for a packed buffer; the plan and the scales' priors."""
    if not 1 <= len(hws) <= len(STRIDES):
        raise ValueError(f"{len(hws)} scales; the finalize takes 1 to {len(STRIDES)}")
    priors = [priors_by_stride[s] for s in STRIDES[:len(hws)]]
    if packed.dtype != torch.float32 or any(p.dtype != torch.float32 for p in priors):
        raise TypeError("epistemic finalize takes float32 moments and priors")
    if not packed.is_contiguous():
        raise ValueError("the packed moments are not contiguous")
    _check_classes(cls_cnt)
    if T < 1:
        raise ValueError(f"T = {T}")
    B = priors[0].shape[0]
    if any(p.dim() != 2 or tuple(p.shape) != (B, 2) for p in priors):
        raise ValueError(f"priors of shapes {[tuple(p.shape) for p in priors]}, want ({B}, 2)")
    plan = decode.scale_plan(hws, B)
    if packed.numel() != plan.rows * (21 + cls_cnt) * n_imgs:
        raise ValueError(f"packed moments of {packed.numel()} floats, want "
                         f"{plan.rows} rows x {21 + cls_cnt} x {n_imgs} images")
    if any(p.device != packed.device for p in priors):
        raise ValueError("priors and moments lie on different devices")
    return plan, priors


def epistemic_finalize_all_scales_plain(packed, priors_by_stride, *, T: int, hws,
                                        cls_cnt: int, n_imgs: int = 1) -> torch.Tensor:
    """The same function in plain PyTorch: each scale's plain rows written
    at ``decode.scale_plan``'s offsets."""
    plan, priors = _check_packed(packed, priors_by_stride, T, hws, cls_cnt, n_imgs)
    out = torch.empty((n_imgs, plan.rows, 21 + cls_cnt), dtype=torch.float32,
                      device=packed.device)
    views = decode.packed_views(packed.reshape(-1), plan, 21 + cls_cnt, n_imgs)
    for i, (m, (h, w), pri) in enumerate(zip(views, plan.hws, priors)):
        off = plan.row_off[i]
        out[:, off:off + plan.n_priors * h * w] = epistemic_finalize_plain(
            m, pri, T=T, h=h, w=w, cls_cnt=cls_cnt, layer_id=i, n_imgs=n_imgs)
    return out


def epistemic_finalize_all_scales(packed, priors_by_stride, *, T: int, hws, cls_cnt: int,
                                  n_imgs: int = 1) -> torch.Tensor:
    """A frame's global sums of every scale, packed (``decode.packed_views``:
    scale s of ``hws`` a contiguous (B, 21+C, n_imgs*h*w) block, scale order
    32/16/8, layer ids 0/1/2) -> (n_imgs, N_total, 21+C) f32 rows in the
    reference concat order, the output of the three one-shot decodes
    concatenated; one kernel launch on the card.  ``priors_by_stride``:
    {stride: (B, 2) tensor}; ``T`` the GLOBAL sample count."""
    plan, priors = _check_packed(packed, priors_by_stride, T, hws, cls_cnt, n_imgs)
    if not packed.is_cuda:
        return epistemic_finalize_all_scales_plain(packed, priors_by_stride, T=T, hws=hws,
                                                   cls_cnt=cls_cnt, n_imgs=n_imgs)
    base, step = packed.data_ptr(), (21 + cls_cnt) * n_imgs * packed.element_size()
    return _finalize_launch([base + off * step for off in plan.row_off], priors,
                            list(range(len(plan.hws))), plan, T, cls_cnt, n_imgs,
                            packed.device)
