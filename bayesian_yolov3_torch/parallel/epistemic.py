"""MC-sample-parallel epistemic inference over a ``torch.distributed`` group.

PyTorch counterpart of the JAX package's ``parallel/epistemic.py``.  The T
MC-dropout samples of one image are split over the N ranks of an ``mc``
group (``parallel.mesh.make_groups``); every rank runs the backbone on the
whole image and the dropout-bearing heads on its T/N samples.  Two ways:

* ``make_mc_sharded_fused_pipeline`` — the fast one: each rank reduces its
  samples to unscaled moment sums (``ops.cuda_moments.epistemic_moments_cf``,
  a hand-written kernel) written into one packed buffer per frame (the
  three scales' (B, 21+C, h*w) float32 blocks one after the other,
  independent of T), the buffer is all-reduced once, and every rank
  finalizes the global sums of all three scales into the concatenated
  decoded rows in one launch (``epistemic_finalize_all_scales``, a second
  kernel) and runs exact NMS.  With quantized heads (``quantize="int8"``)
  the rank's samples run the int8 head section (``models.quant``).
* ``make_mc_sharded_forward`` — the fallback: each rank computes its
  samples' raw heads and all-gathers them, so every rank holds all T
  samples (ch, T, h*w) per scale, for the one-shot epistemic decode.

Keys.  Every rank draws the same full (T, 15) key table — from the caller's
generator seeded identically on every rank, or the constant table of
``fixed_masks`` — and takes its rows ``local_rows(table, rank, N)``.  A
hash-dropout mask depends on its (sample, site) key and the per-sample
flat index only, not on how many samples are stacked, so the sharded
samples equal the single-device samples of the same table: drawn keys and
fixed masks alike (the JAX package's rbg keys are not layout-invariant;
this port's are).
"""

from __future__ import annotations

import torch

from ..models.quant import mc_forward_cf_q
from ..models.yolov3 import _key_table, mc_forward_cf
from ..ops import decode as ops_decode
from ..ops import nms
from ..ops.cuda_moments import epistemic_finalize_all_scales, epistemic_moments_cf
from .mesh import Group, local_rows


def _check_split(T: int, group: Group):
    if T % group.size:
        raise ValueError(f"T={T} does not divide over the {group.size} ranks of the mc axis")


def _local_raws(model, group: Group, T: int, fixed_masks, params, stats, img, rng,
                qheads=None):
    """This rank's samples of the three raw heads: [(raw_cf (ch, T/N, h*w),
    (h, w)), ...], from its rows of the full key table; with ``qheads`` (the
    quantized heads of ``ops.quant.quantize_heads``) the backbone outputs
    quantize at the entry scales and the rank's samples run the int8
    heads."""
    if img.shape[0] != 1:
        raise ValueError("the mc-sharded path is batch 1")
    keys = local_rows(_key_table(rng, fixed_masks, T), group.rank, group.size)
    kw = dict(spec=model.spec, T=T // group.size, rng=keys, compute_dtype=model._dtype)
    if qheads is None:
        return mc_forward_cf(params, stats, img, **kw)
    return mc_forward_cf_q(qheads, params, stats, img, **kw)


def sharded_moments_rows(outs, group: Group, T: int, priors_by_stride,
                         cls_cnt: int) -> torch.Tensor:
    """The back half of the fused mc pipeline: this rank's T/N samples of a
    frame, [(raw_cf (ch, T/N, h*w), (h, w)), ...] -> their moment sums, the
    three scales into one packed float32 buffer (one launch a scale) -> one
    all-reduce over ``group`` -> one finalize launch with the global T.
    Returns the decoded rows of every anchor, (N_total, 21+C), the same on
    every rank of the group."""
    n_priors = priors_by_stride[32].shape[0]
    hws = [hw for _, hw in outs]
    plan = ops_decode.scale_plan(hws, n_priors)
    packed = torch.empty(plan.rows * (21 + cls_cnt), dtype=torch.float32,
                         device=outs[0][0].device)
    for (raw_cf, _), sums in zip(outs, ops_decode.packed_views(packed, plan, 21 + cls_cnt)):
        epistemic_moments_cf(raw_cf, cls_cnt=cls_cnt, n_priors=n_priors, out=sums)
    group.all_reduce(packed)
    return epistemic_finalize_all_scales(packed, priors_by_stride, T=T, hws=hws,
                                         cls_cnt=cls_cnt)[0]


def make_mc_sharded_forward(model, group: Group, T: int):
    """Build ``fn(params, stats, img (1, H, W, 3) float, rng) -> [(raw_cf
    (ch, T, h*w), (h, w)), ...]``: the raw heads of all T samples on every
    rank, in global sample order, each rank having computed T/N of them.
    ``rng``: a CPU ``torch.Generator`` seeded alike on every rank, or a
    (T, 15) key table."""
    _check_split(T, group)

    @torch.no_grad()
    def call(params, stats, img, rng):
        outs = _local_raws(model, group, T, None, params, stats, img, rng)
        return [(group.all_gather(raw_cf, dim=1), hw) for raw_cf, hw in outs]

    return call


def make_mc_sharded_fused_pipeline(model, group: Group, T: int, *, priors_by_stride,
                                   obj_idx: int, nms_max_boxes: int = 1000,
                                   nms_iou_thresh: float = 0.5, fixed_masks=None):
    """Build ``fn(params, stats, img (1, H, W, 3) float, rng=None,
    qheads=None) -> (rows (1, max_out, 21+C), valid (1, max_out))``:

      per rank:    backbone -> heads on the rank's T/N samples -> the
                   channels-first 1x1 detection conv -> partial moment sums,
                   the three scales' into one packed float32 buffer
      collective:  one all-reduce (sum) of the packed buffer
      every rank:  one finalize launch with the GLOBAL T, the three scales'
                   rows written concatenated -> exact NMS

    ``fn.decode`` stops before NMS.  ``qheads`` (None or the quantized
    heads of ``ops.quant.quantize_heads``): the rank's samples run the int8
    head section; the sums are float32 either way.  ``priors_by_stride``:
    {stride: (B, 2) tensor on the rank's device}.  ``fixed_masks`` (int
    seed or None): the constant key table of the single-device fixed-mask
    runs; ``rng`` is then ignored, else it is a CPU ``torch.Generator``
    seeded alike on every rank or a (T, 15) table.  NMS is exact (over
    every anchor), so there is no certificate to check and no retry."""
    _check_split(T, group)

    @torch.no_grad()
    def decode(params, stats, img, rng=None, qheads=None) -> torch.Tensor:
        """The decoded rows of every anchor, (N_total, 21+C), the same on
        every rank: local sums of the three scales into one packed buffer ->
        one all-reduce -> one finalize launch."""
        outs = _local_raws(model, group, T, fixed_masks, params, stats, img, rng, qheads)
        return sharded_moments_rows(outs, group, T, priors_by_stride, model.spec.cls_cnt)

    def call(params, stats, img, rng=None, qheads=None):
        rows, valid, _ = nms.nms_select(decode(params, stats, img, rng, qheads), obj_idx,
                                        nms_max_boxes, nms_iou_thresh, pre_top_k=0)
        return rows[None], valid[None]

    call.decode = decode
    return call
