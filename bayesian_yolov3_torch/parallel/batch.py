"""Data-parallel batched inference over a ``torch.distributed`` group: the
``dp`` axis.

PyTorch counterpart of the JAX package's ``parallel/batch.py``.  Each of the
N ranks of a ``dp`` group runs the whole single-device batched pipeline —
``forward_cf`` (``forward_cf_q`` with int8 heads), the box decode kernel
over the three scales (``ops.cuda_decode``), exact NMS (``pre_top_k=0``,
the greedy-NMS kernel) — on its NB/N images of the batch, rows
[r*NB/N, (r+1)*NB/N).  Then ``rows`` and ``valid`` are all-gathered over
the group, so every rank holds the whole batch in image order: the one
collective (the JAX package returns the batch sharded instead).

Keys.  The JAX package folds the device index into the dropout key, so
each device draws noise of its own.  Here every rank draws the same (N, 15)
key table from its generator, seeded alike on every rank, and rank r runs
row r: the bayesian variant's dropout masks then differ between ranks, as
the JAX package's do, and rank r's rows are the single-device rows of its
images under key row r.
"""

from __future__ import annotations

import torch

from ..models.quant import forward_cf_q
from ..models.yolov3 import _key_table, forward_cf
from ..ops import nms
from ..ops.cuda_decode import fused_box_decode_all_scales
from .mesh import Group, local_rows


def make_dp_batched_pipeline(model, group: Group, *, priors_by_stride, obj_idx: int,
                             nms_max_boxes: int = 1000, nms_iou_thresh: float = 0.5,
                             standard_test_dropout: bool = False):
    """Build ``fn(params, stats, x (NB/N, H, W, 3) float, rng=None,
    qheads=None) -> (rows (NB, max_out, width), valid (NB, max_out))``, the
    whole batch's detections on every rank, each rank having computed its
    NB/N images ``x``.  ``fn.shard(images)`` is the rank's share of a whole
    batch (a host array, so that only the share is copied to the device and
    converted).  ``rng``: where the bayesian variant's dropout is active, a
    CPU ``torch.Generator`` seeded alike on every rank or an (N, 15) key
    table (rank r takes row r); else ignored.  ``qheads``: the quantized
    heads of ``ops.quant.quantize_heads``, or None.  ``fn.local`` computes
    the rank's share alone, (rows, valid) of its images, with no
    collective."""
    spec = model.spec
    n = group.size
    dropout = spec.mc_dropout and not standard_test_dropout  # as forward_cf draws it

    def shard(images):
        nb = images.shape[0]
        if nb % n:
            raise ValueError(f"batch {nb} must divide over the dp axis ({n})")
        per = nb // n
        return images[group.rank * per:(group.rank + 1) * per]

    @torch.no_grad()
    def local(params, stats, x, rng=None, qheads=None):
        keys = local_rows(_key_table(rng, None, n), group.rank, n) if dropout else None
        kw = dict(spec=spec, rng=keys, standard_test_dropout=standard_test_dropout,
                  compute_dtype=model._dtype)
        outs = (forward_cf(params, stats, x, **kw) if qheads is None
                else forward_cf_q(qheads, params, stats, x, **kw))
        flat = fused_box_decode_all_scales(outs, priors_by_stride, spec=spec)
        rows, valid, _ = nms.nms_select_batch(flat, obj_idx, nms_max_boxes, nms_iou_thresh,
                                              pre_top_k=0)
        return rows, valid

    def call(params, stats, x, rng=None, qheads=None):
        rows, valid = local(params, stats, x, rng, qheads)
        return group.all_gather(rows), group.all_gather(valid)

    call.shard = shard
    call.local = local
    return call
