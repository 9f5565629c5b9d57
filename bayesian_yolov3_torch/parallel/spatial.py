"""Spatial (image-height) sharding of inference over a ``torch.distributed``
group: the ``sp`` axis.

PyTorch counterpart of the JAX package's ``parallel/spatial.py``.  Each of
the N ranks of an ``sp`` group holds one band of image rows, and every map
below it holds the same band of its own rows.  The bands follow GSPMD's
rule for an uneven shard, on the grid of the coarsest map (stride 32):
with R = H/32 coarse rows and ``per`` = ceil(R/N), rank r holds coarse rows
[r*per, min((r+1)*per, R)), and at stride s the 32/s times as many rows
under them, so every band is a whole number of coarse rows and stays
aligned at every stride.
The non-empty bands come first; when N*per > R the last ranks hold empty
bands and idle through the convs (they still take part in every
collective).  The activations a rank holds shrink by about N; the weights
are whole on every rank.  Where GSPMD inserts the halo collectives for the
JAX package, here every 3x3 conv block asks for them (``Band.conv``,
called by ``ops.common.conv_block``):

* a stride-1 3x3 conv takes the previous rank's last row and the next
  rank's first row (zeros at the image's top and bottom edge, and from an
  empty band, which offers zero rows), stacks them around its band, and
  convolves with no vertical padding;
* a stride-2 3x3 darknet conv (explicit (1, 1) pad, then VALID): rank r's
  outputs [a, b) read input rows 2a-1 .. 2b-1, so it takes the previous
  rank's last row alone (zeros at the top edge) and no bottom row;
* 1x1 convs, BN, leaky, the 2x upsample and the concat are local to a band.

The backbone runs unfused, with the plain stem (``darknet.darknet53``): the
fused conv kernels and the space-to-depth stem assume the whole image, and
the plain stem computes the same function.  Dropout masks index the whole
map (``ops.common.dropout`` with the band's origin), so a band draws its
rows of the single-device masks exactly.

Decode and NMS are global (NMS is sequential over all anchors), so the
channels-first raw heads, (ch, NB, h_loc*w) per scale, are all-gathered
over the group along their last dim — rank order is row order — before the
decode kernels; an uneven band is padded to ``per`` coarse rows for the
gather (gloo gathers equal shapes) and trimmed after it.

Shards: H must be a multiple of 32 (the coarsest map's stride); any N.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..models.yolov3 import _key_table, forward_cf, mc_forward_cf
from ..ops.common import conv2d
from .mesh import Group, local_rows

STRIDE = 32  # the coarsest map's stride: the bands are whole rows of it


def check_height(height: int, n: int) -> None:
    if height % STRIDE or height < STRIDE:
        raise ValueError(f"image height {height} must be a positive multiple of {STRIDE}, the "
                         f"coarsest map's stride, to split over sp ({n})")


class BandPlan(NamedTuple):
    """The bands of an ``sp`` axis over the stride-32 grid: ``coarse`` rows
    of it, ``per`` = ceil(coarse / N) a rank at most, and rank r's first
    coarse row and count (``start[r]``, ``size[r]``; 0 rows for the empty
    bands at the end)."""

    coarse: int
    per: int
    start: Tuple[int, ...]
    size: Tuple[int, ...]


def band_plan(height: int, n: int) -> BandPlan:
    """GSPMD's shards of ``height`` image rows over ``n`` ranks, in rows of
    the stride-32 map: rank r holds [r*per, min((r+1)*per, R))."""
    check_height(height, n)
    coarse = height // STRIDE
    per = -(-coarse // n)
    start = tuple(min(r * per, coarse) for r in range(n))
    size = tuple(min(r * per + per, coarse) - a for r, a in enumerate(start))
    return BandPlan(coarse, per, start, size)


class Band:
    """This rank's band of image rows on an ``sp`` group: the hooks that
    ``ops.common.conv_block`` calls for the halo rows and the mask origin.
    ``rows`` fixes the plan from the image batch."""

    def __init__(self, group: Group):
        self.group = group
        self.plan = None
        self.width = None  # image columns: a map's width gives its stride

    def rows(self, imgs: torch.Tensor) -> torch.Tensor:
        """The rank's band of an (NB, H, W, C) image batch."""
        self.plan = band_plan(imgs.shape[1], self.group.size)
        self.width = imgs.shape[2]
        a = self.plan.start[self.group.rank] * STRIDE
        return imgs[:, a:a + self.plan.size[self.group.rank] * STRIDE]

    def _scale(self, w: int) -> int:
        """Rows of a map ``w`` columns wide in one row of the stride-32 map."""
        return STRIDE * w // self.width

    def origin(self, h: int):
        """(first row, whole height) of the band's h rows of a map; (0, 0)
        for an empty band."""
        size = self.plan.size[self.group.rank]
        if size == 0:
            return 0, 0
        f = h // size
        return self.plan.start[self.group.rank] * f, self.plan.coarse * f

    def conv(self, x: torch.Tensor, w: torch.Tensor, *, stride: int = 1) -> torch.Tensor:
        """``ops.common.conv2d`` of the band, with the halo rows of its
        neighbours in place of the zero padding rows.  An empty band offers
        zero edge rows to the exchange and returns an empty map."""
        k = w.shape[2]
        empty = x.shape[1] == 0
        if k == 3 and stride in (1, 2):
            edge = x.new_zeros((x.shape[0], *x.shape[2:])) if empty else None
            prev_last, next_first = self.group.exchange_edges(
                None if stride == 2 else (edge if empty else x[:, 0]),
                edge if empty else x[:, -1])
        elif k != 1:
            raise ValueError(f"no halo rule for a {k}x{k} conv at stride {stride}")
        if empty:
            cols = x.shape[2] if k == 1 else (x.shape[2] - 1) // stride + 1
            return x.new_zeros((x.shape[0], 0, cols, w.shape[0]))
        if k == 1:
            return conv2d(x, w, stride=stride)
        zero = x.new_zeros(x[:, :1].shape)
        parts = [zero if prev_last is None else prev_last[:, None], x]
        if stride == 1:
            parts.append(zero if next_first is None else next_first[:, None])
        return conv2d(torch.cat(parts, dim=1), w, stride=stride, padding=((0, 0), (1, 1)))

    def gather(self, outs):
        """[(raw_cf (ch, M, h_loc*w), (h_loc, w)), ...] of every rank ->
        the whole maps' [(raw_cf (ch, M, h*w), (h, w)), ...] on every rank.
        A band shorter than ``per`` rows of the stride-32 map is padded for
        the all-gather (gloo gathers equal shapes) and trimmed after it."""
        plan = self.plan
        out = []
        for raw_cf, (_, w) in outs:
            f = self._scale(w)
            full = plan.per * f * w
            got = self.group.all_gather(F.pad(raw_cf, (0, full - raw_cf.shape[-1])), dim=-1)
            if min(plan.size) < plan.per:
                got = torch.cat([got[..., r * full:r * full + c * f * w]
                                 for r, c in enumerate(plan.size)], dim=-1)
            out.append((got, (plan.coarse * f, w)))
        return out


@torch.no_grad()
def spatial_forward_raws(params, stats, imgs, rng, *, spec, group: Group, compute_dtype,
                         standard_test_dropout: bool = False):
    """The batched forward (``forward_cf``) of this rank's band of ``imgs``
    (NB, H, W, 3) float, then the gather of the channels-first raws over
    ``group``: [(raw_cf (ch, NB, h*w), (h, w)), ...], the whole maps, on
    every rank — the input of the box decode kernel.  ``rng``: as
    ``forward_cf`` takes it (the bayesian variant's (1, 15) table)."""
    band = Band(group)
    outs = forward_cf(params, stats, band.rows(imgs), spec=spec, rng=rng,
                      standard_test_dropout=standard_test_dropout,
                      compute_dtype=compute_dtype, band=band)
    return band.gather(outs)


@torch.no_grad()
def spatial_mc_raws(params, stats, img, rng, *, spec, group: Group, T: int, compute_dtype,
                    mc: Optional[Group] = None):
    """The T-sample epistemic forward (``mc_forward_cf``, batch 1) of this
    rank's band of ``img`` (1, H, W, 3), its raws gathered over ``group``:
    [(raw_cf (ch, T', h*w), (h, w)), ...].  ``mc`` (an ``mc`` group beside
    the ``sp`` one, or None): the rank runs its rows of the (T, 15) key
    table (``local_rows``), T' = T / mc.size; else all T.  ``rng``: a CPU
    ``torch.Generator`` seeded alike on every rank, or a (T, 15) table."""
    if img.shape[0] != 1:
        raise ValueError("epistemic inference requires batch_size == 1")
    keys = _key_table(rng, None, T)
    if mc is not None:
        keys = local_rows(keys, mc.rank, mc.size)
    band = Band(group)
    outs = mc_forward_cf(params, stats, band.rows(img), spec=spec, T=keys.shape[0], rng=keys,
                         compute_dtype=compute_dtype, band=band)
    return band.gather(outs)
