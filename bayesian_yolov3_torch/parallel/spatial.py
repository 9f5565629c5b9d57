"""Spatial (image-height) sharding of inference over a ``torch.distributed``
group: the ``sp`` axis.

PyTorch counterpart of the JAX package's ``parallel/spatial.py``.  Each of
the N ranks of an ``sp`` group holds one band of H/N image rows, and every
map below it holds the same band of its own rows: at stride s, rows
[r*H/(s*N), (r+1)*H/(s*N)) on rank r.  The activations a rank holds shrink
by N; the weights are whole on every rank.  Where GSPMD inserts the halo
collectives for the JAX package, here every 3x3 conv block asks for them
(``Band.conv``, called by ``ops.common.conv_block``):

* a stride-1 3x3 conv takes the previous rank's last row and the next
  rank's first row (zeros at the image's top and bottom edge), stacks them
  around its band, and convolves with no vertical padding;
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
decode kernels.

Shards: H must be a multiple of 32*N, so every rank holds an equal band at
every stride; anything else raises ``ValueError`` (GSPMD pads uneven
shards instead).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..models.yolov3 import _key_table, forward_cf, mc_forward_cf
from ..ops.common import conv2d
from .mesh import Group, local_rows

STRIDE = 32  # the coarsest map's stride: each rank holds >= 1 of its rows


def check_height(height: int, n: int) -> None:
    if height % (STRIDE * n):
        raise ValueError(
            f"image height {height} must be a multiple of {STRIDE} x sp ({STRIDE * n}), so "
            f"that every sp rank holds an equal band of every map")


class Band:
    """This rank's band of image rows on an ``sp`` group: the hooks that
    ``ops.common.conv_block`` calls for the halo rows and the mask origin."""

    def __init__(self, group: Group):
        self.group = group

    def rows(self, imgs: torch.Tensor) -> torch.Tensor:
        """The rank's band of an (NB, H, W, C) image batch."""
        check_height(imgs.shape[1], self.group.size)
        per = imgs.shape[1] // self.group.size
        return imgs[:, self.group.rank * per:(self.group.rank + 1) * per]

    def origin(self, h: int):
        """(first row, whole height) of a band h rows high."""
        return self.group.rank * h, self.group.size * h

    def conv(self, x: torch.Tensor, w: torch.Tensor, *, stride: int = 1) -> torch.Tensor:
        """``ops.common.conv2d`` of the band, with the halo rows of its
        neighbours in place of the zero padding rows."""
        k = w.shape[2]
        if k == 1:
            return conv2d(x, w, stride=stride)
        if k != 3 or stride not in (1, 2):
            raise ValueError(f"no halo rule for a {k}x{k} conv at stride {stride}")
        prev_last, next_first = self.group.exchange_edges(
            x[:, 0] if stride == 1 else None, x[:, -1])
        zero = x.new_zeros(x[:, :1].shape)
        parts = [zero if prev_last is None else prev_last[:, None], x]
        if stride == 1:
            parts.append(zero if next_first is None else next_first[:, None])
        return conv2d(torch.cat(parts, dim=1), w, stride=stride, padding=((0, 0), (1, 1)))

    def gather(self, outs):
        """[(raw_cf (ch, M, h_loc*w), (h_loc, w)), ...] of every rank ->
        the whole maps' [(raw_cf (ch, M, h*w), (h, w)), ...] on every rank."""
        return [(self.group.all_gather(raw_cf, dim=-1), (h * self.group.size, w))
                for raw_cf, (h, w) in outs]


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
