"""The three YOLOv3 variants: standard, aleatoric, bayesian (MC-dropout).

Three detection heads at strides 32/16/8, each six convs + a 1x1 linear
detection conv; heads 2/3 branch from the 5th conv of the previous head,
1x1-reduce, 2x nearest-upsample, and concat the backbone skip at stride
16/8.  Same flat parameter names as the JAX package (``backbone``,
``head{i}_conv{j}``, ``trans{i}``, ``det{i}``).

MC-dropout inference runs the deterministic backbone once; the T samples
of the dropout-bearing head section are stacked on the batch axis
(sample-major: row ``t*NB + n``), where the JAX package ``vmap``s over T.
Each of the 15 dropout sites takes one uint32 hash key per sample, so a
key table is (T, 15).  A mask depends on its (sample, site) key and the
per-sample flat index only, not on how many samples are stacked: a rank of
an ``mc`` group that runs rows [r*T/N, (r+1)*T/N) of the table
(``parallel/epistemic.py``) draws exactly those samples' masks.  Batched
standard/aleatoric inference (``forward``, ``forward_cf``) runs the heads
once; the bayesian variant's dropout then takes a (1, 15) table.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..core.blueprint import ModelBlueprint, Variant, VariantSpec
from ..core.priors import PriorSet
from ..ops.common import (
    conv_block,
    conv_block_train,
    detection_conv,
    detection_conv_cf,
    init_conv_block,
    init_detection_conv,
    upsample2x,
)
from . import darknet

DROP_PROB = 0.1  # hard-coded in the reference
N_DROP_SITES = 15  # convs 0..4 of each of the 3 heads

# per-head conv channel plans: six (kernel, cout) convs; the 5th conv (index
# 4) is the branch point feeding the next scale.
_HEAD_PLANS = {
    1: ((1, 512), (3, 1024), (1, 512), (3, 1024), (1, 512), (3, 1024)),
    2: ((1, 256), (3, 512), (1, 256), (3, 512), (1, 256), (3, 512)),
    3: ((1, 128), (3, 256), (1, 128), (3, 256), (1, 128), (3, 256)),
}
_TRANS_PLANS = {1: (1, 256), 2: (1, 128)}  # 1x1 reduce before upsample
_BRANCH_IDX = 4  # dropout on convs 0..4, none on conv 5


def init_yolov3(gen: torch.Generator, spec: VariantSpec, device="cpu") -> Tuple[Dict, Dict]:
    """Initialize the full parameter/stat dicts (flat name -> block)."""
    bparams, bstats = darknet.init_darknet53(gen, device)
    params: Dict = {"backbone": bparams}
    stats: Dict = {"backbone": bstats}

    head_cout = spec.head_channels_per_prior * 3  # 3 priors per scale
    cins = {1: 1024, 2: 256 + 512, 3: 128 + 256}  # concat of upsample + skip
    for head in (1, 2, 3):
        cin = cins[head]
        for j, (k, cout) in enumerate(_HEAD_PLANS[head]):
            p, s = init_conv_block(gen, k, cin, cout, device)
            params[f"head{head}_conv{j}"] = p
            stats[f"head{head}_conv{j}"] = s
            cin = cout
        params[f"det{head}"] = init_detection_conv(gen, cin, head_cout, device)
        if head in _TRANS_PLANS:
            k, cout = _TRANS_PLANS[head]
            branch_c = _HEAD_PLANS[head][_BRANCH_IDX][1]
            p, s = init_conv_block(gen, k, branch_c, cout, device)
            params[f"trans{head}"] = p
            stats[f"trans{head}"] = s
    return params, stats


def draw_key_table(gen: torch.Generator, T: int) -> np.ndarray:
    """(T, 15) uint32 dropout keys from a CPU ``torch.Generator`` — the
    fresh-masks mode.  (The JAX package's own key stream is not reproduced;
    parity between the packages is held under ``fixed_masks``.)"""
    keys = torch.randint(0, 2**32, (T, N_DROP_SITES), generator=gen, dtype=torch.int64)
    return keys.numpy().astype(np.uint32)


def _fixed_key_table(seed, T: int) -> np.ndarray:
    """Constant (T, 15) uint32 dropout-key table for the fixed-MC-masks
    mode: one key per (sample, site), from numpy Philox — the identical
    table in both packages for the same seed and T."""
    return (
        np.random.Generator(np.random.Philox(int(seed)))
        .integers(0, 2**32, size=(T, N_DROP_SITES), dtype=np.uint32)
    )


def _key_table(rng, fixed_masks, T: int) -> np.ndarray:
    if fixed_masks is not None:
        return _fixed_key_table(fixed_masks, T)
    if isinstance(rng, torch.Generator):
        return draw_key_table(rng, T)
    if rng is None:
        raise ValueError("MC dropout requires a torch.Generator or a key table")
    table = np.asarray(rng)
    if table.shape != (T, N_DROP_SITES):
        raise ValueError(f"key table has shape {table.shape}, want {(T, N_DROP_SITES)}")
    return table


def _walk_heads(dn_out, skip16, skip8, site_keys: Optional[np.ndarray], block):
    """The head section's topology, shared by the float and the int8 heads:
    3 heads of six conv blocks, the transitions, upsample and concat.
    ``block(name, x, keys)`` runs one conv block, ``keys`` the per-sample
    dropout keys of its site or None (convs 0..4 of each head drop when a
    table is given; the transitions and the final conv never do).  With a
    (T, 15) table the backbone outputs are stacked T times sample-major on
    the batch axis.  Returns the three pre-detection feature maps."""
    T = 1 if site_keys is None else site_keys.shape[0]
    site = 0

    def stacked(t: torch.Tensor) -> torch.Tensor:
        # one copy of a backbone activation per MC sample, sample-major
        return t if T == 1 else t.unsqueeze(0).expand(T, *t.shape).reshape(-1, *t.shape[1:])

    def run_block(name, x, drop):
        nonlocal site
        keys = None
        if drop and site_keys is not None:
            keys = [int(k) for k in site_keys[:, site]]
            site += 1
        return block(name, x, keys)

    feats = []
    x = stacked(dn_out)
    for head, skip in ((1, None), (2, skip16), (3, skip8)):
        if skip is not None:
            x = run_block(f"trans{head - 1}", x, drop=False)
            x = upsample2x(x)
            x = torch.cat([x, stacked(skip).to(x.dtype)], dim=-1)  # [upsampled, skip]
        branch = None
        for j in range(6):
            x = run_block(f"head{head}_conv{j}", x, drop=j <= _BRANCH_IDX)
            if j == _BRANCH_IDX:
                branch = x
        feats.append(x)
        x = branch
    return feats


def _heads(
    params: Dict,
    stats: Dict,
    dn_out: torch.Tensor,
    skip16: torch.Tensor,
    skip8: torch.Tensor,
    *,
    site_keys: Optional[np.ndarray] = None,
    compute_dtype=torch.float32,
    return_features: bool = False,
    capture: Optional[Dict] = None,
    band=None,
):
    """Everything after the backbone: 3 det heads + scale transitions.

    ``site_keys`` (T, 15) uint32 or None: with a table, dropout (p=0.1)
    runs on head convs 0..4 of each head (the transition convs and the
    final pre-detection conv are dropout-free) and the T samples are
    stacked sample-major on the batch axis of the returned tensors
    (T*NB, h, w, ch); None runs one dropout-free pass.

    ``return_features=True`` returns the pre-detection-conv activations
    instead of detection outputs.  ``capture`` (dict or None): every conv
    block's post-LeakyReLU output is stored under its block name — what
    the int8 calibration reduces (``ops.quant.calibrate_mc_amax``).
    ``band``: the backbone outputs are an sp rank's bands of rows
    (``darknet.darknet53``); every head conv block exchanges its halo rows.
    """

    def block(name, x, keys):
        y = conv_block(params[name], stats[name], x,
                       drop_rate=DROP_PROB if keys is not None else None,
                       drop_keys=keys, compute_dtype=compute_dtype, band=band)
        if capture is not None:
            capture[name] = y
        return y

    feats = _walk_heads(dn_out, skip16, skip8, site_keys, block)
    if return_features:
        return tuple(feats)
    return tuple(detection_conv(params[f"det{head}"], f, compute_dtype=compute_dtype)
                 for head, f in enumerate(feats, start=1))


def _heads_train(params: Dict, stats: Dict, dn_out, skip16, skip8, *,
                 site_keys: Optional[np.ndarray], compute_dtype, group=None):
    """The head section in training mode: batch-statistics BN in every
    block, dropout with one key per site for the whole batch (row 0 of a
    (1, 15) table; None: no dropout).  ``group``: the inputs are a
    data-parallel rank's share of the batch; statistics and masks are the
    whole batch's (``ops.common.conv_block_train``).  Returns ((raw1, raw2,
    raw3), new_stats of the head blocks)."""
    new_stats = {}

    def block(name, x, keys):
        y, new_stats[name] = conv_block_train(
            params[name], stats[name], x,
            drop_rate=DROP_PROB if keys is not None else None,
            drop_key=None if keys is None else keys[0], compute_dtype=compute_dtype,
            group=group)
        return y

    feats = _walk_heads(dn_out, skip16, skip8, site_keys, block)
    raws = tuple(detection_conv(params[f"det{head}"], f, compute_dtype=compute_dtype)
                 for head, f in enumerate(feats, start=1))
    return raws, new_stats


def forward(
    params: Dict,
    stats: Dict,
    imgs: torch.Tensor,
    *,
    spec: VariantSpec,
    training: bool = False,
    freeze_backbone: bool = True,
    rng=None,
    standard_test_dropout: bool = False,
    compute_dtype=torch.float32,
    fused_early=None,
    packed_hw=None,
    group=None,
):
    """Single forward pass.  Returns (raw1, raw2, raw3): raw_i is the f32
    detection-conv output at scale i, (N, H/stride, W/stride,
    3 * head_channels_per_prior).

    The bayesian variant draws one set of dropout masks from ``rng`` (a
    CPU ``torch.Generator`` or a (1, 15) key table) unless
    ``standard_test_dropout`` switches dropout off.  ``packed_hw=(H, W)``:
    ``imgs`` is host-packed uint8 planes (see ``darknet.darknet53``).

    ``training=True`` returns ``((raw1, raw2, raw3), new_stats)``: the heads
    take batch statistics (their moving statistics advanced in
    ``new_stats``) and, in the bayesian variant, one dropout key per site
    for the whole batch.  ``freeze_backbone`` (the default training
    configuration) runs the backbone on its moving statistics without
    autograd — on the card in bf16 through the fused conv kernels — so its
    output is a constant and its statistics come back unchanged; False
    trains it with batch statistics through the plain convolutions.
    ``group`` (training only; ``parallel.mesh.Group`` of the ``data`` axis):
    ``imgs`` is the rank's share of the global batch, and every
    batch-statistics block — the heads, and the backbone when it trains —
    takes the global batch's statistics and dropout masks; the frozen
    backbone needs no synchronisation.
    """
    if training:
        if packed_hw is not None:
            raise ValueError("training takes NHWC images")
        with torch.no_grad() if freeze_backbone else contextlib.nullcontext():
            out32, skip16, skip8, bstats = darknet.darknet53(
                params["backbone"], stats["backbone"], imgs, training=not freeze_backbone,
                compute_dtype=compute_dtype, fused_early=fused_early,
                group=None if freeze_backbone else group,
            )
        raws, new_stats = _heads_train(
            params, stats, out32, skip16, skip8,
            site_keys=_batch_keys(spec, rng, standard_test_dropout),
            compute_dtype=compute_dtype, group=group)
        return raws, {**new_stats, "backbone": bstats}
    out32, skip16, skip8, _ = darknet.darknet53(
        params["backbone"], stats["backbone"], imgs,
        compute_dtype=compute_dtype, fused_early=fused_early, packed_hw=packed_hw,
    )
    return _heads(params, stats, out32, skip16, skip8,
                  site_keys=_batch_keys(spec, rng, standard_test_dropout),
                  compute_dtype=compute_dtype)


def _batch_keys(spec: VariantSpec, rng, standard_test_dropout: bool, n: int = 1):
    """The (n, 15) key table of a batched pass with dropout active (the
    bayesian variant without ``standard_test_dropout``), else None: one row
    for a pass, one row per rank for the ranks of a dp group."""
    if spec.mc_dropout and not standard_test_dropout:
        return _key_table(rng, None, n)
    return None


def forward_cf(
    params: Dict,
    stats: Dict,
    imgs: torch.Tensor,
    *,
    spec: VariantSpec,
    rng=None,
    standard_test_dropout: bool = False,
    compute_dtype=torch.float32,
    fused_early=None,
    packed_hw=None,
    band=None,
):
    """Batched inference forward emitting CHANNELS-FIRST raw heads.

    Standard/aleatoric counterpart of ``mc_forward_cf``: the backbone runs
    once, the heads once (dropout as in ``forward``), and the 1x1 detection
    convs run as channels-first matrix products over the batch, yielding
    (ch, NB, h*w) f32 per scale — the input layout of the box decode kernel
    (ops.cuda_decode), with no relayout in between.

    Returns [(raw_cf (ch, NB, h*w), (h, w)), ...].  ``band``
    (``parallel.spatial.Band``): ``imgs`` is an sp rank's band of image
    rows; the raws are the band's, h its rows.
    """
    out32, skip16, skip8, _ = darknet.darknet53(
        params["backbone"], stats["backbone"], imgs,
        compute_dtype=compute_dtype, fused_early=fused_early, packed_hw=packed_hw, band=band,
    )
    feats = _heads(params, stats, out32, skip16, skip8,
                   site_keys=_batch_keys(spec, rng, standard_test_dropout),
                   compute_dtype=compute_dtype, return_features=True, band=band)
    out = []
    for head, f in enumerate(feats, start=1):
        raw_cf = detection_conv_cf(params[f"det{head}"], f, compute_dtype=compute_dtype)
        out.append((raw_cf, tuple(f.shape[1:3])))
    return out


def mc_forward(
    params: Dict,
    stats: Dict,
    img: torch.Tensor,
    *,
    spec: VariantSpec,
    T: int,
    rng=None,
    compute_dtype=torch.float32,
    fused_early=None,
    fixed_masks=None,
):
    """T-sample MC-dropout forward for epistemic inference (batch size 1).

    The backbone runs once; the head section runs on T stacked samples.
    Returns three raw tensors of shape (T, h, w, ch).  ``rng``: a CPU
    ``torch.Generator`` or a (T, 15) uint32 key table; ``fixed_masks``
    (int seed) takes the constant table of ``_fixed_key_table`` instead,
    so both packages draw bit-identical masks.
    """
    if spec.variant != Variant.BAYESIAN:
        raise ValueError("mc_forward needs the bayesian variant")
    if img.shape[0] != 1:
        raise ValueError("epistemic mc_forward requires batch_size == 1")
    out32, skip16, skip8, _ = darknet.darknet53(
        params["backbone"], stats["backbone"], img,
        compute_dtype=compute_dtype, fused_early=fused_early,
    )
    return _heads(params, stats, out32, skip16, skip8,
                  site_keys=_key_table(rng, fixed_masks, T),
                  compute_dtype=compute_dtype)


def mc_forward_cf(
    params: Dict,
    stats: Dict,
    img: torch.Tensor,
    *,
    spec: VariantSpec,
    T: int,
    rng=None,
    compute_dtype=torch.float32,
    fused_early=None,
    packed_hw=None,
    fixed_masks=None,
    band=None,
):
    """T-sample MC forward emitting CHANNELS-FIRST raw heads.

    Like ``mc_forward`` but the 1x1 detection convs are applied as one
    channels-first matrix product over the stacked samples
    (ops.common.detection_conv_cf), yielding (ch, T, NB*h*w) f32 per scale
    — the input layout of the epistemic decode kernel, with no relayout in
    between.  An image batch NB >= 1 folds onto the anchor axis; dropout
    masks are drawn per (sample, image, position).

    Returns [(raw_cf (ch, T, NB*h*w), (h, w)), ...].  ``band``: as in
    ``forward_cf``.
    """
    if spec.variant != Variant.BAYESIAN:
        raise ValueError("mc_forward_cf needs the bayesian variant")
    out32, skip16, skip8, _ = darknet.darknet53(
        params["backbone"], stats["backbone"], img,
        compute_dtype=compute_dtype, fused_early=fused_early, packed_hw=packed_hw, band=band,
    )
    feats = _heads(params, stats, out32, skip16, skip8,
                   site_keys=_key_table(rng, fixed_masks, T),
                   compute_dtype=compute_dtype, return_features=True, band=band)
    nb = img.shape[0]
    out = []
    for head, f in enumerate(feats, start=1):
        h, w, c = f.shape[1:]
        raw_cf = detection_conv_cf(params[f"det{head}"], f.reshape(T, nb, h, w, c),
                                   compute_dtype=compute_dtype)
        out.append((raw_cf, (h, w)))
    return out


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass
class YoloV3:
    """Convenience holder: spec + priors + blueprint, with ``init`` /
    ``forward`` / ``mc_forward`` bound to them."""

    spec: VariantSpec
    priors: PriorSet
    img_size: Tuple[int, int, int]
    freeze_darknet53: bool = True
    compute_dtype: str = "float32"

    def __post_init__(self):
        self.blueprint = ModelBlueprint.build(self.img_size, self.priors, self.spec.cls_cnt)
        self.cls_cnt = self.spec.cls_cnt
        self.obj_idx = self.spec.obj_idx(epistemic=False)
        self.cls_start_idx = self.spec.cls_start_idx(epistemic=False)

    @classmethod
    def from_config(cls, config) -> "YoloV3":
        return cls(
            spec=config.variant_spec,
            priors=config.resolved_priors(),
            img_size=config.img_size,
            freeze_darknet53=config.freeze_darknet53,
            compute_dtype=config.compute_dtype,
        )

    @property
    def _dtype(self) -> torch.dtype:
        return _DTYPES[self.compute_dtype]

    def init(self, gen: torch.Generator, device="cpu"):
        return init_yolov3(gen, self.spec, device)

    def forward(self, params, stats, imgs, *, training=False, rng=None,
                standard_test_dropout=False, packed_hw=None, fused_early=None, group=None):
        """``training=True`` freezes the backbone as the model was
        configured (``freeze_darknet53``) and returns (raws, new_stats)."""
        return forward(params, stats, imgs, spec=self.spec, training=training,
                       freeze_backbone=self.freeze_darknet53, rng=rng,
                       standard_test_dropout=standard_test_dropout,
                       compute_dtype=self._dtype, fused_early=fused_early,
                       packed_hw=packed_hw, group=group)

    def mc_forward(self, params, stats, img, *, T, rng=None, fixed_masks=None):
        return mc_forward(params, stats, img, spec=self.spec, T=T, rng=rng,
                          compute_dtype=self._dtype, fixed_masks=fixed_masks)

    def load_darknet53_weights(self, weightfile, params, stats):
        bp, bs = darknet.load_darknet53_weights(
            weightfile, params["backbone"], stats["backbone"]
        )
        return {**params, "backbone": bp}, {**stats, "backbone": bs}
