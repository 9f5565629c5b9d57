"""Shape contracts for the model variants.

The reference encodes the decoded-bbox column layout in magic indices
(``obj_idx``/``cls_start_idx``, lib_yolo/yolov3.py:183-184,321-322,464-465)
and asserts built graphs against a ``ModelBlueprint``
(lib_yolo/model.py:218-268).  Here the layout is table-driven from a
``VariantSpec`` and the blueprint check is a real unit-testable contract.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Sequence, Tuple

from .priors import Prior, PriorSet, STRIDES


class Variant(str, enum.Enum):
    STANDARD = "standard"  # plain YOLOv3 heads
    ALEATORIC = "aleatoric"  # doubled heads: per-output log-variance channels
    BAYESIAN = "bayesian"  # aleatoric heads + MC dropout in the det heads


@dataclasses.dataclass(frozen=True)
class VariantSpec:
    """Per-variant head width and decoded-bbox column layout.

    Decoded layouts (parity with lib_yolo/layers.py):

    * standard  (decode_bbox_standard, layers.py:191-258), width ``7 + C``::

        [y0, x0, y1, x1, obj, cls_0..cls_{C-1}, layer_id, prior_id]

      (the reference's own tensor is width 5+C; its JSON writer then reads
      ``layer_id``/``prior_id`` from the wrong columns,
      inference_standard_yolov3.py:175-176 — we carry real id columns so the
      keys are emitted with correct values; a documented quirk fix)

    * aleatoric (decode_bbox_aleatoric, layers.py:261-346), width ``14 + C``::

        [y0, x0, y1, x1,
         loc_var_x, loc_var_y, loc_var_w, loc_var_h, total_ale_var,
         obj, obj_entropy,
         cls_0..cls_{C-1}, cls_entropy, layer_id, prior_id]

    * epistemic (decode_bbox_epistemic, layers.py:414-502), width ``21 + C``::

        [y0, x0, y1, x1,
         epi_var_x, epi_var_y, epi_var_w, epi_var_h,
         ale_var_x, ale_var_y, ale_var_w, ale_var_h,
         total_var_epi, total_var_ale,
         obj_mean, obj_mutual_info, obj_entropy,
         cls_0..cls_{C-1}, cls_mutual_info, cls_entropy, layer_id, prior_id]
    """

    variant: Variant
    cls_cnt: int

    @property
    def aleatoric_head(self) -> bool:
        return self.variant in (Variant.ALEATORIC, Variant.BAYESIAN)

    @property
    def mc_dropout(self) -> bool:
        return self.variant == Variant.BAYESIAN

    @property
    def head_channels_per_prior(self) -> int:
        """Raw 1x1 detection conv channels per prior.

        Standard: ``4 + 1 + C`` (layers.py:600-605); aleatoric/bayesian:
        ``2 * (4 + 1 + C)`` with per-prior channel order
        ``[loc(4), log_loc_var(4), obj(1), log_obj_stddev(1),
        cls(C), log_cls_stddev(C)]`` (layers.py:41-84, 608-613).
        """
        base = 4 + 1 + self.cls_cnt
        return 2 * base if self.aleatoric_head else base

    def decoded_width(self, epistemic: bool = False) -> int:
        if epistemic:
            assert self.variant == Variant.BAYESIAN
            return 21 + self.cls_cnt
        if self.aleatoric_head:
            return 14 + self.cls_cnt
        return 7 + self.cls_cnt

    def obj_idx(self, epistemic: bool = False) -> int:
        if epistemic:
            return 14
        return 9 if self.aleatoric_head else 4

    def cls_start_idx(self, epistemic: bool = False) -> int:
        if epistemic:
            return 17
        return 11 if self.aleatoric_head else 5


@dataclasses.dataclass(frozen=True)
class DetScaleBlueprint:
    """Expected grid geometry of one detection scale.

    Parity: lib_yolo/model.py:263-268 (``DetLayerBlueprint``).
    """

    h: int
    w: int
    downsample: int
    priors: Tuple[Prior, ...]

    @classmethod
    def from_img_size(cls, img_size, downsample: int, priors: Sequence[Prior]):
        return cls(
            h=img_size[0] // downsample,
            w=img_size[1] // downsample,
            downsample=downsample,
            priors=tuple(priors),
        )

    @property
    def boxes_per_cell(self) -> int:
        return len(self.priors)

    @property
    def anchor_cnt(self) -> int:
        return self.h * self.w * self.boxes_per_cell


@dataclasses.dataclass(frozen=True)
class ModelBlueprint:
    """Expected shapes of the full three-scale detector.

    Parity: lib_yolo/model.py:257-260 + the input-divisibility contract of
    yolov3.py:207-211 (H and W must be multiples of 32).
    """

    det_scales: Tuple[DetScaleBlueprint, ...]
    cls_cnt: int
    img_size: Tuple[int, int]

    @classmethod
    def build(cls, img_size, priors: PriorSet, cls_cnt: int) -> "ModelBlueprint":
        assert img_size[0] % 32 == 0 and img_size[1] % 32 == 0, (
            "input H and W must be divisible by 32 (reference yolov3.py:207-211)"
        )
        scales = tuple(
            DetScaleBlueprint.from_img_size(img_size, d, priors[d]) for d in STRIDES
        )
        return cls(det_scales=scales, cls_cnt=cls_cnt, img_size=(img_size[0], img_size[1]))

    @property
    def total_anchor_cnt(self) -> int:
        return sum(s.anchor_cnt for s in self.det_scales)

    def matches(self, det_scales: Sequence[DetScaleBlueprint], cls_cnt: int) -> bool:
        """Structural check mirroring Model.matches_blueprint (model.py:218-225)."""
        if cls_cnt != self.cls_cnt or len(det_scales) != len(self.det_scales):
            return False
        for got, want in zip(det_scales, self.det_scales):
            if (got.h, got.w, got.downsample) != (want.h, want.w, want.downsample):
                return False
            if len(got.priors) != len(want.priors):
                return False
            for p, q in zip(got.priors, want.priors):
                if p.h != q.h or p.w != q.w:
                    return False
        return True
