"""ECP-format JSON serialization of decoded detections.

Field-for-field parity with the reference output writers:

* standard — inference_standard_yolov3.py:148-169
* aleatoric — inference_aleatoric.py:148-178
* epistemic — inference_epistemic.py:131-170

Each detection row's column layout is the VariantSpec decoded layout
(core/blueprint.py); coordinates are scaled to pixels here; ``score`` is
``obj * cls_score_of_argmax_class``; ``identity`` maps class -> name with
the implicit-background +1 shift re-applied (detect.py:44-45).

Documented quirk fixes (the reference reads wrong columns):

* standard: the reference emits ``layer_id``/``prior_id`` read from the
  last two CLASS-SCORE columns (inference_standard_yolov3.py:175-176 on a
  5+C-wide tensor).  We keep the keys — downstream ECP tooling may expect
  them — but write correct values from the real id columns our standard
  decode appends (ops/decode.py:decode_bbox_standard, width 7+C).
* aleatoric: the reference writes ``cls_entropy``, ``layer_id`` and
  ``prior_id`` all from the SAME column (inference_aleatoric.py:172-174);
  we write the actual cls_entropy / layer_id / prior_id columns.
* epistemic: ``ped_score``/``rider_score`` are hard-coded columns 17/18 in
  the reference (valid only for C==2); we emit them only when C == 2, from
  the class-mean columns.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ..core.blueprint import VariantSpec

DEFAULT_CLS_NAMES = {1: "pedestrian", 2: "rider"}  # ECP (reference :133-136)


def bbox_to_ecp_format(
    bbox: np.ndarray,
    img_size,
    spec: VariantSpec,
    *,
    epistemic: bool = False,
    implicit_background_class: bool = True,
    cls_names: Optional[Dict[int, str]] = None,
) -> Dict:
    cls_names = cls_names or DEFAULT_CLS_NAMES
    img_h, img_w = img_size[:2]
    C = spec.cls_cnt
    obj_idx = spec.obj_idx(epistemic)
    cls_start = spec.cls_start_idx(epistemic)

    cls_scores = np.asarray(bbox[cls_start : cls_start + C], np.float64)
    cls = int(np.argmax(cls_scores))
    cls_idx = cls
    if implicit_background_class:
        cls += 1

    out = {
        "y0": float(bbox[0] * img_h),
        "x0": float(bbox[1] * img_w),
        "y1": float(bbox[2] * img_h),
        "x1": float(bbox[3] * img_w),
    }

    if epistemic:
        out.update(
            x_var_epi=float(bbox[4]),
            y_var_epi=float(bbox[5]),
            w_var_epi=float(bbox[6]),
            h_var_epi=float(bbox[7]),
            x_var_ale=float(bbox[8]),
            y_var_ale=float(bbox[9]),
            w_var_ale=float(bbox[10]),
            h_var_ale=float(bbox[11]),
            total_var_epi=float(bbox[12]),
            total_var_ale=float(bbox[13]),
            score=float(bbox[obj_idx]) * float(bbox[cls_start + cls_idx]),
            obj_mutual_info=float(bbox[obj_idx + 1]),
            obj_entropy=float(bbox[obj_idx + 2]),
            cls_scores=cls_scores.tolist(),
            cls_mutual_info=float(bbox[cls_start + C]),
            cls_entropy=float(bbox[cls_start + C + 1]),
            layer_id=float(bbox[cls_start + C + 2]),
            prior_id=float(bbox[cls_start + C + 3]),
        )
        if C == 2:
            out["ped_score"] = float(bbox[cls_start])
            out["rider_score"] = float(bbox[cls_start + 1])
    elif spec.aleatoric_head:
        out.update(
            x_var=float(bbox[4]),
            y_var=float(bbox[5]),
            w_var=float(bbox[6]),
            h_var=float(bbox[7]),
            total_var=float(bbox[8]),
            score=float(bbox[obj_idx]) * float(bbox[cls_start + cls_idx]),
            obj_entropy=float(bbox[obj_idx + 1]),
            cls_scores=cls_scores.tolist(),
            cls_entropy=float(bbox[cls_start + C]),
            layer_id=float(bbox[cls_start + C + 1]),
            prior_id=float(bbox[cls_start + C + 2]),
        )
    else:
        out.update(
            score=float(bbox[obj_idx]) * float(bbox[cls_start + cls_idx]),
            cls_scores=cls_scores.tolist(),
            layer_id=float(bbox[cls_start + C]),
            prior_id=float(bbox[cls_start + C + 1]),
        )

    out["identity"] = cls_names.get(cls, cls)
    return out
