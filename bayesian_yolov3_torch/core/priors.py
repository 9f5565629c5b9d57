"""Anchor priors for the three detection scales.

Parity target: the five hard-coded 9-anchor sets of the reference
(``lib_yolo/yolov3.py:6-173``).  Each set has 9 priors in normalized
(h, w) image fractions, ordered largest -> smallest, split 3 per stride
(32, 16, 8).  The CityPersons set is defined in pixels on the original
1024x2048 images and normalized here, exactly as the reference does.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

STRIDES: Tuple[int, int, int] = (32, 16, 8)


@dataclasses.dataclass(frozen=True)
class Prior:
    """One anchor box in normalized image fractions."""

    h: float
    w: float

    def scaled(self, scale_h: float, scale_w: float) -> "Prior":
        return Prior(h=self.h * scale_h, w=self.w * scale_w)


PriorSet = Dict[int, List[Prior]]  # stride -> 3 priors


def _split_by_stride(hw: List[List[float]]) -> PriorSet:
    assert len(hw) == 9
    priors = [Prior(h=p[0], w=p[1]) for p in hw]
    return {32: priors[:3], 16: priors[3:6], 8: priors[6:]}


def _city_persons() -> PriorSet:
    # pixel sizes on the original 1024x2048 CityPersons images
    # (reference yolov3.py:6-26)
    px = [
        [495.27, 203.83],
        [297.84, 122.19],
        [197.44, 81.48],
        [141.07, 58.5],
        [102.72, 43.1],
        [75.78, 31.66],
        [54.24, 23.19],
        [37.55, 16.15],
        [22.55, 10.09],
    ]
    return _split_by_stride([[p[0] / 1024.0, p[1] / 2048.0] for p in px])


CITY_PERSONS_9_PRIORS: PriorSet = _city_persons()

# reference yolov3.py:29-61
ECP_9_PRIORS: PriorSet = _split_by_stride(
    [
        [0.56643243, 0.13731691],
        [0.41022839, 0.09028599],
        [0.30508716, 0.06047965],
        [0.20774711, 0.04376083],
        [0.15475611, 0.02996197],
        [0.10878717, 0.02149197],
        [0.07694039, 0.01488527],
        [0.05248527, 0.01007212],
        [0.03272104, 0.00631827],
    ]
)

# reference yolov3.py:64-96
ECP_NIGHT_9_PRIORS: PriorSet = _split_by_stride(
    [
        [0.6197282176953125, 0.14694562146874998],
        [0.4243941425683594, 0.09687759120833334],
        [0.3103862368359375, 0.06362734035416667],
        [0.23494613041992188, 0.043568554453125],
        [0.1634832566796875, 0.03293052755208333],
        [0.12444031231445313, 0.023274527578125],
        [0.08800429220703125, 0.016930080526041665],
        [0.06101826478515625, 0.011638404229166668],
        [0.03925641140625, 0.007475639645833334],
    ]
)

# reference yolov3.py:99-131
ECP_DAY_NIGHT_9_PRIORS: PriorSet = _split_by_stride(
    [
        [0.5728529907421875, 0.13943622409895834],
        [0.41761617583007815, 0.09156660707291667],
        [0.3015263176855469, 0.06248444700520834],
        [0.22101856140625, 0.042888710765625],
        [0.1533158565527344, 0.031196821406250002],
        [0.11255495265625, 0.021566710822916668],
        [0.07823327209960937, 0.015212825187500001],
        [0.0533416983203125, 0.010216603067708333],
        [0.0332035418359375, 0.006413999807291667],
    ]
)

# reference yolov3.py:134-166
ECP_BIC_9_PRIORS: PriorSet = _split_by_stride(
    [
        [0.5541169062011718, 0.15767184942708334],
        [0.3872792363671875, 0.08849276056770834],
        [0.27297898112304686, 0.05552458755208333],
        [0.18570756796875, 0.034849724458333335],
        [0.13080457012695312, 0.052510955223958336],
        [0.12203939466796875, 0.02422101765625],
        [0.083340965234375, 0.01635016602083333],
        [0.055563667021484374, 0.010672233619791667],
        [0.03409191838867188, 0.006481136984375],
    ]
)

PRIOR_SETS: Dict[str, PriorSet] = {
    "city_persons": CITY_PERSONS_9_PRIORS,
    "ecp": ECP_9_PRIORS,
    "ecp_night": ECP_NIGHT_9_PRIORS,
    "ecp_day_night": ECP_DAY_NIGHT_9_PRIORS,
    "ecp_bic": ECP_BIC_9_PRIORS,
}


def scale_priors_for_crop(
    priors: PriorSet, full_img_size, crop_img_size
) -> PriorSet:
    """Rescale priors defined on the full image to a crop.

    Parity: ``lib_yolo/model.py:6-17`` (``img_size_and_priors_if_crop``):
    priors are always defined for the full image, so cropping to a smaller
    window makes objects occupy a larger normalized fraction.
    """
    scale_h = full_img_size[0] / float(crop_img_size[0])
    scale_w = full_img_size[1] / float(crop_img_size[1])
    return {
        stride: [p.scaled(scale_h, scale_w) for p in prs]
        for stride, prs in priors.items()
    }


def priors_as_array(priors: PriorSet) -> Dict[int, np.ndarray]:
    """(3, 2) float32 arrays of (h, w) per stride, for device-side math."""
    return {
        stride: np.asarray([[p.h, p.w] for p in prs], dtype=np.float32)
        for stride, prs in priors.items()
    }
