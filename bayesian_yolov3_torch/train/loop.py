"""The parameter partition shared by training and inference.

Only the split between the trainable head section and the frozen backbone
is here: checkpoints store the two parts under separate keys, and the
inference runner merges them back.  The training loop itself belongs to
a later slice of this package.
"""

from __future__ import annotations

from typing import Dict, Tuple


def partition_params(params: Dict, freeze_backbone: bool) -> Tuple[Dict, Dict]:
    if freeze_backbone:
        trainable = {k: v for k, v in params.items() if k != "backbone"}
        frozen = {"backbone": params["backbone"]}
    else:
        trainable, frozen = dict(params), {}
    return trainable, frozen


def merge_params(trainable: Dict, frozen: Dict) -> Dict:
    return {**frozen, **trainable}
