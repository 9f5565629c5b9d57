"""The run's process may not hold JAX or the JAX package: top-level module
names compared whole (``bayesian_yolov3_torch`` is not ``bayesian_yolov3_tpu``)."""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "bayesian_yolov3_tpu")


def forbidden_loaded(names: Iterable[str] = None) -> List[str]:
    tops = {n.split(".", 1)[0] for n in (sys.modules if names is None else names)}
    return sorted(tops & set(FORBIDDEN))
