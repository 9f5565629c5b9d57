"""The kernel wrappers' launch counters, read and set to 0 together.

Each wrapper of a hand-written kernel adds one to its module's counter
where it launches its kernel, and nowhere else (a CPU tensor takes the
plain version and counts nothing)."""

from __future__ import annotations

from typing import Dict

from . import cuda_conv, cuda_decode, cuda_epistemic, cuda_moments, cuda_nms, cuda_quant

_SINGLE = {"epistemic_decode": cuda_epistemic, "box_decode": cuda_decode,
           "greedy_nms": cuda_nms, "quant_epilogue": cuda_quant}
_TABLES = (cuda_conv.launch_counts, cuda_moments.launch_counts)


def reset() -> None:
    for module in _SINGLE.values():
        module.launch_count = 0
    for counts in _TABLES:
        for name in counts:
            counts[name] = 0


def read() -> Dict[str, int]:
    """{kernel name: launches since the last ``reset``} of all nine kernels."""
    out = {name: module.launch_count for name, module in _SINGLE.items()}
    for counts in _TABLES:
        out.update(counts)
    return out
