"""The arithmetic that metrics of the inference cells share: each metric's
own file (``metrics/<metric>.py``) names which of these it reads."""

from __future__ import annotations

from typing import Dict, Optional

from . import flops, peaks


def rate(rec: Dict) -> Optional[float]:
    """Images whose rows reached the host in the window, over all of the
    window's time (the call in flight at the deadline finished and
    counted)."""
    if rec["kind"] != "infer":
        return None
    return rec["run"]["images"] / rec["run"]["seconds"]


def idle_pct(rec: Dict) -> Optional[float]:
    """Share of an image's wall time in which no operation runs on the
    device: the traced calls' device busy time per image (kernels, copies
    and sets in the profiler's trace) against the host-clock time per image
    of the calls before the profiled range, which the profiler does not
    slow.  None where the window closed before the traced calls were
    made."""
    tr, run = rec.get("trace"), rec["run"]
    if rec["kind"] != "infer" or not tr or not run["plain_images"] \
            or run["traced_calls"] < int(rec["traffic"]["trace"]["calls"]):
        return None
    device_s = tr["busy_s"] / run["traced_images"]
    wall_s = run["plain_seconds"] / run["plain_images"]
    return 100.0 * (1.0 - device_s / wall_s)


def mfu_pct(rec: Dict) -> Optional[float]:
    """The whole step's share of the card's bf16 peak: the model's FLOPs per
    image (``flops.py``: the backbone once, the head section T times) times
    the images per second of the calls before the profiled range (the
    profiler slows the host), over 989 TFLOP/s."""
    run = rec["run"]
    if rec["kind"] != "infer" or not run["plain_seconds"]:
        return None
    rate_ = run["plain_images"] / run["plain_seconds"]
    return 100.0 * flops.inference_per_image(rec["config"], rec["image_hw"]) * rate_ \
        / peaks.BF16_FLOPS


def layer_ms(rec: Dict, name: str) -> Optional[float]:
    """Device ms per image of one layer alone, from the profiler's trace of
    it at the cell's batch and dtype after the window (the driver's
    ``layers``)."""
    return rec["layers"].get(name)
