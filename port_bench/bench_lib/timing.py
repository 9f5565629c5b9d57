"""The card's name and power limit."""

from __future__ import annotations

import subprocess


def card() -> dict:
    """Name and power limit by nvidia-smi ({} where it does not answer)."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return {}
    if not out:
        return {}
    name, _, limit = out[0].partition(",")
    return {"name": name.strip(), "power_limit": limit.strip()}
