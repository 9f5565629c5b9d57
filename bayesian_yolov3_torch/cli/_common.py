"""Shared CLI plumbing.

The reference's "CLI" is a hand-edited config dict per entry script.  These
scripts keep that shape — a ``DEFAULTS`` dict per script — and accept
``--config some.json`` (merged over the defaults), ``--set key=value``
overrides and ``--device`` (the card unless the caller names another).
"""

from __future__ import annotations

import argparse
import json
from typing import Tuple

from ..config import Config


def parse_value(raw: str):
    try:
        return json.loads(raw)
    except json.JSONDecodeError:
        return raw


def parse_cli(defaults: dict, argv=None) -> Tuple[Config, str]:
    """-> (config, device)."""
    p = argparse.ArgumentParser()
    p.add_argument("--config", help="JSON file merged over the script defaults")
    p.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                   help="override a single config key (dotted keys allowed)")
    p.add_argument("--device", default="cuda",
                   help="torch device to compute on (default: cuda)")
    args, _ = p.parse_known_args(argv)
    merged = dict(defaults)
    if args.config:
        with open(args.config) as f:
            merged.update(json.load(f))
    for kv in args.set:
        key, _, raw = kv.partition("=")
        target = merged
        parts = key.split(".")
        for part in parts[:-1]:
            target = target.setdefault(part, {})
        target[parts[-1]] = parse_value(raw)
    return Config.from_dict(merged), args.device
