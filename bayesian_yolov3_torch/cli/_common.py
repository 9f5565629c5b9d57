"""Shared CLI plumbing.

The reference's "CLI" is a hand-edited config dict per entry script.  These
scripts keep that shape — a ``DEFAULTS`` dict per script — and accept
``--config some.json`` (merged over the defaults), ``--set key=value``
overrides and ``--device`` (the card unless the caller names another).

Under ``torchrun`` (``RANK`` / ``WORLD_SIZE`` in the environment) or with
``coordinator_address`` set, ``parse_cli`` joins the process group that a
``mesh_shape`` axis runs over; the default device is ``cuda:{LOCAL_RANK}``,
one card per rank (``cuda:0`` for a single process).
"""

from __future__ import annotations

import argparse
import json
import logging
from typing import Tuple

import torch.distributed as dist

from ..config import Config
from ..parallel import local_rank, maybe_initialize_from_config


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
    p.add_argument("--device", default=None,
                   help="torch device to compute on (default: cuda:LOCAL_RANK under "
                        "torchrun, else cuda:0)")
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
    config = Config.from_dict(merged)
    device = args.device or f"cuda:{local_rank()}"
    # a multi-process run joins its process group here; ranks other than 0
    # then log warnings only, so that one rank reports progress
    if (maybe_initialize_from_config(config, device=device)
            and dist.get_rank() != 0):
        logging.getLogger().setLevel(logging.WARNING)
    return config, device
