"""Logging setup (parity lib_yolo/utils.py:156-172 + entry-script basicConfig)."""

from __future__ import annotations

import logging
import os


def setup_logging(level=logging.INFO):
    logging.basicConfig(
        level=level,
        format="%(asctime)s, pid: %(process)d, %(levelname)-8s %(message)s",
        datefmt="%a, %d %b %Y %H:%M:%S",
    )


def add_file_logging(config, override_existing: bool = False) -> str:
    """Per-run log file; refuses to overwrite unless asked (utils.py:164-166)."""
    path = os.path.join(config.log_path, f"{config.run_id}.log")
    os.makedirs(config.log_path, exist_ok=True)
    if os.path.exists(path) and not override_existing:
        raise RuntimeError(f"Logging file {path} already exists")
    handler = logging.FileHandler(path, "w")
    handler.setLevel(logging.INFO)
    handler.setFormatter(
        logging.Formatter(
            fmt="%(asctime)s, %(levelname)-8s %(message)s",
            datefmt="%a, %d %b %Y %H:%M:%S",
        )
    )
    logging.getLogger("").addHandler(handler)
    return path
