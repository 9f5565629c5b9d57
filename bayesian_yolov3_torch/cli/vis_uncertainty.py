#!/usr/bin/env python
"""Per-anchor uncertainty heatmaps (``infer/vis.py``): for each image file,
one PNG per (key, scale, prior) — 11 keys x 3 scales x 3 priors = 99 — of
the epistemic and aleatoric localization variances, the mutual
informations and the objectness, blended over the image:

    python -m bayesian_yolov3_torch.cli.vis_uncertainty IMG.png ... \\
        --out-dir ./vis_uncertainty --set run_id=... --set checkpoint_path=...

Runs on the CUDA device unless ``--device cpu`` is given (bf16 by default);
reads PNG without PIL and writes PNG without matplotlib or PIL.
"""

import argparse
import logging

from ..infer.detect import load_img
from ..infer.vis import UncertaintyVisualizer
from ..utils import setup_logging
from ._common import parse_cli

DEFAULTS = {
    "model": "bayesian",
    "checkpoint_path": "./checkpoints",  # edit
    "run_id": "epi_ale",  # edit
    "step": "last",  # edit
    "full_img_size": [1024, 1920, 3],  # edit
    "cls_cnt": 2,
    "T": 30,  # edit
    "inference_mode": True,
    "crop": False,
    "aleatoric_loss": False,
    "priors": "ecp",  # edit
    "implicit_background_class": True,
    "batch_size": 1,
}


def main(argv=None):
    """Returns the PNG paths written, image after image."""
    setup_logging()
    p = argparse.ArgumentParser()
    p.add_argument("files", nargs="+")
    p.add_argument("--out-dir", default="./vis_uncertainty")
    args, rest = p.parse_known_args(argv)
    config, device = parse_cli(DEFAULTS, rest)
    vis = UncertaintyVisualizer(config, device=device)
    written = []
    for i, path in enumerate(args.files):
        paths = vis.render(load_img(path), args.out_dir, tag=f"img{i:03d}")
        logging.info("%s -> %d heatmaps", path, len(paths))
        written.extend(paths)
    return written


if __name__ == "__main__":
    main()
