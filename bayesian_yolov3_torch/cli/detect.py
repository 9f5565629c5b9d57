#!/usr/bin/env python
"""Image-file detection demo (parity with the reference detect.py).

    python -m bayesian_yolov3_torch.cli.detect IMG [IMG...] [--out-dir DIR] \
        [--show] [--set key=value ...] [--device cpu]

Writes ``<name>_det.png`` per file into ``--out-dir``.  Runs on the CUDA
device unless ``--device cpu`` is given.
"""

import argparse
import logging

from ..infer.detect import Detector
from ..utils import setup_logging
from ._common import parse_cli

DEFAULTS = {
    "model": "bayesian",  # edit: standard | aleatoric | bayesian
    "checkpoint_path": "./checkpoints",  # edit
    "run_id": "epi_ale",  # edit
    "step": "last",  # edit
    "thresh": 0.1,  # edit: objectness threshold (detect.py:143)
    "full_img_size": [1024, 1920, 3],  # edit
    "crop_img_size": [768, 1440, 3],
    "crop": False,  # edit: center-crop files before detection
    "cls_cnt": 2,
    "T": 35,  # edit if out of memory (detect.py:146)
    "inference_mode": True,
    "aleatoric_loss": False,
    "priors": "ecp",  # edit
    "implicit_background_class": True,
}


def main(argv=None):
    setup_logging()
    p = argparse.ArgumentParser()
    p.add_argument("files", nargs="+")
    p.add_argument("--out-dir", default="./detections")
    p.add_argument("--show", action="store_true",
                   help="blocking matplotlib windows like the reference")
    # read again by parse_cli; declared here so their values are no file names
    p.add_argument("--config")
    p.add_argument("--set", action="append", default=[])
    p.add_argument("--device")
    args = p.parse_args(argv)
    config, device = parse_cli(DEFAULTS, argv)
    results = Detector(config, device=device).run(args.files, out_dir=args.out_dir,
                                                  show=args.show)
    total = sum(len(r["boxes"]) for r in results)
    logging.info("%d detections over %d files", total, len(args.files))
    return results


if __name__ == "__main__":
    main()
