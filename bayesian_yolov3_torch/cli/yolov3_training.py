#!/usr/bin/env python
"""Standard YOLOv3 training:

    python -m bayesian_yolov3_torch.cli.yolov3_training --set run_id=... \\
        --set train.file_pattern=... --set val.file_pattern=...

Runs on the CUDA device unless ``--device cpu`` is given.  ``training=False``
(the qualitative eval) is not ported yet.
"""

from ..train import Trainer
from ..utils import add_file_logging, setup_logging
from ._common import parse_cli

DEFAULTS = {
    "model": "standard",
    "run_id": "yolo",  # edit
    "priors": "ecp",  # edit
    "checkpoint_path": "./checkpoints",
    "log_path": "./log",
    "ckp_max_to_keep": 102,
    "checkpoint_interval": 5000,
    "ign_thresh": 0.7,
    "crop_img_size": [768, 1440, 3],
    "full_img_size": [1024, 1920, 3],  # edit if not ECP dataset
    "train_steps": 500000,  # edit
    "darknet53_weights": "./darknet53.conv.74",
    "batch_size": 8,  # edit
    "lr": 1e-5,
    "crop": True,
    "freeze_darknet53": True,
    "aleatoric_loss": False,
    "cls_cnt": 2,
    "implicit_background_class": True,
    "train": {  # edit
        "file_pattern": "./data/ecp-day-train-*-of-*",
        "num_shards": 20,
        "shuffle_buffer_size": 2000,
        "cache": False,
    },
    "val": {  # edit
        "file_pattern": "./data/ecp-day-val-*-of-*",
        "num_shards": 4,
        "shuffle_buffer_size": 10,
        "cache": False,
    },
}


def main(argv=None):
    setup_logging()
    config, device = parse_cli(DEFAULTS, argv)
    add_file_logging(config, override_existing=True)
    if not config.training:
        raise NotImplementedError(
            "training=False runs the qualitative eval, which belongs to the tools "
            "slice (infer/qualitative.py) and is not ported yet")
    return Trainer(config, device=device).run()


if __name__ == "__main__":
    main()
