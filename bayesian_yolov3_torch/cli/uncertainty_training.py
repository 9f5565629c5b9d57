#!/usr/bin/env python
"""Uncertainty fine-tuning.

Trains the bayesian variant WITH the aleatoric loss, warm-started from a
pretraining checkpoint of the same ``run_id`` (``resume_training``: both
variants share the aleatoric head structure, so every variable restores):

    python -m bayesian_yolov3_torch.cli.uncertainty_training --set run_id=... \\
        --set train.file_pattern=... --set val.file_pattern=...

Runs on the CUDA device unless ``--device cpu`` is given.

Data-parallel over N cards, one process a card (the batch split evenly,
the BN batch statistics and the gradients synchronised):

    torchrun --nproc-per-node N -m bayesian_yolov3_torch.cli.uncertainty_training \\
        --set mesh_shape='{"data": N}' ...

``--set training=false`` runs the qualitative eval instead
(``infer/qualitative.py``): detections drawn on the first val images, one
PNG a copy, under ``./qualitative``.
"""

from ._common import train_main

DEFAULTS = {
    "model": "bayesian",
    "run_id": "epi_ale",  # edit
    "resume_training": True,
    "resume_checkpoint": "last",  # edit: or an explicit step
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
    "batch_size": 2,  # edit
    "lr": 1e-5,
    "crop": True,
    "freeze_darknet53": True,
    "aleatoric_loss": True,
    "inference_mode": False,
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
    return train_main(DEFAULTS, argv)


if __name__ == "__main__":
    main()
