#!/usr/bin/env python
"""Aleatoric pretraining on crops.

Trains the aleatoric variant WITHOUT the aleatoric loss on random crops of
768x1440 from 1024x1920 frames, the backbone frozen — the warm-start stage
before ``uncertainty_training``:

    python -m bayesian_yolov3_torch.cli.pretraining --set run_id=... \\
        --set train.file_pattern=... --set val.file_pattern=...

Runs on the CUDA device unless ``--device cpu`` is given; bf16 by default
(the frozen backbone's convs 0-25 through the fused conv kernels), ``--set
compute_dtype=float32`` for true float32.  ``darknet53_weights`` is loaded
after the init where the file exists.

Data-parallel over N cards, one process a card (the batch split evenly,
the BN batch statistics and the gradients synchronised):

    torchrun --nproc-per-node N -m bayesian_yolov3_torch.cli.pretraining \\
        --set mesh_shape='{"data": N}' ...

``--set training=false`` runs the qualitative eval instead
(``infer/qualitative.py``): detections drawn on the first val images, one
PNG a copy, under ``./qualitative``.
"""

from ._common import train_main

DEFAULTS = {
    "model": "aleatoric",
    "run_id": "pretrain",  # edit
    "priors": "ecp",  # edit
    "checkpoint_path": "./checkpoints",  # edit
    "tensorboard_path": "./tensorboard",  # edit
    "log_path": "./log",  # edit
    "ckp_max_to_keep": 102,  # edit
    "checkpoint_interval": 5000,
    "ign_thresh": 0.7,
    "crop_img_size": [768, 1440, 3],
    "full_img_size": [1024, 1920, 3],  # edit if not ECP dataset
    "train_steps": 500000,  # edit
    "darknet53_weights": "./darknet53.conv.74",  # edit
    "batch_size": 8,  # edit
    "lr": 1e-5,
    "cpu_thread_cnt": 24,  # edit
    "crop": True,  # edit
    "freeze_darknet53": True,  # edit
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
    return train_main(DEFAULTS, argv)


if __name__ == "__main__":
    main()
