#!/usr/bin/env python
"""Aleatoric inference -> ECP JSON.

JSON fields include per-coordinate aleatoric variances, total variance,
and objectness / class entropies.

    python -m bayesian_yolov3_torch.cli.inference_aleatoric \\
        --set run_id=... --set data.file_pattern=...

Runs on the CUDA device unless ``--device cpu`` is given.  Batched: the
image batch (``batch_size``, 11 by default) goes through one forward, the
box decode kernel and the greedy-NMS kernel.  The default
``compute_dtype=bfloat16`` takes the fused early backbone (hand-written conv
kernels) and the tensor cores; ``--set compute_dtype=float32`` runs every
convolution in true float32; ``--set packed_host_input=true`` feeds
host-packed uint8 planes instead of NHWC images; ``--set quantize=int8``
runs the head section in int8, calibrated on the first
``quant_calib_images`` frames (2 by default).

The image batch splits over N cards, one process per card (batch_size a
multiple of N; each rank runs its batch_size/N images with exact NMS, the
rows are gathered, rank 0 writes the JSON; composes with int8):

    torchrun --nproc_per_node N -m bayesian_yolov3_torch.cli.inference_aleatoric \\
        --set mesh_shape='{"dp": N}' --set run_id=... --set data.file_pattern=...

or the image rows, one band per card with a one-row halo exchange around
every 3x3 conv (H a multiple of 32, any N): ``--set mesh_shape='{"sp": N}'``.
Each rank computes on ``cuda:{LOCAL_RANK}`` over NCCL unless ``--device``
names another device.
"""

import logging
import time

from ..infer import InferenceRunner
from ..utils import setup_logging
from ._common import parse_cli

DEFAULTS = {
    "model": "aleatoric",
    "checkpoint_path": "./checkpoints",  # edit
    "run_id": "ale",  # edit
    "step": "last",  # edit: or an explicit step number
    "full_img_size": [1024, 1920, 3],  # edit if not ECP dataset
    "cls_cnt": 2,  # edit if not ECP dataset
    "batch_size": 11,  # edit
    "inference_mode": False,
    "cpu_thread_cnt": 24,  # edit
    "crop": False,
    "aleatoric_loss": True,
    "priors": "ecp",  # edit
    "implicit_background_class": True,
    "data": {
        "file_pattern": "./data/ecp-day-val-*-of-*",  # edit
        "num_shards": 4,
        "shuffle_buffer_size": 1,
        "cache": False,
    },
    "out_path": "./inference/ale",  # edit
}


def main(argv=None):
    setup_logging()
    config, device = parse_cli(DEFAULTS, argv)
    logging.info("----- START -----")
    start = time.time()
    out_dir = InferenceRunner(config, device=device).run()
    elapsed = int(time.time() - start)
    logging.info("----- FINISHED in %02d:%02d:%02d -----",
                 elapsed // 3600, (elapsed // 60) % 60, elapsed % 60)
    logging.info("results: %s", out_dir)
    return out_dir


if __name__ == "__main__":
    main()
