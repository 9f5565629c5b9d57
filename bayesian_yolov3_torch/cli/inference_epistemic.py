#!/usr/bin/env python
"""Epistemic (MC-dropout) inference -> ECP JSON.

T MC samples per image; output JSON fields include epistemic and aleatoric
variances, mutual information, and entropies.

    python -m bayesian_yolov3_torch.cli.inference_epistemic \\
        --set run_id=... --set data.file_pattern=...

Runs on the CUDA device unless ``--device cpu`` is given.  The default
``compute_dtype=bfloat16`` takes the fused early backbone (hand-written conv
kernels) and the tensor cores; ``--set compute_dtype=float32`` runs every
convolution in true float32; ``--set packed_host_input=true`` feeds
host-packed uint8 planes instead of NHWC images; ``--set quantize=int8``
runs the head section in int8, calibrated on the first
``quant_calib_images`` frames (2 by default).

The T samples of each image split over N cards, one process per card:

    torchrun --nproc_per_node N -m bayesian_yolov3_torch.cli.inference_epistemic \
        --set mesh_shape='{"mc": N}' --set run_id=... --set data.file_pattern=...

(T a multiple of N; each rank computes on ``cuda:{LOCAL_RANK}`` over NCCL
unless ``--device`` names another device; every rank reads every frame;
rank 0 logs progress and writes the JSON.)  The image rows split over N
cards, one band per card, with a one-row halo exchange around every 3x3
conv (H a multiple of 32, any N; less device memory per card):

    torchrun --nproc_per_node N -m bayesian_yolov3_torch.cli.inference_epistemic \
        --set mesh_shape='{"sp": N}' ...

and both at once over a x b cards (rank = sp index x b + mc index):

    torchrun --nproc_per_node 4 -m bayesian_yolov3_torch.cli.inference_epistemic \
        --set mesh_shape='{"sp": 2, "mc": 2}' ...
"""

import logging
import time

from ..infer import InferenceRunner
from ..utils import setup_logging
from ._common import parse_cli

DEFAULTS = {
    "model": "bayesian",
    "checkpoint_path": "./checkpoints",  # edit
    "run_id": "epi_ale",  # edit
    "step": "last",  # edit: or an explicit step number
    "full_img_size": [1024, 1920, 3],  # edit if not ECP dataset
    "cls_cnt": 2,  # edit if not ECP dataset
    "batch_size": 1,
    "T": 50,  # edit if out of memory
    "inference_mode": True,
    "cpu_thread_cnt": 24,  # edit
    "crop": False,
    "aleatoric_loss": False,
    "priors": "ecp",  # edit
    "implicit_background_class": True,
    "data": {
        "file_pattern": "./data/ecp-day-val-*-of-*",  # edit
        "num_shards": 4,
        "shuffle_buffer_size": 1,
        "cache": False,
    },
    "out_path": "./inference/epi_ale",  # edit
}


def main(argv=None):
    setup_logging()
    config, device = parse_cli(DEFAULTS, argv)
    if config.crop or not config.inference_mode:
        raise SystemExit("epistemic inference needs crop=false and inference_mode=true")
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
