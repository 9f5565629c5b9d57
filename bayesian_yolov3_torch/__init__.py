"""bayesian_yolov3_torch — the PyTorch/CUDA port of bayesian_yolov3_tpu.

Bayesian YOLOv3 (YOLOv3 object detection with aleatoric + epistemic
MC-dropout uncertainty) for an NVIDIA Hopper GPU.  The package imports
``torch`` and numpy and nothing of the JAX package beside it; sub-package
names mirror the JAX package so each counterpart is found by name.

This slice covers float32 epistemic inference end to end:

core      priors, model blueprints (shape contracts)
ops       conv/BN/dropout blocks, anchor decode, entropy/MI, NMS, and the
          hand-written CUDA kernels (``ops/cuda_*.py`` + ``csrc/*.cu``)
models    Darknet-53 backbone + the YOLOv3 heads, T-sample MC forward
data      tfrecord IO, PNG codec, test loader
train     checkpoint store, parameter partition
infer     InferenceRunner, ECP JSON output
cli       ``python -m bayesian_yolov3_torch.cli.inference_epistemic``
"""

__version__ = "0.1.0"
