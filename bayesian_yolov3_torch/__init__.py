"""bayesian_yolov3_torch — the PyTorch/CUDA port of bayesian_yolov3_tpu.

Bayesian YOLOv3 (YOLOv3 object detection with aleatoric + epistemic
MC-dropout uncertainty) for an NVIDIA Hopper GPU.  The package imports
``torch`` and numpy and nothing of the JAX package beside it; sub-package
names mirror the JAX package so each counterpart is found by name.

It covers epistemic and batched inference (every mesh axis of the JAX
runner, int8 heads), training on one device or data-parallel over N, the
TF1 checkpoint importer and the tools:

core      priors, model blueprints (shape contracts)
ops       conv/BN/dropout blocks, anchor decode, entropy/MI, NMS, the
          training loss, and the hand-written CUDA kernels
          (``ops/cuda_*.py`` + ``csrc/*.cu``)
models    Darknet-53 backbone + the YOLOv3 heads, T-sample MC forward,
          the TF1 checkpoint importer
data      tfrecord IO, PNG codec, test and train loaders, augmentation,
          GT encoding, CityPersons ingestion, prior clustering
train     the trainer (one device or the ``data`` axis), Adam, checkpoint
          store
parallel  process groups: the mc, dp and sp axes of inference, the data
          axis of training
infer     InferenceRunner, ECP JSON output, detect, uncertainty heatmaps,
          the qualitative eval
eval      detection metrics (AP, LAMR, mAP)
cli       the inference, detect, training and tool entry points
"""

__version__ = "0.1.0"
