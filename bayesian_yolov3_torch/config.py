"""Typed configuration with the reference's config-dict key surface.

The reference configures every entry script through a hand-edited Python
dict.  The same keys are dataclass fields here, with the same defaults as
the JAX package's ``Config`` so a config file carries over between the two
packages unchanged.  Keys that belong to parts of the system this package
does not cover yet (the ``data`` axis of ``mesh_shape``: dp training) are
kept on the surface; the trainer raises on them instead of ignoring them.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Optional, Tuple

from .core.blueprint import ModelBlueprint, Variant, VariantSpec
from .core.priors import PRIOR_SETS, PriorSet, scale_priors_for_crop


@dataclasses.dataclass
class DataConfig:
    """One dataset split (reference config['train'|'val'|'data'])."""

    file_pattern: str = ""
    # writer-only: shard count for the tfrecord creator; readers glob
    # file_pattern and ignore this
    num_shards: int = 1
    shuffle_buffer_size: int = 64
    cache: bool = False


@dataclasses.dataclass
class Config:
    # --- model -----------------------------------------------------------
    model: str = "bayesian"  # standard | aleatoric | bayesian
    cls_cnt: int = 2
    priors: Any = "ecp"  # name in PRIOR_SETS or a PriorSet dict
    full_img_size: Tuple[int, int, int] = (1024, 1920, 3)
    crop: bool = False
    crop_img_size: Tuple[int, int, int] = (768, 1440, 3)
    freeze_darknet53: bool = True
    aleatoric_loss: bool = False
    inference_mode: bool = False
    T: int = 20  # MC-dropout sample count (reference config['T'])
    standard_test_dropout: bool = False
    implicit_background_class: bool = True

    # --- training --------------------------------------------------------
    training: bool = True
    run_id: str = "run"
    train_steps: int = 500000
    batch_size: int = 8
    lr: float = 1e-5
    ign_thresh: float = 0.7
    checkpoint_interval: int = 5000
    ckp_max_to_keep: int = 1
    resume_training: bool = False
    resume_checkpoint: str = "last"
    darknet53_weights: str = "./darknet53.conv.74"
    checkpoint_path: str = "./checkpoints"
    tensorboard_path: str = "./tensorboard"
    log_path: str = "./log"

    # --- data ------------------------------------------------------------
    train: DataConfig = dataclasses.field(default_factory=DataConfig)
    val: DataConfig = dataclasses.field(default_factory=DataConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    cpu_thread_cnt: int = 4

    # --- inference -------------------------------------------------------
    thresh: float = 0.1
    step: Any = "last"
    out_path: str = "./inference"
    nms_max_boxes: int = 1000  # reference: tf.image.non_max_suppression(..., 1000)
    nms_iou_thresh: float = 0.5  # TF default iou_threshold
    # Pre-NMS candidate cap.  The restriction is OPTIMISTIC, not lossy:
    # every NMS call emits a per-image exactness certificate (ops/nms.py —
    # selection filled AND min selected score >= max excluded score, sound
    # incl. ties) and the inference runner re-runs uncertified batches
    # with pre_top_k=0.  Trained models certify essentially always; diffuse
    # score surfaces (random weights) do not and get the exact re-run.
    # 0 = always-exact full-anchor NMS.
    nms_pre_top_k: int = 8192

    # --- accelerator knobs (no reference counterpart) ----------------------
    # conv/matmul compute dtype.  "bfloat16": convs 0-25 of the backbone
    # through the fused conv kernels (ops/cuda_conv.py), every other
    # convolution and matmul in bf16 with float32 accumulation.  "float32"
    # runs every convolution in true float32 (TF32 off).
    compute_dtype: str = "bfloat16"
    # key name shared with the JAX package's config files.  The hand-written
    # kernels run on CUDA tensors either way; over mesh_shape={'mc': N} True
    # takes the fused pipeline (partial moments -> all-reduce -> finalize),
    # False the all-gather fallback (parallel/epistemic.py)
    use_pallas: bool = True
    packed_host_input: bool = False
    # deterministic epistemic inference: reuse the SAME T dropout-mask sets
    # (derived from this int seed) for every image — MC integration with T
    # fixed posterior samples; same image -> same uncertainties.  None =
    # the reference behaviour (fresh masks per image).
    fixed_mc_masks: Any = None
    quantize: Optional[str] = None
    quant_calib_images: int = 2
    quant_calib_percentile: Optional[float] = None
    # the axes of inference over the ranks of a process group (parallel/):
    # 'mc' (the T MC samples), 'dp' (the image batch), 'sp' (the image
    # rows); 'data' (dp training) is not ported yet
    mesh_shape: Dict[str, int] = dataclasses.field(default_factory=dict)
    max_boxes_per_img: int = 60
    # a tcp rendezvous (host:port) for the process group of a multi-process
    # run, with its world size and this process's rank; empty: torchrun's
    # environment, if any (parallel/mesh.py:maybe_initialize_from_config)
    coordinator_address: str = ""
    num_processes: int = 1
    process_id: int = 0

    # ----------------------------------------------------------------------
    @property
    def variant(self) -> Variant:
        return Variant(self.model)

    @property
    def variant_spec(self) -> VariantSpec:
        return VariantSpec(variant=self.variant, cls_cnt=self.cls_cnt)

    @property
    def img_size(self) -> Tuple[int, int, int]:
        """Active input size (crop-aware)."""
        return tuple(self.crop_img_size) if self.crop else tuple(self.full_img_size)

    def resolved_priors(self) -> PriorSet:
        priors = PRIOR_SETS[self.priors] if isinstance(self.priors, str) else self.priors
        if self.crop:
            priors = scale_priors_for_crop(priors, self.full_img_size, self.crop_img_size)
        return priors

    def blueprint(self) -> ModelBlueprint:
        return ModelBlueprint.build(self.img_size, self.resolved_priors(), self.cls_cnt)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=4, default=str)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Config":
        d = dict(d)
        data_fields = {x.name for x in dataclasses.fields(DataConfig)}
        for k in ("train", "val", "data"):
            if k in d and isinstance(d[k], dict):
                d[k] = DataConfig(**{f: v for f, v in d[k].items() if f in data_fields})
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})
