"""Qualitative evaluation: NMS'd detections drawn on val images, one PNG a
copy — the ``training=False`` branch of the three training CLIs, the
PyTorch counterpart of the JAX package's ``infer/qualitative.py``.

* The bayesian variant switches to ``inference_mode`` (epistemic), T 20
  where the configuration leaves it unset.
* ``crop``: each val image is centre-cropped on the host and the runner
  works at the crop size with the crop-rescaled priors.
* ``stack_same_image`` (the default): ``batch_size`` copies of each image,
  so that MC-dropout variation shows across them — in ONE batched
  ``predict`` where the runner's device batch takes them (dropout masks
  are drawn per batch position), else one batch-1 ``predict`` a copy, each
  with its own key table.  The key tables come from a CPU generator seeded
  with ``seed``, one table a ``predict`` call.
* ``filter_and_score`` (objectness threshold, score = obj * max class) and
  ``draw_boxes``; PNGs written by the package's own ``encode_png``.
  ``show=True`` also opens each image in a matplotlib window (matplotlib
  imported then, and only then).
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import List

import numpy as np
import torch

from ..config import Config
from ..data import pipeline
from .detect import center_crop, draw_boxes, filter_and_score
from .runner import InferenceRunner

log = logging.getLogger("byolo.qualitative")


def eval_config(config: Config) -> Config:
    """The runner's configuration of the qualitative eval: epistemic for the
    bayesian variant (T 20 if unset), host-cropped images at the crop size,
    without the training's ``data`` axis (the JAX runner ignores it)."""
    if config.model == "bayesian":
        config = dataclasses.replace(config, inference_mode=True, T=config.T or 20)
    config = dataclasses.replace(
        config, packed_host_input=False,
        mesh_shape={k: v for k, v in config.mesh_shape.items() if k != "data"})
    if config.crop:
        config = dataclasses.replace(config, crop=False,
                                     full_img_size=tuple(config.crop_img_size),
                                     priors=config.resolved_priors())
    return config


def _show(img: np.ndarray) -> None:
    try:
        import matplotlib.pyplot as plt
    except ImportError:
        raise RuntimeError("qualitative_eval(show=True) opens a matplotlib window; "
                           "matplotlib is not installed (the PNGs need none)") from None
    plt.imshow(img)
    plt.show()


def qualitative_eval(config: Config, n_images: int = 20, out_dir: str = "./qualitative",
                     show: bool = False, stack_same_image: bool = True, seed: int = 0,
                     device="cuda") -> List[str]:
    """Draw the detections of the first ``n_images`` val images; returns the
    PNG paths written (``qual_<i>[_s<copy>]_step<step>.png``)."""
    device_cfg = eval_config(config)
    runner = InferenceRunner(device_cfg, seed=seed, device=device)
    params, stats, step = runner.load_state()
    loader = pipeline.TestLoader(dataclasses.replace(device_cfg, data=config.val),
                                 batch_size=1)
    n_stack = max(1, config.batch_size) if stack_same_image else 1
    batched = runner.device_batch_size() >= n_stack
    gen = torch.Generator().manual_seed(seed)
    os.makedirs(out_dir, exist_ok=True)
    written = []
    for i, batch in enumerate(loader.batches()):
        if i >= n_images:
            break
        img = batch["image"][0].astype(np.float32) / 255.0
        if config.crop:
            img = center_crop(img, config.crop_img_size)
        u8 = (img[None] * 255).astype(np.uint8)
        if batched:  # one call over the copies: masks drawn per batch position
            rows, valid = runner.predict(params, stats, np.repeat(u8, n_stack, axis=0),
                                         runner.draw_keys(gen))
        else:
            per = [runner.predict(params, stats, u8, runner.draw_keys(gen))
                   for _ in range(n_stack)]
            rows = np.concatenate([r for r, _ in per])
            valid = np.concatenate([v for _, v in per])
        for b in range(n_stack):
            boxes = filter_and_score(rows[b], valid[b], runner.spec, runner.epistemic,
                                     config.thresh, img.shape[:2])
            drawn = draw_boxes(img, boxes)
            if show:
                _show(drawn)
            name = (f"qual_{i:04d}_s{b}_step{step}.png" if n_stack > 1
                    else f"qual_{i:04d}_step{step}.png")
            path = os.path.join(out_dir, name)
            with open(path, "wb") as f:
                f.write(pipeline.encode_png(drawn))
            written.append(path)
            log.info("%s: %d boxes", path, len(boxes))
    return written
