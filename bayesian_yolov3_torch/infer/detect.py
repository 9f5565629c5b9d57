"""Image-file detection demo (parity with the reference's detect.py).

Reads image files (not tfrecords), optionally center-crops, runs forward +
decode + NMS on the runner's device, filters by objectness threshold,
computes ``score = obj * max_cls`` and draws boxes.

PNG files are read and the drawn images written with the package's own
codec (``data.pipeline.decode_png`` / ``encode_png``), so the demo needs
neither PIL nor cv2; other formats are read through PIL where it is
installed.  Boxes are drawn by a numpy rectangle rasterizer.  Each file's
dropout keys (bayesian variant) come from a generator seeded by the CRC-32
of its path, the same in every process.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import zlib
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..config import Config
from ..data.pipeline import _PNG_SIG, decode_png, encode_png
from .runner import InferenceRunner

log = logging.getLogger("byolo.detect")


def load_img(path: str) -> np.ndarray:
    """Image file -> (h, w, 3) float32 in [0, 1] (parity detect.py:76-85)."""
    with open(path, "rb") as f:
        data = f.read()
    if data.startswith(_PNG_SIG):
        return decode_png(data).astype(np.float32) / 255.0
    try:
        from PIL import Image
    except ImportError:
        fmt = os.path.splitext(path)[1].lstrip(".").upper() or "non-PNG"
        raise RuntimeError(
            f"{path}: reading {fmt} files needs PIL, which is not installed "
            "(PNG files are read without it)") from None
    return np.asarray(Image.open(path).convert("RGB"), np.float32) / 255.0


def center_crop(img: np.ndarray, crop_hw) -> np.ndarray:
    h, w = img.shape[:2]
    ch, cw = crop_hw[:2]
    y0, x0 = (h - ch) // 2, (w - cw) // 2
    return img[y0:y0 + ch, x0:x0 + cw]


def filter_and_score(rows: np.ndarray, valid: np.ndarray, spec, epistemic: bool,
                     thresh: float, img_hw) -> List[Dict]:
    """objectness threshold + score computation (parity detect.py:36-63)."""
    obj_idx = spec.obj_idx(epistemic)
    cls_start = spec.cls_start_idx(epistemic)
    out = []
    for i in np.flatnonzero(valid):
        row = rows[i]
        obj = float(row[obj_idx])
        if obj <= thresh:
            continue
        cls_scores = row[cls_start:cls_start + spec.cls_cnt]
        cls = int(np.argmax(cls_scores))
        out.append({
            "y0": float(row[0]) * img_hw[0],
            "x0": float(row[1]) * img_hw[1],
            "y1": float(row[2]) * img_hw[0],
            "x1": float(row[3]) * img_hw[1],
            "score": obj * float(cls_scores[cls]),
            "cls": cls,
        })
    return out


def draw_boxes(img: np.ndarray, boxes: Sequence[Dict]) -> np.ndarray:
    """Green detection rectangles (reference detect.py:66-73), one pixel
    wide, drawn by numpy into a uint8 copy of ``img``."""
    out = (img * 255).astype(np.uint8).copy()
    h, w = out.shape[:2]
    for b in boxes:
        y0, x0 = max(int(b["y0"]), 0), max(int(b["x0"]), 0)
        y1, x1 = min(int(b["y1"]), h - 1), min(int(b["x1"]), w - 1)
        out[y0:y1 + 1, [x0, x1]] = (0, 255, 0)
        out[[y0, y1], x0:x1 + 1] = (0, 255, 0)
    return out


class Detector:
    """detect.py-style runner over a list of image files."""

    def __init__(self, config: Config, seed: int = 0, device="cuda"):
        self.config = config
        # the device pipeline is crop-agnostic; files are cropped on the host
        self.runner = InferenceRunner(_uncropped(config), seed=seed, device=device)
        self.params, self.stats, self.step = self.runner.load_state()

    def detect_file(self, path: str) -> Dict:
        cfg = self.config
        img = load_img(path)
        if cfg.crop:
            img = center_crop(img, cfg.crop_img_size)
        images = (img[None] * 255).astype(np.uint8)
        gen = torch.Generator().manual_seed(zlib.crc32(os.fsencode(path)))
        rows, valid = self.runner.predict(self.params, self.stats, images,
                                          self.runner.draw_keys(gen))
        boxes = filter_and_score(rows[0], valid[0], self.runner.spec,
                                 self.runner.epistemic, cfg.thresh, img.shape[:2])
        return {"image": img, "boxes": boxes}

    def run(self, files: Sequence[str], out_dir: Optional[str] = None,
            show: bool = False) -> List[Dict]:
        results = []
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
        for path in files:
            res = self.detect_file(path)
            drawn = draw_boxes(res["image"], res["boxes"])
            if out_dir:
                name = os.path.splitext(os.path.basename(path))[0] + "_det.png"
                with open(os.path.join(out_dir, name), "wb") as f:
                    f.write(encode_png(drawn))
            if show:  # reference behaviour: a blocking matplotlib window
                import matplotlib.pyplot as plt

                plt.imshow(drawn)
                plt.show()
            log.info("%s: %d boxes over thresh %.2f", path, len(res["boxes"]),
                     self.config.thresh)
            results.append(res)
        return results


def _uncropped(config: Config) -> Config:
    """detect.py crops on the host then feeds the crop-sized image; the
    device pipeline therefore sees img_size = crop size with crop=False
    (priors already rescaled by Config.resolved_priors)."""
    if not config.crop:
        return config
    return dataclasses.replace(config, crop=False, full_img_size=tuple(config.crop_img_size),
                               priors=config.resolved_priors())
