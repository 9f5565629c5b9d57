"""Per-anchor uncertainty heatmaps — the counterpart of the JAX package's
``infer/vis.py``.

For each of the 9 priors and each uncertainty key —
``{epi_covar_loc, ale_var_loc} x {x, y, w, h}`` plus ``cls_mutual_info``,
``obj_mean`` and ``obj_mutual_info``, 11 keys — the detection grid is
coloured with the plasma map (vmin 0, vmax the grid's 99th percentile),
nearest-upsampled by the stride, blended ``0.7 * image + 0.3 * heatmap``
and written as a PNG: 99 PNGs a frame.

``UncertaintyVisualizer`` runs the runner's epistemic device path once a
frame — ``mc_forward_cf``, then ``fused_epistemic_decode_cf_batched``, one
launch a scale (the hand-written kernel on the card) — and reads every map
from the columns of the decoded rows (``core.blueprint``'s epistemic
layout): ``epi_var_{x,y,w,h}`` (the diagonal of the epistemic covariance,
which the JAX package's maps take as ``epi_covar_loc[..., i, i]``),
``ale_var_{x,y,w,h}``, ``obj_mean``, ``obj_mutual_info`` and
``cls_mutual_info``, each scale's rows reshaped to (h, w, 3 priors) through
``ops.decode.scale_plan``; no second decode runs.  The colour table is a
copy of matplotlib's (``infer.plasma``) and the PNGs are written by the
package's own ``encode_png``: neither matplotlib nor PIL is needed.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

import numpy as np
import torch

from ..config import Config
from ..data.pipeline import encode_png
from ..ops.decode import scale_plan
from .plasma import PLASMA_RGB
from .runner import InferenceRunner

log = logging.getLogger("byolo.vis")

LOC_KEYS = ["x", "y", "w", "h"]
ALPHA = 0.7  # the image's weight in the blend
# the maps' columns of the epistemic rows (core.blueprint.VariantSpec)
EPI_VAR_COL, ALE_VAR_COL, OBJ_MEAN_COL, OBJ_MI_COL = 4, 8, 14, 15


def map_columns(cls_cnt: int) -> Dict[str, int]:
    """Each heatmap key's column of the epistemic decoded rows, in the order
    of the JAX package's ``uncertainty_maps``."""
    cols = {}
    for i, key in enumerate(LOC_KEYS):
        cols[f"epi_covar_loc_{key}"] = EPI_VAR_COL + i
        cols[f"ale_var_loc_{key}"] = ALE_VAR_COL + i
    cols.update(cls_mutual_info=17 + cls_cnt, obj_mean=OBJ_MEAN_COL,  # after the C class means
                obj_mutual_info=OBJ_MI_COL)
    return cols


def uncertainty_maps(rows: np.ndarray, hws, cls_cnt: int) -> Dict[str, List[np.ndarray]]:
    """One frame's epistemic decoded rows (N_total, 21 + C), the three scales'
    rows one after the other (``concat_all_scales`` order) -> per key, the
    (h, w, 3) map of each scale."""
    plan = scale_plan(hws)
    grids = []
    for off, (h, w) in zip(plan.row_off, plan.hws):
        block = rows[off:off + plan.n_priors * h * w]  # prior-major, then row-major cells
        grids.append(block.reshape(plan.n_priors, h, w, -1).transpose(1, 2, 0, 3))
    return {key: [g[..., col] for g in grids] for key, col in map_columns(cls_cnt).items()}


def colorize(grid: np.ndarray, vmin: Optional[float] = None,
             vmax: Optional[float] = None) -> np.ndarray:
    """(h, w) -> plasma RGB in [0, 1], as matplotlib's ``cm.plasma``: vmin
    the grid's minimum and vmax its 99th percentile unless given; norm =
    (grid - vmin) / (vmax - vmin) clipped to [0, 1]; entry ``int(norm *
    256)`` of the table, 1.0 taking entry 255 (NaN: black)."""
    if vmin is None:
        vmin = float(np.min(grid))
    if vmax is None:
        vmax = np.percentile(grid, 99)
    span = max(float(vmax) - float(vmin), 1e-12)
    norm = np.clip((grid - float(vmin)) / span, 0.0, 1.0)
    idx = norm * len(PLASMA_RGB)
    nan = np.isnan(idx)
    idx = np.minimum(np.where(nan, 0, idx).astype(np.int64), len(PLASMA_RGB) - 1)
    return np.where(nan[..., None], 0.0, PLASMA_RGB[idx])


def upsample_to(img_hw, grid: np.ndarray) -> np.ndarray:
    """Nearest-upsample a (h, w, 3) grid to the image size (stride blocks)."""
    reps_y = img_hw[0] // grid.shape[0]
    reps_x = img_hw[1] // grid.shape[1]
    return np.repeat(np.repeat(grid, reps_y, axis=0), reps_x, axis=1)


def blend(img: np.ndarray, heat: np.ndarray, alpha: float = ALPHA) -> np.ndarray:
    """``alpha * img + (1 - alpha) * heat``: 70 % image, 30 % heatmap."""
    return np.clip(alpha * img + (1 - alpha) * heat, 0.0, 1.0)


class UncertaintyVisualizer:
    """Image -> heatmap PNGs through the runner's epistemic device path
    (``cuda`` unless the caller passes another device).  ``config``: the
    bayesian variant at the images' size; the dropout keys are one (T, 15)
    table drawn as ``InferenceRunner.draw_keys`` draws, from a generator
    seeded with ``seed``, the same for every image.  ``params`` / ``stats``
    None: the configuration's checkpoint (``InferenceRunner.load_state``)."""

    def __init__(self, config: Config, params=None, stats=None, seed: int = 0, device="cuda"):
        if config.model != "bayesian":
            raise ValueError(f"uncertainty heatmaps need the bayesian variant, not "
                             f"{config.model!r}")
        self.config = dataclasses.replace(config, inference_mode=True)
        self.runner = InferenceRunner(self.config, seed=seed, device=device)
        if params is None:
            params, stats, _ = self.runner.load_state()
        self.params, self.stats = params, stats
        self.keys = self.runner.draw_keys(torch.Generator().manual_seed(seed))
        h, w = self.config.full_img_size[:2]
        self.hws = [(h // s, w // s) for s in (32, 16, 8)]

    def maps(self, img: np.ndarray) -> Dict[str, List[np.ndarray]]:
        """(h, w, 3) float image in [0, 1] (a uint8 image / 255, as
        ``detect.load_img`` gives) -> every key's per-scale (h, w, 3) maps."""
        u8 = np.round(np.asarray(img) * 255.0).astype(np.uint8)[None]
        rows = self.runner._decoded_rows(self.params, self.stats,
                                         self.runner._to_device(u8), self.keys)
        return uncertainty_maps(rows[0].cpu().numpy(), self.hws, self.runner.spec.cls_cnt)

    def render(self, img: np.ndarray, out_dir: str, tag: str = "img") -> List[str]:
        """Writes one PNG per (key, scale, prior), ``<tag>_<key>_l<scale>_p<prior>.png``;
        returns their paths.  The PNGs are coloured, blended and encoded on
        a pool of threads (zlib and numpy release the interpreter lock)."""
        os.makedirs(out_dir, exist_ok=True)
        jobs = [(key, s, p, grid[..., p])
                for key, per_scale in self.maps(img).items()
                for s, grid in enumerate(per_scale) for p in range(grid.shape[-1])]

        def write(job):
            key, s, p, grid = job
            heat = upsample_to(img.shape[:2], colorize(grid, vmin=0.0))
            path = os.path.join(out_dir, f"{tag}_{key}_l{s}_p{p}.png")
            with open(path, "wb") as f:
                f.write(encode_png((blend(img, heat) * 255).astype(np.uint8)))
            return path

        with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as ex:
            written = list(ex.map(write, jobs))
        log.info("wrote %d heatmaps to %s", len(written), out_dir)
        return written
