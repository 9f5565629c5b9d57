#!/usr/bin/env python3
"""Convert a checkpoint step written by the JAX package's trainer (an orbax
store, ``bayesian_yolov3_tpu/train/checkpoints.py``) into the PyTorch
port's store (``bayesian_yolov3_torch/train/checkpoints.py``: one
``state.npz`` per step), so the port's inference CLIs can run weights
trained with the JAX package.

    python3 jax_checkpoint_to_torch.py --out ./checkpoints_torch \\
        --set model=bayesian --set checkpoint_path=./checkpoints \\
        --set run_id=my_run [--set step=1200]

``--set`` takes the keys of the training run's config (``model``,
``cls_cnt``, ``freeze_darknet53``, ...: whatever shapes the model), as the
JAX CLIs do; ``step`` is ``last`` by default.  The step is restored with
the JAX store's ``restore_partial`` (the parameters, the frozen backbone
and the BN statistics, shape-checked against the configured model; the
optimizer state is not carried over), mapped through
``bayesian_yolov3_torch.convert.params_from_jax`` (conv kernels HWIO ->
OIHW) and saved under ``--out`` for the same run id and step.  The port
then reads it with ``--set checkpoint_path=<--out>``.

This tool imports both packages (and so JAX and orbax); the port itself
imports neither.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Tuple

import jax
import numpy as np

from bayesian_yolov3_tpu.config import Config
from bayesian_yolov3_tpu.models.yolov3 import YoloV3
from bayesian_yolov3_tpu.train import loop as jax_loop
from bayesian_yolov3_tpu.train.checkpoints import CheckpointStore as JaxStore
from bayesian_yolov3_torch import convert
from bayesian_yolov3_torch.train import loop as torch_loop
from bayesian_yolov3_torch.train.checkpoints import CheckpointStore as TorchStore


def convert_checkpoint(cfg: Config, out_root: str) -> Tuple[str, int]:
    """Step ``cfg.step`` of run ``cfg.run_id`` under ``cfg.checkpoint_path``
    (a JAX store) -> the same run id and step under ``out_root`` (the
    port's store).  Returns (the step's directory, step).  Refuses to write
    over a step that is already there."""
    shapes = jax.eval_shape(YoloV3.from_config(cfg).init, jax.random.PRNGKey(0))
    trainable, frozen = jax_loop.partition_params(shapes[0], cfg.freeze_darknet53)
    like = {"params": trainable, "frozen": frozen, "stats": shapes[1]}
    store = JaxStore(cfg.checkpoint_path, cfg.run_id, max_to_keep=cfg.ckp_max_to_keep)
    restored, step = store.restore_partial(like, step=cfg.step)
    params_np = jax.tree.map(np.asarray, jax_loop.merge_params(restored["params"],
                                                               restored["frozen"]))
    params, stats = convert.params_from_jax(params_np, jax.tree.map(np.asarray,
                                                                    restored["stats"]))
    out = TorchStore(out_root, cfg.run_id, max_to_keep=0)  # 0: delete no other step
    if step in out.all_steps():
        raise FileExistsError(f"step {step} of run {cfg.run_id!r} is already in {out.dir}")
    p_trainable, p_frozen = torch_loop.partition_params(params, cfg.freeze_darknet53)
    out.save(step, {"params": p_trainable, "frozen": p_frozen, "stats": stats})
    return os.path.join(out.dir, str(step)), step


def _parse_value(raw: str):
    try:
        return json.loads(raw)
    except json.JSONDecodeError:
        return raw


def main(argv=None) -> str:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", required=True, help="checkpoint_path of the port's store")
    p.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                   help="a key of the training run's config (dotted keys allowed)")
    args = p.parse_args(argv)
    merged = {}
    for kv in args.set:
        key, _, raw = kv.partition("=")
        target = merged
        parts = key.split(".")
        for part in parts[:-1]:
            target = target.setdefault(part, {})
        target[parts[-1]] = _parse_value(raw)
    path, step = convert_checkpoint(Config.from_dict(merged), args.out)
    print(f"step {step} -> {path}")
    return path


if __name__ == "__main__":
    main(sys.argv[1:])
