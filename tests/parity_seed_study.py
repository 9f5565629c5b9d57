"""How the accuracy-parity recipe's outcome depends on the training
trajectory, in both packages, on the CPU at the suite's 64x96 (the recipe of
tests/test_accuracy_parity.py and tests/test_torch_accuracy_parity.py: the
same inputs, unfrozen float32 training at lr 3e-3).

    JAX_PLATFORMS=cpu python tests/parity_seed_study.py {jax,port} SEED

trains 300 steps from training seed SEED (JAX: init key SEED, step key
11 + 100 SEED; the port: ``eval/parity.py``'s seed) and, after 150 and 300
steps, prints and appends to ``parity_seed_study.jsonl`` (in the working
directory; no other file) one JSON line: the loss, the f32 twin's mAP (the
port's ``reference_twin`` on either package's weights, fixed masks 99), its
best score per image, its confident matches, whether the comparison would
be non-vacuous, and a checksum of the weights, so that two runs of one
seed can be held equal.  Several minutes a run on the CPU."""

import json
import os
import sys

import numpy as np
import torch

TESTS = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [TESTS, os.path.dirname(TESTS)]  # the test helpers, the packages

import test_torch_accuracy_parity as t  # noqa: E402

from bayesian_yolov3_torch import convert  # noqa: E402
from bayesian_yolov3_torch.eval import parity  # noqa: E402
from bayesian_yolov3_torch.models.yolov3 import _fixed_key_table  # noqa: E402

CHECKPOINTS = (150, 300)
OUT = "parity_seed_study.jsonl"


def report(mode, seed, steps, loss, params, stats, batch, gt):
    keys = _fixed_key_table(t.MASKS, t.T)
    ref = {b: parity.reference_twin(params, stats, batch["image"][b:b + 1], keys, "cpu")
           for b in range(t.N_IMAGES)}
    out = parity.compare(ref, ref, gt, t.SPEC, geometry=t.IMG, T=t.T, train_steps=steps)
    checksum = sum(float(v.double().abs().sum()) for v in _leaves(params))
    line = json.dumps({"mode": mode, "seed": seed, "steps": steps, "loss": loss,
                       "mAP": out["mAP_reference_f32"], "top": out["ref_top_score_per_image"],
                       "matched": out["matched_confident_detections"],
                       "nonvacuous": out["nonvacuous"], "weights_abs_sum": checksum})
    print(line, flush=True)
    with open(OUT, "a") as f:
        f.write(line + "\n")


def _leaves(tree):
    for v in tree.values():
        yield from _leaves(v) if isinstance(v, dict) else [v]


def port(seed, batch, gt):
    from bayesian_yolov3_torch.data import encode
    from bayesian_yolov3_torch.models.yolov3 import YoloV3
    from bayesian_yolov3_torch.train.loop import (detached, dropout_keys, init_state,
                                                  make_train_step, merge_params)

    cfg = parity.overfit_config(t.IMG, t.N_IMAGES, t.N_BOXES)
    model = YoloV3.from_config(cfg)
    step, _, opt = make_train_step(model, cfg, encode.build_prior_tables(model.blueprint),
                                   seed=seed)
    state = init_state(model, cfg, torch.Generator().manual_seed(seed), opt, "cpu")
    b = {k: torch.as_tensor(v) for k, v in batch.items()}
    for i in range(1, CHECKPOINTS[-1] + 1):
        state, metrics = step(state, b)
        if i in CHECKPOINTS:
            with torch.no_grad():  # parity.overfit's recovery, without ending the run
                imgs, gts = step.preprocess(b, state["step"])
                _, (_, after) = step.loss_fn(state["params"], state["frozen"], state["stats"],
                                             imgs, gts, dropout_keys(seed, state["step"]))
            report("port", seed, i, float(metrics["total"]),
                   detached(merge_params(state["params"], state["frozen"])),
                   parity.batch_statistics(state["stats"], after), batch, gt)


def jax_(seed, batch, gt):
    import jax
    import jax.numpy as jnp

    from bayesian_yolov3_tpu.config import Config
    from bayesian_yolov3_tpu.data import encode
    from bayesian_yolov3_tpu.models.yolov3 import YoloV3
    from bayesian_yolov3_tpu.train import loop

    cfg = Config(model="bayesian", full_img_size=t.IMG, batch_size=t.N_IMAGES,
                 aleatoric_loss=True, max_boxes_per_img=t.N_BOXES, lr=3e-3,
                 compute_dtype="float32", darknet53_weights="", freeze_darknet53=False)
    model = YoloV3.from_config(cfg)
    train_step, _, optimizer = loop.make_train_step(model, cfg,
                                                    encode.build_prior_tables(model.blueprint))
    state = loop.init_state(model, cfg, jax.random.PRNGKey(seed), optimizer)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    step, key = jax.jit(train_step), jax.random.PRNGKey(11 + 100 * seed)
    for i in range(1, CHECKPOINTS[-1] + 1):
        state, metrics = step(state, jb, key)
        if i in CHECKPOINTS:  # the JAX test's recovery (tests/test_accuracy_parity.py:92-104)
            after, _ = step(state, jb, jax.random.PRNGKey(12))
            stats = jax.tree.map(lambda new, old: np.asarray((new - 0.99 * old) / 0.01),
                                 after["stats"], state["stats"])
            stats = jax.tree_util.tree_map_with_path(
                lambda path, leaf: np.maximum(leaf, 1e-8) if path[-1].key == "var" else leaf,
                stats)
            params = jax.tree.map(np.asarray, loop.merge_params(state["params"],
                                                                 state["frozen"]))
            report("jax", seed, i, float(metrics["total"]),
                   *convert.params_from_jax(params, stats), batch, gt)


def main():
    mode, seed = sys.argv[1], int(sys.argv[2])
    batch = t._overfit_batch(np.random.default_rng(0))
    gt = {b: (batch["bbox"][b], batch["label"][b] + 1) for b in range(t.N_IMAGES)}
    {"port": port, "jax": jax_}[mode](seed, batch, gt)


if __name__ == "__main__":
    main()
