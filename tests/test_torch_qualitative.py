"""The port's qualitative eval (``infer/qualitative.py``) and the
``training=False`` branch of its training CLIs, on the CPU at 64x96.

Each PNG is held, pixel for pixel, against ``draw_boxes`` of
``filter_and_score`` of the port's own ``runner.predict`` on the same
copies under the same key tables — functions that ``tests/test_torch_
batched.py`` and ``tests/test_torch_runner.py`` hold against the JAX
package.  ``InferenceRunner.load_state`` is patched to hand out seeded numpy
weights.  The eval's own rules are also held against the JAX package's
``qualitative_eval`` on the same weights (its runner's ``load_state``
patched alike, no training run) for the variants without dropout, where
the two packages' key schemes do not matter: the standard variant stacked
and the aleatoric one with a crop — the same PNG names and, for each copy,
the same boxes at ``tests/test_torch_runner.py``'s row tolerance (box
corners rtol 1e-3, atol 1e-4 of the image side; scores rtol 1e-3, atol
1e-4; classes exact)."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from bayesian_yolov3_tpu.config import Config as JConfig, DataConfig as JDataConfig
from bayesian_yolov3_tpu.core.blueprint import Variant as JVariant, VariantSpec as JSpec
from bayesian_yolov3_tpu.infer import qualitative as jqualitative
from bayesian_yolov3_tpu.infer.runner import InferenceRunner as JRunner

from bayesian_yolov3_torch.infer import qualitative as tqualitative

from bayesian_yolov3_torch.cli import uncertainty_training, yolov3_training
from bayesian_yolov3_torch.cli._common import build_config
from bayesian_yolov3_torch.config import Config, DataConfig
from bayesian_yolov3_torch.data import pipeline, proto, tfrecord
from bayesian_yolov3_torch.infer import InferenceRunner
from bayesian_yolov3_torch.infer.detect import center_crop, draw_boxes, filter_and_score
from bayesian_yolov3_torch.infer.qualitative import eval_config, qualitative_eval

import torch_parity as tp

STEP = 9
N_IMAGES = 2


@pytest.fixture(scope="module")
def numpy_weights():
    """JAX-layout numpy (params, stats) by variant."""
    out = {}
    for name in ("standard", "bayesian"):
        params_np, stats_np = tp.numpy_weights(seed=3, spec=JSpec(JVariant(name), 2))
        for i in (1, 2, 3):
            params_np[f"det{i}"]["w"] *= np.float32(0.2)  # logits of a few units
        out[name] = params_np, stats_np
    out["aleatoric"] = out["bayesian"]
    return out


@pytest.fixture(scope="module")
def weights(numpy_weights):
    return {name: tp.to_torch(*w) for name, w in numpy_weights.items()}


@pytest.fixture(autouse=True)
def use_weights(weights, numpy_weights, monkeypatch):
    monkeypatch.setattr(InferenceRunner, "load_state",
                        lambda self: (*weights[self.config.model], STEP))
    monkeypatch.setattr(JRunner, "load_state", lambda self: (
        *(tp.to_jax(t) for t in numpy_weights[self.config.model]), STEP))


def _records(path, hw, n=N_IMAGES + 1):
    os.makedirs(path)
    with tfrecord.TFRecordWriter(os.path.join(path, "v-00000-of-00001.tfrecord")) as wr:
        for i in range(n):
            wr.write(proto.encode_example({
                "image/encoded": [pipeline.encode_png(tp.image_u8(seed=30 + i, hw=hw)[0])],
                "image/filename": [f"val_{i}.png".encode()]}))
    return os.path.join(path, "v-*-of-*.tfrecord")


@pytest.fixture(scope="module")
def val(tmp_path_factory):
    root = tmp_path_factory.mktemp("qual")
    return {"full": _records(str(root / "full"), tp.IMG[:2]),
            "big": _records(str(root / "big"), (128, 192))}


def _config(model, pattern, **kw):
    return Config(**{**dict(model=model, full_img_size=tp.IMG, batch_size=2, T=2,
                            compute_dtype="float32", thresh=0.0, nms_max_boxes=20,
                            nms_pre_top_k=0, val=DataConfig(file_pattern=pattern)), **kw})


def _expected(config, n_stack, seed=0):
    """What the eval must write: per image and copy, the drawn PNG's pixels
    — the runner's predict on the copies (one call, or one a copy), its
    key tables from a generator seeded with ``seed``."""
    runner = InferenceRunner(eval_config(config), seed=seed, device="cpu")
    params, stats, _ = runner.load_state()
    gen = torch.Generator().manual_seed(seed)
    loader = pipeline.TestLoader(dataclasses.replace(runner.config, data=config.val),
                                 batch_size=1)
    out = []
    for i, batch in zip(range(N_IMAGES), loader.batches()):
        img = batch["image"][0].astype(np.float32) / 255.0
        if config.crop:
            img = center_crop(img, config.crop_img_size)
        u8 = (img[None] * 255).astype(np.uint8)
        if runner.device_batch_size() >= n_stack:
            rows, valid = runner.predict(params, stats, np.repeat(u8, n_stack, axis=0),
                                         runner.draw_keys(gen))
        else:
            per = [runner.predict(params, stats, u8, runner.draw_keys(gen))
                   for _ in range(n_stack)]
            rows, valid = (np.concatenate(x) for x in zip(*per))
        for b in range(n_stack):
            boxes = filter_and_score(rows[b], valid[b], runner.spec, runner.epistemic,
                                     config.thresh, img.shape[:2])
            out.append((i, b, draw_boxes(img, boxes), len(boxes)))
    return out


def _check(written, expected, n_stack):
    assert len(written) == len(expected) == N_IMAGES * n_stack
    for path, (i, b, want, _) in zip(written, expected):
        name = f"qual_{i:04d}_s{b}_step{STEP}.png" if n_stack > 1 else f"qual_{i:04d}_step{STEP}.png"
        assert os.path.basename(path) == name
        with open(path, "rb") as f:
            np.testing.assert_array_equal(pipeline.decode_png(f.read()), want, err_msg=path)


def test_stacked_standard(val, tmp_path):
    cfg = _config("standard", val["full"])
    written = qualitative_eval(cfg, n_images=N_IMAGES, out_dir=str(tmp_path), device="cpu")
    expected = _expected(cfg, 2)
    _check(written, expected, 2)
    assert sum(n for *_, n in expected) > 0


def test_aleatoric_with_crop(val, tmp_path):
    """crop: 128x192 val frames centre-cropped to 64x96, the runner at the
    crop size with the crop-rescaled priors."""
    cfg = _config("aleatoric", val["big"], full_img_size=(128, 192, 3), crop=True,
                  crop_img_size=tp.IMG)
    assert eval_config(cfg).full_img_size == tp.IMG
    assert eval_config(cfg).resolved_priors() == cfg.resolved_priors()
    assert eval_config(dataclasses.replace(cfg, mesh_shape={"data": 2})).mesh_shape == {}
    written = qualitative_eval(cfg, n_images=N_IMAGES, out_dir=str(tmp_path), device="cpu")
    _check(written, _expected(cfg, 2), 2)


def test_bayesian_copies_vary(val, tmp_path):
    """The bayesian variant runs epistemic (T=2 here; 20 where unset) and
    its stacked copies take other dropout masks, so their detections
    differ."""
    cfg = _config("bayesian", val["full"])
    assert eval_config(cfg).inference_mode and eval_config(cfg).T == 2
    assert eval_config(dataclasses.replace(cfg, T=0)).T == 20
    written = qualitative_eval(cfg, n_images=N_IMAGES, out_dir=str(tmp_path), device="cpu")
    expected = _expected(cfg, 2)
    _check(written, expected, 2)
    assert any(not np.array_equal(expected[2 * i][2], expected[2 * i + 1][2])
               for i in range(N_IMAGES))


def test_stacking_off(val, tmp_path):
    cfg = _config("standard", val["full"])
    written = qualitative_eval(cfg, n_images=N_IMAGES, out_dir=str(tmp_path), device="cpu",
                               stack_same_image=False)
    _check(written, _expected(cfg, 1), 1)


def test_one_predict_a_copy_where_the_batch_is_not_taken(val, tmp_path, monkeypatch):
    """Where the runner's device batch is smaller than the copies (the
    epistemic mc and sp paths are batch 1), each copy is a batch-1 call with
    a key table of its own."""
    monkeypatch.setattr(InferenceRunner, "device_batch_size", lambda self: 1)
    cfg = _config("bayesian", val["full"])
    written = qualitative_eval(cfg, n_images=N_IMAGES, out_dir=str(tmp_path), device="cpu")
    _check(written, _expected(cfg, 2), 2)


def _drawn_boxes(module, monkeypatch):
    """The box lists that ``module``'s eval hands ``draw_boxes``, in order."""
    seen = []
    draw = module.draw_boxes
    monkeypatch.setattr(module, "draw_boxes",
                        lambda img, boxes, *a: (seen.append(boxes), draw(img, boxes, *a))[1])
    return seen


@pytest.mark.parametrize("model,crop", [("standard", False), ("aleatoric", True)])
def test_matches_jax_qualitative_eval(val, tmp_path, monkeypatch, model, crop):
    """The eval's rules against the JAX package's: the standard variant's
    stacked copies in one batched predict, and the aleatoric variant's
    centre crop with the runner at the crop size — the same PNG names, and
    each copy's boxes at the runner tests' tolerance."""
    kw = dict(model=model, batch_size=2, T=2, compute_dtype="float32", thresh=0.0,
              nms_max_boxes=20, nms_pre_top_k=0)
    kw.update(dict(full_img_size=(128, 192, 3), crop=True, crop_img_size=tp.IMG) if crop
              else dict(full_img_size=tp.IMG))
    pattern = val["big" if crop else "full"]
    got_boxes = _drawn_boxes(tqualitative, monkeypatch)
    got = qualitative_eval(Config(**kw, val=DataConfig(file_pattern=pattern)),
                           n_images=N_IMAGES, out_dir=str(tmp_path / "port"), device="cpu")
    want_boxes = _drawn_boxes(jqualitative, monkeypatch)
    want = jqualitative.qualitative_eval(JConfig(**kw, val=JDataConfig(file_pattern=pattern)),
                                         n_images=N_IMAGES, out_dir=str(tmp_path / "jax"))
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want]
    assert len(got) == N_IMAGES * 2
    assert len(got_boxes) == len(want_boxes) == len(got)
    side = max(tp.IMG[:2])
    for g, w in zip(got_boxes, want_boxes):
        assert len(g) == len(w) > 0
        assert [b["cls"] for b in g] == [b["cls"] for b in w]
        for k in ("y0", "x0", "y1", "x1"):
            np.testing.assert_allclose([b[k] for b in g], [b[k] for b in w],
                                       rtol=1e-3, atol=1e-4 * side, err_msg=k)
        np.testing.assert_allclose([b["score"] for b in g], [b["score"] for b in w],
                                   rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("cli", [yolov3_training, uncertainty_training])
def test_training_cli_false_runs_the_eval(val, tmp_path, cli):
    """``--set training=false`` of a training CLI writes the eval's PNGs
    under ./qualitative (the test's own working directory)."""
    argv = ["--device", "cpu"] + [a for kv in (
        "training=false", "crop=false", "full_img_size=[64,96,3]", "batch_size=2", "T=2",
        "compute_dtype=float32", "thresh=0.0", f"val.file_pattern={val['full']}",
        f"log_path={tmp_path / 'log'}", "resume_training=false") for a in ("--set", kv)]
    written = cli.main(argv)
    assert len(written) == 3 * 2  # the 3 val images (fewer than 20), 2 copies each
    assert all(os.path.dirname(os.path.abspath(p)) == os.path.abspath("qualitative")
               for p in written)
    expected = _expected(build_config(cli.DEFAULTS, argv), 2)
    for path, (_, _, want, _) in zip(written, expected):
        with open(path, "rb") as f:
            np.testing.assert_array_equal(pipeline.decode_png(f.read()), want)
