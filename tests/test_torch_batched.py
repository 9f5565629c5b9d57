"""The port's batched standard / aleatoric inference as a whole, on the CPU:
``InferenceRunner.predict`` against the JAX package's runner (which takes
its XLA decode path off the TPU) on the same numpy weights and images,
``run()`` from a tfrecord to ECP JSON, the packed host input, the two
batched CLIs and the image-file ``Detector``.

The JAX runner compiles once per (variant, compute dtype), with exact NMS
(``nms_pre_top_k=0``): a certified or retried pre-top-k selection equals
the exact one, so the port's ``pre_top_k=40`` run is held to it as well.
Float32 rows: 75 float32 convolutions summed in another order, then the
elementwise decode — rtol 1e-3 / atol 1e-4 on every value column (the
epistemic runner's bound in test_torch_runner.py), ids and ``valid``
exactly.  Runs that read a checkpoint get the module's weights through a
patched ``load_state``: checkpoint loading is held by test_torch_runner.py,
and a full-width checkpoint costs 241 MB of temp space."""

import glob
import json
import os

import numpy as np
import pytest
import torch

from bayesian_yolov3_tpu.config import Config as JConfig
from bayesian_yolov3_tpu.core.blueprint import Variant as JVariant
from bayesian_yolov3_tpu.core.blueprint import VariantSpec as JSpec
from bayesian_yolov3_tpu.infer import detect as jdetect
from bayesian_yolov3_tpu.infer.runner import InferenceRunner as JRunner

from bayesian_yolov3_torch.config import Config, DataConfig
from bayesian_yolov3_torch.data import pipeline, proto, tfrecord
from bayesian_yolov3_torch.infer import InferenceRunner, bbox_to_ecp_format
from bayesian_yolov3_torch.infer import detect as tdetect

import torch_parity as tp

STEP = 12
KW = dict(inference_mode=False, batch_size=2, compute_dtype="float32",
          full_img_size=tp.IMG, nms_max_boxes=50, nms_pre_top_k=0)
IMAGES = tp.image_u8(seed=4, nb=2)


@pytest.fixture(scope="module")
def weights():
    """model -> numpy (params, stats); det convs scaled so raw logits are a
    few units, not tens."""
    out = {}
    for name in ("standard", "bayesian"):
        params_np, stats_np = tp.numpy_weights(seed=3, spec=JSpec(JVariant(name), 2))
        for i in (1, 2, 3):
            params_np[f"det{i}"]["w"] *= np.float32(0.2)
        out[name] = (params_np, stats_np)
    out["aleatoric"] = out["bayesian"]
    return out


@pytest.fixture
def use_weights(weights, monkeypatch):
    """Patch ``InferenceRunner.load_state`` to hand out the module's weights
    of the runner's variant, as step ``STEP``."""

    def load_state(self):
        return (*tp.to_torch(*weights[self.config.model]), STEP)

    monkeypatch.setattr(InferenceRunner, "load_state", load_state)
    return weights


@pytest.fixture(scope="module")
def jax_predictions(weights):
    """(model, compute dtype) -> the JAX runner's (rows, valid) on IMAGES."""
    cache = {}

    def get(model, dtype):
        if (model, dtype) not in cache:
            jr = JRunner(JConfig(**dict(KW, model=model, compute_dtype=dtype)))
            params_np, stats_np = weights[model]
            cache[model, dtype] = tuple(np.asarray(a) for a in jr.predict(
                tp.to_jax(params_np), tp.to_jax(stats_np), IMAGES, jr.rng))
        return cache[model, dtype]

    return get


@pytest.mark.parametrize("pre_top_k", [40, 0])
@pytest.mark.parametrize("model", ["standard", "aleatoric"])
def test_predict_matches_jax_runner(weights, jax_predictions, model, pre_top_k):
    """pre_top_k=40 of 378 anchors cannot fill 50 selections, so the
    certificate fails and the port takes its exact retry."""
    want_rows, want_valid = jax_predictions(model, "float32")
    tr = InferenceRunner(Config(**dict(KW, model=model, nms_pre_top_k=pre_top_k)),
                         device="cpu")
    assert not tr.epistemic and tr.draw_keys() is None
    tparams, tstats = tp.to_torch(*weights[model])
    got_rows, got_valid = tr.predict(tparams, tstats, IMAGES)
    width = tr.spec.decoded_width()
    assert got_rows.shape == want_rows.shape == (2, 50, width)
    np.testing.assert_array_equal(got_valid, want_valid)
    assert got_valid.sum(axis=1).min() > 10
    np.testing.assert_array_equal(got_rows[..., -2:], want_rows[..., -2:])  # ids
    np.testing.assert_allclose(got_rows[..., :-2], want_rows[..., :-2], rtol=1e-3, atol=1e-4)
    if pre_top_k:
        _, _, cert = tr._device_pipeline(tparams, tstats, torch.from_numpy(IMAGES),
                                         None, pre_top_k=pre_top_k)
        assert not bool(cert.any())  # the retry really ran


def test_predict_bf16_matches_jax_runner(weights, jax_predictions):
    """Aleatoric at ``compute_dtype="bfloat16"``, both runners.  bf16
    convolutions round in other places in the two frameworks and near-tied
    scores may swap in NMS, so detections are paired by anchor (layer id,
    prior id, nearest box) and held as test_torch_runner.py holds the
    epistemic bf16 rows: corners within 0.01 of the unit image, objectness,
    class scores and entropies within 0.05, variance columns within rtol
    0.35 (the jitter bound of tests/test_accuracy_parity.py) + 1e-6; at
    least 60 % of either side's detections pair up."""
    # row layout: 0-3 corners, 4-7 loc variances, 8 total variance, 9 obj,
    # 10 obj entropy, 11-12 classes, 13 class entropy, 14 layer id, 15 prior id
    want_rows, want_valid = jax_predictions("aleatoric", "bfloat16")
    tr = InferenceRunner(Config(**dict(KW, model="aleatoric", compute_dtype="bfloat16")),
                         device="cpu")
    got_rows, got_valid = tr.predict(*tp.to_torch(*weights["aleatoric"]), IMAGES)
    assert got_rows.shape == want_rows.shape == (2, 50, 16)
    assert np.isfinite(got_rows).all()
    for b in range(2):
        g_rows, w_rows = got_rows[b][got_valid[b]], want_rows[b][want_valid[b]]
        n_got, n_want = len(g_rows), len(w_rows)
        assert n_got > 10 and abs(n_got - n_want) <= 0.2 * n_want
        pairs = []
        for r in g_rows:
            same = w_rows[(w_rows[:, 14] == r[14]) & (w_rows[:, 15] == r[15])]
            if len(same):
                d = np.abs(same[:, :4] - r[:4]).max(axis=1)
                if d.min() <= 0.01:
                    pairs.append((r, same[int(d.argmin())]))
        assert len(pairs) >= 0.6 * max(n_got, n_want), (b, len(pairs), n_got, n_want)
        g, w = (np.stack(x) for x in zip(*pairs))
        np.testing.assert_allclose(g[:, :4], w[:, :4], atol=0.01, rtol=0)
        np.testing.assert_allclose(g[:, 9:14], w[:, 9:14], atol=0.05, rtol=0)
        np.testing.assert_allclose(g[:, 4:9], w[:, 4:9], rtol=0.35, atol=1e-6)


def _write_records(path, images, names):
    os.makedirs(path, exist_ok=True)
    with tfrecord.TFRecordWriter(os.path.join(path, "d-00000-of-00001.tfrecord")) as wr:
        for img, name in zip(images, names):
            wr.write(proto.encode_example({
                "image/encoded": [pipeline.encode_png(img)],
                "image/filename": [name.encode()],
            }))
    return os.path.join(path, "d-*-of-*.tfrecord")


def _read_dets(out_dir):
    out = {}
    for f in sorted(glob.glob(os.path.join(out_dir, "*.json"))):
        with open(f) as fh:
            out[os.path.basename(f)] = json.load(fh)["children"]
    return out


@pytest.mark.parametrize("model", ["standard", "aleatoric"])
def test_run_writes_ecp_json_of_its_rows(use_weights, tmp_path, model):
    """tfrecord -> one JSON per frame, equal to bbox_to_ecp_format of
    predict()'s rows; batch 2 over 3 frames pads the last batch."""
    images = [tp.image_u8(seed=10 + i)[0] for i in range(3)]
    names = [f"frame_{i}.png" for i in range(3)]
    cfg = Config(**dict(KW, model=model), cpu_thread_cnt=2,
                 out_path=str(tmp_path / "out" / model),
                 data=DataConfig(file_pattern=_write_records(str(tmp_path / "data"), images, names)))
    runner = InferenceRunner(cfg, device="cpu")
    out_dir = runner.run()
    assert out_dir.endswith(f"{model}_{STEP}")
    got = _read_dets(out_dir)
    assert list(got) == [f"frame_{i}.json" for i in range(3)]
    # a frame is predicted in the batch it had in run(): [0, 1], then [2, 2]
    params, stats, _ = runner.load_state()
    preds = [runner.predict(params, stats, b)
             for b in (np.stack(images[:2]), np.stack([images[2], images[2]]))]
    fields = ({"x_var", "y_var", "w_var", "h_var", "total_var", "obj_entropy", "cls_entropy"}
              if model == "aleatoric" else set())
    for k, name in enumerate(got):
        rows, valid = (p[k % 2] for p in preds[k // 2])
        want = [bbox_to_ecp_format(rows[i], cfg.full_img_size, runner.spec)
                for i in np.flatnonzero(valid)]
        assert len(got[name]) == len(want) > 10
        assert got[name] == json.loads(json.dumps(want))
        keys = set(got[name][0])
        assert {"score", "cls_scores", "layer_id", "prior_id", "identity"} | fields <= keys
        assert "x_var_epi" not in keys and ("x_var" in keys) == (model == "aleatoric")
        assert {d["layer_id"] for d in got[name]} <= {0.0, 1.0, 2.0}


def test_run_with_packed_host_input(use_weights, tmp_path, monkeypatch):
    """Batched aleatoric bf16 run() from the loader's uint8 planes against the
    image-fed run with the fused branch forced (what a CUDA tensor takes by
    itself): the feeds differ only in how an input pixel is rounded to bf16,
    so the same boxes come out — corners within 2 px, scores within 0.02, on
    at least 80 % of the detections (the bound of test_torch_runner.py)."""
    from bayesian_yolov3_torch.models import darknet as tdark

    images = [tp.image_u8(seed=30 + i)[0] for i in range(3)]
    pattern = _write_records(str(tmp_path / "data"), images, ["a.png", "b.png", "c.png"])
    kw = dict(KW, model="aleatoric", compute_dtype="bfloat16", cpu_thread_cnt=1,
              data=DataConfig(file_pattern=pattern))
    packed = InferenceRunner(Config(**kw, packed_host_input=True,
                                    out_path=str(tmp_path / "packed")), device="cpu")
    got = _read_dets(packed.run())
    monkeypatch.setattr(tdark, "_fused_early_auto", lambda x, compute_dtype: True)
    want = _read_dets(InferenceRunner(Config(**kw, out_path=str(tmp_path / "fed")),
                                      device="cpu").run())
    assert set(got) == set(want) == {"a.json", "b.json", "c.json"}
    for name in got:
        assert len(got[name]) > 10 and abs(len(got[name]) - len(want[name])) <= 2
        matched = 0
        for d in got[name]:
            near = [w for w in want[name]
                    if max(abs(d[k] - w[k]) for k in ("x0", "y0", "x1", "y1")) <= 2.0]
            if near:
                matched += 1
                assert min(abs(d["score"] - w["score"]) for w in near) <= 0.02
        assert matched >= 0.8 * len(got[name]), (name, matched, len(got[name]))


@pytest.mark.parametrize("model,std_dropout,keys_shape", [
    ("standard", False, None), ("aleatoric", False, None), ("bayesian", True, None),
    ("bayesian", False, (1, 15))])
def test_batched_configurations_construct(model, std_dropout, keys_shape):
    """Every configuration but bayesian + inference_mode takes the batched
    branch; the bayesian variant draws a (1, 15) key table where its dropout
    is active, from the runner's generator or the one passed in."""
    r = InferenceRunner(Config(**dict(KW, model=model, standard_test_dropout=std_dropout,
                                      fixed_mc_masks=7)), device="cpu")
    assert not r.epistemic and r.device_batch_size() == 2
    keys = r.draw_keys()
    assert (None if keys is None else keys.shape) == keys_shape
    if keys is not None:
        again = r.draw_keys(torch.Generator().manual_seed(1))
        assert np.array_equal(again, r.draw_keys(torch.Generator().manual_seed(1)))
        assert not np.array_equal(again, keys)


def _cli_argv(tmp_path, model):
    return ["--device", "cpu", "--set", "compute_dtype=float32", "--set", f"run_id={model}",
            "--set", "full_img_size=[64,96,3]", "--set", "cpu_thread_cnt=1",
            "--set", "nms_max_boxes=20", "--set", f"out_path={tmp_path / 'out'}"]


@pytest.mark.parametrize("name", ["inference_standard_yolov3", "inference_aleatoric"])
def test_batched_cli_runs_the_port(use_weights, tmp_path, name):
    import importlib

    cli = importlib.import_module(f"bayesian_yolov3_torch.cli.{name}")
    images = [tp.image_u8(seed=20 + i)[0] for i in range(3)]
    pattern = _write_records(str(tmp_path / "data"), images, ["a.png", "b.png", "c.png"])
    model = cli.DEFAULTS["model"]
    out_dir = cli.main(_cli_argv(tmp_path, model) + ["--set", "batch_size=2", "--set",
                                                     f"data.file_pattern={pattern}"])
    assert out_dir.endswith(f"out_{STEP}")
    assert set(_read_dets(out_dir)) == {"a.json", "b.json", "c.json"}
    assert cli.DEFAULTS["batch_size"] == 11 and cli.DEFAULTS["inference_mode"] is False
    assert model == {"inference_standard_yolov3": "standard",
                     "inference_aleatoric": "aleatoric"}[name]


@pytest.mark.parametrize("name", ["inference_standard_yolov3", "inference_aleatoric", "detect"])
def test_cli_needs_the_card_unless_told_otherwise(name, monkeypatch, tmp_path):
    """No CUDA device and no --device cpu: raise, never carry on on the CPU."""
    import importlib

    cli = importlib.import_module(f"bayesian_yolov3_torch.cli.{name}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--set", f"checkpoint_path={tmp_path}"]
    with pytest.raises(RuntimeError, match="CUDA device"):
        cli.main(argv + (["frame.png"] if name == "detect" else []))


@pytest.mark.parametrize("model", ["bayesian", "aleatoric"])
def test_detector_matches_jax_filter(use_weights, tmp_path, model):
    """Detector on a PNG written by encode_png: bayesian runs epistemic
    inference (T=4), aleatoric the batched branch.  Its boxes equal the JAX
    package's filter_and_score on the same rows (the file's dropout keys come
    from a generator seeded by the CRC-32 of its path, so predict() gives the
    same rows again); ``run`` writes the drawn frame as a PNG, and the CLI
    runs on the CPU."""
    import zlib

    from bayesian_yolov3_torch.cli import detect as cli

    img = tp.image_u8(seed=50)[0]
    path = str(tmp_path / "frame.png")
    with open(path, "wb") as f:
        f.write(pipeline.encode_png(img))
    cfg = Config(model=model, inference_mode=model == "bayesian", T=4,
                 compute_dtype="float32", full_img_size=tp.IMG, nms_max_boxes=300,
                 thresh=0.5)
    det = tdetect.Detector(cfg, device="cpu")
    res = det.run([path], out_dir=str(tmp_path / "drawn"))[0]
    np.testing.assert_array_equal((res["image"] * 255).round().astype(np.uint8), img)
    keys = det.runner.draw_keys(torch.Generator().manual_seed(zlib.crc32(os.fsencode(path))))
    rows, valid = det.runner.predict(det.params, det.stats, img[None], keys)
    jspec = JSpec(JVariant(model), 2)
    want = jdetect.filter_and_score(rows[0], valid[0], jspec, det.runner.epistemic,
                                    cfg.thresh, img.shape[:2])
    assert 0 < len(res["boxes"]) == len(want) < valid[0].sum()
    assert res["boxes"] == want
    drawn = pipeline.decode_png(open(tmp_path / "drawn" / "frame_det.png", "rb").read())
    assert drawn.shape == img.shape and (drawn == (0, 255, 0)).all(axis=2).any()

    results = cli.main([path, "--out-dir", str(tmp_path / "cli"), "--device", "cpu",
                        "--set", f"model={model}", "--set", "T=4",
                        "--set", "compute_dtype=float32", "--set", "full_img_size=[64,96,3]",
                        "--set", f"inference_mode={str(model == 'bayesian').lower()}",
                        "--set", "nms_max_boxes=300", "--set", "thresh=0.5"])
    assert results[0]["boxes"] == res["boxes"]
    assert os.path.exists(tmp_path / "cli" / "frame_det.png")


def test_load_img_names_the_format_without_pil(tmp_path, monkeypatch):
    import sys

    path = tmp_path / "frame.jpg"
    path.write_bytes(b"\xff\xd8\xff\xe0" + b"\0" * 64)
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(RuntimeError, match="frame.jpg: reading JPG files needs PIL"):
        tdetect.load_img(str(path))
