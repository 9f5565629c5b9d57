"""The port's int8 inference runner (``quantize="int8"``) on the CPU: predict
against the JAX runner's, ``run()`` with its automatic calibration to ECP
JSON (the runner and the CLI), the refusal rules, and the fused mc pipeline
in int8 on two spawned ``gloo`` ranks against the single-device int8 rows.

Tolerance against the JAX runner.  The two float32 backbones and the jitted
JAX program round in other places, so an activation on an int8 rounding
boundary can land one step apart in the two packages, and on random
weights one step moves the rows of its image by a few tenths of a percent
(tests/test_torch_quant.py holds the section itself bit for bit from equal
int8 entries).  So detections are paired by anchor (layer id, prior id,
nearest box) and held to the bounds of the bf16 runner comparison of
tests/test_torch_runner.py: corners within 0.01 of the unit image, scores
within 0.05, variance columns within rtol 0.35; at least 60 % of either
side's detections pair up.  The mc pipeline against the single-device
rows: the split tolerances of tests/test_torch_mc_sharded.py (the sums
reordered).

Weights are handed to ``run()`` by a patched ``load_state`` (checkpoint
loading is held by tests/test_torch_runner.py and
tests/test_torch_checkpoint_import.py)."""

import glob
import json
import os
import time
import traceback

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import jax

from bayesian_yolov3_tpu.config import Config as JConfig
from bayesian_yolov3_tpu.core.blueprint import Variant as JVariant, VariantSpec as JSpec
from bayesian_yolov3_tpu.infer.runner import InferenceRunner as JRunner

from bayesian_yolov3_torch import convert
from bayesian_yolov3_torch.config import Config, DataConfig
from bayesian_yolov3_torch.data import pipeline, proto, tfrecord
from bayesian_yolov3_torch.infer import InferenceRunner, bbox_to_ecp_format
from bayesian_yolov3_torch.models.yolov3 import YoloV3
from bayesian_yolov3_torch.ops import cuda_quant
from bayesian_yolov3_torch.parallel import (
    initialize_distributed,
    make_groups,
    make_mc_sharded_fused_pipeline,
)

import torch_parity as tp

T = 4
SEED = 7  # fixed_mc_masks
STEP = 3
EPI = dict(model="bayesian", inference_mode=True, T=T, batch_size=1, compute_dtype="float32",
           full_img_size=tp.IMG, fixed_mc_masks=SEED, nms_max_boxes=50, nms_pre_top_k=0,
           quantize="int8")
BATCHED = dict(inference_mode=False, batch_size=2, compute_dtype="float32",
               full_img_size=tp.IMG, nms_max_boxes=50, nms_pre_top_k=0, quantize="int8")
WORLD = 2
JOIN_TIMEOUT_S = 120
# the mc phase's T: 8 samples give a full-rank 4x4 covariance, whose
# determinant (column 12) is then no rounding noise around 0
MC = dict(EPI, T=8)


def _weights(model):
    params_np, stats_np = tp.numpy_weights(seed=3, spec=JSpec(JVariant(model), 2))
    for i in (1, 2, 3):  # raw logits of a few units, not tens
        params_np[f"det{i}"]["w"] *= np.float32(0.2)
    return params_np, stats_np


@pytest.fixture(scope="module")
def weights():
    return {m: _weights(m) for m in ("bayesian", "aleatoric", "standard")}


@pytest.fixture
def use_weights(weights, monkeypatch):
    """``InferenceRunner.load_state`` hands out the module's weights of the
    runner's variant, as step ``STEP``."""
    monkeypatch.setattr(InferenceRunner, "load_state",
                        lambda self: (*tp.to_torch(*weights[self.config.model]), STEP))
    return weights


# layout of a row: (corner columns, variance columns, score columns); the
# layer and prior ids are the last two columns
LAYOUT = {"bayesian": (slice(0, 4), slice(4, 12), slice(14, 21)),
          "aleatoric": (slice(0, 4), slice(4, 9), slice(9, 14)),
          "standard": (slice(0, 4), slice(0, 0), slice(4, 7))}


def _assert_detections_near(model, got_rows, got_valid, want_rows, want_valid):
    corners, var, scores = LAYOUT[model]
    for g_rows, g_valid, w_rows, w_valid in zip(got_rows, got_valid, want_rows, want_valid):
        n_got, n_want = int(g_valid.sum()), int(w_valid.sum())
        assert n_got > 10 and abs(n_got - n_want) <= 0.2 * n_want
        wrows = w_rows[w_valid]
        pairs = []
        for r in g_rows[g_valid]:
            same = wrows[(wrows[:, -2] == r[-2]) & (wrows[:, -1] == r[-1])]
            if len(same):
                d = np.abs(same[:, :4] - r[:4]).max(axis=1)
                if d.min() <= 0.01:
                    pairs.append((r, same[int(d.argmin())]))
        assert len(pairs) >= 0.6 * max(n_got, n_want), (len(pairs), n_got, n_want)
        g, w = (np.stack(x) for x in zip(*pairs))
        np.testing.assert_allclose(g[:, corners], w[:, corners], atol=0.01, rtol=0)
        np.testing.assert_allclose(g[:, scores], w[:, scores], atol=0.05, rtol=0)
        np.testing.assert_allclose(g[:, var], w[:, var], rtol=0.35, atol=1e-6)


def test_predict_epistemic_int8_matches_jax_runner(weights):
    """Epistemic int8, fixed masks: the JAX runner calibrates (its own keys)
    and both runners run ITS quantized heads (``qheads_from_jax``)."""
    params_np, stats_np = weights["bayesian"]
    img = tp.image_u8(seed=4)
    jr = JRunner(JConfig(**EPI))
    jp, js = tp.to_jax(params_np), tp.to_jax(stats_np)
    jr.calibrate_int8(jp, js, img)
    want_rows, want_valid = (np.asarray(a) for a in jr.predict(jp, js, img, jr.rng))
    tr = InferenceRunner(Config(**EPI), device="cpu")
    tr._qheads = convert.qheads_from_jax(jax.tree.map(np.asarray, jr._qheads))
    got_rows, got_valid = tr.predict(*tp.to_torch(params_np, stats_np), img)
    assert got_rows.shape == want_rows.shape == (1, 50, 23) and np.isfinite(got_rows).all()
    _assert_detections_near("bayesian", got_rows, got_valid, want_rows, want_valid)


@pytest.mark.parametrize("model", ["aleatoric", "standard"])
def test_predict_batched_int8_matches_jax_runner(weights, model):
    """Batched int8 over two images, each runner calibrated by itself on
    them: quantized heads alike (int8 kernels one step apart in at most
    1e-5 of their elements: the calibration maxima of the two float32
    backbones differ by ~1e-7) and the detections near."""
    params_np, stats_np = weights[model]
    imgs = np.concatenate([tp.image_u8(seed=s) for s in (11, 12)])
    cfg = dict(BATCHED, model=model)
    jr = JRunner(JConfig(**cfg))
    jp, js = tp.to_jax(params_np), tp.to_jax(stats_np)
    jr.calibrate_int8(jp, js, imgs)
    want_rows, want_valid = (np.asarray(a) for a in jr.predict(jp, js, imgs, jr.rng))
    tr = InferenceRunner(Config(**cfg), device="cpu")
    tparams, tstats = tp.to_torch(params_np, stats_np)
    qh = tr.calibrate_int8(tparams, tstats, imgs)
    jqh = convert.qheads_from_jax(jax.tree.map(np.asarray, jr._qheads))
    for k, v in jqh.items():
        if k == "entry":
            for e in v:
                np.testing.assert_allclose(qh[k][e], v[e], rtol=1e-5)
            continue
        d = (qh[k]["wq"].int() - v["wq"].int()).abs()
        assert int(d.max()) <= 1 and float(d.float().mean()) <= 1e-5, k
    got_rows, got_valid = tr.predict(tparams, tstats, imgs)
    assert got_rows.shape == want_rows.shape and np.isfinite(got_rows).all()
    _assert_detections_near(model, got_rows, got_valid, want_rows, want_valid)


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


@pytest.mark.parametrize("model,batch", [("bayesian", 1), ("aleatoric", 2)])
def test_run_calibrates_and_writes_ecp_json(use_weights, tmp_path, model, batch):
    """run() calibrates on the dataset's first ``quant_calib_images`` frames
    by itself (the same heads as calibrate_int8 on those frames), then writes
    one JSON per frame, equal to bbox_to_ecp_format of predict()'s rows."""
    images = [tp.image_u8(seed=20 + i)[0] for i in range(3)]
    names = [f"frame_{i}.png" for i in range(3)]
    base = EPI if model == "bayesian" else dict(BATCHED, model=model)
    cfg = Config(**dict(base, batch_size=batch), cpu_thread_cnt=1, quant_calib_images=2,
                 out_path=str(tmp_path / "out" / model),
                 data=DataConfig(file_pattern=_write_records(str(tmp_path / "data"), images,
                                                             names)))
    runner = InferenceRunner(cfg, device="cpu")
    out_dir = runner.run()
    assert out_dir.endswith(f"{model}_{STEP}") and runner._qheads is not None
    params, stats, _ = runner.load_state()
    fresh = InferenceRunner(cfg, device="cpu")
    want_qh = fresh.calibrate_int8(params, stats, np.stack(images[:2]))
    for k in ("head3_conv1", "det2", "trans1"):
        assert torch.equal(runner._qheads[k]["wq"], want_qh[k]["wq"])
    assert runner._qheads["entry"] == want_qh["entry"]
    got = _read_dets(out_dir)
    assert list(got) == [f"frame_{i}.json" for i in range(3)]
    batches = ([np.stack([im]) for im in images] if batch == 1 else
               [np.stack(images[:2]), np.stack([images[2], images[2]])])
    preds = [runner.predict(params, stats, b) for b in batches]
    epistemic = model == "bayesian"
    for k, name in enumerate(got):
        rows, valid = (p[k % batch] for p in preds[k // batch])
        want = [bbox_to_ecp_format(rows[i], cfg.full_img_size, runner.spec, epistemic=epistemic)
                for i in np.flatnonzero(valid)]
        assert len(got[name]) == len(want) > 10
        assert got[name] == json.loads(json.dumps(want))
        assert ("x_var_epi" in got[name][0]) == epistemic


def test_cli_takes_quantize_int8(use_weights, tmp_path, monkeypatch):
    """``--set quantize=int8`` reaches the runner through the batched CLI and
    writes ECP JSON (the weights through the patched load_state)."""
    from bayesian_yolov3_torch.cli import inference_standard_yolov3 as cli

    pattern = _write_records(str(tmp_path / "data"), [tp.image_u8(seed=30)[0]], ["a.png"])
    seen = []
    init = InferenceRunner.__init__

    def record(self, config, *a, **kw):
        seen.append(config.quantize)
        init(self, config, *a, **kw)

    argv = ["--device", "cpu", "--set", "quantize=int8", "--set", "compute_dtype=float32",
            "--set", "full_img_size=[64,96,3]", "--set", "cpu_thread_cnt=1",
            "--set", "batch_size=1", "--set", f"data.file_pattern={pattern}",
            "--set", "data.num_shards=1", "--set", "nms_max_boxes=20",
            "--set", "quant_calib_images=1", "--set", f"out_path={tmp_path / 'out'}"]
    monkeypatch.setattr(InferenceRunner, "__init__", record)
    out_dir = cli.main(argv)
    assert seen == ["int8"]
    dets = _read_dets(out_dir)["a.json"]
    assert dets and all(np.isfinite(d["score"]) for d in dets)


@pytest.mark.parametrize("kw,exc,match", [
    (dict(quantize="int4"), ValueError, "unknown quantize mode"),
    (dict(mesh_shape={"mc": 2}, use_pallas=False), ValueError, "fused pipeline"),
    (dict(mesh_shape={"sp": 2}, fixed_mc_masks=None), ValueError,
     "does not compose with the sp"),
])
def test_runner_int8_rules(kw, exc, match):
    """The JAX runner's int8 rules: an unknown mode, int8 over the mc
    all-gather fallback, and int8 over the sp axis are refused."""
    with pytest.raises(exc, match=match):
        InferenceRunner(Config(**{**EPI, **kw}), device="cpu")


def test_predict_before_calibration_and_the_key_stream(weights):
    """predict() refuses to run before the heads are calibrated, as the JAX
    runner does; calibrate_int8 draws its keys from a generator of its own,
    so the runner's key stream is where a runner without int8 has it."""
    cfg = dict(EPI, fixed_mc_masks=None)
    runner = InferenceRunner(Config(**cfg), device="cpu")
    tparams, tstats = tp.to_torch(*weights["bayesian"])
    img = tp.image_u8(seed=4)
    with pytest.raises(RuntimeError, match="calibrat"):
        runner.predict(tparams, tstats, img)
    runner.calibrate_int8(tparams, tstats, img)
    plain = InferenceRunner(Config(**dict(cfg, quantize=None)), device="cpu")
    np.testing.assert_array_equal(runner.draw_keys(), plain.draw_keys())
    rows, valid = runner.predict(tparams, tstats, img)
    assert rows.shape == (1, 50, 23) and valid.sum() > 10 and np.isfinite(rows).all()


# --------------------------------------------------------------------------
# the fused mc pipeline in int8 on two gloo ranks
# --------------------------------------------------------------------------


def _rank_work(rank, out, qh_path, pattern):
    """A rank's int8 runner over the mc group: predict with the given heads,
    the pipeline itself, and run() with its own calibration."""
    params, stats = tp.to_torch(*_weights("bayesian"))
    qh = torch.load(qh_path)
    img = tp.image_u8(seed=4)
    cfg = Config(**MC, mesh_shape={"mc": WORLD}, cpu_thread_cnt=1, quant_calib_images=1,
                 out_path=os.path.join(out, "run"), data=DataConfig(file_pattern=pattern))
    runner = InferenceRunner(cfg, device="cpu")
    runner._qheads = qh
    res = {}
    res["rows"], res["valid"] = runner.predict(params, stats, img)
    model = YoloV3.from_config(cfg)
    pipe = make_mc_sharded_fused_pipeline(
        model, make_groups({"mc": WORLD})["mc"], MC["T"], priors_by_stride=runner._priors,
        obj_idx=model.spec.obj_idx(epistemic=True), nms_max_boxes=50, fixed_masks=SEED)
    res["pipe_rows"], res["pipe_valid"] = (
        a.numpy() for a in pipe(params, stats, torch.from_numpy(img).float() / 255.0,
                                qheads=qh))
    calibrating = InferenceRunner(cfg, device="cpu")
    calibrating.load_state = lambda: (params, stats, STEP)
    res["run_dir"] = np.array(calibrating.run())
    res["entry"] = np.array([calibrating._qheads["entry"][k]
                             for k in ("out32", "skip16", "skip8")])
    return res


def _rank_main(rank, store, out, qh_path, pattern):
    torch.set_num_threads(2)
    try:
        initialize_distributed("gloo", f"file://{store}", world_size=WORLD, rank=rank,
                               device="cpu")
        np.savez(os.path.join(out, f"rank{rank}.npz"), **_rank_work(rank, out, qh_path, pattern))
    except BaseException:
        with open(os.path.join(out, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


@pytest.fixture(scope="module")
def mc_ranks(weights, tmp_path_factory):
    """Two spawned gloo ranks (file store under the temp dir, joined under a
    timeout); the heads they are given; per rank, its results."""
    root = str(tmp_path_factory.mktemp("mc_int8"))
    single = InferenceRunner(Config(**MC), device="cpu")
    params, stats = tp.to_torch(*weights["bayesian"])
    qh = single.calibrate_int8(params, stats, tp.image_u8(seed=5))
    qh_path = os.path.join(root, "qheads.pt")
    torch.save(qh, qh_path)
    pattern = _write_records(os.path.join(root, "data"),
                             [tp.image_u8(seed=40 + i)[0] for i in range(2)],
                             ["frame_0.png", "frame_1.png"])
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, os.path.join(root, "store"), root, qh_path, pattern))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    deadline = time.time() + JOIN_TIMEOUT_S
    for p in procs:
        p.join(max(0.0, deadline - time.time()))
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join()
    errs = "\n".join(open(f).read() for f in sorted(glob.glob(os.path.join(root, "*.err"))))
    assert not hung, f"{len(hung)} rank(s) still running after {JOIN_TIMEOUT_S} s\n{errs}"
    assert [p.exitcode for p in procs] == [0] * WORLD, errs
    return {"single": single, "params": params, "stats": stats,
            "ranks": [dict(np.load(os.path.join(root, f"rank{r}.npz"))) for r in range(WORLD)]}


def _assert_split_close(got, want):
    """tests/test_pallas.py:151-153: the split composition against the
    one-shot decode."""
    np.testing.assert_allclose(got[..., :12], want[..., :12], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got[..., 12], want[..., 12], rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(got[..., 13:], want[..., 13:], rtol=1e-4, atol=2e-4)


def test_mc_fused_int8_matches_single_device(mc_ranks):
    """Each rank runs the int8 heads on its T/2 samples; after the one
    all-reduce every rank holds the single-device int8 runner's rows (the
    same heads and fixed masks), through predict() and the pipeline."""
    want_rows, want_valid = mc_ranks["single"].predict(mc_ranks["params"], mc_ranks["stats"],
                                                       tp.image_u8(seed=4))
    assert want_valid.sum() > 10
    for r in mc_ranks["ranks"]:
        for rows, valid in ((r["rows"], r["valid"]), (r["pipe_rows"], r["pipe_valid"])):
            np.testing.assert_array_equal(valid, want_valid)
            _assert_split_close(rows, want_rows)


def test_mc_run_calibrates_alike_on_every_rank(mc_ranks):
    """run() over the mc group: every rank calibrates on the same frame with
    the same keys (the same heads), and rank 0 writes the JSON."""
    r0, r1 = mc_ranks["ranks"]
    np.testing.assert_array_equal(r0["entry"], r1["entry"])
    out_dir = str(r0["run_dir"])
    assert out_dir == str(r1["run_dir"]) and out_dir.endswith(f"run_{STEP}")
    dets = _read_dets(out_dir)
    assert list(dets) == ["frame_0.json", "frame_1.json"] and all(dets.values())


def test_epilogue_wrapper_counts_only_card_launches(weights):
    """The epilogue wrapper takes its plain version on the CPU and counts no
    launch there (``launch_count`` counts kernel launches on the card)."""
    runner = InferenceRunner(Config(**EPI), device="cpu")
    params, stats = tp.to_torch(*weights["bayesian"])
    before = cuda_quant.launch_count
    runner.calibrate_int8(params, stats, tp.image_u8(seed=4))
    runner.predict(params, stats, tp.image_u8(seed=4))
    assert cuda_quant.launch_count == before
