"""The PyTorch port's epistemic inference as a whole, on the CPU (bayesian,
fixed MC masks) against the JAX package's ``InferenceRunner`` on the same
numpy weights and image, and the port's ``run()`` from a tfrecord and a
checkpoint to ECP JSON.

Tolerance of the float32 row comparison: 75 float32 convolutions, then sums
over T, in another order in the two frameworks — ten times the kernel-level
tolerances of test_torch_epistemic.py; ``valid`` and the picks themselves
(layer / prior id columns) are exact.  The bf16 comparison states its own.

The full-width checkpoint (241 MB) is written once for the module and
removed at teardown: a run leaves a few MB behind."""

import glob
import io
import json
import os
import shutil
import struct
import zlib

import numpy as np
import pytest
import torch

from bayesian_yolov3_tpu.config import Config as JConfig
from bayesian_yolov3_tpu.infer.runner import InferenceRunner as JRunner

from bayesian_yolov3_torch.config import Config, DataConfig
from bayesian_yolov3_torch.data import pipeline, proto, tfrecord
from bayesian_yolov3_torch.infer import InferenceRunner, bbox_to_ecp_format
from bayesian_yolov3_torch.train import CheckpointStore, partition_params

import torch_parity as tp

KW = dict(model="bayesian", inference_mode=True, T=4, batch_size=1,
          compute_dtype="float32", full_img_size=tp.IMG, fixed_mc_masks=7,
          nms_max_boxes=50, nms_pre_top_k=40)


@pytest.fixture(scope="module")
def weights():
    params_np, stats_np = tp.numpy_weights(seed=3)
    for i in (1, 2, 3):  # raw logits of a few units, not tens
        params_np[f"det{i}"]["w"] *= np.float32(0.2)
    return params_np, stats_np


def _assert_rows_close(got, want):
    np.testing.assert_array_equal(got[..., 21:], want[..., 21:])  # layer, prior ids
    np.testing.assert_allclose(got[..., :12], want[..., :12], rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(got[..., 12], want[..., 12], rtol=1e-2, atol=1e-5)
    np.testing.assert_allclose(got[..., 13:21], want[..., 13:21], rtol=1e-3, atol=2e-3)


@pytest.mark.parametrize("pre_top_k", [40, 0])
def test_predict_matches_jax_runner(weights, pre_top_k):
    """pre_top_k=40 of 378 anchors cannot fill 50 selections, so the
    certificate fails and both runners take their exact retry."""
    params_np, stats_np = weights
    img = tp.image_u8(seed=4)
    kw = dict(KW, nms_pre_top_k=pre_top_k)
    jr = JRunner(JConfig(**kw))
    want_rows, want_valid = jr.predict(tp.to_jax(params_np), tp.to_jax(stats_np), img, jr.rng)
    tr = InferenceRunner(Config(**kw), device="cpu")
    tparams, tstats = tp.to_torch(params_np, stats_np)
    got_rows, got_valid = tr.predict(tparams, tstats, img)
    assert got_rows.shape == want_rows.shape == (1, 50, 23)
    np.testing.assert_array_equal(got_valid, want_valid)
    assert got_valid.sum() > 10
    _assert_rows_close(got_rows, np.asarray(want_rows))
    if pre_top_k:
        _, _, cert = tr._device_pipeline(tparams, tstats, torch.from_numpy(img),
                                         tr.draw_keys(), pre_top_k=pre_top_k)
        assert not bool(cert.all())  # the retry really ran


def _write_records(path, images, names):
    os.makedirs(path, exist_ok=True)
    with tfrecord.TFRecordWriter(os.path.join(path, "d-00000-of-00001.tfrecord")) as wr:
        for img, name in zip(images, names):
            wr.write(proto.encode_example({
                "image/encoded": [pipeline.encode_png(img)],
                "image/filename": [name.encode()],
                "image/object/class/label": np.asarray([1], np.int64),
            }))
    return os.path.join(path, "d-*-of-*.tfrecord")


CKPT_RUN, CKPT_STEP = "shared", 12


@pytest.fixture(scope="module")
def checkpoint(weights, tmp_path_factory):
    """The module's one saved checkpoint (run ``CKPT_RUN``, step ``CKPT_STEP``)
    of ``weights``; tests read it and never write beside it.  Yields its
    ``checkpoint_path``."""
    root = tmp_path_factory.mktemp("ckpt")
    cfg = Config(**KW, run_id=CKPT_RUN, checkpoint_path=str(root))
    tparams, tstats = tp.to_torch(*weights)
    trainable, frozen = partition_params(tparams, cfg.freeze_darknet53)
    CheckpointStore(cfg.checkpoint_path, cfg.run_id).save(
        CKPT_STEP, {"params": trainable, "frozen": frozen, "stats": tstats})
    yield str(root)
    shutil.rmtree(root, ignore_errors=True)


def test_run_writes_ecp_json_of_its_rows(weights, checkpoint, tmp_path):
    """tfrecord + checkpoint -> one JSON per frame, equal to
    bbox_to_ecp_format of predict()'s rows; batch 2 over 3 frames pads the
    last batch; a second run refuses to overwrite."""
    images = [tp.image_u8(seed=10 + i)[0] for i in range(3)]
    names = [f"frame_{i}.png" for i in range(3)]
    cfg = Config(**dict(KW, batch_size=2), run_id=CKPT_RUN, cpu_thread_cnt=2,
                 checkpoint_path=checkpoint, out_path=str(tmp_path / "out" / "epi"),
                 data=DataConfig(file_pattern=_write_records(str(tmp_path / "data"), images, names)))
    tparams, tstats = tp.to_torch(*weights)

    runner = InferenceRunner(cfg, device="cpu")
    out_dir = runner.run()
    assert out_dir.endswith("epi_12")  # step suffix
    assert runner.retried == 2  # both batches failed the certificate
    files = sorted(glob.glob(os.path.join(out_dir, "*.json")))
    assert [os.path.basename(f) for f in files] == [f"frame_{i}.json" for i in range(3)]
    # dropout masks index the (NB, h, w, c) batch tensor, so a frame is
    # predicted in the batch it had in run(): [0, 1], then [2, 2] (padding)
    batches = [np.stack(images[:2]), np.stack([images[2], images[2]])]
    preds = [runner.predict(tparams, tstats, b) for b in batches]
    for k, f in enumerate(files):
        rows, valid = (p[k % 2] for p in preds[k // 2])
        want = [bbox_to_ecp_format(rows[i], cfg.full_img_size, runner.spec, epistemic=True)
                for i in np.flatnonzero(valid)]
        with open(f) as fh:
            got = json.load(fh)["children"]
        assert len(got) == len(want) > 10
        assert got == json.loads(json.dumps(want))
        assert {"x_var_epi", "x_var_ale", "obj_mutual_info", "cls_mutual_info",
                "ped_score", "rider_score", "total_var_epi"} <= set(got[0])
    with pytest.raises(FileExistsError):
        runner.run()


def test_checkpoint_store_steps_and_wrong_variant(weights, tmp_path):
    tparams, tstats = tp.to_torch(*weights)
    heads = {k: v for k, v in tparams.items() if k.startswith("det")}
    hstats = {"head1_conv0": tstats["head1_conv0"]}
    store = CheckpointStore(str(tmp_path), "run", max_to_keep=2)
    assert store.latest_step() is None
    for step in (5, 10, 15):
        store.save(step, {"params": heads, "stats": hstats, "opt": {"count": torch.tensor(step)}})
    store.save(15, {"params": {}})  # an existing step is left alone
    assert store.all_steps() == [10, 15] and store.latest_step() == 15
    like = {"params": heads, "stats": hstats}  # partial: no optimizer state
    restored, step = store.restore_partial(like, step="last")
    assert step == 15 and set(restored) == {"params", "stats"}
    assert torch.equal(restored["params"]["det2"]["w"], heads["det2"]["w"])
    _, step = store.restore_partial(like, step=10)
    assert step == 10
    # a 3-class model's det convs are 48 wide, the checkpoint's 42
    wrong = {"params": {k: {"w": torch.empty(48, v["w"].shape[1], 1, 1, device="meta"),
                            "b": torch.empty(48, device="meta")} for k, v in heads.items()}}
    with pytest.raises(ValueError, match=r"does not match.*det1/w.*\(42, 1024, 1, 1\).*\(48, 1024"):
        store.restore_partial(wrong)
    with pytest.raises(KeyError, match="frozen"):
        store.restore_partial({"frozen": {}})
    with pytest.raises(FileNotFoundError):
        CheckpointStore(str(tmp_path), "empty").restore_partial(like)


def test_runner_loads_wrong_variant_loudly(weights, checkpoint):
    tparams, tstats = tp.to_torch(*weights)
    cfg = Config(**KW, run_id=CKPT_RUN, checkpoint_path=checkpoint)
    cfg3 = Config(**KW, run_id=CKPT_RUN, checkpoint_path=checkpoint, cls_cnt=3)
    with pytest.raises(ValueError, match="wrong variant or config"):
        InferenceRunner(cfg3, device="cpu").load_state()
    params, stats, step = InferenceRunner(cfg, device="cpu").load_state()
    assert step == CKPT_STEP and torch.equal(params["backbone"]["conv_07"]["w"],
                                     tparams["backbone"]["conv_07"]["w"])
    assert torch.equal(stats["trans2"]["var"], tstats["trans2"]["var"])


@pytest.mark.parametrize("kw,exc,match", [
    (dict(mesh_shape={"mc": 2}), RuntimeError, "initialised process group"),
    (dict(mesh_shape={"dp": 2}), ValueError, "epistemic inference is batch-1"),
    (dict(quantize="int4"), ValueError, "unknown quantize mode"),
    (dict(packed_host_input=True, full_img_size=(48, 96, 3)), AssertionError, "divisible by 32"),
    (dict(crop=True), ValueError, "full images"),
])
def test_runner_refuses_what_this_slice_lacks(kw, exc, match):
    with pytest.raises(exc, match=match):
        InferenceRunner(Config(**dict(KW, **kw)), device="cpu")


def test_runner_needs_the_card_unless_told_otherwise():
    """No CUDA device and no device='cpu': raise, never carry on on the CPU."""
    if torch.cuda.is_available():
        assert InferenceRunner(Config(**KW)).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA device"):
            InferenceRunner(Config(**KW))


def test_cli_runs_the_port(checkpoint, tmp_path):
    from bayesian_yolov3_torch.cli import inference_epistemic as cli

    images = [tp.image_u8(seed=20)[0]]
    pattern = _write_records(str(tmp_path / "data"), images, ["a.png"])
    argv = ["--device", "cpu", "--set", "compute_dtype=float32", "--set", "T=2",
            "--set", f"run_id={CKPT_RUN}", "--set", f"checkpoint_path={checkpoint}",
            "--set", "full_img_size=[64,96,3]", "--set", "cpu_thread_cnt=1",
            "--set", f"data.file_pattern={pattern}", "--set", "nms_max_boxes=20",
            "--set", f"out_path={tmp_path / 'out'}"]
    out_dir = cli.main(argv)
    assert out_dir.endswith(f"out_{CKPT_STEP}") and os.path.exists(os.path.join(out_dir, "a.json"))
    assert cli.DEFAULTS["T"] == 50 and cli.DEFAULTS["batch_size"] == 1


def _read_dets(out_dir):
    out = {}
    for f in sorted(glob.glob(os.path.join(out_dir, "*.json"))):
        with open(f) as fh:
            out[os.path.basename(f)] = json.load(fh)["children"]
    return out


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_run_with_packed_host_input(checkpoint, tmp_path, monkeypatch, dtype):
    """``packed_host_input``: run() feeds the loader's uint8 planes through
    the fused early backbone (on the CPU: the kernels' plain versions).
    Against the image-fed run of the same configuration with the fused
    branch forced, under fixed masks: the two feeds differ only in how the
    input pixel is rounded (u8 -> bf16, times bf16(1/255), against float/255
    -> bf16), one bf16 step on some pixels, so the same boxes come out; box
    coordinates within 2 px, scores within 0.02.  predict() keeps taking NHWC
    images and refuses the packed configuration."""
    from bayesian_yolov3_torch.models import darknet as tdark

    images = [tp.image_u8(seed=30 + i)[0] for i in range(2)]
    pattern = _write_records(str(tmp_path / "data"), images, ["a.png", "b.png"])
    kw = dict(KW, compute_dtype=dtype, run_id=CKPT_RUN, checkpoint_path=checkpoint,
              cpu_thread_cnt=1, data=DataConfig(file_pattern=pattern), nms_pre_top_k=0)
    packed = InferenceRunner(Config(**kw, packed_host_input=True,
                                    out_path=str(tmp_path / "packed")), device="cpu")
    got = _read_dets(packed.run())
    with pytest.raises(ValueError, match="NHWC uint8 images"):
        packed.predict(None, None, images[0][None])

    # image-fed, with the fused branch that a CUDA tensor would take by itself
    monkeypatch.setattr(tdark, "_fused_early_auto", lambda x, compute_dtype: True)
    want = _read_dets(InferenceRunner(
        Config(**kw, out_path=str(tmp_path / "fed")), device="cpu").run())
    assert set(got) == set(want) == {"a.json", "b.json"}
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


def _match_rows(got, valid_g, want, valid_w):
    """Pairs (row of got, row of want) of the same anchor's detection: same
    layer and prior id, box corners within 1 % of the image."""
    pairs = []
    wrows = want[valid_w]
    for r in got[valid_g]:
        same = wrows[(wrows[:, 21] == r[21]) & (wrows[:, 22] == r[22])]
        if len(same):
            d = np.abs(same[:, :4] - r[:4]).max(axis=1)
            if d.min() <= 0.01:
                pairs.append((r, same[int(d.argmin())]))
    return pairs


def test_predict_bf16_matches_jax_runner(weights):
    """The whole pipeline at ``compute_dtype="bfloat16"`` on the CPU, both
    runners, same weights, image and fixed masks.

    bf16 convolutions perturb each sample's logits, in other places in the two
    frameworks, and near-tied scores may swap in NMS: pick ORDER is not
    compared (test_torch_nms.py holds NMS exactly on equal rows).  Detections
    are paired by anchor (layer id, prior id, nearest box) and held to: box
    corners within 0.01 of the unit image; objectness and class scores within
    0.05; epistemic and aleatoric variance columns within rtol 0.35 — the
    jitter bound of tests/test_accuracy_parity.py for bf16 against float32 —
    plus 1e-6 absolute.  At least 60 % of either side's detections pair up."""
    # row layout: 0-3 corners, 4-7 epistemic var, 8-11 aleatoric var, 12 det of
    # the epistemic covariance, 13 total aleatoric var, 14-16 objectness, 17-20
    # classes, 21 layer id, 22 prior id
    params_np, stats_np = weights
    img = tp.image_u8(seed=4)
    kw = dict(KW, compute_dtype="bfloat16", nms_pre_top_k=0)
    jr = JRunner(JConfig(**kw))
    want_rows, want_valid = (np.asarray(a) for a in jr.predict(
        tp.to_jax(params_np), tp.to_jax(stats_np), img, jr.rng))
    tr = InferenceRunner(Config(**kw), device="cpu")
    got_rows, got_valid = tr.predict(*tp.to_torch(params_np, stats_np), img)
    assert got_rows.shape == want_rows.shape == (1, 50, 23)
    assert np.isfinite(got_rows).all()
    n_got, n_want = int(got_valid.sum()), int(want_valid.sum())
    assert n_got > 10 and abs(n_got - n_want) <= 0.2 * n_want
    pairs = _match_rows(got_rows[0], got_valid[0], want_rows[0], want_valid[0])
    assert len(pairs) >= 0.6 * max(n_got, n_want), (len(pairs), n_got, n_want)
    g, w = (np.stack(x) for x in zip(*pairs))
    np.testing.assert_allclose(g[:, :4], w[:, :4], atol=0.01, rtol=0)
    # objectness mean / MI / entropy, class means / MI / entropy
    np.testing.assert_allclose(g[:, 14:21], w[:, 14:21], atol=0.05, rtol=0)
    for cols in (slice(4, 12), slice(13, 14)):  # epistemic, aleatoric, total aleatoric
        np.testing.assert_allclose(g[:, cols], w[:, cols], rtol=0.35, atol=1e-6)
    # column 12, the determinant of a 4x4 covariance estimated from T=4
    # samples, has rank <= 3: it is 0 up to rounding noise on both sides
    np.testing.assert_allclose(g[:, 12], w[:, 12], rtol=0, atol=1e-5)


# ---- PNG codec -------------------------------------------------------------


def _png_with_filters(img, filters):
    """A PNG whose row y is stored with filter type filters[y % len]."""
    h, w, c = img.shape
    rows = img.reshape(h, w * c).astype(np.int32)
    out = bytearray()
    for y in range(h):
        ft = filters[y % len(filters)]
        cur = rows[y]
        up = rows[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(c, np.int32), cur[:-c]])
        upleft = np.concatenate([np.zeros(c, np.int32), up[:-c]])
        if ft == 0:
            pred = 0
        elif ft == 1:
            pred = left
        elif ft == 2:
            pred = up
        elif ft == 3:
            pred = (left + up) // 2
        else:
            p = left + up - upleft
            pa, pb, pc = abs(p - left), abs(p - up), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
        out.append(ft)
        out += ((cur - pred) % 256).astype(np.uint8).tobytes()

    def chunk(tag, body):
        return struct.pack(">I", len(body)) + tag + body + struct.pack(
            ">I", zlib.crc32(tag + body) & 0xFFFFFFFF)

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(bytes(out))) + chunk(b"IEND", b""))


def test_png_round_trip_and_all_row_filters(rng):
    from PIL import Image

    img = rng.integers(0, 256, (13, 17, 3), dtype=np.uint8)
    img[4:9, 3:12] = [200, 30, 90]
    np.testing.assert_array_equal(pipeline.decode_png(pipeline.encode_png(img)), img)
    np.testing.assert_array_equal(pipeline._decode_png_zlib(pipeline.encode_png(img)), img)
    # PIL reads what encode_png writes
    np.testing.assert_array_equal(
        np.asarray(Image.open(io.BytesIO(pipeline.encode_png(img)))), img)
    gray = img[..., 0]
    np.testing.assert_array_equal(pipeline._decode_png_zlib(pipeline.encode_png(gray)),
                                  np.repeat(gray[..., None], 3, axis=2))
    # every one of the five row filters, in every position relative to row 0
    for filters in ([0, 1, 2, 3, 4], [4, 3, 2, 1, 0], [3], [4], [1, 4]):
        data = _png_with_filters(img, filters)
        np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data))), img)
        np.testing.assert_array_equal(pipeline._decode_png_zlib(data), img)


def test_png_written_by_pil_decodes(rng):
    """PIL chooses row filters adaptively on a smooth image."""
    from PIL import Image

    yy, xx = np.mgrid[0:40, 0:56]
    smooth = np.stack([yy * 4 + xx, xx * 3, (yy + xx) * 2], axis=2) % 256
    img = (smooth + rng.integers(0, 3, smooth.shape)).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    data = buf.getvalue()
    raw = zlib.decompress(b"".join(b for t, b in pipeline._png_chunks(data) if t == b"IDAT"))
    used = set(raw[::56 * 3 + 1])
    assert used - {0}, f"PIL used only filter 0 ({used})"
    np.testing.assert_array_equal(pipeline._decode_png_zlib(data), img)
    np.testing.assert_array_equal(pipeline.decode_png(data), img)
    # RGBA decodes too, its alpha dropped as PIL's convert("RGB") drops it
    rgba = io.BytesIO()
    Image.fromarray(np.dstack([img, img[..., :1]])).save(rgba, format="PNG")
    np.testing.assert_array_equal(pipeline._decode_png_zlib(rgba.getvalue()), img)
    with pytest.raises(ValueError, match="not a PNG"):
        pipeline._decode_png_zlib(b"JFIF" * 10)


def test_tfrecord_pure_python_crc_and_loader(rng, tmp_path, monkeypatch):
    """The writer/reader work without the C helper (pure-python crc32c),
    and TestLoader yields ordered batches with a final partial one."""
    monkeypatch.setattr(tfrecord, "_NATIVE", False)
    assert tfrecord.crc32c(b"123456789") == 0xE3069283  # the CRC-32C check value
    images = [rng.integers(0, 256, (8, 12, 3), dtype=np.uint8) for _ in range(3)]
    pattern = _write_records(str(tmp_path), images, ["a.png", "b.png", "c.png"])
    recs = list(tfrecord.read_records(glob.glob(pattern)[0], verify=True))
    assert len(recs) == 3
    cfg = Config(data=DataConfig(file_pattern=pattern), cpu_thread_cnt=2)
    batches = list(pipeline.TestLoader(cfg, batch_size=2).batches())
    assert [b["image"].shape[0] for b in batches] == [2, 1]
    assert [n for b in batches for n in b["filename"]] == [b"a.png", b"b.png", b"c.png"]
    np.testing.assert_array_equal(batches[1]["image"][0], images[2])
    packed = list(pipeline.TestLoader(cfg, batch_size=2, pack_planes=True).batches())
    assert packed[0]["packed"].shape == (2, 16, (4 + 16) * 256) and packed[0]["packed"].dtype == np.uint8
    np.testing.assert_array_equal(packed[1]["packed"][0], pipeline.pack_planes_host(images[2]))
    np.testing.assert_array_equal(packed[1]["image"][0], images[2])
