"""The first slice of the PyTorch port as a whole, on the CPU: epistemic
inference (bayesian, float32, fixed MC masks) against the JAX package's
``InferenceRunner`` on the same numpy weights and image, and the port's
``run()`` from a tfrecord and a checkpoint to ECP JSON.

Tolerance of the row comparison: 75 float32 convolutions, then sums over T,
in another order in the two frameworks — ten times the kernel-level
tolerances of test_torch_epistemic.py; ``valid`` and the picks themselves
(layer / prior id columns) are exact."""

import glob
import io
import json
import os
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


def _save(cfg, params, stats, step):
    trainable, frozen = partition_params(params, cfg.freeze_darknet53)
    CheckpointStore(cfg.checkpoint_path, cfg.run_id).save(
        step, {"params": trainable, "frozen": frozen, "stats": stats})


def test_run_writes_ecp_json_of_its_rows(weights, tmp_path):
    """tfrecord + checkpoint -> one JSON per frame, equal to
    bbox_to_ecp_format of predict()'s rows; batch 2 over 3 frames pads the
    last batch; a second run refuses to overwrite."""
    images = [tp.image_u8(seed=10 + i)[0] for i in range(3)]
    names = [f"frame_{i}.png" for i in range(3)]
    cfg = Config(**dict(KW, batch_size=2), run_id="r", cpu_thread_cnt=2,
                 checkpoint_path=str(tmp_path / "ckpt"), out_path=str(tmp_path / "out" / "epi"),
                 data=DataConfig(file_pattern=_write_records(str(tmp_path / "data"), images, names)))
    tparams, tstats = tp.to_torch(*weights)
    _save(cfg, tparams, tstats, step=12)

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


def test_runner_loads_wrong_variant_loudly(weights, tmp_path):
    tparams, tstats = tp.to_torch(*weights)
    cfg = Config(**KW, run_id="w", checkpoint_path=str(tmp_path / "ckpt"))
    _save(cfg, tparams, tstats, step=1)
    cfg3 = Config(**KW, run_id="w", checkpoint_path=str(tmp_path / "ckpt"), cls_cnt=3)
    with pytest.raises(ValueError, match="wrong variant or config"):
        InferenceRunner(cfg3, device="cpu").load_state()
    params, stats, step = InferenceRunner(cfg, device="cpu").load_state()
    assert step == 1 and torch.equal(params["backbone"]["conv_07"]["w"],
                                     tparams["backbone"]["conv_07"]["w"])
    assert torch.equal(stats["trans2"]["var"], tstats["trans2"]["var"])


@pytest.mark.parametrize("kw,exc,match", [
    (dict(model="aleatoric", inference_mode=False), NotImplementedError, "later slice"),
    (dict(inference_mode=False), NotImplementedError, "later slice"),
    (dict(mesh_shape={"mc": 2}), NotImplementedError, "multi-device"),
    (dict(quantize="int8"), NotImplementedError, "int8"),
    (dict(packed_host_input=True), NotImplementedError, "fused early backbone"),
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


def test_cli_runs_the_port(weights, tmp_path):
    from bayesian_yolov3_torch.cli import inference_epistemic as cli

    images = [tp.image_u8(seed=20)[0]]
    pattern = _write_records(str(tmp_path / "data"), images, ["a.png"])
    cfg = Config(**KW, run_id="c", checkpoint_path=str(tmp_path / "ckpt"))
    _save(cfg, *tp.to_torch(*weights), step=3)
    argv = ["--device", "cpu", "--set", "compute_dtype=float32", "--set", "T=2",
            "--set", "run_id=c", "--set", f"checkpoint_path={tmp_path / 'ckpt'}",
            "--set", "full_img_size=[64,96,3]", "--set", "cpu_thread_cnt=1",
            "--set", f"data.file_pattern={pattern}", "--set", "nms_max_boxes=20",
            "--set", f"out_path={tmp_path / 'out'}"]
    out_dir = cli.main(argv)
    assert out_dir.endswith("out_3") and os.path.exists(os.path.join(out_dir, "a.json"))
    assert cli.DEFAULTS["T"] == 50 and cli.DEFAULTS["batch_size"] == 1


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
    with pytest.raises(ValueError, match="unsupported PNG"):
        rgba = io.BytesIO()
        Image.fromarray(np.dstack([img, img[..., :1]])).save(rgba, format="PNG")
        pipeline._decode_png_zlib(rgba.getvalue())
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
    with pytest.raises(NotImplementedError, match="fused early backbone"):
        pipeline.TestLoader(cfg, pack_planes=True)
