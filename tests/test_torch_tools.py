"""The port's tools against the JAX package's, on the CPU: detection
metrics, prior clustering, the CityPersons converter, the heatmap helpers
and ``UncertaintyVisualizer``, the ``evaluate_detections`` CLI, and the
trace helpers.

Tolerances: the metrics, the k-means centres, the converter's features
and ``.npy`` files, ``colorize`` / ``upsample_to`` / ``blend`` are the same
numpy arithmetic and are held exactly (``colorize`` against matplotlib's
``cm.plasma``).  The heatmaps come from the epistemic decode, whose float32
sums over T run in another order than JAX's ``decode_epistemic_stats``:
held at ``tests/test_torch_epistemic.py``'s bounds for those columns —
variances rtol 1e-4 / atol 1e-5, objectness and mutual informations rtol
1e-4 / atol 2e-4."""

import glob
import json
import os
import pickle

import numpy as np
import pytest
import scipy.io
import torch

import jax.numpy as jnp

from bayesian_yolov3_tpu.core.blueprint import Variant as JVariant, VariantSpec as JSpec
from bayesian_yolov3_tpu.data import citypersons as jcity
from bayesian_yolov3_tpu.data import prior_clustering as jpc
from bayesian_yolov3_tpu.eval import detection_metrics as jdm
from bayesian_yolov3_tpu.infer import vis as jvis
from bayesian_yolov3_tpu.ops import decode as jdec

from bayesian_yolov3_torch.cli import evaluate_detections as cli_eval
from bayesian_yolov3_torch.config import Config, DataConfig
from bayesian_yolov3_torch.data import citypersons, pipeline, prior_clustering, proto, tfrecord
from bayesian_yolov3_torch.eval import detection_metrics as dm
from bayesian_yolov3_torch.infer import vis
from bayesian_yolov3_torch.infer.plasma import PLASMA_RGB
from bayesian_yolov3_torch.utils.profiling import annotate, trace

import torch_parity as tp


def _same(a, b):
    """Equal, NaN where NaN (the metrics of a class without GT)."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    else:
        assert a == b or (np.isnan(a) and np.isnan(b)), (a, b)


def _dataset(rng, n_images=6, n_cls=2):
    """Seeded GT and predictions: near and far boxes, duplicates, misses,
    an image without predictions and one without GT."""
    gt, preds = {}, {}
    for i in range(n_images):
        m = int(rng.integers(0 if i == 0 else 1, 6))
        yx = rng.uniform(0, 0.7, (m, 2))
        boxes = np.concatenate([yx, yx + rng.uniform(0.05, 0.3, (m, 2))], axis=1)
        labels = rng.integers(0, n_cls, m)
        gt[f"img{i}"] = (boxes, labels)
        if i == 1:
            continue
        n = int(rng.integers(0, 9))
        pick = rng.integers(0, max(m, 1), n)
        jitter = rng.normal(0, 0.03, (n, 4))
        pb = (boxes[pick] if m else rng.uniform(0, 1, (n, 4))) + jitter
        pl = np.where(rng.uniform(size=n) < 0.8, labels[pick] if m else 0,
                      rng.integers(0, n_cls, n))
        preds[f"img{i}"] = (pb, rng.uniform(0, 1, n), pl)
    return gt, preds


def test_detection_metrics_equal_jax(rng):
    for _ in range(4):
        gt, preds = _dataset(rng)
        for thresh in (0.3, 0.5):
            _same(dm.evaluate_detections(preds, gt, [0, 1], thresh),
                  jdm.evaluate_detections(preds, gt, [0, 1], thresh))
            boxes_only = {k: v[0] for k, v in gt.items()}
            scored = {k: v[:2] for k, v in preds.items()}
            for fn in ("average_precision", "log_average_miss_rate"):
                _same(getattr(dm, fn)(scored, boxes_only, thresh),
                      getattr(jdm, fn)(scored, boxes_only, thresh))
        a, b = rng.uniform(0, 1, (5, 4)), rng.uniform(0, 1, (7, 4))
        np.testing.assert_array_equal(dm._iou_matrix(a, b), jdm._iou_matrix(a, b))


def test_prior_clustering_equals_jax(rng):
    boxes_px = rng.uniform(10, 400, (300, 2))
    for seed in (0, 3):
        np.testing.assert_array_equal(prior_clustering.kmeans_iou(boxes_px / 1000, seed=seed),
                                      jpc.kmeans_iou(boxes_px / 1000, seed=seed))
        got = prior_clustering.cluster_priors(boxes_px, (1024, 2048), seed=seed)
        want = jpc.cluster_priors(boxes_px, (1024, 2048), seed=seed)
        assert {s: [(p.h, p.w) for p in ps] for s, ps in got.items()} == \
            {s: [(p.h, p.w) for p in ps] for s, ps in want.items()}
    centers = jpc.kmeans_iou(boxes_px / 1000, k=5)
    assert prior_clustering.mean_best_iou(boxes_px / 1000, centers) == \
        jpc.mean_best_iou(boxes_px / 1000, centers)
    with pytest.raises(ValueError, match="at least k=9"):
        prior_clustering.kmeans_iou(boxes_px[:4])


# --------------------------------------------------------------------------
# CityPersons
# --------------------------------------------------------------------------


def _citypersons_tree(root, rng, n_train=3, n_val=2):
    """A CityPersons-like tree (the .mat annotations, 1024x2048 PNGs), as
    ``tests/test_tools.py`` builds one; the images tile a random 64x64 patch
    so that encoding them is quick."""
    img_root = os.path.join(root, "cityscapes", "leftImg8bit_trainvaltest", "leftImg8bit")
    anno_dir = os.path.join(root, "citypersons", "annotations")
    os.makedirs(anno_dir)
    dt = np.dtype([("cityname", "O"), ("im_name", "O"), ("bbs", "O")])

    def split(name, n):
        arr = np.empty((1, n), object)
        for i in range(n):
            city, im = "testcity", f"testcity_{name}_{i:06d}.png"
            os.makedirs(os.path.join(img_root, name, city), exist_ok=True)
            img = np.tile(rng.integers(0, 256, (64, 64, 3), dtype=np.uint8), (16, 32, 1))
            with open(os.path.join(img_root, name, city, im), "wb") as f:
                f.write(pipeline.encode_png(img, level=1))
            bbs = np.asarray([[1, 100 + i, 200, 50, 120, 1, 0, 0, 0, 0],
                              [2, 400, 300 + i, 40, 100, 2, 0, 0, 0, 0],
                              [0, 0, 0, 10, 10, 3, 0, 0, 0, 0],
                              [5, 50, 50, 30, 30, 4, 0, 0, 0, 0],
                              [3, 700, 100, 20, 60 + i, 5, 0, 0, 0, 0]], np.uint16)
            rec = np.zeros((1, 1), dtype=dt)
            rec[0, 0] = (np.asarray([city]), np.asarray([im]), bbs)
            arr[0, i] = rec
        return arr

    scipy.io.savemat(os.path.join(anno_dir, "anno_train.mat"),
                     {"anno_train_aligned": split("train", n_train)})
    scipy.io.savemat(os.path.join(anno_dir, "anno_val.mat"),
                     {"anno_val_aligned": split("val", n_val)})
    return os.path.join(root, "citypersons"), os.path.join(root, "cityscapes")


def test_citypersons_process_dataset_equals_jax(tmp_path, rng):
    """The same shards, records feature by feature (the PNGs by their
    decoded pixels), box-size and image-size files and pickled RNG state as
    the JAX package's converter, from the same global numpy RNG state."""
    anno_dir, img_dir = _citypersons_tree(str(tmp_path), rng)
    outs = {}
    for name, mod in (("port", citypersons), ("jax", jcity)):
        np.random.seed(11)
        outs[name] = str(tmp_path / name)
        mod.process_dataset(out_dir=outs[name], dataset_name="cp", anno_dir=anno_dir,
                            img_dir=img_dir, train_shards=2, val_shards=1, shuffle=True)
    files = sorted(os.listdir(outs["jax"]))
    assert files == sorted(os.listdir(outs["port"]))
    assert len([f for f in files if "-train-" in f and "-of-" in f]) == 2
    n_records = 0
    for f in files:
        got, want = (os.path.join(outs[k], f) for k in ("port", "jax"))
        if f.endswith(".npy"):
            np.testing.assert_array_equal(np.load(got), np.load(want))
            continue
        if f.endswith("np_random_state"):
            with open(got, "rb") as a, open(want, "rb") as b:
                sa, sb = pickle.load(a), pickle.load(b)
            assert sa[0] == sb[0] and all(np.array_equal(x, y) for x, y in zip(sa[1:], sb[1:]))
            continue
        for rg, rw in zip(tfrecord.read_records(got, verify=True),
                          tfrecord.read_records(want, verify=True), strict=True):
            fg, fw = proto.decode_example(rg), proto.decode_example(rw)
            assert fg.keys() == fw.keys()
            for k in fw:
                if k == "image/encoded":
                    np.testing.assert_array_equal(pipeline.decode_png(fg[k][0]),
                                                  pipeline.decode_png(fw[k][0]))
                else:
                    np.testing.assert_array_equal(np.asarray(fg[k]), np.asarray(fw[k]), k)
            assert sorted(fg["image/object/class/label"]) == [1, 1, 2]
            n_records += 1
    assert n_records == 5
    sizes = np.load(os.path.join(outs["port"], "cp-train-box_sizes.npy"))
    assert sizes.shape == (9, 2)


def test_citypersons_refuses_other_image_sizes(tmp_path):
    path = tmp_path / "small.png"
    path.write_bytes(pipeline.encode_png(np.zeros((64, 96, 3), np.uint8)))
    with pytest.raises(AssertionError, match="height 64"):
        citypersons.create_example(str(path), np.zeros((0, 10), np.uint16))


# --------------------------------------------------------------------------
# heatmaps
# --------------------------------------------------------------------------


def test_plasma_table_and_heatmap_helpers_equal_jax(rng):
    import matplotlib.cm as cm

    np.testing.assert_array_equal(PLASMA_RGB, np.asarray(cm.plasma(np.arange(256)))[:, :3])
    grids = [rng.uniform(0.5, 3.0, (8, 12)), np.array([[0.0, 1.0], [5.0, 10.0]]),
             rng.exponential(1.0, (16, 24)), np.arange(512, dtype=np.float64).reshape(16, 32)]
    for g in grids:
        for kw in ({}, {"vmin": 0.0}, {"vmin": 0.0, "vmax": 5.0}):
            np.testing.assert_array_equal(vis.colorize(g, **kw), jvis.colorize(g, **kw))
    heat = rng.uniform(0, 1, (4, 6, 3))
    np.testing.assert_array_equal(vis.upsample_to((32, 48), heat), jvis.upsample_to((32, 48), heat))
    img = rng.uniform(0, 1, (32, 48, 3)).astype(np.float32)
    up = vis.upsample_to((32, 48), heat)
    np.testing.assert_array_equal(vis.blend(img, up), jvis.blend(img, up))


T = 4


@pytest.fixture(scope="module")
def visualizer():
    cfg = Config(model="bayesian", full_img_size=tp.IMG, T=T, compute_dtype="float32")
    params, stats = tp.to_torch(*tp.numpy_weights(seed=3))
    return vis.UncertaintyVisualizer(cfg, params, stats, seed=5, device="cpu")


def test_visualizer_maps_match_jax(visualizer):
    """The maps read from the port's decoded rows against the JAX package's
    ``uncertainty_maps`` of its ``decode_epistemic_stats`` over the T
    samples of its forward under the same site keys, sample by sample."""
    img = tp.image_u8(seed=9)[0].astype(np.float32) / 255.0
    got = visualizer.maps(img)
    params_np, stats_np = tp.numpy_weights(seed=3)
    samples = [tp.jax_forward_cf(params_np, stats_np, img[None], tp.SPEC, site_keys=k)
               for k in visualizer.keys]  # one forward per row of the (T, 15) table
    stats = []
    for s in range(3):
        raws = []
        for outs in samples:
            raw_cf, (h, w) = outs[s]
            raws.append(raw_cf.reshape(-1, h, w).transpose(1, 2, 0))
        det = jdec.split_detection(jnp.asarray(np.stack(raws)), tp.SPEC)
        stats.append(jdec.decode_epistemic_stats(det))
    want = jvis.uncertainty_maps(stats)
    assert list(got) == list(want) and len(got) == 11
    for key in want:
        atol = 1e-5 if "var_loc" in key else 2e-4
        for s in range(3):
            assert got[key][s].shape == want[key][s].shape == (
                tp.IMG[0] // (32 >> s), tp.IMG[1] // (32 >> s), 3)
            np.testing.assert_allclose(got[key][s], want[key][s], rtol=1e-4, atol=atol,
                                       err_msg=f"{key} scale {s}")


def test_visualizer_renders_99_blended_pngs(visualizer, tmp_path):
    img = tp.image_u8(seed=9)[0].astype(np.float32) / 255.0
    written = visualizer.render(img, str(tmp_path), tag="t")
    assert len(written) == 11 * 3 * 3 and len(set(written)) == 99
    maps = visualizer.maps(img)
    path = os.path.join(str(tmp_path), "t_obj_mean_l1_p2.png")
    with open(path, "rb") as f:
        png = pipeline.decode_png(f.read())
    heat = vis.upsample_to(img.shape[:2], vis.colorize(maps["obj_mean"][1][..., 2], vmin=0.0))
    np.testing.assert_array_equal(png, (vis.blend(img, heat) * 255).astype(np.uint8))


# --------------------------------------------------------------------------
# the evaluate_detections CLI and the trace helpers
# --------------------------------------------------------------------------


def test_evaluate_detections_cli(tmp_path, rng, capsys):
    """GT tfrecords and an ECP JSON directory through the CLI, against the
    JAX package's metrics of the same boxes (pixels), scores and labels."""
    h, w = 64, 96
    gt, preds = _dataset(rng, n_images=4)
    os.makedirs(tmp_path / "json")
    with tfrecord.TFRecordWriter(str(tmp_path / "gt-00000-of-00001")) as wr:
        for name, (boxes, labels) in gt.items():
            boxes = np.clip(boxes, 0, 1).astype(np.float32)
            gt[name] = (boxes * [h, w, h, w], labels.astype(np.int32))
            wr.write(proto.encode_example({
                "image/encoded": [pipeline.encode_png(np.zeros((h, w, 3), np.uint8))],
                "image/filename": [f"{name}.png".encode()],
                "image/object/bbox/ymin": boxes[:, 0], "image/object/bbox/xmin": boxes[:, 1],
                "image/object/bbox/ymax": boxes[:, 2], "image/object/bbox/xmax": boxes[:, 3],
                "image/object/class/label": labels.astype(np.int64) + 1}))
    want_preds = {}
    for name, (boxes, scores, labels) in preds.items():
        dets = [{"y0": float(b[0] * h), "x0": float(b[1] * w), "y1": float(b[2] * h),
                 "x1": float(b[3] * w), "score": float(s),
                 "cls_scores": [1.0 - float(c), float(c)]}
                for b, s, c in zip(boxes, scores, labels)]
        with open(tmp_path / "json" / f"{name}.json", "w") as f:
            json.dump({"children": dets}, f)
        want_preds[name] = (np.asarray([[d["y0"], d["x0"], d["y1"], d["x1"]] for d in dets],
                                       float).reshape(-1, 4),
                            np.asarray([d["score"] for d in dets]), labels)
    out = cli_eval.main([str(tmp_path / "json"), "--set", f"full_img_size=[{h},{w},3]",
                         "--set", f"data.file_pattern={tmp_path / 'gt-*-of-*'}"])
    printed = json.loads(capsys.readouterr().out)
    want = jdm.evaluate_detections(want_preds, gt, cls_ids=range(2))
    _same(out, want)
    assert set(printed) == {"per_class", "mAP"} and len(printed["per_class"]) == 2
    assert np.isfinite(out["mAP"])


def test_trace_writes_the_annotation(tmp_path):
    with trace(str(tmp_path / "tr")) as prof:
        with annotate("a_step"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    with open(tmp_path / "tr" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "a_step" for e in events)
    assert any(e.key == "a_step" for e in prof.key_averages())
