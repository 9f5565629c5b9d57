"""Spans and counters of the port's inference path (``utils.profiling``), on
the CPU at 64x96: the span tree of a ``predict`` call (bayesian T=4, and
aleatoric batch 2), one request a call, the counters with a forced exact-NMS
retry, the bound of the ring, no ``record_function`` without a profiler,
every span on the Chrome trace's clock under ``profiling.trace``, and the
requests and the summary line of ``run()``.  Seeded weights of the port's
own initialiser; no JAX."""

import glob
import json
import logging
import os

import numpy as np
import pytest
import torch

from bayesian_yolov3_torch.config import Config, DataConfig
from bayesian_yolov3_torch.data import pipeline, proto, tfrecord
from bayesian_yolov3_torch.infer import InferenceRunner
from bayesian_yolov3_torch.infer import runner as runner_mod
from bayesian_yolov3_torch.utils import profiling

HW = (64, 96)
KW = {"epistemic": dict(model="bayesian", inference_mode=True, T=4, batch_size=1,
                        fixed_mc_masks=7),
      "aleatoric": dict(model="aleatoric", batch_size=2)}
COMMON = dict(compute_dtype="float32", full_img_size=HW + (3,), nms_max_boxes=50)
# the root's children on a certified call (no byolo.nms_exact)
CHILDREN = {"byolo.h2d", "byolo.backbone", "byolo.heads", "byolo.decode", "byolo.nms",
            "byolo.wait.certificate", "byolo.wait.fetch"}


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(2, n))
    yield
    torch.set_num_threads(n)


def _runner(kind, pre_top_k=0, **kw):
    return InferenceRunner(Config(**KW[kind], **COMMON, nms_pre_top_k=pre_top_k, **kw),
                           device="cpu")


@pytest.fixture(scope="module")
def weights():
    """Seeded weights of the bayesian model (the aleatoric one has the same
    tree): diffuse scores, so a small pre-top-k fails its certificate."""
    model = _runner("epistemic").model
    return model.init(torch.Generator().manual_seed(0), device="cpu")


def _images(nb, seed=1):
    return np.random.default_rng(seed).integers(0, 256, (nb,) + HW + (3,), dtype=np.uint8)


def _predict(runner, weights, nb):
    """One ``predict`` call; returns the request it kept."""
    before = profiling.requests()
    runner.predict(*weights, _images(nb))
    after = profiling.requests()
    assert len(after) == min(len(before) + 1, profiling.REQUESTS_KEPT)
    return after[-1]


def _children(rec, span):
    return [s for s in rec["spans"] if s["parent"] == span["id"]]


@pytest.mark.parametrize("kind, nb", [("epistemic", 1), ("aleatoric", 2)])
def test_span_tree_of_one_predict(weights, kind, nb):
    rec = _predict(_runner(kind), weights, nb)
    root = rec["spans"][0]
    assert root["name"] == "byolo.predict" and root["parent"] is None
    assert rec["id"] == root["id"] and not rec["profiled"]
    assert {s["name"] for s in _children(rec, root)} == CHILDREN
    assert sorted(s["name"] for s in _children(rec, root)) == sorted(CHILDREN)  # each once
    heads = next(s for s in rec["spans"] if s["name"] == "byolo.heads")
    drops = [s for s in rec["spans"] if s["name"] == "byolo.dropout"]
    assert len(drops) == (15 if kind == "epistemic" else 0)
    assert all(s["parent"] == heads["id"] for s in drops)
    assert rec["counters"] == {"images": nb, "nms_certificate_failed": 0, "nms_exact_retry": 0,
                               "h2d_bytes": nb * HW[0] * HW[1] * 3}


def test_one_request_per_call_and_parents_enclose_children(weights):
    runner = _runner("epistemic")
    a, b = (_predict(runner, weights, 1) for _ in range(2))
    assert a["id"] != b["id"]
    for rec in (a, b):
        by_id = {s["id"]: s for s in rec["spans"]}
        assert len(by_id) == len(rec["spans"])  # span ids are unique
        for s in rec["spans"]:
            assert s["request"] == rec["id"]
            assert s["start_ns"] <= s["end_ns"]
            if s["parent"] is not None:
                p = by_id[s["parent"]]
                assert p["start_ns"] <= s["start_ns"] and s["end_ns"] <= p["end_ns"]
        # self time = duration - children: the children of a span do not
        # overlap, so it is never negative
        for s in rec["spans"]:
            kids = sorted(_children(rec, s), key=lambda k: k["start_ns"])
            assert all(x["end_ns"] <= y["start_ns"] for x, y in zip(kids, kids[1:]))
            self_ns = (s["end_ns"] - s["start_ns"]) - sum(k["end_ns"] - k["start_ns"]
                                                          for k in kids)
            assert self_ns >= 0


@pytest.mark.parametrize("kind, nb", [("epistemic", 1), ("aleatoric", 2)])
def test_counters_of_a_forced_retry(weights, kind, nb):
    """A pre-top-k of 40 cannot fill 50 selections: every image's
    certificate fails and the call takes the exact retry."""
    rec = _predict(_runner(kind, pre_top_k=40), weights, nb)
    names = [s["name"] for s in _children(rec, rec["spans"][0])]
    assert sorted(names) == sorted(CHILDREN | {"byolo.nms_exact"})
    nms = next(s for s in rec["spans"] if s["name"] == "byolo.nms")
    # the certificate's host scalar, copied to the device (a sync on a card)
    assert [s["name"] for s in _children(rec, nms)] == ["byolo.wait.nms_scalar"]
    assert rec["counters"] == {"images": nb, "nms_certificate_failed": nb, "nms_exact_retry": 1,
                               "h2d_bytes": nb * HW[0] * HW[1] * 3}


def test_ring_keeps_the_last_requests():
    first = profiling.Request("r", 1)
    first.end()
    for _ in range(profiling.REQUESTS_KEPT):
        profiling.Request("r", 1).end()
    kept = profiling.requests()
    assert len(kept) == profiling.REQUESTS_KEPT
    assert first.record["id"] not in {r["id"] for r in kept}
    assert [r["id"] for r in kept] == sorted(r["id"] for r in kept)  # oldest first
    not_ended = profiling.Request("r", 1)
    assert profiling.requests()[-1] is kept[-1] and not_ended.record not in profiling.requests()


def test_spans_outside_a_request_are_not_kept():
    before = profiling.requests()
    with profiling.annotate("byolo.backbone"):
        pass
    profiling.count("images", 3)
    assert profiling.requests() == before


def test_no_record_function_without_a_profiler(weights, monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    rec = _predict(_runner("epistemic"), weights, 1)
    assert len(rec["spans"]) == 1 + len(CHILDREN) + 15


def test_spans_sit_on_the_trace_clock(weights, tmp_path):
    """Under ``profiling.trace`` every kept span is a ``user_annotation`` of
    its name, whose ``ts`` + ``baseTimeNanoseconds`` is its stamp to 1 ms.
    The profile's first range takes about 2 ms to enter (5-10 us after it),
    so a warm-up range comes first, as the benchmark's window range does."""
    runner = _runner("aleatoric", pre_top_k=40)
    with profiling.trace(str(tmp_path / "tr")):
        with profiling.annotate("warm-up"):
            pass
        runner.predict(*weights, _images(2))
    rec = profiling.requests()[-1]
    assert rec["profiled"] and len(rec["spans"]) == 1 + len(CHILDREN) + 2
    with open(tmp_path / "tr" / "trace.json") as f:
        trace = json.load(f)
    base = int(trace["baseTimeNanoseconds"])
    marks = {}
    for e in trace["traceEvents"]:
        if e.get("cat") == "user_annotation" and e.get("ph") == "X":
            marks.setdefault(e["name"], []).append(base + float(e["ts"]) * 1e3)
    for s in rec["spans"]:
        gap = min(abs(t - s["start_ns"]) for t in marks[s["name"]])
        assert gap < 1e6, (s["name"], gap)


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


def test_run_keeps_a_request_a_batch_and_logs_one_summary(weights, tmp_path, monkeypatch,
                                                          caplog):
    """3 frames in batches of 2: two ``byolo.batch`` requests (the second
    padded), each with its pull, copy, waits and write (on the writer
    thread); one summary line of host ms per image with the retries."""
    images = list(_images(3, seed=5))
    cfg = Config(**KW["aleatoric"], **COMMON, nms_pre_top_k=40, run_id="r", cpu_thread_cnt=2,
                 out_path=str(tmp_path / "out" / "ale"),
                 data=DataConfig(file_pattern=_write_records(
                     str(tmp_path / "data"), images, [f"f{i}.png" for i in range(3)])))
    monkeypatch.setattr(InferenceRunner, "load_state", lambda self: (*weights, 7))
    runner = InferenceRunner(cfg, device="cpu")
    seen = {r["id"] for r in profiling.requests()}
    with caplog.at_level(logging.INFO, logger="byolo.infer"):
        out_dir = runner.run()
    assert len(glob.glob(os.path.join(out_dir, "*.json"))) == 3
    recs = [r for r in profiling.requests() if r["id"] not in seen]
    assert len(recs) == 2
    assert [r["spans"][0]["name"] for r in recs] == ["byolo.batch"] * 2
    assert [r["counters"]["images"] for r in recs] == [2, 1]
    assert [r["counters"]["h2d_bytes"] for r in recs] == [2 * HW[0] * HW[1] * 3] * 2
    assert sum(r["counters"]["nms_exact_retry"] for r in recs) == runner.retried == 2
    for r in recs:
        names = [s["name"] for s in r["spans"]]
        for name in ("byolo.load", "byolo.h2d", "byolo.backbone", "byolo.heads", "byolo.decode",
                     "byolo.nms", "byolo.nms_exact", "byolo.wait.nms_scalar",
                     "byolo.wait.certificate", "byolo.wait.fetch", "byolo.write"):
            assert names.count(name) == 1, (name, names)
        assert all(s["request"] == r["id"] for s in r["spans"])
    lines = [m.getMessage() for m in caplog.records if m.getMessage().startswith("Host ms")]
    assert len(lines) == 1
    want = runner_mod.host_ms_per_image(recs)
    failed = sum(r["counters"]["nms_certificate_failed"] for r in recs)
    assert failed >= 2
    assert lines[0] == ("Host ms per image: " + ", ".join(f"{k} {v:.3f}" for k, v in want.items())
                        + f"; h2d {runner_mod.h2d_gb_per_s(recs):.2f} GB/s"
                        + f"; 2 batches re-run with exact NMS (certificate failed on {failed} images).")
    assert list(want) == ["load", "h2d", "enqueue", "wait", "write"]
    assert all(v > 0 for v in want.values())


def test_host_ms_per_image_sums_by_span():
    """A wait inside an enqueue span (the NMS scalar) counts as wait, not
    as enqueue; the dropout sites inside the heads count once."""
    def span(name, t0, t1, sid=0, parent=None):
        return {"name": name, "id": sid, "parent": parent,
                "start_ns": int(t0 * 1e6), "end_ns": int(t1 * 1e6)}

    recs = [{"counters": {"images": 2},
             "spans": [span("byolo.batch", 0, 20), span("byolo.load", 0, 2),
                       span("byolo.h2d", 2, 3), span("byolo.backbone", 3, 5),
                       span("byolo.heads", 5, 9), span("byolo.dropout", 5, 6),
                       span("byolo.decode", 9, 10), span("byolo.nms", 10, 13, sid=7),
                       span("byolo.wait.nms_scalar", 11, 13, parent=7),
                       span("byolo.wait.certificate", 13, 15), span("byolo.nms_exact", 15, 16),
                       span("byolo.wait.fetch", 16, 20), span("byolo.write", 20, 26)]}]
    assert runner_mod.host_ms_per_image(recs) == pytest.approx(
        {"load": 1.0, "h2d": 0.5, "enqueue": 4.5, "wait": 4.0, "write": 3.0})


def test_h2d_gb_per_s_is_bytes_over_copy_time():
    """The summary's copy rate: every request's ``h2d_bytes`` over the
    summed ``byolo.h2d`` spans, other spans left out; 0 with no copy."""
    def rec(nbytes, *spans):
        return {"counters": {"h2d_bytes": nbytes},
                "spans": [{"name": n, "start_ns": t0, "end_ns": t1} for n, t0, t1 in spans]}

    recs = [rec(6_000_000, ("byolo.batch", 0, 9_000_000), ("byolo.h2d", 1_000_000, 2_000_000)),
            rec(3_000_000, ("byolo.h2d", 0, 500_000), ("byolo.load", 0, 7_000_000))]
    assert runner_mod.h2d_gb_per_s(recs) == pytest.approx(6.0)
    assert runner_mod.h2d_gb_per_s([rec(0, ("byolo.load", 0, 5))]) == 0.0
