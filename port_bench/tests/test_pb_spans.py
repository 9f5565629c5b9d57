"""The metrics that read the program's spans and counters
(``bench_lib/spans.py``): known values on a synthetic request ring, the
plain calls chosen, None when there are too few or the program keeps no
requests, and a traced CPU run of each cell that reports them."""

import pytest
import torch

import run
from bench_lib import cells, spans
from bayesian_yolov3_torch.utils import profiling

NEW = {"epistemic_T30_batch1": ["host_wait_pct.stream", "heads_host_ms_per_img.stream",
                                "dropout_host_ms_per_img", "nms_retry_pct.stream"],
       "aleatoric_batch11": ["host_wait_pct.batch", "h2d_host_ms_per_img.batch",
                             "nms_retry_pct.batch"]}
MS = 1_000_000  # ns


def _request(profiled, retry=0, images=1, scale=1):
    """A call of 10 ms (x ``scale``): h2d 1, heads 4 holding two dropout
    sites of 1, the certificate wait 2, the fetch 1."""
    def span(name, t0, t1):
        return {"name": name, "start_ns": t0 * scale * MS, "end_ns": t1 * scale * MS}

    return {"profiled": profiled,
            "counters": {"images": images, "nms_certificate_failed": retry,
                         "nms_exact_retry": retry, "h2d_bytes": 0},
            "spans": [span("byolo.predict", 0, 10), span("byolo.h2d", 0, 1),
                      span("byolo.heads", 2, 6), span("byolo.dropout", 2, 3),
                      span("byolo.dropout", 3, 4), span("byolo.wait.certificate", 7, 9),
                      span("byolo.wait.fetch", 9, 10)]}


def _rec(first_call=3):
    return {"kind": "infer", "traffic": {"trace": {"first_call": first_call, "calls": 2}}}


def _ring(monkeypatch, reqs):
    monkeypatch.setattr(profiling, "requests", lambda: list(reqs))


def test_known_values_of_the_plain_calls(monkeypatch):
    """Warm-up and early calls (10x longer, retried) and the calls after the
    profiled range are not read; the 3 plain calls before it are."""
    early = [_request(False, retry=1, scale=10) for _ in range(4)]
    plain = [_request(False, retry=int(i == 0), images=2) for i in range(3)]
    traced = [_request(True, retry=1, scale=10) for _ in range(2)]
    after = [_request(False, retry=1, scale=10) for _ in range(5)]
    _ring(monkeypatch, early + plain + traced + after)
    rec = _rec()
    assert spans.plain_requests(rec) == plain
    assert cells.module("metrics", "host_wait_pct.stream").read(rec) == pytest.approx(30.0)
    assert cells.module("metrics", "host_wait_pct.batch").read(rec) == pytest.approx(30.0)
    assert cells.module("metrics", "heads_host_ms_per_img.stream").read(rec) == pytest.approx(2.0)
    assert cells.module("metrics", "dropout_host_ms_per_img").read(rec) == pytest.approx(1.0)
    assert cells.module("metrics", "h2d_host_ms_per_img.batch").read(rec) == pytest.approx(0.5)
    for name in ("nms_retry_pct.stream", "nms_retry_pct.batch"):
        assert cells.module("metrics", name).read(rec) == pytest.approx(100.0 / 3)


@pytest.mark.parametrize("ring", [
    [_request(False)] * 2 + [_request(True)],   # fewer plain calls than first_call
    [_request(False)] * 5,                      # no profiled call: the window closed early
    [_request(False), _request(True), _request(False), _request(False), _request(True)],
    [],
], ids=["too_few", "none_profiled", "profiled_inside", "empty"])
def test_none_without_enough_plain_calls(monkeypatch, ring):
    _ring(monkeypatch, ring)
    for names in NEW.values():
        for name in names:
            assert cells.module("metrics", name).read(_rec()) is None


def test_none_from_a_program_without_requests(monkeypatch):
    monkeypatch.delattr(profiling, "requests")
    for names in NEW.values():
        for name in names:
            assert cells.module("metrics", name).read(_rec()) is None


def test_the_new_metrics_are_each_cells_own():
    bench = cells.benchmark()
    for cell, names in NEW.items():
        reported = {m["name"] for m in cells.metrics_of(bench, cell, True)}
        assert set(names) <= reported
        other = next(c for c in NEW if c != cell)
        assert not set(names) & {m["name"] for m in cells.metrics_of(bench, other, True)}


@pytest.fixture
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


SMALL = {"epistemic_T30_batch1": ({"full_img_size": [64, 96, 3], "T": 8},
                                  {"pool": 2, "batch": 1,
                                   "trace": {"first_call": 3, "calls": 2}}),
         "aleatoric_batch11": ({"full_img_size": [64, 96, 3]},
                               {"pool": 4, "batch": 2, "trace": {"first_call": 3, "calls": 2}})}


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_traced_cpu_run_reports_the_new_metrics(cell, _threads):
    cfg, traffic = SMALL[cell]
    args = run.parse(["--workload", cell, "--seed", str(2**31 + 7), "--seconds", "2",
                      "--trace", "1"])
    result, checks, _ = run.run(args, device="cpu", overrides={"config": cfg, "traffic": traffic})
    assert result["correct"], checks
    got = result["metrics"]
    for name in NEW[cell]:
        assert name in got and got[name]["value"] >= 0.0, (name, sorted(got))
    assert 0.0 < got[NEW[cell][0]]["value"] < 100.0  # the wait share
    assert got[NEW[cell][-1]]["value"] == 0.0  # no retry with the benchmark's weights
