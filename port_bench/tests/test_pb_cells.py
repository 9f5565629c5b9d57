"""Every cell, configuration, entry, metric and kernel bound is a file found
by its name, and BENCHMARK.json keeps to the shape the harness reads."""

import json
import os
import re

import pytest

from bench_lib import cells

BENCH = cells.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
REPO = os.path.dirname(cells.ROOT)


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_loads_by_name(w):
    cell = cells.cell(w["name"])
    assert cell["config"]["name"] == w["config"]
    assert cell["traffic"]["name"] == w["traffic"]
    assert cell["why"] == w["why"] and cell["chips"] == w["chips"]
    driver = cells.module("drivers", cell["traffic"]["entry"])
    assert hasattr(driver, "Session") and driver.KIND in ("infer", "train")
    assert cell["check"]["limits"], "a cell compares at least one number"


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_is_its_own(c):
    assert c["file"] == f"port_bench/configs/{c['name']}.json"
    with open(os.path.join(REPO, c["file"])) as f:
        cfg = json.load(f)
    assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
    assert cfg["reduced"] == c["reduced"]
    assert os.path.exists(os.path.join(cells.ROOT, "reference", cfg["reference"] + ".py"))


@pytest.mark.parametrize("m", BENCH["end_to_end"] + BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_reader_by_name(m):
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    assert callable(cells.module("metrics", m["name"]).read)


def test_kernel_bounds_by_name():
    seen = 0
    for m in BENCH["per_layer"]:
        kernel, roof, _ = m["name"].partition("_roofline")  # <kernel>_roofline[.<cells>]
        if roof:
            k = cells.module("kernels", kernel)
            assert re.compile(k.PATTERN) and callable(k.work)
            assert m["unit"] == "%"
            seen += 1
    assert seen >= 4


def test_idle_share_against_the_untraced_rate():
    """Device busy 30 ms an image in the traced calls, 40 ms an image of
    wall time in the calls outside them: idle 25 %, whatever the traced
    window's own length (the profiler slows the host)."""
    from bench_lib import readings

    rec = {"kind": "infer", "trace": {"busy_s": 0.3, "window_s": 0.9},
           "traffic": {"trace": {"first_call": 2, "calls": 10}},
           "run": {"traced_calls": 10, "traced_images": 10, "plain_images": 100,
                   "plain_seconds": 4.0}}
    assert readings.idle_pct(rec) == pytest.approx(25.0)
    assert readings.idle_pct({**rec, "trace": None}) is None
    cut = {**rec, "run": {**rec["run"], "traced_calls": 1, "traced_images": 1}}
    assert readings.idle_pct(cut) is None  # the window closed inside the traced calls


def test_benchmark_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["port_bench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [w["name"] for w in BENCH["workloads"]]
    assert len(set(names)) == len(names)
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for w in names:  # every cell reports setup_s, another end-to-end metric, a per-layer one
        rep = {m["name"] for m in cells.metrics_of(BENCH, w, False)}
        assert "setup_s" in rep and len(rep) >= 2
        assert cells.metrics_of(BENCH, w, True)
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for w in m.get("workloads", []):
            assert m["moves"] in {x["name"] for x in cells.metrics_of(BENCH, w, False)}


def test_metrics_of_selects_by_cell():
    bench = {"end_to_end": [{"name": "a"}, {"name": "b", "workloads": ["x"]}],
             "per_layer": [{"name": "p", "moves": "b"}, {"name": "q", "moves": "a",
                                                         "workloads": ["y"]}]}
    assert [m["name"] for m in cells.metrics_of(bench, "x", False)] == ["a", "b"]
    assert [m["name"] for m in cells.metrics_of(bench, "y", False)] == ["a"]
    assert [m["name"] for m in cells.metrics_of(bench, "x", True)] == ["p"]
    assert [m["name"] for m in cells.metrics_of(bench, "y", True)] == ["q"]


def test_window_makes_the_traced_calls_in_full(monkeypatch):
    """The traced range is made in full past the deadline; only the calls
    before it count as plain (the profiler slows the calls after it too)."""
    import contextlib
    import time

    import run

    class Sess:
        def call(self, i):
            time.sleep(0.002)
            return 2

        def finish(self):
            pass

    monkeypatch.setattr(run.trace, "profiler", contextlib.nullcontext)
    w = run.window(Sess(), 0.02, True, {"first_call": 3, "calls": 50})
    assert w["traced_calls"] == 50 and w["traced_images"] == 100
    assert w["plain_images"] == 6 and w["calls"] == 53 and w["images"] == 106
    w = run.window(Sess(), 0.02, False, {"first_call": 3, "calls": 50})
    assert w["traced_calls"] == 0 and w["plain_images"] == w["images"] == 2 * w["calls"]
