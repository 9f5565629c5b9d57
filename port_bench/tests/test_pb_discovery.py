"""A new cell, traffic mix, entry and metric are new files, found by name
with no edit to a file that is there: a dummy of each in a copy of the
benchmark drives a whole run."""

import json
import os
import shutil

import run
from bench_lib import cells

DRIVER = '''
KIND = "infer"


class Session:
    def __init__(self, ctx):
        self.nb, self.image_hw, self.calls = ctx["traffic"]["batch"], (32, 32), []

    def call(self, i):
        self.calls.append({"ms": 1.0, "nms_runs": 1, "picks": [1]})
        return self.nb

    def counters(self):
        return {"dummy": len(self.calls)}

    def finish(self):
        pass

    def layers(self):
        return {}

    def release(self):
        pass

    def check(self):
        return {"gap": 0.5}
'''


def test_dummy_files_are_picked_up(tmp_path):
    root = tmp_path / "port_bench"
    shutil.copytree(cells.ROOT, root, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (root / "drivers" / "dummy_entry.py").write_text(DRIVER)
    (root / "traffic" / "dummy_mix.json").write_text(json.dumps(
        {"entry": "dummy_entry", "batch": 3, "trace": {"first_call": 0, "calls": 1}}))
    (root / "workloads" / "dummy_cell.json").write_text(json.dumps(
        {"config": "aleatoric_yolov3_ecp", "traffic": "dummy_mix", "chips": 1, "why": "test",
         "check": {"calls": 1, "limits": {"gap": 1.0}}}))
    (root / "metrics" / "dummy_calls.py").write_text(
        "def read(rec):\n    return rec['run']['calls']\n")
    bench = cells.benchmark()
    bench["workloads"].append({"name": "dummy_cell", "config": "aleatoric_yolov3_ecp",
                               "traffic": "dummy_mix", "chips": 1, "why": "test"})
    bench["end_to_end"].append({"name": "dummy_calls", "unit": "1", "better": "higher",
                                "bound": 0.1, "source": "host_clock",
                                "workloads": ["dummy_cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    args = run.parse(["--workload", "dummy_cell", "--seed", str(2**31 + 11), "--seconds", "0.05"])
    result, checks, _ = run.run(args, device="cpu", root=str(root))
    assert result["correct"] and checks == {"gap": {"value": 0.5, "limit": 1.0}}
    assert result["metrics"]["dummy_calls"]["value"] == result["attempted"] > 0
    assert result["metrics"]["setup_s"]["value"] > 0
    assert "img_per_s" not in result["metrics"]  # listed for other cells only
    assert os.path.exists(root / "run.py")
