"""Everything a cell is made of, found by name: ``workloads/<cell>.json``
(its configuration, traffic and limits), ``configs/<config>.json``,
``traffic/<traffic>.json`` (the parameters one generator reads, and the
entry it drives), ``drivers/<entry>.py``, ``metrics/<metric>.py`` and
``kernels/<kernel>.py``.  A new one of any kind is a new file."""

from __future__ import annotations

import importlib.util
import json
import os
import sys
import zlib
from typing import Dict, List

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))  # port_bench/


def load_json(kind: str, name: str, root: str = ROOT) -> Dict:
    with open(os.path.join(root, kind, name + ".json")) as f:
        return json.load(f)


def cell(name: str, root: str = ROOT) -> Dict:
    """The cell ``name`` with its configuration and traffic resolved."""
    w = load_json("workloads", name, root)
    return {**w, "name": name, "config": load_json("configs", w["config"], root),
            "traffic": {**load_json("traffic", w["traffic"], root), "name": w["traffic"]}}


def module(kind: str, name: str, root: str = ROOT):
    """The module ``<kind>/<name>.py`` (names may hold dots)."""
    key = f"pb_{kind}__{name}__{zlib.crc32(os.path.abspath(root).encode()):08x}".replace(".", "_")
    mod = sys.modules.get(key)
    if mod is None:
        spec = importlib.util.spec_from_file_location(key, os.path.join(root, kind, name + ".py"))
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        spec.loader.exec_module(mod)
    return mod


def benchmark(root: str = ROOT) -> Dict:
    """``BENCHMARK.json`` at the root of the checkout."""
    with open(os.path.join(os.path.dirname(root), "BENCHMARK.json")) as f:
        return json.load(f)


def metrics_of(bench: Dict, cell_name: str, trace: bool) -> List[Dict]:
    """The metrics a run of ``cell_name`` reports: the end-to-end ones
    untraced, the per-layer ones traced.  A metric without ``workloads``
    goes to every cell (a per-layer one: every cell that reports its
    ``moves``)."""
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or cell_name in m["workloads"]]
    if not trace:
        return e2e
    reported = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell_name in m["workloads"] if "workloads" in m else m["moves"] in reported)]
