#!/usr/bin/env python3
"""The benchmark of bayesian_yolov3_torch: one run of one cell on the card.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  Set-up (imports, the kernels' build or load,
seeded weights and inputs on the device, warm-up of the cell's shapes) is
``setup_s``; then the cell's entry is driven for ``--seconds``; after the
window the reference recomputes a seeded sample of what the window produced
and judges it.  ``--trace 1`` profiles a steady sub-window and reports the
per-layer metrics instead of the end-to-end ones.  The last line of
standard output is the result as JSON; the last lines of standard error
are every number compared with its limit.

Exits non-zero, printing no result, without a CUDA device (or with fewer
than the cell asks for), and when the process holds JAX or the JAX package
once the window has closed."""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import numpy as np  # noqa: E402
import torch  # noqa: E402

from bench_lib import cells, guard, timing, trace  # noqa: E402


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def window(sess, seconds: float, traced, trace_spec):
    """Drive ``sess.call`` until ``seconds`` have passed; a call started
    before the deadline is finished, counted and timed.  ``traced``: calls
    [first, first + calls) run under the profiler, made in full even past
    the deadline.  The calls before them are the plain ones that the traced
    run's host-clock metrics read: the profiler slows the calls it records
    and the ones after it."""
    first, n_traced = int(trace_spec["first_call"]), int(trace_spec["calls"])
    prof = rng = None
    images = i = 0
    traced_images = plain_images = 0
    plain_s = 0.0  # host seconds of the plain calls
    start = time.perf_counter()
    deadline = start + seconds
    while time.perf_counter() < deadline or (traced and first <= i < first + n_traced):
        if traced and i == first:
            prof = trace.profiler()
            prof.__enter__()
            rng = torch.profiler.record_function(trace.WINDOW)
            rng.__enter__()
        t0 = time.perf_counter()
        n = sess.call(i)
        images += n
        i += 1
        if i <= first or not traced:
            plain_images += n
            plain_s += time.perf_counter() - t0
        elif rng is not None:
            traced_images += n
            if i == first + n_traced:
                sess.finish()
                rng.__exit__(None, None, None)
                prof.__exit__(None, None, None)
                rng = None
    sess.finish()
    seconds_run = time.perf_counter() - start
    return {"calls": i, "images": images, "seconds": seconds_run,
            "plain_images": plain_images, "plain_seconds": plain_s,
            "traced_images": traced_images, "traced_calls": min(max(i - first, 0), n_traced) if traced else 0,
            "prof": prof}


def run(args, device: str = "cuda", overrides=None, root: str = HERE, t0: float = T0,
        control: bool = False):
    """One run; returns (result, checks, every number the judge read).  ``overrides`` ({"config": {...},
    "traffic": {...}}) resizes a cell for the CPU tests.  ``control`` (never a cell's run) puts the
    program's int8 head section in place of the bf16 one: the precision below the one the
    configuration states, which the comparison has to refuse."""
    overrides = overrides or {}
    t_run = time.perf_counter()
    bench = cells.benchmark(root)
    cell = cells.cell(args.workload, root)
    cfg = {**cell["config"], **overrides.get("config", {})}
    traffic = {**cell["traffic"], **overrides.get("traffic", {})}
    driver = cells.module("drivers", traffic["entry"], root)
    ctx = {"config": cfg, "traffic": traffic, "check": cell["check"], "seed": args.seed,
           "device": device, "control": bool(control)}
    sess = driver.Session(ctx)
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    counters0 = sess.counters()
    w = window(sess, args.seconds, bool(args.trace), traffic["trace"])
    counters = {k: (v - counters0.get(k, 0)) / max(w["calls"], 1)
                for k, v in sess.counters().items()}
    peak = torch.cuda.max_memory_allocated() if cuda else 0  # the window's, before the rest
    prof = w.pop("prof")
    tr = trace.export(prof) if prof is not None else None
    layers = sess.layers() if args.trace and cuda else {}
    sess.release()
    numbers = sess.check()
    limits = cell["check"]["limits"]
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    rec = {"cell": cell["name"], "config": cfg, "traffic": traffic, "kind": driver.KIND,
           "setup_s": setup_s, "run": w, "calls": sess.calls, "layers": layers, "trace": tr,
           "image_hw": sess.image_hw, "batch": sess.nb, "root": root}
    metrics = {}
    for m in cells.metrics_of(bench, cell["name"], bool(args.trace)):
        v = cells.module("metrics", m["name"], root).read(rec)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name() if cuda else "cpu",
           "count": int(cell.get("chips", 1)), "memory_peak_bytes": int(peak)}
    if cuda:
        dev["power_limit"] = timing.card().get("power_limit", "not read")
    result = {"correct": all(c["value"] <= c["limit"] for c in checks.values()),
              "attempted": w["calls"], "failed": 0, "metrics": metrics, "device": dev}
    if tr:
        dev.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        result["breakdown"] = {"device_ops": trace.top(tr["device_ops"]),
                               "idle_gaps": trace.top(tr["idle_gaps"])}
    result["launches_per_call"] = counters
    result["setup_parts"] = {"imports_s": t_run - t0, **getattr(sess, "setup_parts", {})}
    result["checks"] = checks
    return result, checks, numbers


def main(argv=None) -> int:
    args = parse(argv)
    cell = cells.cell(args.workload)
    chips = int(cell.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"port_bench: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 2
    result, checks, _ = run(args)
    bad = guard.forbidden_loaded()
    if bad:
        print(f"port_bench: the process holds {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result, default=_jsonable), flush=True)
    return 0


def _jsonable(x):
    if isinstance(x, (np.integer, np.floating)):
        return x.item()
    raise TypeError(type(x))


if __name__ == "__main__":
    sys.exit(main())
