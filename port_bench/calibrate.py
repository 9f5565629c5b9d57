#!/usr/bin/env python3
"""Readings that the limits of ``correct`` are set from, in one process:
a cell's compared numbers over many seeds of the program as configured,
and over a few seeds of the control (``run.run(..., control=True)``: the
program's int8 head section).  Short windows: the numbers judge the sampled calls, whose
count the cell fixes, not the window's length.

    python3 port_bench/calibrate.py --workload <cell> --seeds 12 --control-seeds 3 \
        --seconds 4 [--out chiprun_out/calibrate_<cell>.jsonl]

Prints one JSON line a run, then the largest sound reading and the
smallest control reading of every number."""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import run  # noqa: E402

FIRST_SEED = 1_000_003  # seeds FIRST_SEED + k * 7919; the driver's are drawn elsewhere


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--first-seed", type=int, default=FIRST_SEED)
    p.add_argument("--out", default="")
    a = p.parse_args(argv)
    runs = [(0, a.first_seed + k * 7919) for k in range(a.seeds)]
    runs += [(1, a.first_seed + 3 + k * 7919) for k in range(a.control_seeds)]
    sound, control = {}, {}
    out = open(a.out, "a") if a.out else None
    try:
        for ctl, seed in runs:
            t0 = time.perf_counter()
            args = run.parse(["--workload", a.workload, "--seed", str(seed), "--seconds",
                              str(a.seconds)])
            result, _, numbers = run.run(args, t0=t0, control=bool(ctl))
            line = {"workload": a.workload, "seed": seed, "control": ctl,
                    "numbers": numbers,
                    "metrics": {k: m["value"] for k, m in result["metrics"].items()},
                    "nms_runs_per_call": result["launches_per_call"].get("greedy_nms"),
                    "wall_s": time.perf_counter() - t0}
            print(json.dumps(line), flush=True)
            if out:
                out.write(json.dumps(line) + "\n")
                out.flush()
            into = control if ctl else sound
            for k, v in line["numbers"].items():
                into.setdefault(k, []).append(v)
    finally:
        if out:
            out.close()
    summary = {k: {"sound_max": max(v), "control_min": min(control.get(k, [float("nan")])),
                   "ratio": min(control.get(k, [float("nan")])) / max(max(v), 1e-30)}
               for k, v in sound.items()}
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
