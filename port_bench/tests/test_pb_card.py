"""On the card, at each cell's own size: a run of the program as configured
is correct, and its control -- the program's int8 head section, the
precision below the configuration's bf16 -- is not.  Run on a machine with
a card: ``python -m pytest port_bench/tests -m card``."""

import pytest

import run
from bench_lib import cells

CELLS = [w["name"] for w in cells.benchmark()["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("control", [0, 1])
def test_control_is_refused(card, cell, control):
    args = run.parse(["--workload", cell, "--seed", str(2**31 + 333), "--seconds", "3"])
    result, checks, _ = run.run(args, control=bool(control))
    assert result["correct"] == (not control), checks
