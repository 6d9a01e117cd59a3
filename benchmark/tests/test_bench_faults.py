"""A run with the timed path broken underneath comes out not correct,
and so does the control; a sound run comes out correct.  Each drives
``run.execute`` on the CPU (the look for a card skipped) at two columns
with the cell's own limits; the faults are ``tools/faults.py``'s."""

import numpy as np
import pytest

from benchmark import run
from benchmark.harness import pieces
from benchmark.tools import calibrate, faults

MAN = pieces.manifest()
CELLS = [w["name"] for w in MAN["workloads"]]
#: the cells whose timed path runs a backward
GRAD_CELLS = [c for c in CELLS if pieces.traffic(
    pieces.cell(MAN, c)["traffic"])["entry"] == "grad_step"]
SMALL = {"columns": 2, "pool": 1, "warmup_calls": 0, "check_calls": 1,
         "check_block": 2, "grad_check_columns": 2, "grad_check_block": 2}
SEED = 2 ** 31 + 77


def execute(cell):
    return run.execute(MAN, cell, SEED, 0.2, False, "cpu", SMALL)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    res = execute(cell)
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("fault", faults.FORWARD)
@pytest.mark.parametrize("cell", CELLS)
def test_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch.setattr)
    res = execute(cell)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("fault", faults.BACKWARD)
@pytest.mark.parametrize("cell", GRAD_CELLS)
def test_broken_backward_is_not_correct(cell, fault, monkeypatch):
    """The backward broken, the forward intact: the loss still agrees
    and the gradient has to fail."""
    fault(monkeypatch.setattr)
    res = execute(cell)
    assert not res["correct"], res["checks"]
    c = res["checks"]
    assert c["loss_gap"]["value"] <= c["loss_gap"]["limit"], c
    assert c["grad_gap"]["value"] > c["grad_gap"]["limit"], c


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_a_limit(cell):
    ctx, entry, kept = calibrate.kept_calls(MAN, cell, SEED, "cpu", SMALL)
    gaps = calibrate.readings(ctx, entry, kept, control=True)
    over = {k: v for k, v in gaps.items() if v > ctx.limits[k]["limit"]}
    assert over, gaps
    assert all(np.isfinite(v) for v in gaps.values())
