"""Each cell run on the card for a short window, as the driver runs it:
one JSON result line, correct, the cell's metrics reported.  Marked
``cuda``; without a card each test skips with the reason."""

import json
import subprocess
import sys

import pytest

from benchmark.harness import pieces

MAN = pieces.manifest()
CELLS = [w["name"] for w in MAN["workloads"]]


def needs_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the benchmark measures the card")


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_on_the_card(cell, trace):
    needs_card()
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         str(2 ** 31 + 5), "--seconds", "3", "--trace", str(trace)],
        capture_output=True, text=True, cwd=pieces.ROOT, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    kind = "per_layer" if trace else "end_to_end"
    want = {m["name"] for m in pieces.metrics_of(MAN, cell, kind)}
    assert set(res["metrics"]) == want
    assert res["device"]["platform"] == "gpu"
