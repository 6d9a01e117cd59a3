"""No run imports JAX or the JAX package, and the reference imports
nothing of the program: each checked in a fresh interpreter by the
top-level module names (the part before the first dot), compared
whole, after importing what a run imports."""

import json
import subprocess
import sys

import pytest

from benchmark.harness import pieces

PROBE = """
import json, sys
sys.path.insert(0, {root!r})
for name in {modules!r}:
    __import__(name)
{extra}
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def top_level_names(modules, extra=""):
    code = PROBE.format(root=str(pieces.ROOT), modules=modules, extra=extra)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=pieces.ROOT)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_reference_imports_no_program_and_no_jax():
    names = top_level_names([
        "benchmark.reference.answers", "benchmark.reference.case",
        "benchmark.reference.counts", "benchmark.reference.inputs",
        "benchmark.reference.rt"])
    assert not names & {"frei_tpu_torch", "frei_tpu", "jax", "jaxlib",
                        "flax"}


def test_the_whole_harness_and_its_program_import_no_jax():
    man = pieces.manifest()
    extra = "\n".join(
        ["from benchmark.harness import pieces, cell, trace, program",
         "import benchmark.run, benchmark.tools.calibrate",
         "import frei_tpu_torch, frei_tpu_torch.parallel"]
        + [f"pieces.entry({pieces.traffic(w['traffic'])['entry']!r})"
           for w in man["workloads"]]
        + [f"pieces.reader({m['name']!r})"
           for m in man["end_to_end"] + man["per_layer"]])
    names = top_level_names(["benchmark.harness.pieces"], extra)
    assert "frei_tpu_torch" in names
    assert not names & {"frei_tpu", "jax", "jaxlib", "flax"}


@pytest.mark.parametrize("held, found", [
    (["frei_tpu_torch.api", "jaxtyping"], []),
    (["frei_tpu.rt.solver", "numpy"], ["frei_tpu"]),
    (["jax.numpy", "jaxlib"], ["jax", "jaxlib"]),
])
def test_forbidden_modules_compares_whole_top_level_names(monkeypatch,
                                                          held, found):
    import benchmark.run as run
    fake = dict.fromkeys(held)
    monkeypatch.setattr(run.sys, "modules", fake)
    assert run.forbidden_modules() == found
