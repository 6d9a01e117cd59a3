"""The per-layer metrics that read the program's own spans
(``benchmark/harness/spans.py``): a traced CPU run of each cell at
``test_bench_faults.py``'s small sizes reports them, and the spans name
idle time but are never counted as the device's work."""

import contextlib
import time

import pytest

from benchmark import run
from benchmark.harness import pieces, spans
from benchmark.tests.test_bench_faults import SEED, SMALL

MAN = pieces.manifest()
#: seconds each planet's F_toa row takes in the slowed build
SLOW_ROW_S = 0.5
SPAN_METRICS = {m["name"]: m["workloads"] for m in MAN["per_layer"]
                if m["source"] == "program_span"}


def traced(cell, device="cpu", **overrides):
    return run.execute(MAN, cell, SEED, 0.2, True, device,
                       {**SMALL, **overrides})


@pytest.fixture(scope="module")
def slow_build_run():
    """A traced ``pop_auto_f64`` run of one iteration a call, warmed up
    by one call, whose population build outlasts the rest of the call
    (the planets' F_toa rows, built in one call, slowed by SLOW_ROW_S a
    planet), so that the middle of the window, idle on the CPU, lies in
    it."""
    import frei_tpu_torch.parallel.solve as psolve
    mp = pytest.MonkeyPatch()
    inner = psolve.f_toa_rows

    def slow(lam_cm, T_star, *args):
        time.sleep(SLOW_ROW_S * len(T_star))
        return inner(lam_cm, T_star, *args)
    mp.setattr(psolve, "f_toa_rows", slow)
    try:
        yield traced("pop_auto_f64", iterations=1, warmup_calls=1)
    finally:
        mp.undo()


def test_span_metrics_are_declared_for_their_cells():
    assert SPAN_METRICS == {"population_build_ms": ["pop_auto_f64"],
                            "iteration_host_ms": ["pop_auto_f64"],
                            "recompute_s": ["hj_grad"]}


def test_population_cell_reports_its_span_metrics(slow_build_run):
    res = slow_build_run
    assert res["correct"], res["checks"]
    m = res["metrics"]
    # two planets a call, each row slowed
    build = m["population_build_ms"]["value"]
    assert 2 * SLOW_ROW_S * 1e3 <= build < 2 * SLOW_ROW_S * 1e3 + 500
    assert 0 < m["iteration_host_ms"]["value"] < build


def test_population_build_names_the_idle_gap(slow_build_run):
    res = slow_build_run
    names = [n for n, _ in res["breakdown"]["idle_gaps"]]
    assert any(n.startswith("frei.") for n in names), res
    assert names[0] == "frei.population.build", res


def test_gradient_cell_reports_recompute_s():
    res = traced("hj_grad")
    assert res["correct"], res["checks"]
    m = res["metrics"]
    assert 0 < m["recompute_s"]["value"] < m["backward_s"]["value"]


@pytest.mark.parametrize("device", ["cpu", pytest.param(
    "cuda", marks=pytest.mark.cuda)])
def test_spans_are_not_device_operations(device, monkeypatch):
    """``device_ops_per_solve.host`` reads the same with the program's
    spans as with each span the null context, to within the wobble of
    under one operation a call that the card shows between runs (a span
    counted as the device's work would add 82 a call), and no span's
    projection onto the device's timeline is among its operations."""
    import torch

    from benchmark.harness import cell, trace
    from frei_tpu_torch.diag import telemetry
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the device trace of the card")
    kept = []
    stop = trace.stop

    def keep(prof):
        kept.append(stop(prof))
        return kept[-1]
    monkeypatch.setattr(trace, "stop", keep)
    on = traced("pop_auto_f64", device, warmup_calls=1)
    with monkeypatch.context() as m:
        m.setattr(telemetry, "span", lambda name: contextlib.nullcontext())
        off = traced("pop_auto_f64", device, warmup_calls=1)
    with_spans, without = kept
    assert any(n.startswith("frei.") for n, _, _ in with_spans.host)
    assert not any(n.startswith("frei.") for n, _, _ in without.host)
    assert not {n for n, _, _ in with_spans.device
                if n.startswith("frei.") or n == cell.CALL_SPAN}
    ops_on = on["metrics"].get("device_ops_per_solve.host")
    ops_off = off["metrics"].get("device_ops_per_solve.host")
    assert (ops_on is None) == (ops_off is None) == (device == "cpu")
    if ops_on is not None:
        assert abs(ops_on["value"] - ops_off["value"]) < 1, (ops_on, ops_off)
    assert "population_build_ms" not in off["metrics"]


@pytest.mark.parametrize("intervals, want", [
    ([], 0),
    ([(0, 10)], 10),
    ([(0, 10), (2, 5), (3, 12)], 12),
    ([(0, 4), (6, 9), (8, 8)], 7),
])
def test_union_counts_nested_spans_once(intervals, want):
    assert spans.union_ns(sorted(intervals)) == want
