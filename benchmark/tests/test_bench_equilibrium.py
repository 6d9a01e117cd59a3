"""The four-species equilibrium deployment (``hot_jupiter_4sp_eq_f64``,
cell ``hj4sp_eq_loop``): the reference's own equilibrium solve against
frei's goldens and the port's exact solver, the port against the
reference at the cell's limits on a test-only configuration, the
faults that only equilibrium tables can show, and the pieces the cell
reads."""

import copy
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.harness import cell, pieces
from benchmark.reference import case, equilibrium, inputs, rt_equilibrium
from benchmark.tests.test_bench_imports import top_level_names

CELL = "hj4sp_eq_loop"
LIMITS = pieces.limits(CELL)
SPECIES = ("1H2-16O", "23Na", "39K", "48Ti-16O")
SEED = 2 ** 31 + 91
#: the reference's test profile (`frei/tests/test_chemistry.py:12-13`)
#: and frei's maximum-VMR goldens on it (`test_chemistry.py:45-67`)
P_BAR = np.logspace(-6, 2, 100)
T_K = 2400.0 * (P_BAR / 0.1) ** 0.1
GOLDEN_MAX_VMR = {"1H2-16O": 3e-4, "23Na": 3e-6, "39K": 1.8e-7,
                  "48Ti-16O": 1.4e-7}


def small_cfg():
    """The cell's configuration at a test size: 64 bins, 12 layers, an
    (8, 6) chemistry table over the same ranges."""
    cfg = copy.deepcopy(pieces.config("hot_jupiter_4sp_eq_f64"))
    cfg["name"] = "hot_jupiter_4sp_eq_f64_small"
    cfg["grid"].update(n_wl_bins=64, n_layers=12)
    cfg["chemistry"]["grid_shape"] = [8, 6]
    return cfg


def small_context(engine="loop", **traffic):
    """The cell's run context with ``small_cfg`` in place of its
    configuration: 4 columns, 3 iterations."""
    cfg = small_cfg()
    ctx = cell.Context(CELL, SEED, "cpu", overrides={
        "columns": 4, "iterations": 3, "pool": 1, "check_block": 4,
        "engine": engine, **traffic})
    ctx.cfg, ctx.grid = cfg, inputs.grid_arrays(cfg["grid"])
    ctx.tables = case.opacity_tables(cfg, ctx.grid)
    return ctx


def checked(ctx):
    """One kept call of the cell's entry and its gaps against the
    reference."""
    entry = pieces.entry(ctx.traffic["entry"])
    state = entry.prepare(ctx)
    rec = entry.call(ctx, state, 0, True)
    return entry.gaps(ctx, rec, entry.reference(ctx, rec, torch.float64))


def correct(gaps) -> bool:
    return all(c["value"] <= c["limit"]
               for c in cell.judged(gaps, LIMITS).values())


@pytest.fixture(scope="module")
def profile():
    return equilibrium.solve(equilibrium.load(), T_K, P_BAR)


def _index(th, iso):
    name = rt_equilibrium.fastchem_name(iso)
    if name in th.elements:
        return th.elements.index(name)
    return len(th.elements) + th.species.index(name)


@pytest.mark.parametrize("iso", SPECIES)
def test_reference_solve_matches_frei_goldens(profile, iso):
    """The reference's Newton solve on frei's 100-point profile: each
    species' largest VMR at frei's golden, rtol 0.1 (as the port's tests
    hold them)."""
    th = equilibrium.load()
    vmr = np.exp(profile[:, _index(th, iso)]) / P_BAR
    np.testing.assert_allclose(vmr.max(), GOLDEN_MAX_VMR[iso], rtol=0.1)


def test_reference_solve_matches_the_ports_exact_solver(profile):
    """The same profile against the port's ``"equilibrium-exact"``
    (its Gauss-Seidel solve, 60 sweeps from the atoms): VMRs at rtol
    1e-8."""
    from frei_tpu_torch.chemistry.fastchem import FastChemTorch
    th = equilibrium.load()
    model = FastChemTorch(SPECIES, case.m_bar_g({"planet": {
        "kind": "hot_jupiter"}}), mode="exact")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)    # thousands of tiny operations a sweep
    try:
        got = model.vmr(torch.tensor(T_K),
                        torch.tensor(P_BAR * 1e6)).numpy()
    finally:
        torch.set_num_threads(threads)
    for i, iso in enumerate(SPECIES):
        want = np.exp(profile[:, _index(th, iso)]) / P_BAR
        np.testing.assert_allclose(got[i], want, rtol=1e-8, err_msg=iso)


def test_every_node_is_solved_to_its_tolerance():
    """The residuals the reference's solve leaves at a table's coldest
    row, walked down from the atoms at ``T_HOT``: each relative residual
    at most 1e-12."""
    th = equilibrium.load()
    sy = equilibrium._System(th)
    P = np.logspace(-8, 3, 6)
    T = np.full(P.shape, 500.0)
    _, x = equilibrium.walk(th, np.full(P.shape, equilibrium.T_HOT), T, P,
                            sy=sy)
    F, _, _ = sy.residual(equilibrium.ln_k(th, T), np.log(P), x)
    assert np.abs(F).max() <= equilibrium.TOL == 1e-12


def test_names_of_the_species():
    assert [rt_equilibrium.fastchem_name(s) for s in SPECIES] == [
        "H2O1", "Na", "K", "O1Ti1"]
    with pytest.raises(ValueError, match="not in the thermochemical"):
        rt_equilibrium._table(("7Li-1H",), (2, 2), (5000, 6000), (1, 10))


def test_data_is_the_programs_file_byte_for_byte():
    ours = Path(equilibrium.DATA)
    program = (pieces.ROOT / "frei_tpu_torch" / "chemistry" / "data"
               / "chem_tables.npz")
    assert ours.read_bytes() == program.read_bytes()


def test_new_reference_modules_import_no_program_and_no_jax():
    names = top_level_names(["benchmark.reference.equilibrium",
                             "benchmark.reference.rt_equilibrium"])
    assert not names & {"frei_tpu_torch", "frei_tpu", "jax", "jaxlib",
                        "flax"}


@pytest.mark.parametrize("engine", ["eager", "loop"])
def test_port_agrees_at_the_cells_limits(engine):
    """The port's ``"eager"`` and ``"loop"`` (its CPU twin) at the test
    size against the reference, within the cell's limits."""
    gaps = checked(small_context(engine))
    assert correct(gaps), gaps


def test_control_fails_a_limit_and_chem_gap():
    """The reference in float32, its table rounded to float32, in the
    program's place: ``chem_gap`` fails, as the float32 chemistry the
    port stored before float64 grids got their own does."""
    ctx = small_context()
    entry = pieces.entry(ctx.traffic["entry"])
    rec = entry.call(ctx, entry.prepare(ctx), 0, True)
    ref = entry.reference(ctx, rec, torch.float64)
    low = dict(rec, out=entry.reference(ctx, rec, torch.float32))
    gaps = entry.gaps(ctx, low, ref)
    assert gaps["chem_gap"] > LIMITS["chem_gap"]["limit"], gaps


def rotated_species(patch):
    """The layer table's species in another order: each species read at
    its neighbour's mixing ratios."""
    from frei_tpu_torch.chemistry.fastchem import FastChemTorch
    inner = FastChemTorch.layer_ln_mmr_tables

    def rotated(self, pressures_cgs):
        grid, tab = inner(self, pressures_cgs)
        return grid, tab.roll(1, dims=-1).contiguous()
    patch(FastChemTorch, "layer_ln_mmr_tables", rotated)


def stored_in_float32(patch):
    """The table and its axes rounded to float32 wherever they are read:
    the port's chemistry before float64 grids got float64 tables."""
    from frei_tpu_torch.chemistry.fastchem import FastChemTorch
    inner = FastChemTorch._tables

    def rounded(self, device, dtype=torch.float32):
        return tuple(x.float().to(dtype) for x in inner(self, device, dtype))
    patch(FastChemTorch, "_tables", rounded)


@pytest.mark.parametrize("fault", [rotated_species, stored_in_float32])
def test_planted_chemistry_faults_are_caught(fault, monkeypatch):
    fault(monkeypatch.setattr)
    gaps = checked(small_context())
    assert not correct(gaps), gaps


def test_float32_layer_tables_in_a_float64_solve_are_refused(monkeypatch):
    """A program whose chemistry hands a float64 solve float32 layer
    tables (as the port's did) fails at set-up, before any call."""
    from frei_tpu_torch.chemistry.fastchem import FastChemTorch
    inner = FastChemTorch.layer_ln_mmr_tables

    def float32(self, pressures_cgs):
        return tuple(x.float() for x in inner(self, pressures_cgs))
    monkeypatch.setattr(FastChemTorch, "layer_ln_mmr_tables", float32)
    ctx = small_context()
    with pytest.raises(RuntimeError, match="needs float64 chemistry"):
        pieces.entry(ctx.traffic["entry"]).prepare(ctx)


def test_chemistry_metrics_read_the_solves_own_spans():
    """A traced window of one call at the test size, kept for the check:
    ``chem_layer_ms`` counts the layer-table span inside the solve, not
    the entry's copy for the check; ``chem_build_s`` is the model's own
    build wall."""
    from benchmark.harness import spans
    ctx = small_context()
    entry = pieces.entry(ctx.traffic["entry"])
    state = entry.prepare(ctx)
    w = cell.run_window(ctx, entry, state, 0.0, profile_calls=1)
    run = cell.Run(ctx, w, 0.0)
    assert len(w.walls) == len(w.kept) == 1
    layer = spans.named(w.trace, "frei.chemistry.layer_tables")
    (solve,) = spans.named(w.trace, "frei.solve")
    assert len(layer) == 2
    inside = [(s, e) for s, e in layer if solve[0] <= s and e <= solve[1]]
    assert len(inside) == 1
    assert pieces.reader("chem_layer_ms").read(run) == pytest.approx(
        (inside[0][1] - inside[0][0]) / 1e6)
    build = pieces.reader("chem_build_s").read(run)
    assert build == state.chem.build_seconds > 0


def test_cell_declares_its_metrics():
    man = pieces.manifest()
    layer = {m["name"]: m for m in man["per_layer"]
             if CELL in m["workloads"]}
    assert set(layer) == {"rc_loop_roofline", "device_ops_per_solve",
                          "idle_share.forward", "chem_build_s",
                          "chem_layer_ms"}
    assert layer["chem_build_s"]["moves"] == "setup_s"
    assert layer["chem_layer_ms"]["moves"] == "spectra_rate"
    e2e = {m["name"] for m in pieces.metrics_of(man, CELL, "end_to_end")}
    assert e2e == {"setup_s", "spectra_rate"}
    assert pieces.cell(man, CELL)["chips"] == 1
