"""Populations on the whole-iteration engines of frei_tpu_torch, and the
benchmark's plain references of the cells that run them, on the CPU in
float64.

* a population of five planets on ``"iteration"`` and ``"loop"`` (their
  kernels' plain twins here), column by column bit for bit each
  planet's shared-planet solve of the same five profiles on the same
  engine (of one profile alone the twins' batched contractions may round
  otherwise, 1.5e-12 relative here; the card's kernels are held against
  one column alone in tests/test_torch_cuda.py), with one species (mock
  chemistry) and four in equilibrium (an (8, 6) table), and against the
  ``"eager"`` population solve (rtol 1e-10, the tolerance of
  tests/test_torch_population.py; max |dT|, a difference of
  temperatures, to 1e-10 of the temperatures);
* ``benchmark/reference/rt_population_eq`` (cell ``pop4sp_eq_loop``)
  and ``rt_converge`` (cell ``hj_converge``) against the port, through
  the cells' own entries at a small size, within the cells' limits;
  ``rt_converge`` stops each column at the port's iteration count;
* faults planted in the program, each of which has to fail its gap:
  every column reading row 0 of F_toa, one g for every column where
  each has its own, the freeze ignored, the flip count off by one.

The cells' configurations are cut here to 64 bins and 12 layers (the
equilibrium table to 8 x 6 nodes), but for ``hj_converge``'s flip
fault, which needs the cell's own grid: only there do some columns stop
by their zero crossings.
"""

import copy
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.harness import cell, chemistry, pieces, program  # noqa: E402
from benchmark.reference import case, inputs  # noqa: E402
from frei_tpu_torch import Planet, SolverConfig  # noqa: E402
from frei_tpu_torch.ops import iteration_cuda as ic  # noqa: E402
from frei_tpu_torch.parallel import solve_population  # noqa: E402
from frei_tpu_torch.rt.solver import solve_rc_batched  # noqa: E402
from frei_tpu_torch.stellar.irradiation import f_toa_rows  # noqa: E402

torch.set_num_threads(2)
SEED = 2 ** 31 + 4099
N_PLANETS = 5
#: the configuration of each chemistry's population
CONFIGS = {"mock": "population_r500_f64",
           "equilibrium": "population_4sp_eq_f64"}
FIELDS = ["flux", "final_temps", "temp_history", "dtaus", "max_dT_history",
          "loop_temps", "loop_F_up", "loop_F_down"]


def small_context(cell_name, config, columns, cut=True, **traffic):
    """``cell_name``'s run context at ``columns`` columns, on
    ``config`` cut (with ``cut``) to 64 bins, 12 layers and an (8, 6)
    equilibrium table."""
    cfg = copy.deepcopy(pieces.config(config))
    if cut:
        cfg["name"] += "_small"
        cfg["grid"].update(n_wl_bins=64, n_layers=12)
        if cfg["chemistry"]["kind"] == "equilibrium":
            cfg["chemistry"]["grid_shape"] = [8, 6]
    ctx = cell.Context(cell_name, SEED, "cpu", overrides={
        "columns": columns, "pool": 1, "check_calls": 1,
        "check_block": columns, **traffic})
    ctx.cfg, ctx.grid = cfg, inputs.grid_arrays(cfg["grid"])
    ctx.tables = case.opacity_tables(cfg, ctx.grid)
    return ctx


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def population(request):
    """A grid of the chemistry's configuration (one species, or four in
    equilibrium), five planets drawn from its bounds and their
    profiles."""
    ctx = small_context("pop4sp_eq_loop", CONFIGS[request.param],
                        N_PLANETS)
    grid = program.make_grid(ctx)
    if request.param == "equilibrium":
        chemistry.load(ctx, grid)
    pl = ctx.cfg["planet"]
    d = inputs.population(ctx.rng(1), N_PLANETS, pl["draws"])
    planets = [Planet(a_rstar=a, m_bar=pl["m_bar"], g=g, T_star=t,
                      alpha=al)
               for a, g, t, al in zip(*(x.tolist() for x in d))]
    T0, _ = program.profile_pool(ctx)
    return request.param, grid, planets, T0[0]


def _close(got, ref, rtol, what):
    """Every field of ``got`` within ``rtol`` of ``ref``'s; max |dT|, a
    difference of temperatures, within ``rtol`` of the temperatures."""
    scale = float(ref.final_temps.abs().max())
    for f in FIELDS:
        a, b = getattr(got, f), getattr(ref, f)
        atol = (rtol * scale if f == "max_dT_history"
                else 1e-14 * float(b.abs().max()))
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=rtol,
                                   atol=atol, err_msg=f"{what} {f}")
    for f in ("n_iterations", "converged"):
        assert torch.equal(getattr(got, f), getattr(ref, f)), (what, f)


@pytest.mark.parametrize("engine", ["iteration", "loop"])
def test_population_columns_are_shared_planet_solves(population, engine):
    """Column b of the population is, bit for bit, column b of planet
    b's shared-planet solve of the same profiles on the same engine: its
    F_toa row, g and alpha, from one shared-planet pack."""
    chem, grid, planets, T0 = population
    cfg = SolverConfig(n_timesteps=3, engine=engine)
    pop = solve_population(T0, grid, planets, cfg)
    lam = grid.rt_grid.lam_cm
    for b, p in enumerate(planets):
        row = f_toa_rows(lam, torch.tensor([p.T_star], dtype=torch.float64),
                         torch.tensor([p.a_rstar], dtype=torch.float64),
                         torch.float64)[0]
        one = solve_rc_batched(T0, grid._consts._replace(F_toa=row),
                               p.physics_params(), grid._kappa_fn, cfg)
        for f, x in zip(pop._fields, pop):
            assert torch.equal(x[b], getattr(one, f)[b]), (chem, b, f)


@pytest.mark.parametrize("engine", ["iteration", "loop"])
def test_population_on_kernel_engines_matches_eager(population, engine):
    """The population on a whole-iteration engine against the eager
    population solve, with frei's default exits on so that the freeze
    runs (rtol 1e-10)."""
    chem, grid, planets, T0 = population
    cfg = SolverConfig(n_timesteps=6, convergence_dT=50.0)
    got = solve_population(T0, grid, planets, cfg._replace(engine=engine))
    ref = solve_population(T0, grid, planets, cfg._replace(engine="eager"))
    _close(got, ref, 1e-10, f"{chem} {engine}")


def _run(ctx):
    """One kept call of the cell's entry and its gaps against the
    reference, judged by the cell's limits: (gaps, correct)."""
    entry = pieces.entry(ctx.traffic["entry"])
    state = entry.prepare(ctx)
    rec = entry.call(ctx, state, 0, True)
    gaps = entry.gaps(ctx, rec, entry.reference(ctx, rec, torch.float64))
    judged = cell.judged(gaps, ctx.limits)
    return gaps, all(c["value"] <= c["limit"] for c in judged.values())


@pytest.mark.parametrize("engine", ["loop", "eager"])
def test_rt_population_eq_matches_the_port(engine):
    """``pop4sp_eq_loop``'s entry against ``rt_population_eq``: flux,
    temperatures, the layer table and each planet's F_toa, g and alpha
    within the cell's limits, on the loop twin and the eager engine."""
    ctx = small_context("pop4sp_eq_loop", "population_4sp_eq_f64", 4,
                        iterations=3, engine=engine)
    gaps, ok = _run(ctx)
    assert ok, gaps
    assert set(gaps) == set(ctx.limits), gaps
    assert gaps["flux_gap"] < 1e-12 and gaps["chem_gap"] < 1e-10, gaps


@pytest.mark.parametrize("engine", ["loop", "eager"])
def test_rt_converge_stops_each_column_where_the_port_does(engine):
    """``hj_converge``'s entry against ``rt_converge`` under frei's
    default exits: every column's iteration count the port's, the flux
    and temperatures within the cell's limits, and the counts apart (the
    columns freeze apart)."""
    ctx = small_context("hj_converge", "hot_jupiter_r500_f64", 8,
                        engine=engine)
    entry = pieces.entry(ctx.traffic["entry"])
    state = entry.prepare(ctx)
    rec = entry.call(ctx, state, 0, True)
    ref = entry.reference(ctx, rec, torch.float64)
    n = rec["out"]["n_iterations"]
    assert torch.equal(n.long(), ref["n_iterations"]), (n, ref)
    assert len(set(n.tolist())) > 1 and int(n.max()) < 150, n
    assert ctx.spans["n_iterations"] == [float(n.double().mean())]
    gaps = entry.gaps(ctx, rec, ref)
    assert gaps["iters_gap"] == 0.0 and all(
        c["value"] <= c["limit"]
        for c in cell.judged(gaps, ctx.limits).values()), gaps


def _row0(x):
    """Row 0 of a per-column tensor, given to every column."""
    return x[:1].expand_as(x).contiguous()


def _f_toa_row0(monkeypatch):
    """Every column's loop reads row 0 of F_toa."""
    inner = ic.make_iteration_pack

    def pack(*args):
        p = inner(*args)
        return p._replace(sc=p.sc._replace(f_toa=_row0(p.sc.f_toa)))
    monkeypatch.setattr(ic, "make_iteration_pack", pack)


def _g_shared(monkeypatch):
    """The loop gives every column column 0's g (its dtau factors and
    its physics)."""
    inner = ic.rc_loop_kernel

    def loop(temps, F_up, F_down, pack, params, *args):
        sc = pack.sc._replace(dtf_emit=_row0(pack.sc.dtf_emit),
                              dtf_absorb=_row0(pack.sc.dtf_absorb))
        return inner(temps, F_up, F_down, pack._replace(sc=sc),
                     params._replace(g=_row0(params.g)), *args)
    monkeypatch.setattr(ic, "rc_loop_kernel", loop)


def _exits_changed(monkeypatch, flips=0, freeze=True):
    """The loop with its flip threshold moved by ``flips``, or without
    ``freeze`` both exits off."""
    inner = ic.rc_loop_kernel

    def loop(temps, F_up, F_down, pack, params, n, n_zc, dT, *args):
        if not freeze:
            n_zc, dT = 10 ** 6, 0.0
        return inner(temps, F_up, F_down, pack, params, n, n_zc + flips,
                     dT, *args)
    monkeypatch.setattr(ic, "rc_loop_kernel", loop)


@pytest.mark.parametrize("fault", ["f_toa_row0", "g_shared"])
def test_population_fault_fails_its_gap(fault, monkeypatch):
    """A loop that reads one planet's F_toa or g for every column: the
    rows the call handed on are right, the answers are not."""
    {"f_toa_row0": _f_toa_row0, "g_shared": _g_shared}[fault](monkeypatch)
    ctx = small_context("pop4sp_eq_loop", "population_4sp_eq_f64", 4,
                        iterations=3)
    gaps, ok = _run(ctx)
    assert not ok, gaps
    lim = ctx.limits
    for k in ("ftoa_gap", "g_gap", "alpha_gap", "chem_gap"):
        assert gaps[k] <= lim[k]["limit"], (k, gaps)
    assert gaps["temps_gap"] > lim["temps_gap"]["limit"], gaps


@pytest.mark.parametrize("fault", ["freeze_ignored", "flips_off_by_one"])
def test_converge_fault_fails_iters_gap(fault, monkeypatch):
    """A loop that runs every column to the cap, or counts one zero
    crossing too many, stops columns where the reference does not."""
    if fault == "freeze_ignored":
        _exits_changed(monkeypatch, freeze=False)
        ctx = small_context("hj_converge", "hot_jupiter_r500_f64", 4)
    else:
        _exits_changed(monkeypatch, flips=-1)
        ctx = small_context("hj_converge", "hot_jupiter_r500_f64", 16,
                            cut=False)
    gaps, ok = _run(ctx)
    assert not ok, gaps
    assert gaps["iters_gap"] > ctx.limits["iters_gap"]["limit"], gaps
