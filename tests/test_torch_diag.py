"""Diagnostics, telemetry, checkpoints and the stellar comparison of
frei_tpu_torch, mirroring ``tests/test_diag.py``, against frei_tpu.

* ``diag/plot.py``: the contribution function (normalized, and equal to
  the JAX package's on the same arrays), the five-panel dashboard
  (matplotlib's Agg backend) through ``Grid.emission_dashboard``, with
  a blackbody comparison;
* ``stellar/phoenix.py``: binning and the blackbody stand-in against
  the JAX package's, and the ``expecto`` ``ImportError``;
* ``diag/telemetry.py``: ``SolveMetrics``, the progress line,
  ``flux_balance`` against the JAX package's on the same results,
  ``profile_trace``, ``enable_nan_debugging``, and the ``frei.*`` spans
  (recorded under the profiler where the work happens, the null context
  without one);
* ``io/checkpoint.py``: the npz round trip, an exact 3 + 3 resume, and
  files crossing between the packages (rtol 1e-9 against the port's
  own run where a JAX solve wrote the file: the eager and xla engines
  sum the quadratures in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import frei_tpu  # noqa: E402
from frei_tpu.diag import plot as j_plot  # noqa: E402
from frei_tpu.diag import telemetry as j_tel  # noqa: E402
from frei_tpu.io import checkpoint as j_ckpt  # noqa: E402
from frei_tpu.rt.solver import SolverConfig as JConfig  # noqa: E402
from frei_tpu.rt.solver import solve_rc_batched as j_solve  # noqa: E402
from frei_tpu.stellar import phoenix as j_phoenix  # noqa: E402
from frei_tpu_torch import Grid, Planet, load_example_opacity  # noqa: E402
from frei_tpu_torch.diag import telemetry  # noqa: E402
from frei_tpu_torch.diag.plot import (contribution_function,  # noqa: E402
                                      dashboard)
from frei_tpu_torch.io import convert  # noqa: E402
from frei_tpu_torch.io.checkpoint import (load_solution,  # noqa: E402
                                          resume_state, save_solution)
from frei_tpu_torch.rt.solver import (SolverConfig,  # noqa: E402
                                      solve_rc_batched)
from frei_tpu_torch.stellar.phoenix import (  # noqa: E402
    bin_spectrum_mean, get_binned_blackbody_spectrum,
    get_binned_phoenix_spectrum)

torch.set_num_threads(2)
F64 = torch.float64


def _grid(W, L):
    grid = Grid(Planet.from_hot_jupiter(), n_wl_bins=W, n_layers=L,
                T_ref=2400.0, dtype=F64, device="cpu")
    grid.load_opacities(opacities=load_example_opacity(
        grid, scale_factor=1.0, dtype=F64))
    return grid


@pytest.fixture(scope="module")
def solved_grid():
    grid = _grid(48, 8)
    spec, temps, hist, dtaus = grid.emission_spectrum(n_timesteps=2)
    return grid, spec, temps, hist, dtaus


@pytest.fixture
def plt():
    mpl = pytest.importorskip("matplotlib")
    mpl.use("Agg")
    import matplotlib.pyplot as plt
    yield plt
    plt.close("all")


def test_contribution_function_normalized(solved_grid):
    grid, spec, temps, hist, dtaus = solved_grid
    cf = contribution_function(dtaus, grid.pressures, temps, grid.lam)
    assert cf.shape == (8, 48) and np.all(cf >= 0)
    np.testing.assert_allclose(cf.sum(axis=0), 1.0, rtol=1e-12)
    # the same arrays through the JAX package's (numpy) function
    np.testing.assert_allclose(
        cf, j_plot.contribution_function(dtaus, grid.pressures, temps,
                                         grid.lam), rtol=1e-12)


def test_dashboard_renders(solved_grid, plt):
    grid, spec, temps, hist, dtaus = solved_grid
    fig, ax = grid.emission_dashboard(spec, temps, hist, dtaus,
                                      plot_phoenix=False)
    assert len(ax) == 5
    assert ax[0].get_legend_handles_labels()[1] == ["frei_tpu_torch"]


def test_dashboard_with_blackbody_comparison(solved_grid, plt):
    grid, spec, temps, hist, dtaus = solved_grid
    bb = get_binned_blackbody_spectrum(2400.0, grid.wl_bins, grid.lam)
    assert bb.shape == (48,)
    np.testing.assert_allclose(bb, j_phoenix.get_binned_blackbody_spectrum(
        2400.0, grid.wl_bins, grid.lam), rtol=1e-14)
    fig, ax = dashboard(grid, spec, bb, dtaus, temps, hist)
    assert ax[0].get_legend_handles_labels()[1] == ["PHOENIX",
                                                    "frei_tpu_torch"]


def test_phoenix_requires_expecto(solved_grid):
    grid, spec, temps, hist, dtaus = solved_grid
    with pytest.raises(ImportError, match="expecto"):
        get_binned_phoenix_spectrum(2400.0, 24.79, grid.wl_bins, grid.lam)
    with pytest.raises(ImportError, match="expecto"):
        grid.emission_dashboard(spec, temps, hist, dtaus, T_eff=2400.0)


def test_bin_spectrum_mean():
    wav = np.linspace(1.0, 2.0, 101)
    flux = np.full(101, 7.0)
    edges = np.array([1.0, 1.25, 1.5, 3.0])
    out = bin_spectrum_mean(flux, wav, edges, 5)
    np.testing.assert_allclose(out[:3], 7.0)
    np.testing.assert_allclose(out[3:], 0.0)   # zero-padded tail
    # a ragged spectrum, bins with 0, 1 and many samples, as JAX bins it
    rng = np.random.RandomState(1)
    wav = np.sort(rng.uniform(0.5, 3.0, 400))
    flux = rng.uniform(0.0, 1.0, 400)
    edges = np.concatenate([[0.2, 0.3], np.linspace(0.6, 2.5, 30),
                            [wav[-2] + 1e-9, 3.5]])
    np.testing.assert_array_equal(
        bin_spectrum_mean(flux, wav, edges, 40),
        j_phoenix.bin_spectrum_mean(flux, wav, edges, 40))


def test_solve_metrics(solved_grid):
    grid, *_ = solved_grid
    m = grid.last_metrics
    assert m.n_iterations >= 1 and m.bins == 48
    assert "max|dT|" in m.summary()


def test_progress_callback(solved_grid, capsys):
    """``progress=True`` prints the reference's line through
    ``progress_printer``, one per iteration."""
    grid, *_ = solved_grid
    grid.emission_spectrum(n_timesteps=2, progress=True)
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 2 and all(
        "RC iter" in x and "max|dT|" in x for x in out), out
    telemetry.progress_printer(3, 1.5, 7, 8)
    assert capsys.readouterr().out == (
        "RC iter    3: max|dT| =     1.50 K; conv = 7/8\n")


def test_checkpoint_roundtrip(solved_grid, tmp_path):
    grid, *_ = solved_grid
    p = save_solution(tmp_path / "sol.npz", grid.last_result, note=[1, 2])
    state = load_solution(p)
    for f in grid.last_result._fields:
        np.testing.assert_array_equal(
            state[f], getattr(grid.last_result, f).numpy(), err_msg=f)
    np.testing.assert_array_equal(state["extra_note"], [1, 2])
    # the JAX package reads the port's file
    np.testing.assert_array_equal(j_ckpt.load_solution(p)["final_temps"],
                                  state["final_temps"])
    g2 = Grid(Planet.from_hot_jupiter(), n_wl_bins=48, n_layers=8,
              init_temperatures=state["final_temps"], dtype=F64,
              device="cpu")
    assert np.allclose(g2.init_temperatures, state["final_temps"])


@pytest.fixture(scope="module")
def resume_setup():
    """The JAX test's resume fixture (24 bins x 6 layers, three columns
    of the profile x U(0.95, 1.05), seed 4) in both packages, on the same
    opacity stack; convergence exits off, so the restarted statistics
    cannot change the stopping rule."""
    jg = frei_tpu.Grid(frei_tpu.Planet.from_hot_jupiter(), n_wl_bins=24,
                       n_layers=6, T_ref=2400.0, dtype=jnp.float64)
    jg.load_opacities(opacities=frei_tpu.load_example_opacity(
        jg, scale_factor=1.0, dtype=jnp.float64))
    grid = Grid(Planet.from_hot_jupiter(), n_wl_bins=24, n_layers=6,
                T_ref=2400.0, dtype=F64, device="cpu")
    grid.load_opacities(opacities=convert.to_opacity_stack(jg.opacities))
    rng = np.random.RandomState(4)
    T0 = np.asarray(grid.init_temperatures)[None, :] * rng.uniform(
        0.95, 1.05, (3, 1))
    args = (grid._consts, grid.planet.physics_params(), grid._kappa_fn)
    return jg, grid, T0, args


def _cfg(n, **kw):
    return dict(n_timesteps=n, n_zero_crossings=10 ** 6, convergence_dT=0.0,
                **kw)


def test_checkpoint_resume_is_exact(resume_setup, tmp_path):
    """3 iterations, saved, resumed for 3 more: the 6-iteration run bit
    for bit (the file carries the pre-final-emit loop state)."""
    _, grid, T0, args = resume_setup
    T0 = torch.tensor(T0)
    full = solve_rc_batched(T0, *args, SolverConfig(**_cfg(6)))
    part = solve_rc_batched(T0, *args, SolverConfig(**_cfg(3)))
    save_solution(tmp_path / "ckpt.npz", part)
    temps, fluxes = resume_state(tmp_path / "ckpt.npz", device="cpu")
    resumed = solve_rc_batched(temps, *args, SolverConfig(**_cfg(3)),
                               init_fluxes=fluxes)
    for f in ("flux", "final_temps", "F_up", "F_down", "loop_temps"):
        assert torch.equal(getattr(full, f), getattr(resumed, f)), f


def test_resume_from_jax_checkpoint(resume_setup, tmp_path):
    """A file that the JAX package's ``save_solution`` wrote after 3
    iterations, resumed by the port for 3 more, reaches the port's own
    6-iteration run at rtol 1e-9."""
    jg, grid, T0, args = resume_setup
    part = j_solve(jnp.asarray(T0), jg._consts, jg.planet.physics_params(),
                   jg._kappa_fn, JConfig(engine="xla", **_cfg(3)))
    j_ckpt.save_solution(tmp_path / "jax.npz", part, run="jax")
    assert str(load_solution(tmp_path / "jax.npz")["extra_run"]) == "jax"
    temps, fluxes = resume_state(tmp_path / "jax.npz", device="cpu")
    assert temps.dtype == F64
    resumed = solve_rc_batched(temps, *args, SolverConfig(**_cfg(3)),
                               init_fluxes=fluxes)
    full = solve_rc_batched(torch.tensor(T0), *args,
                            SolverConfig(**_cfg(6)))
    for f in ("flux", "final_temps", "F_up", "F_down"):
        a = getattr(full, f).numpy()
        np.testing.assert_allclose(getattr(resumed, f).numpy(), a,
                                   rtol=1e-9,
                                   atol=1e-12 * float(np.abs(a).max()),
                                   err_msg=f)


def test_flux_balance_matches_jax(resume_setup):
    """``flux_balance`` per column on a JAX result carried over by
    ``to_rt_result`` equals the JAX package's on the original, and the
    port's own result agrees at rtol 1e-9; more iterations lower it."""
    jg, grid, T0, args = resume_setup
    jres = j_solve(jnp.asarray(T0), jg._consts, jg.planet.physics_params(),
                   jg._kappa_fn, JConfig(engine="xla", **_cfg(2)))
    tres = convert.to_rt_result(jres)
    assert all(torch.is_tensor(x) for x in tres)
    assert tres.converged.dtype == torch.bool
    assert tres.n_iterations.dtype == torch.int32
    want = j_tel.flux_balance(jres, jg._consts.trapz_w)
    got = telemetry.flux_balance(tres, grid._consts.trapz_w)
    assert got.shape == (3,) and np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=1e-13)
    own = solve_rc_batched(torch.tensor(T0), *args, SolverConfig(**_cfg(2)))
    np.testing.assert_allclose(
        telemetry.flux_balance(own, grid._consts.trapz_w), want, rtol=1e-9)
    more = solve_rc_batched(torch.tensor(T0), *args,
                            SolverConfig(**_cfg(40)))
    assert np.all(telemetry.flux_balance(more, grid._consts.trapz_w) < got)


def test_profile_trace_writes_a_trace(resume_setup, tmp_path):
    _, grid, T0, args = resume_setup
    with telemetry.profile_trace(tmp_path / "trace") as prof:
        solve_rc_batched(torch.tensor(T0), *args, SolverConfig(n_timesteps=1))
    files = list((tmp_path / "trace").glob("*.json"))
    assert len(files) == 1 and files[0].stat().st_size > 0
    assert any("aten::" in e.key for e in prof.key_averages())
    # the program's spans reach the Chrome trace
    assert '"frei.solver.iteration"' in files[0].read_text()


def test_nan_debugging(resume_setup):
    """Off by default: a NaN temperature runs through silently.  On, the
    solve and the standalone drivers raise ``FloatingPointError`` naming
    the sweep and the iteration."""
    from frei_tpu_torch import emit
    _, grid, T0, args = resume_setup
    T = torch.tensor(T0)
    T[1, 2] = float("nan")
    assert not telemetry._NAN_CHECKS
    res = solve_rc_batched(T, *args, SolverConfig(n_timesteps=2))
    assert not torch.isfinite(res.final_temps).all()
    telemetry.enable_nan_debugging()
    try:
        assert torch.is_anomaly_enabled() and torch.is_anomaly_check_nan_enabled()
        with pytest.raises(FloatingPointError,
                           match="emit sweep of iteration 0"):
            solve_rc_batched(T, *args, SolverConfig(n_timesteps=2))
        with pytest.raises(FloatingPointError,
                           match="emit sweep of timestep 0"):
            emit(T[1], *args, n_timesteps=2)
        # finite inputs still solve
        solve_rc_batched(torch.tensor(T0), *args, SolverConfig(n_timesteps=1))
    finally:
        telemetry.enable_nan_debugging(False)
    assert not torch.is_anomaly_enabled()


def _profiled_spans(fn):
    """Run ``fn`` under ``torch.profiler`` (CPU): its result and the
    ``frei.*`` spans recorded, as (name, start_us, end_us)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = [(e.name, e.time_range.start, e.time_range.end)
             for e in prof.events() if e.name.startswith("frei.")]
    return out, spans


def _named(spans, name):
    return [(s, e) for n, s, e in spans if n == name]


def test_spans_of_a_population_solve(resume_setup):
    """A population solve of 2 columns x 3 iterations under the profiler:
    one ``frei.population.build``, ended before the one ``frei.solve``
    that holds the three ``frei.solver.iteration`` and the two
    per-iteration reads between them."""
    from frei_tpu_torch.parallel import solve_population
    _, grid, T0, _ = resume_setup
    planets = [Planet.from_hot_jupiter(),
               Planet(a_rstar=6.0, m_bar=2.4, g=15.0, T_star=5500.0)]
    _, spans = _profiled_spans(lambda: solve_population(
        torch.tensor(T0[:2]), grid, planets, SolverConfig(**_cfg(3))))
    (build,) = _named(spans, "frei.population.build")
    (solve,) = _named(spans, "frei.solve")
    its = _named(spans, "frei.solver.iteration")
    reads = _named(spans, "frei.solver.host_read")
    assert len(its) == 3 and len(reads) == 2, spans
    assert build[1] <= solve[0]
    assert all(solve[0] <= s and e <= solve[1] for s, e in its + reads)
    # each read lies between two iterations
    for (s, e), before, after in zip(sorted(reads), its, its[1:]):
        assert before[1] <= s and e <= after[0]
    assert not _named(spans, "frei.remat.recompute")


def test_remat_spans_only_in_the_backward(resume_setup):
    """A differentiable solve records no ``frei.remat.recompute`` in its
    forward, and replays (and spans again) its iterations inside
    ``torch.autograd.grad``."""
    _, grid, T0, args = resume_setup
    T = torch.tensor(T0, requires_grad=True)
    cfg = SolverConfig(differentiable=True, **_cfg(4))
    res, fwd = _profiled_spans(
        lambda: solve_rc_batched(T, *args, cfg))
    assert len(_named(fwd, "frei.solver.iteration")) == 4
    assert not _named(fwd, "frei.remat.recompute")
    _, bwd = _profiled_spans(
        lambda: torch.autograd.grad(res.flux.sum(), T))
    replays = _named(bwd, "frei.remat.recompute")
    assert replays, bwd
    # the chunks' replays hold the iterations' replays
    assert _named(bwd, "frei.solver.iteration")
    assert not _named(bwd, "frei.solve")


@pytest.mark.parametrize("path", ["auto", "eager", "iteration", "loop",
                                  "population", "differentiable"])
def test_spans_off_enter_no_record_function(resume_setup, monkeypatch,
                                            path):
    """With no profiler active a span is the shared null context: with
    ``record_function`` made to raise, a solve on every CPU engine, a
    population solve and a differentiable backward still run."""
    from frei_tpu_torch.parallel import solve_population

    def refuse(*a, **k):
        raise AssertionError("record_function entered with no profiler")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    assert telemetry.span("frei.solve") is telemetry.span("frei.x")
    _, grid, T0, args = resume_setup
    T = torch.tensor(T0)
    if path == "population":
        res = solve_population(T, grid, [grid.planet] * 3,
                               SolverConfig(**_cfg(2)))
    elif path == "differentiable":
        T.requires_grad_(True)
        res = solve_rc_batched(T, *args, SolverConfig(
            differentiable=True, **_cfg(3)))
        (grad,) = torch.autograd.grad(res.flux.sum(), T)
        assert torch.isfinite(grad).all()
    else:
        res = solve_rc_batched(T, *args, SolverConfig(engine=path,
                                                      **_cfg(2)))
    assert torch.isfinite(res.flux).all()

