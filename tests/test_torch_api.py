"""The user API of frei_tpu_torch: the published goldens, parity with
frei_tpu's emission spectrum, the no-JAX import contract, the loud
refusal of what is not ported yet, and the features ported since."""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import frei_tpu  # noqa: E402
from frei_tpu_torch import (Grid, Planet, effective_temperature,  # noqa: E402
                            load_example_opacity, make_opacity_stack)
from frei_tpu_torch.opacity.hotpath import build_kappa_model  # noqa: E402
from frei_tpu_torch.rt.physics import PhysicsParams  # noqa: E402
from frei_tpu_torch.rt.solver import SolverConfig, solve_rc_batched  # noqa: E402

torch.set_num_threads(2)


@pytest.fixture(scope="module", params=["float64", "float32"])
def golden_run(request):
    dtype = getattr(torch, request.param)
    grid = Grid(Planet.from_hot_jupiter(), T_ref=2400.0, dtype=dtype,
                device="cpu")
    grid.load_opacities(opacities=load_example_opacity(
        grid, scale_factor=1.0, dtype=dtype))
    return (grid,) + grid.emission_spectrum(n_timesteps=1)


def test_golden_peak_wavelength(golden_run):
    _, spec, *_ = golden_run
    lam_peak = spec.wavelength_um[np.argmax(spec.flux_cgs)]
    assert abs(lam_peak - 1.1518) < 0.02, lam_peak


def test_golden_peak_flux(golden_run):
    _, spec, *_ = golden_run
    peak = float(np.max(spec.flux_cgs))
    assert abs(peak - 1.296e13) < 0.1e13, peak


def test_golden_effective_temperature(golden_run):
    grid, spec, temps, hist, dtaus = golden_run
    T_eff = effective_temperature(grid, spec, dtaus, temps)
    assert abs(T_eff - 2400.0) < 200.0, T_eff
    assert hist.shape == (30, 2)
    assert grid.last_metrics.n_iterations == 1


def test_emission_spectrum_matches_jax():
    """500 bins x 30 layers, float64: every output at rtol 1e-12 (same
    arithmetic; quadrature summation order only)."""
    jg = frei_tpu.Grid(frei_tpu.Planet.from_hot_jupiter(), T_ref=2400.0,
                       dtype=jnp.float64)
    jg.load_opacities(opacities=frei_tpu.load_example_opacity(
        jg, scale_factor=1.0, dtype=jnp.float64))
    tg = Grid(Planet.from_hot_jupiter(), T_ref=2400.0, dtype=torch.float64,
              device="cpu")
    tg.load_opacities(opacities=load_example_opacity(
        tg, scale_factor=1.0, dtype=torch.float64))
    ref = jg.emission_spectrum(n_timesteps=2)
    got = tg.emission_spectrum(n_timesteps=2)
    np.testing.assert_array_equal(got[0].wavelength_um, ref[0].wavelength_um)
    for name, a, b in zip(["flux", "temps", "history", "dtaus"],
                          [ref[0].flux_cgs, *ref[1:]],
                          [got[0].flux_cgs, *got[1:]]):
        np.testing.assert_allclose(b, a, rtol=1e-12,
                                   atol=1e-14 * float(np.abs(a).max()),
                                   err_msg=name)
    assert (frei_tpu.effective_temperature(jg, *ref[:1], ref[3], ref[1])
            == pytest.approx(effective_temperature(tg, got[0], got[3],
                                                   got[1]), rel=1e-12))


def test_emission_spectra_matches_columns():
    grid = Grid(Planet.from_hot_jupiter(), n_wl_bins=24, n_layers=7,
                T_ref=2400.0, dtype=torch.float64, device="cpu")
    grid.load_opacities(opacities=load_example_opacity(
        grid, scale_factor=1.0, dtype=torch.float64))
    T = np.asarray(grid.init_temperatures)[None, :] * np.array(
        [[0.95], [1.0], [1.05]])
    spec, temps, hist, dtaus = grid.emission_spectra(T, n_timesteps=3)
    assert spec.flux_cgs.shape == (3, 24) and dtaus.shape == (3, 7, 24)
    assert grid.last_metrics.columns == 3
    grid.rt_grid = grid.rt_grid._replace(init_temperatures=T[2])
    one = grid.emission_spectrum(n_timesteps=3)
    np.testing.assert_allclose(spec.flux_cgs[2], one[0].flux_cgs,
                               rtol=1e-12)
    np.testing.assert_allclose(temps[2], one[1], rtol=1e-12)


def test_import_loads_no_jax():
    code = ("import sys, frei_tpu_torch, frei_tpu_torch.ops.sweep_cuda, "
            "frei_tpu_torch.ops.iteration_cuda, frei_tpu_torch.io, "
            "frei_tpu_torch.io.cache, frei_tpu_torch.ops.rebin, "
            "frei_tpu_torch.ops.rebin_cuda, frei_tpu_torch.ops.kappa_cuda, "
            "frei_tpu_torch.opacity.etl, frei_tpu_torch.native, "
            "frei_tpu_torch.chemistry, frei_tpu_torch.chemistry.api, "
            "frei_tpu_torch.parallel, frei_tpu_torch.parallel.launch, "
            "frei_tpu_torch.rt.standalone, "
            "frei_tpu_torch.io.checkpoint, frei_tpu_torch.diag.plot, "
            "frei_tpu_torch.stellar.phoenix; "
            "bad = [m for m in sys.modules if m.split('.')[0] == 'jax']; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True)


@pytest.fixture(scope="module")
def small():
    grid = Grid(Planet.from_hot_jupiter(), n_wl_bins=16, n_layers=5,
                T_ref=2400.0, dtype=torch.float64, device="cpu")
    grid.load_opacities(opacities=load_example_opacity(
        grid, scale_factor=1.0, dtype=torch.float64))
    T = torch.tensor(np.asarray(grid.init_temperatures)[None, :]
                     .repeat(2, 0))
    return grid, T


def test_default_device_is_the_card():
    """The entry points run on the card unless the caller names the CPU:
    without CUDA, ``Grid(planet)`` raises and names ``device="cpu"``, and
    the stack builders default to the card as well."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default lands on the card")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        Grid(Planet.from_hot_jupiter())
    with pytest.raises(RuntimeError, match='device="cpu"'):
        Grid(Planet.from_hot_jupiter(), device="cuda")
    assert Grid(Planet.from_hot_jupiter(), device="cpu").device.type == "cpu"
    with pytest.raises((RuntimeError, AssertionError)):
        make_opacity_stack({"1H2-16O": (np.ones((2, 2, 3)), [1e3, 2e3],
                                        [1e-3, 1.0])})


def test_cuda_engine_on_cpu_tensors_raises(small):
    grid, T = small
    with pytest.raises(ValueError, match="CUDA tensors"):
        grid.emission_spectra(T, engine="cuda")


@pytest.mark.parametrize("case", [
    "pallas-iteration", "pallas-loop", "differentiable", "bins_axis",
    "associative", "population-g", "population-F_toa",
    "chemistry-equilibrium", "etl"]
    + [f"{engine}-{guard}" for engine in ("iteration", "loop")
       for guard in ("population-g", "population-F_toa", "bins_axis",
                     "no-hook")])
def test_unported_feature_raises(small, case):
    grid, T = small
    consts, params = grid._consts, grid.planet.physics_params()
    cfg = SolverConfig(n_timesteps=1)
    if case.startswith(("iteration-", "loop-")):
        # the JAX package's guards of its whole-iteration engines
        engine, guard = case.split("-", 1)
        cfg = cfg._replace(engine=engine)
        kappa = grid._kappa_fn
        if guard.startswith("population"):
            # ported, where the JAX package refuses: the kernels' twins
            # take per-column g or F_toa, and a population of copies of
            # the planet is the shared solve on the same engine
            if guard == "population-g":
                params = PhysicsParams(g=torch.full((2,), params.g,
                                                    dtype=torch.float64),
                                       m_bar=params.m_bar,
                                       alpha=params.alpha)
            else:
                consts = consts._replace(F_toa=consts.F_toa.expand(2, -1))
            got = solve_rc_batched(T, consts, params, kappa, cfg)
            ref = solve_rc_batched(T, grid._consts,
                                   grid.planet.physics_params(), kappa, cfg)
            assert torch.equal(got.flux, ref.flux)
            assert torch.equal(got.final_temps, ref.final_temps)
            return
        match = {"bins_axis": "does not support a bins-sharded mesh",
                 "no-hook": "needs a layer-factored kappa model"}[guard]
        if guard == "bins_axis":
            cfg = cfg._replace(bins_axis="bins")
        else:       # a single-T-point stack carries no iteration hook
            s = grid.opacities
            kappa = build_kappa_model(
                s._replace(values=s.values[:, :1], temps=s.temps[:1]),
                grid.chemistry, consts.pressures, consts.sigma_scat)
        with pytest.raises(ValueError, match=f"engine '{engine}' {match}"):
            solve_rc_batched(T, consts, params, kappa, cfg)
        return
    if case.startswith("pallas"):
        # the JAX names are refused with the port's counterpart named
        ours = case.split("-")[1]
        with pytest.raises(ValueError,
                           match=f"counterpart is engine '{ours}'"):
            solve_rc_batched(T, consts, params, grid._kappa_fn,
                             cfg._replace(engine=case))
        return
    if case == "chemistry-equilibrium":
        # ported: the equilibrium chemistry runs (the exact solver here;
        # the default 64 x 32 table's build is in tests/test_torch_fastchem
        # .py's slow lane), and an unknown model name still raises
        from frei_tpu_torch.chemistry.fastchem import FastChemTorch
        g2 = Grid(Planet.from_hot_jupiter(), n_wl_bins=16, n_layers=5,
                  T_ref=2400.0, dtype=torch.float64, device="cpu")
        g2.load_opacities(opacities=load_example_opacity(
            g2, scale_factor=1.0, dtype=torch.float64),
            chemistry="equilibrium-exact")
        assert isinstance(g2.chemistry, FastChemTorch)
        assert g2.chemistry.mode == "exact"
        assert g2._kappa_fn.iteration_hook is None
        spec, temps, _, _ = g2.emission_spectrum(n_timesteps=1)
        assert np.all(np.isfinite(spec.flux_cgs)) and spec.flux_cgs.max() > 0
        with pytest.raises(ValueError, match="unknown chemistry model"):
            g2.load_opacities(chemistry="equilibrium-fast")
        return
    if case == "etl":
        # ported: binning from stores runs, and a path with no store
        # raises as in the JAX package
        g2 = Grid(Planet.from_hot_jupiter(), n_wl_bins=16, n_layers=5,
                  device="cpu")
        with pytest.raises(FileNotFoundError, match="nowhere"):
            g2.load_opacities(path="nowhere/*.ftop")
        return
    if case.startswith("population"):
        # ported: per-column g or F_toa run on the eager engine, and a
        # population of copies of the planet is the shared solve
        if case == "population-g":
            params = PhysicsParams(g=torch.full((2,), params.g,
                                                dtype=torch.float64),
                                   m_bar=params.m_bar, alpha=params.alpha)
        else:
            consts = consts._replace(F_toa=consts.F_toa.expand(2, -1))
        got = solve_rc_batched(T, consts, params, grid._kappa_fn, cfg)
        ref = solve_rc_batched(T, grid._consts,
                               grid.planet.physics_params(), grid._kappa_fn,
                               cfg)
        assert torch.equal(got.flux, ref.flux)
        assert torch.equal(got.final_temps, ref.final_temps)
        return
    if case == "differentiable":
        # ported: the kernel engines refuse (no backward), "auto" runs the
        # eager solve, whose forward is the ordinary one
        cfg = cfg._replace(differentiable=True)
        with pytest.raises(ValueError, match="autodiff"):
            solve_rc_batched(T, consts, params, grid._kappa_fn,
                             cfg._replace(engine="cuda"))
        got = solve_rc_batched(T, consts, params, grid._kappa_fn, cfg)
        ref = solve_rc_batched(T, consts, params, grid._kappa_fn,
                               SolverConfig(n_timesteps=1, engine="eager"))
        assert torch.equal(got.flux, ref.flux)
        return
    if case == "associative":
        # ported: the log-depth scan runs and agrees with the sequential one
        got = solve_rc_batched(T, consts, params, grid._kappa_fn,
                               cfg._replace(associative=True))
        ref = solve_rc_batched(T, consts, params, grid._kappa_fn, cfg)
        np.testing.assert_allclose(got.flux.numpy(), ref.flux.numpy(),
                                   rtol=1e-10)
        np.testing.assert_allclose(got.final_temps.numpy(),
                                   ref.final_temps.numpy(), rtol=1e-12)
        return
    # ported: bins_axis names a dim of a sharded solve's mesh; without one
    # it is refused with the entry point named
    with pytest.raises(ValueError, match="solve_ensemble"):
        solve_rc_batched(T, consts, params, grid._kappa_fn,
                         cfg._replace(bins_axis="bins"))


@pytest.mark.parametrize("jax_name, ours", [
    ("xla", "eager"), ("pallas", "cuda"), ("xla-interpret", "eager"),
    ("pallas-interpret", "cuda"), ("pallas-iteration", "iteration"),
    ("pallas-loop", "loop"), ("pallas-iteration-interpret", "iteration"),
    ("pallas-loop-interpret", "loop")])
def test_jax_engine_names_name_the_counterpart(small, jax_name, ours):
    """Every engine name of the JAX package's solver is refused with this
    package's counterpart named, matched exactly (so "pallas" does not
    shadow "pallas-iteration"); a near miss is an unknown engine."""
    grid, T = small
    consts, params = grid._consts, grid.planet.physics_params()
    cfg = SolverConfig(n_timesteps=1, engine=jax_name)
    with pytest.raises(ValueError, match=(
            f"engine '{jax_name}' is the JAX package's name; this "
            f"package's counterpart is engine '{ours}'$")):
        solve_rc_batched(T, consts, params, grid._kappa_fn, cfg)
    with pytest.raises(ValueError, match="unknown sweep engine"):
        solve_rc_batched(T, consts, params, grid._kappa_fn,
                         cfg._replace(engine=jax_name + "-x"))


def test_port_tests_skip_cleanly_without_torch():
    """Where torch is not installed (the JAX package's CI job), every port
    test file skips at collection and the JAX package's tests still
    collect: no collection error stops the run."""
    tests = Path(__file__).resolve().parent
    files = sorted(str(f) for f in tests.glob("test_torch_*.py"))
    code = ("import sys; sys.modules['torch'] = None; import pytest; "
            "sys.exit(pytest.main(sys.argv[1:]))")
    proc = subprocess.run(
        [sys.executable, "-c", code, "--collect-only", "-q",
         "-p", "no:cacheprovider", "-p", "no:xdist", "-p", "no:randomly",
         *files, str(tests / "test_grids.py")],
        capture_output=True, text=True, timeout=120, cwd=tests.parent)
    out = proc.stdout + proc.stderr
    assert proc.returncode == 0, out
    assert "error during collection" not in out.lower(), out
    summary = proc.stdout.strip().splitlines()[-1]   # "N tests collected in ..."
    assert "collected" in summary and "error" not in summary, out
    assert "test_grids.py::" in out, out
