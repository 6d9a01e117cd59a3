"""The user API of frei_tpu_torch: the published goldens, parity with
frei_tpu's emission spectrum, the no-JAX import contract, and the loud
refusal of what is not ported yet."""

import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import frei_tpu
from frei_tpu_torch import (Grid, Planet, effective_temperature,
                            load_example_opacity, make_opacity_stack)
from frei_tpu_torch.opacity.hotpath import build_kappa_model
from frei_tpu_torch.rt.physics import PhysicsParams
from frei_tpu_torch.rt.solver import SolverConfig, solve_rc_batched

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
            "frei_tpu_torch.opacity.etl, frei_tpu_torch.native; "
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
        match = {"population-g": "does not support per-column params",
                 "population-F_toa": "does not support per-column params",
                 "bins_axis": "does not support a bins-sharded mesh",
                 "no-hook": "needs a layer-factored kappa model"}[guard]
        if guard == "population-g":
            params = PhysicsParams(g=torch.full((2,), params.g),
                                   m_bar=params.m_bar, alpha=params.alpha)
        elif guard == "population-F_toa":
            consts = consts._replace(F_toa=consts.F_toa.expand(2, -1))
        elif guard == "bins_axis":
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
        g2 = Grid(Planet.from_hot_jupiter(), n_wl_bins=16, n_layers=5,
                  device="cpu")
        with pytest.raises(NotImplementedError, match="item 10"):
            g2.load_opacities(opacities=load_example_opacity(g2),
                              chemistry="equilibrium")
        return
    if case == "etl":
        # ported: binning from stores runs, and a path with no store
        # raises as in the JAX package
        g2 = Grid(Planet.from_hot_jupiter(), n_wl_bins=16, n_layers=5,
                  device="cpu")
        with pytest.raises(FileNotFoundError, match="nowhere"):
            g2.load_opacities(path="nowhere/*.ftop")
        return
    match = {"differentiable": "item 11", "bins_axis": "item 14",
             "associative": "item 13", "population-g": "item 9",
             "population-F_toa": "item 9"}[case]
    if case == "differentiable":
        cfg = cfg._replace(differentiable=True)
    elif case == "bins_axis":
        cfg = cfg._replace(bins_axis="bins")
    elif case == "associative":
        cfg = cfg._replace(associative=True)
    elif case == "population-g":
        params = PhysicsParams(g=torch.full((2,), params.g),
                               m_bar=params.m_bar, alpha=params.alpha)
    else:
        consts = consts._replace(F_toa=consts.F_toa.expand(2, -1))
    with pytest.raises(NotImplementedError, match=match):
        solve_rc_batched(T, consts, params, grid._kappa_fn, cfg)
