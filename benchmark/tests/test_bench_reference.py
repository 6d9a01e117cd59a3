"""The frozen reference against frei_tpu_torch's "eager" solve in
float64, at a small size on the CPU: the shared planet, a population
and the gradient; and the frozen input generators against the port's."""

import copy

import numpy as np
import pytest
import torch

from benchmark.harness import pieces
from benchmark.reference import answers, case, inputs, rt

HJ = pieces.config("hot_jupiter_r500")
POP = pieces.config("population_r500_f64")
ITERS = 3


def small(cfg):
    cfg = copy.deepcopy(cfg)
    cfg["grid"].update(n_wl_bins=48, n_layers=9)
    return cfg


def port_grid(cfg, tables, planet=None):
    from frei_tpu_torch import Grid, Planet
    g = cfg["grid"]
    grid = Grid(planet or Planet.from_hot_jupiter(),
                lam_min=g["lam_min_um"], lam_max=g["lam_max_um"],
                n_wl_bins=g["n_wl_bins"], P_toa=g["P_toa_bar"],
                P_boa=g["P_boa_bar"], n_layers=g["n_layers"],
                T_ref=g["T_ref"], P_ref=g["P_ref_bar"], alpha=g["alpha"],
                dtype=torch.float64, device="cpu")
    grid.load_opacities(opacities=tables)
    return grid


def cfg_solver():
    from frei_tpu_torch import SolverConfig
    return SolverConfig(n_timesteps=ITERS, n_zero_crossings=10 ** 6,
                        convergence_dT=0.0, engine="eager")


def profiles(cfg, n, seed=5):
    ga = inputs.grid_arrays(cfg["grid"])
    return ga, inputs.profiles(ga, inputs.rng_for(seed, 0), n, 0.95, 1.05)


def test_frozen_inputs_match_the_port():
    from frei_tpu_torch.grids import make_rt_grid
    from frei_tpu_torch.opacity.rayleigh import rayleigh_total
    from frei_tpu_torch.opacity.tables import load_example_opacity
    from frei_tpu_torch.stellar.irradiation import f_toa_np
    g = HJ["grid"]
    ga = inputs.grid_arrays(g)
    rg = make_rt_grid(n_wl_bins=g["n_wl_bins"], n_layers=g["n_layers"],
                      T_ref=g["T_ref"])
    for a, b in ((ga.lam_cm, rg.lam_cm), (ga.trapz_w, rg.trapz_w_cm),
                 (ga.pressures, rg.pressures_cgs),
                 (ga.init_temps, rg.init_temperatures)):
        np.testing.assert_allclose(a, b, rtol=1e-15)
    values, temps, press = case.opacity_tables(HJ, ga)["1H2-16O"]
    stack = load_example_opacity(rg, scale_factor=1.0, dtype=torch.float64,
                                 device="cpu")
    np.testing.assert_allclose(values[::-1, ::-1],
                               stack.values[0].numpy(), rtol=1e-15)
    m_bar = 2.4 * 1.67262192369e-24
    np.testing.assert_allclose(inputs.rayleigh(ga.lam_cm, m_bar),
                               rayleigh_total(rg.lam_cm), rtol=1e-14)
    np.testing.assert_allclose(inputs.f_toa(ga.lam_cm, 5000.0, 6.0),
                               f_toa_np(rg.lam_cm, 5000.0, 6.0), rtol=1e-14)
    assert inputs.iso_mass_amu("1H2-16O") == 18.0
    assert inputs.iso_mass_amu("48Ti-16O") == 64.0


def test_shared_planet_solve_matches_eager():
    from frei_tpu_torch import solve_rc_batched
    cfg = small(HJ)
    ga, T0 = profiles(cfg, 4)
    tables = case.opacity_tables(cfg, ga)
    grid = port_grid(cfg, tables)
    res = solve_rc_batched(torch.as_tensor(T0), grid._consts,
                           grid.planet.physics_params(), grid._kappa_fn,
                           cfg_solver())
    ref = answers.forward(cfg, tables, T0, None, ITERS, torch.float64,
                          "cpu", 3)
    np.testing.assert_allclose(ref["flux"], res.flux, rtol=1e-11)
    np.testing.assert_allclose(ref["final_temps"], res.final_temps,
                               rtol=1e-10)
    gaps = answers.forward_gaps({"flux": res.flux,
                                 "final_temps": res.final_temps}, ref)
    assert max(gaps.values()) < 1e-10


def test_population_solve_matches_eager():
    from frei_tpu_torch import Planet
    from frei_tpu_torch.parallel import solve_population
    cfg = small(POP)
    ga, T0 = profiles(cfg, 5)
    tables = case.opacity_tables(cfg, ga)
    pop = inputs.population(inputs.rng_for(5, 1), 5, cfg["planet"]["draws"])
    planets = [Planet(a_rstar=a, m_bar=2.4, g=g, T_star=t, alpha=al)
               for a, g, t, al in zip(*(x.tolist() for x in pop))]
    grid = port_grid(cfg, tables)
    res = solve_population(torch.as_tensor(T0), grid, planets, cfg_solver())
    ref = answers.forward(cfg, tables, T0, pop, ITERS, torch.float64,
                          "cpu", 2)
    np.testing.assert_allclose(ref["flux"], res.flux, rtol=1e-11)
    np.testing.assert_allclose(ref["final_temps"], res.final_temps,
                               rtol=1e-10)
    assert ref["F_toa"].shape == (5, cfg["grid"]["n_wl_bins"])


def test_gradient_matches_eager_autograd():
    cfg = small(HJ)
    ga, T0 = profiles(cfg, 3)
    tables = case.opacity_tables(cfg, ga)
    grid = port_grid(cfg, tables)
    fn = grid.spectrum_fn(n_timesteps=ITERS, n_zero_crossings=10 ** 6,
                          convergence_dT=0.0)
    T = torch.as_tensor(T0).requires_grad_(True)
    loss = (fn(T, grid.planet.physics_params()) ** 2).sum() / 1e26
    (g,) = torch.autograd.grad(loss, T)
    sample = np.array([0, 2])
    ref = answers.gradient(cfg, tables, T0, ITERS, torch.float64, "cpu", 2,
                           1, sample)
    np.testing.assert_allclose(float(ref["loss"]), float(loss.detach()),
                               rtol=1e-12)
    np.testing.assert_allclose(ref["grad"], g[sample], rtol=1e-8,
                               atol=1e-10 * float(g.abs().max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lower_precision_runs_and_differs(dtype):
    cfg = small(HJ)
    ga, T0 = profiles(cfg, 2)
    tables = case.opacity_tables(cfg, ga)
    hi = answers.forward(cfg, tables, T0, None, ITERS, torch.float64,
                         "cpu", 2)
    lo = answers.forward(cfg, tables, T0, None, ITERS, dtype, "cpu", 2)
    gaps = answers.forward_gaps(lo, hi)
    assert all(np.isfinite(v) and v > 0 for v in gaps.values())


def test_kappa_is_zero_outside_the_hull():
    cfg = small(HJ)
    ga = inputs.grid_arrays(cfg["grid"])
    tables = case.opacity_tables(cfg, ga)
    s, _ = case.build(cfg, tables, torch.float64, "cpu")
    T = torch.as_tensor(ga.init_temps)[None].repeat(2, 1)
    T[1] *= 10.0                       # far above the table's hottest
    k = rt.kappa(s, T)
    torch.testing.assert_close(k[1], s.sigma.expand_as(k[1]))
    assert bool((k[0] > s.sigma).all())
