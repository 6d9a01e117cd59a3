"""The whole-iteration and whole-loop engines of frei_tpu_torch against
frei_tpu.

The plain twins of the CUDA kernels (``ops.iteration_cuda``) run here on
the CPU and are held against the JAX package's Pallas kernels
(``ops.iteration_pallas``), run through the Pallas interpreter as its own
tests run them, on one constant pack handed to both through
``io.convert.to_iteration_pack``.  The engines ``"iteration"`` and
``"loop"`` of ``solve_rc_batched`` are held against the JAX ``"xla"``
engine.  The kernels themselves are held against the twins on the card
by ``tests/test_torch_cuda.py``.

Tolerances (float64): rtol 1e-7 with atol 1e-9 x max|x|, as
``tests/test_sweep_pallas.py`` uses between the JAX engines: the Pallas
kernels evaluate expm1 by a 9-term series (~3e-10 relative), the twins
use ``torch.expm1``, and the adaptive timestep amplifies the difference
in dT.  Integer and boolean outputs must match exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from frei_tpu import Grid as JGrid  # noqa: E402
from frei_tpu import Planet as JPlanet  # noqa: E402
from frei_tpu import load_example_opacity as j_fixture  # noqa: E402
from frei_tpu.chemistry.mocks import MockChemistry as JMock  # noqa: E402
from frei_tpu.ops import iteration_pallas as jip  # noqa: E402
from frei_tpu.rt.solver import SolverConfig as JConfig  # noqa: E402
from frei_tpu.rt.solver import solve_rc_batched as j_solve  # noqa: E402
from frei_tpu_torch import (Grid, Planet, effective_temperature,  # noqa: E402
                            load_example_opacity)
from frei_tpu_torch.chemistry.mocks import MockChemistry  # noqa: E402
from frei_tpu_torch.io import convert  # noqa: E402
from frei_tpu_torch.opacity.hotpath import build_kappa_model  # noqa: E402
from frei_tpu_torch.ops import iteration_cuda as ic  # noqa: E402
from frei_tpu_torch.rt.solver import SolverConfig, solve_rc_batched  # noqa: E402

torch.set_num_threads(2)

B, L, W = 3, 5, 16
DONE = np.array([False, True, False])
N_TC = 6


def _close(ref, got, name):
    ref = np.asarray(ref)
    got = got.detach().cpu().numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-7,
                               atol=1e-9 * float(np.abs(ref).max()),
                               err_msg=name)


class TableChemistry:
    """Temperature-dependent layer chemistry: seeded ln-MMR tables
    (L, N_TC, S) on a log10 T grid spanning ``[lo, hi]``."""

    def __init__(self, n_species, lo, hi, seed=5):
        rng = np.random.RandomState(seed)
        self.tgrid = np.linspace(lo, hi, N_TC)
        self.tab = np.log(1e-3 * rng.uniform(0.2, 2.0, (L, N_TC, n_species)))

    def layer_ln_mmr_tables(self, pressures_cgs):
        assert np.shape(pressures_cgs)[0] == L
        return self.tgrid, self.tab


@pytest.fixture(scope="module")
def setup():
    """A JAX grid at B x L x W, two species (the fixture's table and a
    seeded rescaling of it), columns whose temperatures run past both
    ends of the chemistry grid and, in the third column, past the top
    of the kappa T grid."""
    planet = JPlanet.from_hot_jupiter()
    jg = JGrid(planet, n_wl_bins=W, n_layers=L, T_ref=2400.0,
               dtype=jnp.float64)
    jg.load_opacities(opacities=j_fixture(jg, scale_factor=1.0,
                                          dtype=jnp.float64))
    k_tgrid, tab, _ = jg._kappa_fn.iteration_hook
    rng = np.random.RandomState(0)
    tab = np.asarray(tab)
    k_tab = np.concatenate([tab, tab * rng.uniform(0.1, 0.5, tab.shape)], 1)
    T = np.asarray(jg.init_temperatures)[None, :] * rng.uniform(
        0.9, 1.1, (B, 1))
    T[2] *= 1.5
    logT = np.log10(T)
    chem = TableChemistry(2, logT.min() + 0.1, logT.max() - 0.1)
    params = planet.physics_params()
    pack_j = jip.make_iteration_pack(jg._consts, params,
                                     jnp.asarray(k_tgrid),
                                     jnp.asarray(k_tab), chem)
    Fu = rng.rand(B, L, W) * 1e10
    Fd = rng.rand(B, L, W) * 1e10
    return dict(jg=jg, params=params, pack_j=pack_j,
                pack=convert.to_iteration_pack(pack_j), T=T, Fu=Fu, Fd=Fd,
                chem=chem, k_tgrid=np.asarray(k_tgrid), k_tab=k_tab)


def test_inputs_reach_both_clip_ends_and_the_hull(setup):
    """The chemistry interpolation clips at both ends of its grid, and
    one column's hot layers fall outside the kappa T grid, where the
    weights are zero-filled."""
    s = setup
    logT = np.log10(s["T"])
    assert (logT < s["chem"].tgrid[0]).any()
    assert (logT > s["chem"].tgrid[-1]).any()
    T = torch.tensor(s["T"])
    w = ic._interp_weights(s["pack"].k_tgrid, T, clip=False)
    outside = w.sum(-1) == 0
    assert outside.any() and not outside.all()
    assert outside[2].any()
    c = ic._interp_weights(s["pack"].c_tgrid, torch.log10(T), clip=True)
    np.testing.assert_allclose(c.sum(-1).numpy(), 1.0, rtol=1e-14)


def test_make_iteration_pack_matches_jax(setup):
    """The port's own pack from the same grid, tables and chemistry
    equals the JAX pack carried over."""
    s = setup
    jg = s["jg"]
    consts = convert.to_rt_constants(jg._consts)
    params = convert.to_physics_params(s["params"])
    mine = ic.make_iteration_pack(consts, params,
                                  torch.tensor(s["k_tgrid"]),
                                  torch.tensor(s["k_tab"]), s["chem"])
    ref = s["pack"]
    for f in ic.IterationPack._fields:
        if f == "sc":
            for g in ref.sc._fields:
                np.testing.assert_allclose(getattr(mine.sc, g).numpy(),
                                           getattr(ref.sc, g).numpy(),
                                           rtol=1e-14, err_msg=g)
        else:
            a, b = getattr(mine, f), getattr(ref, f)
            assert a.shape == b.shape and a.is_contiguous(), f
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-14,
                                       err_msg=f)


def test_iteration_twin_matches_pallas_kernel(setup):
    """(a) One RC step, the middle column frozen: both slabs, T1, T2 and
    dT2 for every column."""
    s = setup
    ref = jip.rc_iteration_pallas(
        jnp.asarray(s["T"]), jnp.asarray(s["Fu"]), jnp.asarray(s["Fd"]),
        jnp.asarray(DONE), s["pack_j"], s["params"], block_columns=2,
        interpret=True)
    Fu, Fd = torch.tensor(s["Fu"]), torch.tensor(s["Fd"])
    n0 = ic.rc_iteration_kernel.launches
    got = ic.rc_iteration_kernel(torch.tensor(s["T"]), Fu, Fd,
                                 torch.tensor(DONE), s["pack"],
                                 convert.to_physics_params(s["params"]))
    assert ic.rc_iteration_kernel.launches == n0   # CPU: the twin
    for name, a, b in zip(["T1", "F_up", "F_down", "T2", "dT2"], ref, got):
        _close(a, b, name)
    assert torch.equal(got[1][1], Fu[1]) and torch.equal(got[2][1], Fd[1])


def test_loop_twin_matches_pallas_kernel(setup):
    """(b) Two iterations of the whole loop; the convergence threshold
    lies between the columns' first-iteration max|dT|, so one column
    converges after the first iteration and freezes."""
    s = setup
    pack, params = s["pack"], convert.to_physics_params(s["params"])
    T, Fu, Fd = (torch.tensor(s[k]) for k in ("T", "Fu", "Fd"))
    first = ic.rc_loop_plain(T, Fu, Fd, pack, params, 1, 10 ** 6, 0.0)
    m = np.sort(first[4][:, 0].numpy())
    cdT = float(0.5 * (m[0] + m[1]))
    ref = jip.rc_loop_pallas(jnp.asarray(s["T"]), jnp.asarray(s["Fu"]),
                             jnp.asarray(s["Fd"]), s["pack_j"], s["params"],
                             n_timesteps=2, n_zero_crossings=10 ** 6,
                             convergence_dT=cdT, interpret=True)
    got = ic.rc_loop_kernel(T, Fu, Fd, pack, params, 2, 10 ** 6, cdT)
    assert sorted(got[5].tolist()) == [1, 2, 2]
    names = ["temps", "F_up", "F_down", "hist", "max_dT"]
    for name, a, b in zip(names, ref[:5], got[:5]):
        _close(a, b, name)
    for name, a, b in zip(["n_iters", "converged"], ref[5:], got[5:]):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a),
                                      err_msg=name)
    assert got[5].dtype == torch.int32 and got[6].dtype == torch.bool
    np.testing.assert_array_equal(got[3].numpy() == 0,
                                  np.asarray(ref[3]) == 0)


@pytest.fixture(scope="module")
def solver_setup():
    jg = JGrid(JPlanet.from_hot_jupiter(), n_wl_bins=24, n_layers=7,
               T_ref=2400.0, dtype=jnp.float64)
    jg.load_opacities(opacities=j_fixture(jg, scale_factor=1.0,
                                          dtype=jnp.float64))
    tg = Grid(Planet.from_hot_jupiter(), n_wl_bins=24, n_layers=7,
              T_ref=2400.0, dtype=torch.float64, device="cpu")
    tg.load_opacities(opacities=convert.to_opacity_stack(jg.opacities))
    rng = np.random.RandomState(0)
    T = np.asarray(jg.init_temperatures)[None, :] * rng.uniform(
        0.9, 1.1, (3, 1))
    return jg, tg, T


def _targs(tg):
    return tg._consts, tg.planet.physics_params(), tg._kappa_fn


@pytest.mark.parametrize("engine", ["iteration", "loop"])
def test_engine_matches_xla(solver_setup, engine):
    """(c) The whole solve, 3 iterations, against the JAX xla engine."""
    jg, tg, T = solver_setup
    ref = j_solve(jnp.asarray(T), jg._consts, jg.planet.physics_params(),
                  jg._kappa_fn, JConfig(n_timesteps=3, engine="xla"))
    got = solve_rc_batched(torch.tensor(T), *_targs(tg),
                           SolverConfig(n_timesteps=3, engine=engine))
    np.testing.assert_allclose(got.flux.numpy(), np.asarray(ref.flux),
                               rtol=1e-7)
    np.testing.assert_allclose(got.final_temps.numpy(),
                               np.asarray(ref.final_temps), rtol=1e-8)
    for f in ("temp_history", "dtaus", "F_up", "F_down", "max_dT_history",
              "loop_temps", "loop_F_up", "loop_F_down"):
        _close(getattr(ref, f), getattr(got, f), f)
    for f in ("n_iterations", "n_history", "converged"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)),
                                      err_msg=f)


def test_loop_engine_resume_and_early_convergence(solver_setup):
    """(d) Resuming from the ``loop_*`` fields continues the trajectory
    bit for bit, and early-converged columns freeze with the eager
    engine's counters."""
    _, tg, T = solver_setup
    T = torch.tensor(T)
    args = _targs(tg)

    def cfg(n, engine="loop"):
        return SolverConfig(n_timesteps=n, n_zero_crossings=10 ** 6,
                            convergence_dT=0.0, engine=engine)
    full = solve_rc_batched(T, *args, cfg(2))
    part = solve_rc_batched(T, *args, cfg(1))
    resumed = solve_rc_batched(part.loop_temps, *args, cfg(1),
                               init_fluxes=(part.loop_F_up,
                                            part.loop_F_down))
    assert torch.equal(full.flux, resumed.flux)
    assert torch.equal(full.final_temps, resumed.final_temps)

    loose = SolverConfig(n_timesteps=4, n_zero_crossings=2,
                         convergence_dT=50.0, engine="eager")
    rx = solve_rc_batched(T, *args, loose)
    rl = solve_rc_batched(T, *args, loose._replace(engine="loop"))
    assert rx.n_iterations.min() < 4
    for f in ("n_iterations", "n_history", "converged"):
        assert torch.equal(getattr(rx, f), getattr(rl, f)), f
    np.testing.assert_allclose(rl.final_temps.numpy(),
                               rx.final_temps.numpy(), rtol=1e-8)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_loop_engine_goldens(dtype):
    """(e) The published goldens through ``emission_spectra`` on the
    loop engine, 500 bins x 30 layers."""
    dt = getattr(torch, dtype)
    grid = Grid(Planet.from_hot_jupiter(), T_ref=2400.0, dtype=dt,
                device="cpu")
    grid.load_opacities(opacities=load_example_opacity(
        grid, scale_factor=1.0, dtype=dt))
    T0 = np.asarray(grid.init_temperatures)[None, :]
    spec, temps, hist, dtaus = grid.emission_spectra(T0, n_timesteps=1,
                                                     engine="loop")
    flux = spec.flux_cgs[0]
    lam_peak = spec.wavelength_um[np.argmax(flux)]
    assert abs(lam_peak - 1.1518) < 0.02, lam_peak
    assert abs(float(flux.max()) - 1.296e13) < 0.1e13, flux.max()
    one = type(spec)(wavelength_um=spec.wavelength_um, flux_cgs=flux)
    T_eff = effective_temperature(grid, one, dtaus[0], temps[0])
    assert abs(T_eff - 2400.0) < 200.0, T_eff
    assert hist.shape == (1, 30, 2)


def test_mock_chemistry_tables_match_jax():
    masses = np.array([18.0, 23.0]) * 1.6605e-24
    p = np.logspace(8, 0, L)
    tg, tab = MockChemistry(masses, 3.9e-24).layer_ln_mmr_tables(
        torch.tensor(p))
    jt, jtab = JMock(jnp.asarray(masses), 3.9e-24).layer_ln_mmr_tables(
        jnp.asarray(p))
    assert tab.shape == (L, 2, 2) and tab.dtype == torch.float64
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jt))
    np.testing.assert_allclose(tab.numpy(), np.asarray(jtab), rtol=1e-15)


def test_iteration_hook_only_where_chemistry_serves_it(solver_setup):
    _, tg, _ = solver_setup
    k_tgrid, tab, chem = tg._kappa_fn.iteration_hook
    assert isinstance(chem, MockChemistry) and tab.ndim == 3

    class PlainChem:
        def mmr(self, temps, p):
            return tg.chemistry.mmr(temps, p)

    c = tg._consts
    k = build_kappa_model(tg.opacities, PlainChem(), c.pressures,
                          c.sigma_scat)
    assert k.iteration_hook is None and k.layer_parts is not None
    one_T = tg.opacities._replace(values=tg.opacities.values[:, :1],
                                  temps=tg.opacities.temps[:1])
    k1 = build_kappa_model(one_T, tg.chemistry, c.pressures, c.sigma_scat)
    assert getattr(k1, "iteration_hook", None) is None


def test_loop_first_step_is_the_iteration_step(setup):
    """One trip of the loop twin is one step of the iteration twin with
    no column frozen, quadrature diagnostic included, bit for bit."""
    s = setup
    pack, params = s["pack"], convert.to_physics_params(s["params"])
    T, Fu, Fd = (torch.tensor(s[k]) for k in ("T", "Fu", "Fd"))
    T1, Fu2, Fd2, T2, dT2, sums = ic.rc_iteration_kernel(
        T, Fu, Fd, torch.zeros(B, dtype=torch.bool), pack, params,
        with_sums=True)
    tout, fu, fd, hist, maxdt, n_iters, conv, lsums = ic.rc_loop_kernel(
        T, Fu, Fd, pack, params, 1, 10 ** 6, 0.0, with_sums=True)
    assert sums.shape == (B, 2, 4, L - 1)
    for a, b in [(T1, hist[:, 0]), (T2, hist[:, 1]), (T2, tout),
                 (Fu2, fu), (Fd2, fd), (sums, lsums),
                 (dT2.abs().amax(1), maxdt[:, 0])]:
        assert torch.equal(a, b)
    assert n_iters.tolist() == [1] * B and not conv.any()
