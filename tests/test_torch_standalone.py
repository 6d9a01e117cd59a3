"""The standalone sweep drivers and the log-depth layer scan of
frei_tpu_torch, against frei_tpu and against their own definitions.

* ``emit`` / ``absorb`` (``rt/standalone.py``) keep the reference's
  public-call conventions: self-seeded flux state (``F_down[-1] =
  F_TOA``; absorb also ``F_up[0] = pi B(T0)``), their own loop stopping
  at ``max|dT| < convergence_thresh``; held against the JAX drivers at
  rtol 1e-9 (the quadratures' summation order) and against a manual loop
  of the port's sweeps from the same seeds at rtol 1e-12
  (`tests/test_solver_parity.py:162-215`).
* ``associative=True`` (``rt/sweeps._affine_prefix_assoc``) against the
  sequential scan: the prefix map at rtol 1e-13, solves at the JAX
  test's tolerances (flux 1e-10, temperatures 1e-12), and against the
  JAX package's associative engine at rtol 1e-9.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import frei_tpu  # noqa: E402
from frei_tpu.rt.solver import SolverConfig as JConfig  # noqa: E402
from frei_tpu.rt.solver import solve_rc_batched as j_solve  # noqa: E402
from frei_tpu_torch import (Grid, Planet, absorb, absorb_sweep,  # noqa: E402
                            emit, emit_sweep)
from frei_tpu_torch.io import convert  # noqa: E402
from frei_tpu_torch.ops.planck import bb_flux  # noqa: E402
from frei_tpu_torch.rt.solver import (SolverConfig,  # noqa: E402
                                      solve_rc_batched)
from frei_tpu_torch.rt.sweeps import (_affine_prefix_assoc,  # noqa: E402
                                      _affine_prefix_seq)

torch.set_num_threads(2)
W, L = 64, 10


@pytest.fixture(scope="module")
def setup():
    jg = frei_tpu.Grid(frei_tpu.Planet.from_hot_jupiter(), n_wl_bins=W,
                       n_layers=L, T_ref=2400.0, dtype=jnp.float64)
    jg.load_opacities(opacities=frei_tpu.load_example_opacity(
        jg, scale_factor=1.0, dtype=jnp.float64))
    grid = Grid(Planet.from_hot_jupiter(), n_wl_bins=W, n_layers=L,
                T_ref=2400.0, dtype=torch.float64, device="cpu")
    grid.load_opacities(opacities=convert.to_opacity_stack(jg.opacities))
    return jg, grid


def _args(grid):
    return grid._consts, grid.planet.physics_params(), grid._kappa_fn


def _manual(grid, sweep, T0, Fu, Fd, n):
    """``n`` sweeps of one column by hand, at batch 1."""
    consts, params, kappa = _args(grid)
    kw = dict(sigma_scat=consts.sigma_scat, F_toa=consts.F_toa,
              lam_cm=consts.lam_cm, trapz_w=consts.trapz_w,
              pressures=consts.pressures, params=params)
    T, Fu, Fd = T0[None], Fu[None], Fd[None]
    for _ in range(n):
        s = sweep(T, Fu, Fd, kappa(T, consts.pressures), **kw)
        T, Fu, Fd = s.temps, s.F_up, s.F_down
    return T[0], Fu[0], Fd[0]


def test_absorb_self_seeds_and_equals_manual_sweeps(setup):
    _, grid = setup
    consts = grid._consts
    T0 = torch.tensor(np.asarray(grid.init_temperatures))
    r = absorb(T0, *_args(grid), n_timesteps=4, convergence_thresh=0.0)
    assert int(r.n_history) == 5 and r.temp_history.shape == (5, L)
    assert torch.equal(r.temp_history[0], T0)
    Fu = torch.zeros((L, W), dtype=torch.float64)
    Fu[0] = bb_flux(T0[0], consts.lam_cm)
    Fd = torch.zeros((L, W), dtype=torch.float64)
    Fd[-1] = consts.F_toa
    T, Fu, Fd = _manual(grid, absorb_sweep, T0, Fu, Fd, 4)
    for got, want in ((r.final_temps, T), (r.F_up, Fu), (r.F_down, Fd)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12)


def test_emit_self_seeds_and_stops_early(setup):
    _, grid = setup
    consts = grid._consts
    T0 = torch.tensor(np.asarray(grid.init_temperatures))
    # one step "converges" at a loose threshold
    assert int(emit(T0, *_args(grid), n_timesteps=50,
                    convergence_thresh=1e9).n_history) == 2
    r = emit(T0, *_args(grid), n_timesteps=3, convergence_thresh=0.0)
    assert int(r.n_history) == 4 and torch.isfinite(r.F_up).all()
    Fu = torch.zeros((L, W), dtype=torch.float64)
    Fd = torch.zeros_like(Fu)
    Fd[-1] = consts.F_toa
    T, Fu, Fd = _manual(grid, emit_sweep, T0, Fu, Fd, 3)
    for got, want in ((r.final_temps, T), (r.F_up, Fu), (r.F_down, Fd)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12)
    # the default 10 K threshold ends the reference's loop before 50
    assert 1 < int(emit(T0, *_args(grid)).n_history) <= 51


@pytest.mark.parametrize("direction", ["emit", "absorb"])
@pytest.mark.parametrize("associative", [False, True])
def test_standalone_matches_jax(setup, direction, associative):
    """Every ``StandaloneResult`` field against the JAX driver: floats at
    rtol 1e-9, the history count exactly."""
    jg, grid = setup
    jfn = getattr(frei_tpu, direction)
    fn = {"emit": emit, "absorb": absorb}[direction]
    T0 = np.asarray(grid.init_temperatures)
    kw = dict(n_timesteps=3, convergence_thresh=0.0, associative=associative)
    ref = jfn(jnp.asarray(T0), jg._consts, jg.planet.physics_params(),
              jg._kappa_fn, **kw)
    got = fn(torch.tensor(T0), *_args(grid), **kw)
    assert int(got.n_history) == int(ref.n_history) == 4
    for f in ("F_up", "F_down", "final_temps", "temp_history", "dtaus",
              "dT"):
        a = np.asarray(getattr(ref, f))
        np.testing.assert_allclose(getattr(got, f).numpy(), a, rtol=1e-9,
                                   atol=1e-12 * float(np.abs(a).max()),
                                   err_msg=f)


@pytest.mark.parametrize("n", [1, 2, 3, 29, 64])
def test_affine_prefix_assoc_matches_sequential(n):
    """The doubling scan against the sequential recurrence over n layers
    (n = L - 1: a 2-layer grid up to 65): rtol 1e-13."""
    rng = np.random.RandomState(n)
    A = torch.tensor(rng.uniform(0.05, 1.0, (3, n, 7)))
    c = torch.tensor(rng.uniform(-1e12, 1e12, (3, n, 7)))
    init = torch.tensor(rng.uniform(0.0, 1e12, (3, 7)))
    want = _affine_prefix_seq(A, c, init)
    got = _affine_prefix_assoc(A, c, init)
    assert got.shape == want.shape == (3, n, 7)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-13,
                               atol=1e-13 * float(want.abs().max()))


def test_associative_solve_equals_sequential(setup):
    """``SolverConfig(associative=True)`` on ``"eager"``, four iterations:
    flux rtol 1e-10, temperatures 1e-12
    (`tests/test_solver_parity.py:118-125`)."""
    _, grid = setup
    spec_a, temps_a, *_ = grid.emission_spectrum(n_timesteps=4,
                                                 associative=True)
    spec_s, temps_s, *_ = grid.emission_spectrum(n_timesteps=4,
                                                 associative=False)
    np.testing.assert_allclose(spec_a.flux_cgs, spec_s.flux_cgs, rtol=1e-10)
    np.testing.assert_allclose(temps_a, temps_s, rtol=1e-12)


def test_associative_solve_matches_jax(setup):
    """Batched, three columns, against the JAX ``"xla"`` engine with its
    ``lax.associative_scan``: rtol 1e-9."""
    jg, grid = setup
    rng = np.random.RandomState(2)
    T = np.asarray(grid.init_temperatures)[None, :] * rng.uniform(
        0.9, 1.1, (3, 1))
    ref = j_solve(jnp.asarray(T), jg._consts, jg.planet.physics_params(),
                  jg._kappa_fn, JConfig(n_timesteps=3, engine="xla",
                                        associative=True))
    got = solve_rc_batched(torch.tensor(T), *_args(grid), SolverConfig(
        n_timesteps=3, engine="eager", associative=True))
    for f in ("flux", "final_temps", "F_up", "F_down"):
        a = np.asarray(getattr(ref, f))
        np.testing.assert_allclose(getattr(got, f).numpy(), a, rtol=1e-9,
                                   atol=1e-12 * float(np.abs(a).max()),
                                   err_msg=f)
    assert torch.equal(got.n_iterations,
                       torch.as_tensor(np.array(ref.n_iterations)))
