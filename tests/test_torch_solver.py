"""The batched RC solver of frei_tpu_torch against frei_tpu (float64).

The port's ``engine="eager"`` against the JAX ``engine="xla"``: the
same per-column algorithm, so float fields agree at rtol 1e-9 (the
bolometric matvecs sum in another order, and six iterations of the
adaptive timestep amplify that) and the integer and boolean fields
exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frei_tpu import Grid as JGrid
from frei_tpu import Planet as JPlanet
from frei_tpu import load_example_opacity as j_fixture
from frei_tpu.rt.solver import SolverConfig as JConfig
from frei_tpu.rt.solver import solve_rc as j_solve_rc
from frei_tpu.rt.solver import solve_rc_batched as j_solve
from frei_tpu_torch import Grid, Planet
from frei_tpu_torch.io import convert
from frei_tpu_torch.rt.solver import SolverConfig, solve_rc, solve_rc_batched

torch.set_num_threads(2)
B, L, W = 3, 7, 24
FLOATS = ["flux", "final_temps", "temp_history", "dtaus", "F_up", "F_down",
          "max_dT_history", "loop_temps", "loop_F_up", "loop_F_down"]
EXACT = ["n_iterations", "n_history", "converged"]


@pytest.fixture(scope="module")
def setup():
    jg = JGrid(JPlanet.from_hot_jupiter(), n_wl_bins=W, n_layers=L,
               T_ref=2400.0, dtype=jnp.float64)
    jg.load_opacities(opacities=j_fixture(jg, scale_factor=1.0,
                                          dtype=jnp.float64))
    tg = Grid(Planet.from_hot_jupiter(), n_wl_bins=W, n_layers=L,
              T_ref=2400.0, dtype=torch.float64, device="cpu")
    tg.load_opacities(opacities=convert.to_opacity_stack(jg.opacities))
    rng = np.random.RandomState(0)
    T = np.asarray(jg.init_temperatures)[None, :] * rng.uniform(
        0.9, 1.1, (B, 1))
    return jg, tg, T


def _jargs(jg):
    return jg._consts, jg.planet.physics_params(), jg._kappa_fn


def _targs(tg):
    return tg._consts, tg.planet.physics_params(), tg._kappa_fn


def _compare(ref, got, rtol=1e-9):
    for f in FLOATS:
        a = np.asarray(getattr(ref, f))
        np.testing.assert_allclose(getattr(got, f).numpy(), a, rtol=rtol,
                                   atol=1e-12 * float(np.abs(a).max()),
                                   err_msg=f)
    for f in EXACT:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)),
                                      err_msg=f)


@pytest.mark.parametrize("kw", [dict(), dict(convergence_dT=5.0)],
                         ids=["default", "early-convergence"])
def test_eager_engine_matches_xla(setup, kw):
    """Default controls, and a loose threshold under which columns
    converge and freeze at different iterations."""
    jg, tg, T = setup
    ref = j_solve(jnp.asarray(T), *_jargs(jg),
                  JConfig(n_timesteps=6, engine="xla", **kw))
    got = solve_rc_batched(torch.tensor(T), *_targs(tg),
                           SolverConfig(n_timesteps=6, engine="eager",
                                        **kw))
    _compare(ref, got)
    if kw:
        assert len(set(got.n_iterations.tolist())) > 1


def test_single_column_solve(setup):
    jg, tg, T = setup
    ref = j_solve_rc(jnp.asarray(T[1]), *_jargs(jg), JConfig(n_timesteps=4))
    got = solve_rc(torch.tensor(T[1]), *_targs(tg),
                   SolverConfig(n_timesteps=4))
    _compare(ref, got)


def test_resume_from_jax_result(setup):
    """A JAX solve's loop state, carried over by io.convert, continues
    in the port exactly where a longer JAX solve goes."""
    jg, tg, T = setup
    cfg = dict(n_zero_crossings=10 ** 6, convergence_dT=0.0)
    full = j_solve(jnp.asarray(T), *_jargs(jg),
                   JConfig(n_timesteps=4, engine="xla", **cfg))
    part = j_solve(jnp.asarray(T), *_jargs(jg),
                   JConfig(n_timesteps=2, engine="xla", **cfg))
    temps, fluxes = convert.to_resume_state(part)
    params = convert.to_physics_params(jg.planet.physics_params())
    consts = convert.to_rt_constants(jg._consts)
    got = solve_rc_batched(temps, consts, params, tg._kappa_fn,
                           SolverConfig(n_timesteps=2, engine="eager",
                                        **cfg), init_fluxes=fluxes)
    for f in ("flux", "final_temps", "F_up", "F_down"):
        a = np.asarray(getattr(full, f))
        np.testing.assert_allclose(getattr(got, f).numpy(), a, rtol=1e-9,
                                   atol=1e-12 * float(np.abs(a).max()),
                                   err_msg=f)


def test_cuda_engine_needs_cuda_tensors(setup):
    _, tg, T = setup
    with pytest.raises(ValueError, match="CUDA tensors"):
        solve_rc_batched(torch.tensor(T), *_targs(tg),
                         SolverConfig(engine="cuda"))
