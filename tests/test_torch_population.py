"""Population mode of frei_tpu_torch against frei_tpu (float64): one
planet per column, with per-column g, alpha, m_bar and F_toa.

* the eager engine against the JAX ``"xla"`` engine, which vmaps
  single-column sweeps over the per-column values: rtol 1e-9, the
  tolerance of ``tests/test_torch_solver.py`` on this grid (the
  bolometric matvecs sum in another order and the adaptive timestep
  amplifies it: a shared-planet solve here differs by up to 6e-11 after
  two iterations, and a population by no more);
* the sweep kernels' plain twins with per-column constants against the
  JAX Pallas sweep kernels in interpret mode (rtol 1e-7 with atol 1e-9 x
  max, the tolerance of ``tests/test_torch_sweep.py``: the Pallas kernels
  evaluate expm1 by a series and multiply by a per-column 1/g), and
  column by column bit for bit against the shared-planet twins;
* a population of identical planets bit for bit against the shared
  solve;
* ``solve_population`` against per-planet solves (rtol 1e-9) and the JAX
  ``solve_population`` (rtol 1e-9);
* the guards: wrong lengths raise on every engine, size-1 values
  broadcast, the whole-iteration engines and mixed compositions refuse;
* the mesh path in a world of two gloo ranks: a columns mesh solves, a
  bins mesh is refused.
"""

import os
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from frei_tpu import Grid as JGrid  # noqa: E402
from frei_tpu import Planet as JPlanet  # noqa: E402
from frei_tpu import load_example_opacity as j_fixture  # noqa: E402
from frei_tpu.ops import sweep_pallas as sp  # noqa: E402
from frei_tpu.parallel import solve_population as j_population  # noqa: E402
from frei_tpu.rt.physics import PhysicsParams as JParams  # noqa: E402
from frei_tpu.rt.solver import SolverConfig as JConfig  # noqa: E402
from frei_tpu.rt.solver import solve_rc_batched as j_solve  # noqa: E402
from frei_tpu_torch import Grid, Planet  # noqa: E402
from frei_tpu_torch.io import convert  # noqa: E402
from frei_tpu_torch.ops import sweep_cuda as S  # noqa: E402
from frei_tpu_torch.parallel import solve_population  # noqa: E402
from frei_tpu_torch.parallel.launch import run_ranks  # noqa: E402
from frei_tpu_torch.rt.solver import SolverConfig, solve_rc_batched  # noqa: E402

torch.set_num_threads(2)
B, L, W = 3, 7, 24
FLOATS = ["flux", "final_temps", "temp_history", "dtaus", "F_up", "F_down",
          "max_dT_history", "loop_temps", "loop_F_up", "loop_F_down"]
EXACT = ["n_iterations", "n_history", "converged"]


def _planets(n=3):
    """The population of ``tests/test_parallel.py`` (its first n)."""
    return [
        (5.0, 2.4, 24.79, 5800.0, 1.0), (9.0, 2.4, 10.0, 4500.0, 1.5),
        (6.4, 2.4, 50.0, 6300.0, 1.0), (4.0, 2.4, 15.0, 5000.0, 0.8),
        (7.5, 2.4, 35.0, 6000.0, 1.2), (5.5, 2.4, 20.0, 5500.0, 1.0),
        (8.2, 2.4, 12.0, 4800.0, 1.4), (6.0, 2.4, 28.0, 5900.0, 0.9),
    ][:n]


@pytest.fixture(scope="module")
def setup():
    jg = JGrid(JPlanet.from_hot_jupiter(), n_wl_bins=W, n_layers=L,
               T_ref=2400.0, dtype=jnp.float64)
    jg.load_opacities(opacities=j_fixture(jg, scale_factor=1.0,
                                          dtype=jnp.float64))
    tg = Grid(Planet.from_hot_jupiter(), n_wl_bins=W, n_layers=L,
              T_ref=2400.0, dtype=torch.float64, device="cpu")
    tg.load_opacities(opacities=convert.to_opacity_stack(jg.opacities))
    rng = np.random.RandomState(11)
    T = np.asarray(jg.init_temperatures)[None, :] * rng.uniform(
        0.9, 1.1, (B, 1))
    return jg, tg, T


def _population_inputs(jg, fields):
    """Per-column values for ``fields`` (a subset of g, alpha, m_bar,
    F_toa) from the population's first B planets, the hot Jupiter's
    values elsewhere: (JAX consts, JAX params, torch consts, torch
    params)."""
    from frei_tpu.stellar.irradiation import f_toa_np
    p0 = jg.planet.physics_params()
    pl = [JPlanet(*p) for p in _planets(B)]
    vals = {"g": np.array([p.g for p in pl]),
            "alpha": np.array([p.alpha for p in pl]),
            "m_bar": p0.m_bar * np.array([1.0, 1.1, 0.9])}
    kw = {f: (vals[f] if f in fields else getattr(p0, f))
          for f in ("g", "alpha", "m_bar")}
    jparams = JParams(n_dof=p0.n_dof, **{k: (jnp.asarray(v) if np.ndim(v)
                                             else v) for k, v in kw.items()})
    jconsts = jg._consts
    if "F_toa" in fields:
        lam = np.asarray(jg.rt_grid.lam_cm)
        jconsts = jconsts._replace(F_toa=jnp.asarray(np.stack(
            [f_toa_np(lam, p.T_star, p.a_rstar) for p in pl])))
    return (jconsts, jparams, convert.to_rt_constants(jconsts),
            convert.to_physics_params(jparams))


def _compare(ref, got, rtol):
    for f in FLOATS:
        a = np.asarray(getattr(ref, f))
        np.testing.assert_allclose(getattr(got, f).numpy(), a, rtol=rtol,
                                   atol=1e-14 * float(np.abs(a).max()),
                                   err_msg=f)
    for f in EXACT:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)),
                                      err_msg=f)


@pytest.mark.parametrize("fields", [("g",), ("alpha",), ("m_bar",),
                                    ("F_toa",), ("g", "alpha", "F_toa")],
                         ids=lambda f: "+".join(f))
def test_eager_population_matches_xla(setup, fields):
    """Per-column g, alpha, m_bar (the dtau and timestep physics only) and
    F_toa: the eager engine against the JAX "xla" engine's vmapped
    single-column sweeps, 3 iterations."""
    jg, tg, T = setup
    jconsts, jparams, tconsts, tparams = _population_inputs(jg, fields)
    ref = j_solve(jnp.asarray(T), jconsts, jparams, jg._kappa_fn,
                  JConfig(n_timesteps=3, engine="xla"))
    got = solve_rc_batched(torch.tensor(T), tconsts, tparams, tg._kappa_fn,
                           SolverConfig(n_timesteps=3, engine="eager"))
    _compare(ref, got, 1e-9)


def _sweep_state(tg, T):
    rng = np.random.RandomState(0)
    Fu, Fd = (torch.tensor(rng.rand(B, L, W) * 1e10) for _ in range(2))
    ohs_fn, tab = tg._kappa_fn.layer_parts
    T = torch.tensor(T)
    kaps = {"fused": (ohs_fn(T), tab),
            "kappa": tg._kappa_fn(T, tg._consts.pressures).contiguous()}
    return T, Fu, Fd, kaps


@pytest.mark.parametrize("fused", [False, True], ids=["kappa", "fused"])
@pytest.mark.parametrize("direction", ["emit", "absorb"])
def test_population_twins_match_pallas_kernel(setup, direction, fused):
    """The twins with per-column dtau factors (B, L-1) and F_toa (B, W)
    against the JAX Pallas kernels' per-column forms (1/g (B, 1), F_toa
    blocks), one column frozen; and each column bit for bit against the
    shared-planet twin of its own planet."""
    jg, tg, T_np = setup
    jconsts, jparams, tconsts, tparams = _population_inputs(
        jg, ("g", "alpha", "F_toa"))
    T, Fu, Fd, kaps = _sweep_state(tg, T_np)
    kap = kaps["fused" if fused else "kappa"]
    done = torch.tensor([False, True, False])
    scj = sp.make_sweep_consts(jconsts, jparams)
    assert scj.inv_g is not None and scj.f_toa.shape == (B, W)
    kern = sp._emit_kernel if direction == "emit" else sp._absorb_kernel
    dtf = scj.dtf_emit if direction == "emit" else scj.dtf_absorb
    kap_j = (tuple(jnp.asarray(x.numpy()) for x in kap) if fused
             else jnp.asarray(kap.numpy()))
    ref = sp._run_sweep(kern, dtf, jnp.asarray(T_np), kap_j,
                        jnp.asarray(Fu.numpy()), jnp.asarray(Fd.numpy()),
                        scj, 2, True, done=jnp.asarray(done.numpy()))
    sc = S.make_sweep_consts(
        tconsts, tparams._replace(g=torch.as_tensor(tparams.g)[:, None]))
    assert sc.dtf_emit.shape == (B, L - 1) and sc.f_toa.shape == (B, W)
    wrap = S.emit_kernel if direction == "emit" else S.absorb_kernel
    got = wrap(T, Fu, Fd, kap, sc, done)
    for name, a, b in zip(["F_up", "F_down", "sums"], ref, got):
        a = np.asarray(a)
        np.testing.assert_allclose(b.numpy(), a, rtol=1e-7,
                                   atol=1e-9 * float(np.abs(a).max()),
                                   err_msg=f"{direction} {name}")
    # the opacity of the whole batch, as the twin contracts it (a batched
    # einsum sums in an order that depends on the batch)
    k_all = S._kappa_slab(kap, sc)
    for c in range(B):
        one = tconsts._replace(F_toa=tconsts.F_toa[c])
        sc1 = S.make_sweep_consts(one, tparams._replace(g=tparams.g[c]))
        want = wrap(T[c:c + 1], Fu[c:c + 1], Fd[c:c + 1], k_all[c:c + 1],
                    sc1, done[c:c + 1])
        assert all(torch.equal(x[c], y[0]) for x, y in zip(got, want)), c


@pytest.mark.parametrize("fused", [False, True], ids=["kappa", "fused"])
def test_emit_dtaus_per_column(setup, fused):
    """The final emit's dtaus diagnostic with per-column gravity: the
    twin's against the eager ``emit_dtaus``."""
    from frei_tpu_torch.rt.sweeps import emit_dtaus
    jg, tg, T_np = setup
    _, _, tconsts, tparams = _population_inputs(jg, ("g",))
    T, Fu, Fd, kaps = _sweep_state(tg, T_np)
    g = torch.as_tensor(tparams.g)[:, None]
    sc = S.make_sweep_consts(tconsts, tparams._replace(g=g))
    *_, dtaus = S.emit_kernel(T, Fu, Fd, kaps["fused" if fused else "kappa"],
                              sc, with_dtaus=True)
    want = emit_dtaus(kaps["kappa"], tconsts.pressures,
                      tparams._replace(g=g))
    np.testing.assert_allclose(dtaus.numpy(), want.numpy(), rtol=1e-14)


@pytest.mark.parametrize("engine", ["eager", "sweep twins"])
def test_identical_population_equals_shared_solve(setup, engine):
    """B copies of one planet as a population give the shared-planet
    results bit for bit: the eager solve, and the sweep twins (the
    ``"cuda"`` engine's arithmetic on the CPU) with per-column
    constants."""
    jg, tg, T_np = setup
    consts, p0 = tg._consts, tg.planet.physics_params()
    pop_consts = consts._replace(F_toa=consts.F_toa.expand(B, -1))
    pop_params = p0._replace(g=torch.full((B,), p0.g, dtype=torch.float64),
                             alpha=torch.full((B,), p0.alpha,
                                              dtype=torch.float64))
    if engine == "eager":
        cfg = SolverConfig(n_timesteps=3, engine="eager")
        T = torch.tensor(T_np)
        a = solve_rc_batched(T, consts, p0, tg._kappa_fn, cfg)
        b = solve_rc_batched(T, pop_consts, pop_params, tg._kappa_fn, cfg)
        for f in FLOATS + EXACT:
            assert torch.equal(getattr(a, f), getattr(b, f)), f
        return
    T, Fu, Fd, kaps = _sweep_state(tg, T_np)
    pin = p0._replace(g=torch.tensor(p0.g, dtype=torch.float64))
    sc = S.make_sweep_consts(consts, pin)
    sc_pop = S.make_sweep_consts(
        pop_consts, pin._replace(g=torch.full((B, 1), p0.g,
                                              dtype=torch.float64)))
    for kap in kaps.values():
        for a, b in ((S.emit_kernel(T, Fu, Fd, kap, sc, with_dtaus=True),
                      S.emit_kernel(T, Fu, Fd, kap, sc_pop,
                                    with_dtaus=True)),
                     (S.absorb_kernel(T, Fu, Fd, kap, sc),
                      S.absorb_kernel(T, Fu, Fd, kap, sc_pop))):
            assert all(torch.equal(x, y) for x, y in zip(a, b))


def _torch_planets(n):
    return [Planet(*p) for p in _planets(n)]


def test_solve_population_matches_per_planet_and_jax(setup):
    """``solve_population`` of three planets against each planet's own
    grid and solve (rtol 1e-9, the batched-against-single-column
    tolerance of ``tests/test_parallel.py``) and against the JAX
    ``solve_population`` (rtol 1e-9, as above)."""
    jg, tg, T_np = setup
    cfg = SolverConfig(n_timesteps=3, engine="eager")
    res = solve_population(torch.tensor(T_np), tg, _torch_planets(B), cfg)
    assert res.flux.shape == (B, W)
    ref = j_population(jnp.asarray(T_np), jg,
                       [JPlanet(*p) for p in _planets(B)],
                       JConfig(n_timesteps=3, engine="xla"))
    _compare(ref, res, 1e-9)
    for c, p in enumerate(_torch_planets(B)):
        g1 = Grid(p, n_wl_bins=W, n_layers=L, T_ref=2400.0,
                  dtype=torch.float64, device="cpu")
        g1.load_opacities(opacities=tg.opacities)
        one = solve_rc_batched(torch.tensor(T_np[c:c + 1]), g1._consts,
                               p.physics_params(), g1._kappa_fn, cfg)
        for f in ("flux", "final_temps", "dtaus"):
            np.testing.assert_allclose(getattr(res, f)[c].numpy(),
                                       getattr(one, f)[0].numpy(),
                                       rtol=1e-9, err_msg=f"{c} {f}")


@pytest.mark.parametrize("field", ["params.g", "params.alpha",
                                   "params.m_bar", "F_toa"])
@pytest.mark.parametrize("engine", ["eager", "iteration", "loop"])
def test_wrong_lengths_raise_on_every_engine(setup, engine, field):
    """Wrong per-column lengths fail loudly before the engine branch, the
    JAX package's message on every engine
    (`tests/test_sweep_pallas.py:145-161`)."""
    _, tg, T_np = setup
    consts, p0 = tg._consts, tg.planet.physics_params()
    if field == "F_toa":
        consts = consts._replace(F_toa=consts.F_toa.expand(B + 1, -1))
        match = "per-column F_toa has 4 rows"
    else:
        name = field.split(".")[1]
        p0 = p0._replace(**{name: torch.full((B + 1,), getattr(p0, name),
                                             dtype=torch.float64)})
        match = f"per-column {field} has length 4, expected 3"
    with pytest.raises(ValueError, match=match):
        solve_rc_batched(torch.tensor(T_np), consts, p0, tg._kappa_fn,
                         SolverConfig(n_timesteps=1, engine=engine))


def test_size1_per_column_values_broadcast(setup):
    """A (1,) g and alpha and a (1, W) F_toa with B > 1 columns mean the
    shared values for every column: bit for bit the shared solve, and the
    JAX "xla" engine on the same size-1 inputs at rtol 1e-9
    (`tests/test_sweep_pallas.py:164-198`)."""
    jg, tg, T_np = setup
    consts, p0 = tg._consts, tg.planet.physics_params()
    par1 = p0._replace(g=torch.tensor([p0.g], dtype=torch.float64),
                       alpha=torch.tensor([p0.alpha], dtype=torch.float64))
    consts1 = consts._replace(F_toa=consts.F_toa[None, :])
    cfg = SolverConfig(n_timesteps=2, engine="eager")
    T = torch.tensor(T_np)
    got = solve_rc_batched(T, consts1, par1, tg._kappa_fn, cfg)
    ref = solve_rc_batched(T, consts, p0, tg._kappa_fn, cfg)
    assert torch.equal(got.flux, ref.flux)
    assert torch.equal(got.final_temps, ref.final_temps)
    jp = jg.planet.physics_params()
    jpar1 = jp._replace(g=jnp.asarray([jp.g]), alpha=jnp.asarray([jp.alpha]))
    jref = j_solve(jnp.asarray(T_np),
                   jg._consts._replace(F_toa=jg._consts.F_toa[None, :]),
                   jpar1, jg._kappa_fn, JConfig(n_timesteps=2, engine="xla"))
    _compare(jref, got, 1e-9)


@pytest.mark.parametrize("engine", ["iteration", "loop"])
def test_population_refused_by_whole_iteration_engines(setup, engine):
    """The whole-iteration kernels bake F_toa and g into their constant
    pack: a population is refused with the JAX package's message
    (`tests/test_parallel.py:324-336`)."""
    _, tg, T_np = setup
    with pytest.raises(ValueError, match=(
            f"engine '{engine}' does not support per-column params / "
            "F_toa")):
        solve_population(torch.tensor(T_np[:2]), tg, _torch_planets(2),
                         SolverConfig(n_timesteps=2, engine=engine))


_MESH_WORKER = r"""
import datetime, os, sys
import numpy as np
import torch
torch.set_num_threads(1)
import torch.distributed as dist
from frei_tpu_torch import Grid, Planet, load_example_opacity
from frei_tpu_torch.parallel import (initialize_distributed, make_mesh,
                                     solve_population)

out = sys.argv[1]
initialize_distributed(
    f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}",
    int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"]),
    timeout=datetime.timedelta(seconds=60))
inp = np.load(os.path.join(out, "inputs.npz"))
grid = Grid(Planet.from_hot_jupiter(), n_wl_bins=24, n_layers=7,
            T_ref=2400.0, dtype=torch.float64, device="cpu")
grid.load_opacities(opacities=load_example_opacity(
    grid, scale_factor=1.0, dtype=torch.float64))
planets = [Planet(*p) for p in inp["planets"]]
res = solve_population(torch.tensor(inp["T"]), grid, planets,
                       mesh=make_mesh(2, 1, device_type="cpu"))
saved = {f: getattr(res, f).full_tensor().numpy()
         for f in ("flux", "final_temps")}
try:
    solve_population(torch.tensor(inp["T"]), grid, planets,
                     mesh=make_mesh(1, 2, device_type="cpu"))
except ValueError as e:
    saved["error"] = np.array(str(e))
if dist.get_rank() == 0:
    np.savez(os.path.join(out, "results.npz"), **saved)
dist.destroy_process_group()
"""


def test_population_refuses_mixed_composition_and_mesh(setup, tmp_path):
    """Planets of different m_bar are refused (`tests/test_parallel.py:
    339-348`).  On a device mesh the planets shard over the columns: a
    (2, 1) mesh of two gloo ranks solves two planets as the one-process
    solve does (rtol 1e-10: a rank's batch of one sums in another order
    than a batch of two), and a (1, 2) mesh is refused with "columns"
    (`tests/test_parallel.py:297-321`)."""
    _, tg, T_np = setup
    planets = [Planet(5.0, 2.4, 24.79, 5800.0), Planet(5.0, 2.8, 24.79,
                                                       5800.0)]
    with pytest.raises(ValueError, match="m_bar"):
        solve_population(torch.tensor(T_np[:2]), tg, planets)
    np.savez(tmp_path / "inputs.npz", T=T_np[:2], planets=np.array(_planets(2)))
    repo = Path(__file__).resolve().parent.parent
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(repo)] + os.environ.get("PYTHONPATH", "").split(os.pathsep)))
    run_ranks(2, ["-c", _MESH_WORKER, tmp_path], timeout=120, env=env,
              cwd=repo)
    got = np.load(tmp_path / "results.npz")
    ref = solve_population(torch.tensor(T_np[:2]), tg, _torch_planets(2))
    for f in ("flux", "final_temps"):
        np.testing.assert_allclose(got[f], getattr(ref, f).numpy(),
                                   rtol=1e-10, err_msg=f)
    assert "columns" in str(got["error"])
