"""The parallel plane of frei_tpu_torch (``parallel``) against frei_tpu's,
on the CPU: a world of four gloo ranks, float64, the JAX tests' sizes
(64 bins x 10 layers, 16 columns), 3 iterations.

One spawn of four fresh interpreters (``parallel.launch.run_ranks``:
they import torch and frei_tpu_torch only) solves every mesh shape and
case and leaves the gathered (``full_tensor()``) results in an ``.npz``;
the tests read it.  The references are computed here:

* JAX ``solve_ensemble`` on ``make_mesh(4, 1)`` and ``make_mesh(2, 2)``
  over the conftest's first four virtual devices, and JAX ``solve_rc``
  per column (`tests/test_parallel.py:40-65`): every float field at
  rtol 1e-10, the integer and boolean fields exactly;
* the factorizations (4, 1), (2, 2) and (1, 4) against each other at
  rtol 1e-8 (`__graft_entry__.py:111-137`);
* ``"iteration"`` and ``"loop"`` on (4, 1) against the port's own
  one-process solve on the same engine; on (2, 2) they refuse, naming
  the engine (`tests/test_parallel.py:351-376`);
* the population mesh path against each planet's own solve (rtol 1e-9),
  and its refusal of a bins-sharded mesh;
* the differentiable solve on (4, 1) and (1, 4) with ``engine="auto"``:
  dL/dT0 and dL/dg summed over the ranks against the unsharded
  ``"eager"`` gradient (rtol 1e-10; `__graft_entry__.py:207-243`,
  `tests/test_grad.py:161-189`);
* uneven meshes and ``make_mesh``'s errors.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from frei_tpu import Grid as JGrid  # noqa: E402
from frei_tpu import Planet as JPlanet  # noqa: E402
from frei_tpu import load_example_opacity as j_fixture  # noqa: E402
from frei_tpu.parallel import make_mesh as j_make_mesh  # noqa: E402
from frei_tpu.parallel import solve_ensemble as j_solve_ensemble  # noqa: E402
from frei_tpu.rt.solver import SolverConfig as JConfig  # noqa: E402
from frei_tpu.rt.solver import solve_rc as j_solve_rc  # noqa: E402
from frei_tpu_torch import Grid, Planet, load_example_opacity  # noqa: E402
from frei_tpu_torch.io import convert  # noqa: E402
from frei_tpu_torch.opacity.hotpath import build_kappa_model  # noqa: E402
from frei_tpu_torch.parallel import make_mesh, solve_ensemble  # noqa: E402
from frei_tpu_torch.parallel.launch import run_ranks  # noqa: E402
from frei_tpu_torch.rt.physics import PhysicsParams  # noqa: E402
from frei_tpu_torch.rt.solver import (RTResult, SolverConfig,  # noqa: E402
                                      solve_rc_batched)
from frei_tpu_torch.stellar.irradiation import f_toa_rows  # noqa: E402

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parent.parent
W, L, C, N_IT = 64, 10, 16, 3
FLOATS = ["flux", "final_temps", "temp_history", "dtaus", "F_up", "F_down",
          "max_dT_history", "loop_temps", "loop_F_up", "loop_F_down"]
EXACT = ["n_iterations", "n_history", "converged"]
SHAPES = [(4, 1), (2, 2), (1, 4)]
#: the population of `tests/test_parallel.py:239-249`: a/R*, m_bar [m_p],
#: g [m/s^2], T* [K], alpha
PLANETS = [(5.0, 2.4, 24.79, 5800.0, 1.0), (9.0, 2.4, 10.0, 4500.0, 1.5),
           (6.4, 2.4, 50.0, 6300.0, 1.0), (4.0, 2.4, 15.0, 5000.0, 0.8),
           (7.5, 2.4, 35.0, 6000.0, 1.2), (5.5, 2.4, 20.0, 5500.0, 1.0),
           (8.2, 2.4, 12.0, 4800.0, 1.4), (6.0, 2.4, 28.0, 5900.0, 0.9)]

# Each rank: the grid of the fixture, then every case; a case's results
# are gathered on every rank (collectives), and rank 0 saves them.
_WORKER = r"""
import datetime, os, sys
import numpy as np
import torch
torch.set_num_threads(1)
import torch.distributed as dist
from frei_tpu_torch import Grid, Planet, load_example_opacity
from frei_tpu_torch.parallel import (initialize_distributed, make_mesh,
                                     solve_ensemble, solve_population)
from frei_tpu_torch.rt.physics import PhysicsParams
from frei_tpu_torch.rt.solver import RTResult, SolverConfig

out = sys.argv[1]
rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
initialize_distributed(
    f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}", world, rank,
    timeout=datetime.timedelta(seconds=60))
assert dist.get_backend() == "gloo"
inp = np.load(os.path.join(out, "inputs.npz"))
planet = Planet.from_hot_jupiter()
grid = Grid(planet, n_wl_bins=64, n_layers=10, T_ref=2400.0,
            dtype=torch.float64, device="cpu")
grid.load_opacities(opacities=load_example_opacity(
    grid, scale_factor=1.0, dtype=torch.float64))
consts, p0 = grid._consts, planet.physics_params()
T0 = torch.tensor(inp["T0"])
saved = {}


def mesh(nc, nb):
    return make_mesh(nc, nb, device_type="cpu")


def keep(tag, res):
    for f, x in zip(RTResult._fields, res):
        saved[f"{tag}/{f}"] = x.full_tensor().numpy()


def refusal(tag, fn):
    try:
        fn()
    except ValueError as e:
        saved[f"{tag}/error"] = np.array(str(e))
    else:
        saved[f"{tag}/error"] = np.array("")


args = (consts, p0, grid.opacities, grid.chemistry)
eager = SolverConfig(n_timesteps=3, engine="eager")
m = make_mesh(device_type="cpu")
saved["mesh/default"] = np.array(m.mesh.shape)
saved["mesh/2bins"] = np.array(make_mesh(n_bins=2, device_type="cpu")
                               .mesh.shape)
refusal("mesh/3x2", lambda: make_mesh(3, 2, device_type="cpu"))
for nc, nb in [(4, 1), (2, 2), (1, 4)]:
    keep(f"eager/{nc}x{nb}",
         solve_ensemble(T0, *args, eager, mesh=mesh(nc, nb)))
keep("eager/default", solve_ensemble(T0, *args, eager))
for engine in ("iteration", "loop"):
    cfg = SolverConfig(n_timesteps=3, engine=engine)
    keep(f"{engine}/4x1", solve_ensemble(T0, *args, cfg, mesh=mesh(4, 1)))
    m22 = mesh(2, 2)
    refusal(f"{engine}/2x2", lambda: solve_ensemble(T0, *args, cfg,
                                                    mesh=m22))
planets = [Planet(*p) for p in inp["planets"]]
T0p = T0[:len(planets)]
keep("population/4x1", solve_population(T0p, grid, planets, eager,
                                        mesh=mesh(4, 1)))
m22 = mesh(2, 2)
refusal("population/2x2", lambda: solve_population(T0p, grid, planets,
                                                   eager, mesh=m22))
for nc, nb in [(4, 1), (1, 4)]:
    T = T0.clone().requires_grad_(True)
    g = torch.tensor(float(p0.g), dtype=torch.float64, requires_grad=True)
    par = PhysicsParams(g=g, m_bar=p0.m_bar, alpha=p0.alpha, n_dof=p0.n_dof)
    cfg = SolverConfig(n_timesteps=2, n_zero_crossings=10 ** 6,
                       convergence_dT=0.0, engine="auto", differentiable=True)
    res = solve_ensemble(T, consts, par, grid.opacities, grid.chemistry, cfg,
                         mesh=mesh(nc, nb))
    loss = (res.flux.to_local() ** 2).sum() / 1e26
    loss.backward()
    grads = torch.cat([T.grad.reshape(-1), g.grad.reshape(1),
                       loss.detach().reshape(1)])
    dist.all_reduce(grads)
    saved[f"grad/{nc}x{nb}"] = grads.numpy()
m41, m14 = mesh(4, 1), mesh(1, 4)
refusal("uneven/C", lambda: solve_ensemble(T0[:15], *args, eager, mesh=m41))
cut = consts._replace(**{f: getattr(consts, f)[:62] for f in
                         ("lam_cm", "trapz_w", "sigma_scat", "F_toa")})
stack = grid.opacities
refusal("uneven/W", lambda: solve_ensemble(
    T0, cut, p0, stack._replace(values=stack.values[..., :62]),
    grid.chemistry, eager, mesh=m14))
if rank == 0:
    np.savez(os.path.join(out, "results.npz"), **saved)
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def setup():
    """The JAX grid of `tests/test_parallel.py` and the port's, whose
    fixture stack must be the JAX one bit for bit (the ranks build their
    own), and the ensemble's initial profiles (seed 11)."""
    jg = JGrid(JPlanet.from_hot_jupiter(), n_wl_bins=W, n_layers=L,
               T_ref=2400.0, dtype=jnp.float64)
    jg.load_opacities(opacities=j_fixture(jg, scale_factor=1.0,
                                          dtype=jnp.float64))
    tg = Grid(Planet.from_hot_jupiter(), n_wl_bins=W, n_layers=L,
              T_ref=2400.0, dtype=torch.float64, device="cpu")
    tg.load_opacities(opacities=load_example_opacity(
        tg, scale_factor=1.0, dtype=torch.float64))
    want = convert.to_opacity_stack(jg.opacities)
    assert torch.equal(tg.opacities.values, want.values)
    for f in ("lam_cm", "trapz_w", "pressures", "sigma_scat"):
        np.testing.assert_array_equal(getattr(tg._consts, f).numpy(),
                                      np.asarray(getattr(jg._consts, f)),
                                      err_msg=f)
    # F_toa is the device builder's row (the ranks build the same bits);
    # the JAX grid's is numpy's, whose expm1 and divisions round apart
    p = tg.planet
    assert torch.equal(tg._consts.F_toa, f_toa_rows(
        tg.rt_grid.lam_cm, [p.T_star], [p.a_rstar], torch.float64)[0])
    np.testing.assert_allclose(tg._consts.F_toa.numpy(),
                               np.asarray(jg._consts.F_toa), rtol=2e-15,
                               atol=0)
    rng = np.random.RandomState(11)
    T0 = np.asarray(jg.init_temperatures)[None, :] * rng.uniform(
        0.9, 1.1, (C, 1))
    return jg, tg, T0


@pytest.fixture(scope="module")
def ranks(setup, tmp_path_factory):
    """Every case's gathered results from one world of four gloo ranks
    on the CPU (each rank: one thread, 60 s collective timeout; the
    world: 240 s, then killed)."""
    _, _, T0 = setup
    out = tmp_path_factory.mktemp("ranks")
    np.savez(out / "inputs.npz", T0=T0, planets=np.array(PLANETS))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO)] + os.environ.get("PYTHONPATH", "").split(os.pathsep)))
    run_ranks(4, ["-c", _WORKER, out], timeout=240, env=env, cwd=REPO)
    with np.load(out / "results.npz") as z:
        return dict(z)


def _result(ranks, tag):
    return {f: ranks[f"{tag}/{f}"] for f in RTResult._fields}


@pytest.fixture(scope="module")
def jax_refs(setup):
    """JAX ``solve_ensemble`` on (4, 1) and (2, 2) meshes of four virtual
    CPU devices, and JAX ``solve_rc`` of columns 0, 7 and 15."""
    jg, _, T0 = setup
    args = (jg._consts, jg.planet.physics_params())
    cfg = JConfig(n_timesteps=N_IT)
    out = {}
    for shape in [(4, 1), (2, 2)]:
        r = j_solve_ensemble(jnp.asarray(T0), *args, jg.opacities,
                             jg.chemistry, cfg,
                             mesh=j_make_mesh(*shape,
                                              devices=jax.devices()[:4]))
        out[shape] = {f: np.asarray(getattr(r, f)) for f in FLOATS + EXACT}
    out["columns"] = {c: j_solve_rc(jnp.asarray(T0[c]), *args, jg._kappa_fn,
                                    cfg) for c in (0, 7, 15)}
    return out


def _close(got, ref, rtol, what):
    for f in FLOATS:
        a = np.asarray(ref[f])
        np.testing.assert_allclose(got[f], a, rtol=rtol,
                                   atol=1e-14 * float(np.abs(a).max()),
                                   err_msg=f"{what}: {f}")
    for f in EXACT:
        np.testing.assert_array_equal(got[f], np.asarray(ref[f]),
                                      err_msg=f"{what}: {f}")


def test_make_mesh_shapes_and_errors(ranks):
    """Every rank on columns by default, ``n_bins`` takes ranks from it,
    and a shape that is not the world raises with the JAX package's
    message (`tests/test_parallel.py:30-37`); without a process group
    ``make_mesh`` says what to call first."""
    assert tuple(ranks["mesh/default"]) == (4, 1)
    assert tuple(ranks["mesh/2bins"]) == (2, 2)
    assert str(ranks["mesh/3x2/error"]) == "mesh 3 x 2 != 4 devices"
    with pytest.raises(RuntimeError, match="initialize_distributed"):
        make_mesh(device_type="cpu")


@pytest.mark.parametrize("shape", [(4, 1), (2, 2)], ids=str)
def test_ensemble_matches_jax_ensemble(ranks, jax_refs, shape):
    """The gathered sharded solve against JAX ``solve_ensemble`` on the
    same mesh shape: every field, rtol 1e-10."""
    got = _result(ranks, "eager/{}x{}".format(*shape))
    assert got["flux"].shape == (C, W) and got["dtaus"].shape == (C, L, W)
    _close(got, jax_refs[shape], 1e-10, f"mesh {shape}")


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_ensemble_matches_per_column(ranks, jax_refs, shape):
    """Each factorization, (1, 4) included, against JAX ``solve_rc`` of
    single columns: flux and final temperatures at rtol 1e-10, the
    iteration count exactly."""
    got = _result(ranks, "eager/{}x{}".format(*shape))
    for c, one in jax_refs["columns"].items():
        np.testing.assert_allclose(got["flux"][c], np.asarray(one.flux),
                                   rtol=1e-10, err_msg=f"{shape} {c}")
        np.testing.assert_allclose(got["final_temps"][c],
                                   np.asarray(one.final_temps), rtol=1e-10,
                                   err_msg=f"{shape} {c}")
        assert got["n_iterations"][c] == int(one.n_iterations)


def test_factorizations_agree(ranks):
    """(2, 2) and (1, 4) against (4, 1) at rtol 1e-8 (a bins split sums
    the quadratures in another order); ``mesh=None`` in a world is
    ``make_mesh()``, (4, 1), bit for bit."""
    ref = _result(ranks, "eager/4x1")
    for shape in ("2x2", "1x4"):
        _close(_result(ranks, f"eager/{shape}"), ref, 1e-8, shape)
    default = _result(ranks, "eager/default")
    for f in FLOATS + EXACT:
        np.testing.assert_array_equal(default[f], ref[f], err_msg=f)


@pytest.mark.parametrize("engine", ["iteration", "loop"])
def test_whole_iteration_engines_on_meshes(ranks, setup, engine):
    """On a columns-only mesh the whole-iteration engines (their plain
    twins here) equal their one-process solve; a bins-sharded mesh is
    refused with the engine named."""
    _, tg, T0 = setup
    ref = solve_rc_batched(torch.tensor(T0), tg._consts,
                           tg.planet.physics_params(), tg._kappa_fn,
                           SolverConfig(n_timesteps=N_IT, engine=engine))
    _close(_result(ranks, f"{engine}/4x1"),
           {f: getattr(ref, f).numpy() for f in FLOATS + EXACT}, 1e-12,
           engine)
    assert (f"engine {engine!r} does not support a bins-sharded mesh"
            in str(ranks[f"{engine}/2x2/error"]))


def test_population_mesh(ranks, setup):
    """Eight planets on a (4, 1) mesh against each planet's own grid and
    solve at rtol 1e-9 (`tests/test_parallel.py:297-321`); a (2, 2) mesh
    is refused with "columns"."""
    _, tg, T0 = setup
    got = _result(ranks, "population/4x1")
    cfg = SolverConfig(n_timesteps=N_IT, engine="eager")
    for c, p in enumerate(PLANETS):
        p = Planet(*p)
        g1 = Grid(p, n_wl_bins=W, n_layers=L, T_ref=2400.0,
                  dtype=torch.float64, device="cpu")
        g1.load_opacities(opacities=tg.opacities)
        one = solve_rc_batched(torch.tensor(T0[c:c + 1]), g1._consts,
                               p.physics_params(), g1._kappa_fn, cfg)
        for f in ("flux", "final_temps", "dtaus"):
            np.testing.assert_allclose(got[f][c], getattr(one, f)[0].numpy(),
                                       rtol=1e-9, err_msg=f"{c} {f}")
    assert "columns" in str(ranks["population/2x2/error"])


@pytest.mark.parametrize("shape", [(4, 1), (1, 4)], ids=str)
def test_differentiable_sharded_gradients(ranks, setup, shape):
    """``differentiable=True`` with ``engine="auto"`` on a columns and a
    bins mesh: the loss and dL/dT0, dL/dg summed over the ranks equal the
    unsharded ``"eager"`` solve's at rtol 1e-10 (the bins all-reduce
    carries gradients)."""
    _, tg, T0 = setup
    T = torch.tensor(T0, requires_grad=True)
    p0 = tg.planet.physics_params()
    g = torch.tensor(float(p0.g), dtype=torch.float64, requires_grad=True)
    par = PhysicsParams(g=g, m_bar=p0.m_bar, alpha=p0.alpha, n_dof=p0.n_dof)
    cfg = SolverConfig(n_timesteps=2, n_zero_crossings=10 ** 6,
                       convergence_dT=0.0, engine="eager",
                       differentiable=True)
    res = solve_rc_batched(T, tg._consts, par, tg._kappa_fn, cfg)
    loss = (res.flux ** 2).sum() / 1e26
    loss.backward()
    loss = loss.detach()
    got = ranks["grad/{}x{}".format(*shape)]
    np.testing.assert_allclose(got[:-2].reshape(C, L), T.grad.numpy(),
                               rtol=1e-10, err_msg="dL/dT0")
    np.testing.assert_allclose(got[-2], float(g.grad), rtol=1e-10,
                               err_msg="dL/dg")
    np.testing.assert_allclose(got[-1], float(loss), rtol=1e-12,
                               err_msg="loss")


def test_uneven_meshes_raise(ranks):
    """15 columns over 4 ranks and 62 bins over 4 are refused, as the
    JAX package's ``shard_map`` refuses uneven shards."""
    assert "columns axis of 15" in str(ranks["uneven/C/error"])
    assert "wavelength axis of 62" in str(ranks["uneven/W/error"])


def test_no_process_group_is_one_device_solve(setup):
    """Without a process group and a mesh the solve is one device's:
    plain tensors, bit for bit ``solve_rc_batched`` on the grid's κ
    model."""
    _, tg, T0 = setup
    T = torch.tensor(T0)
    cfg = SolverConfig(n_timesteps=N_IT)
    got = solve_ensemble(T, tg._consts, tg.planet.physics_params(),
                         tg.opacities, tg.chemistry, cfg)
    ref = solve_rc_batched(T, tg._consts, tg.planet.physics_params(),
                           tg._kappa_fn, cfg)
    for f in FLOATS + EXACT:
        assert type(getattr(got, f)) is torch.Tensor, f
        assert torch.equal(getattr(got, f), getattr(ref, f)), f


def test_shard_kappa_model_is_a_slice_of_the_whole(setup):
    """A rank's κ model, built over its slice of the stack, carries the
    grid's hooks, and its layer tables are the whole tables' wavelengths
    bit for bit (the P-interpolation is elementwise along W); the
    opacity it contracts from them agrees to the last ulp (a matmul
    blocks the narrower slab otherwise)."""
    _, tg, _ = setup
    whole = tg._kappa_fn
    sl = slice(16, 32)
    s = tg.opacities
    part = build_kappa_model(s._replace(values=s.values[..., sl]),
                             tg.chemistry, tg._consts.pressures,
                             tg._consts.sigma_scat[sl])
    assert torch.equal(part.layer_tables.tab,
                       whole.layer_tables.tab[..., sl])
    assert part.layer_parts[1] is part.layer_tables.tab
    assert part.iteration_hook is not None and part.chem is tg.chemistry
    T = torch.tensor(setup[2][:2])
    np.testing.assert_allclose(
        part(T, tg._consts.pressures).numpy(),
        whole(T, tg._consts.pressures)[..., sl].numpy(), rtol=1e-15)


def test_workers_import_no_jax():
    """The ranks' script imports torch and frei_tpu_torch, never JAX."""
    code = _WORKER.split("out = sys.argv[1]")[0] + (
        "\nbad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'frei_tpu')]\nassert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO,
                   timeout=120)
