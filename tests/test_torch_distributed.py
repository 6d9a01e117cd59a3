"""Multi-process start-up and the solves of a world of two, on the CPU.

``frei_tpu_torch.parallel.initialize_distributed`` is the counterpart of
the JAX package's ``jax.distributed`` wrapper
(`tests/test_distributed.py:48-77`): a no-op on one process, and on two
a gloo world (no CUDA here) that both processes join.  In that world of
two fresh interpreters (``parallel.launch.run_ranks``; torch and
frei_tpu_torch only), float64, 64 bins x 10 layers:

* early-convergence freezing on a (2, 1) mesh (`tests/test_parallel.py:
  68-87`, with a 5 K threshold so that the columns stop at different
  iterations), and on a (1, 2) mesh, whose two ranks must leave the loop
  together: final temperatures against single-column solves at rtol
  1e-10, iteration counts exactly;
* table-mode equilibrium chemistry through the layer-factored path
  (`tests/test_parallel.py:379-424`): ``chem.mmr`` is replaced by a
  function that raises, so any per-iteration 2-D table lookup in the
  sharded solve would fail; the results against single-column solves
  with the factored κ at rtol 1e-10.  The table is 2 x 2 (a 12 x 8 table
  takes ~24 s to build on one thread of the CPU); what the test pins is
  the route, not the table.
"""

import json
import os
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from frei_tpu_torch import Grid, Planet, load_example_opacity  # noqa: E402
from frei_tpu_torch.parallel import initialize_distributed  # noqa: E402
from frei_tpu_torch.parallel.launch import run_ranks  # noqa: E402
from frei_tpu_torch.rt.solver import SolverConfig, solve_rc  # noqa: E402

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parent.parent
W, L = 64, 10

_WORKER = r"""
import datetime, json, os, sys
import numpy as np
import torch
torch.set_num_threads(1)
import torch.distributed as dist
from frei_tpu_torch import Grid, Planet, load_example_opacity
from frei_tpu_torch.chemistry.fastchem import FastChemTorch
from frei_tpu_torch.opacity.tables import (kappa_from_layer_tables,
                                           make_layer_tables)
from frei_tpu_torch.parallel import (initialize_distributed, make_mesh,
                                     solve_ensemble)
from frei_tpu_torch.rt.solver import SolverConfig, solve_rc

out = sys.argv[1]
rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
initialize_distributed(
    f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}", world, rank,
    timeout=datetime.timedelta(seconds=60))
with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
    json.dump({"rank": dist.get_rank(), "world": dist.get_world_size(),
               "backend": dist.get_backend()}, f)
inp = np.load(os.path.join(out, "inputs.npz"))
planet = Planet.from_hot_jupiter()
grid = Grid(planet, n_wl_bins=64, n_layers=10, T_ref=2400.0,
            dtype=torch.float64, device="cpu")
grid.load_opacities(opacities=load_example_opacity(
    grid, scale_factor=1.0, dtype=torch.float64))
consts, p0 = grid._consts, planet.physics_params()
saved = {}
meshes = {s: make_mesh(*s, device_type="cpu") for s in [(2, 1), (1, 2)]}

T0 = torch.tensor(inp["T_freeze"])
for (nc, nb), m in meshes.items():
    res = solve_ensemble(T0, consts, p0, grid.opacities, grid.chemistry,
                         SolverConfig(n_timesteps=30, convergence_dT=5.0),
                         mesh=m)
    saved[f"freeze/{nc}x{nb}/final_temps"] = res.final_temps.full_tensor()
    saved[f"freeze/{nc}x{nb}/n_iterations"] = res.n_iterations.full_tensor()

chem = FastChemTorch(grid.opacities.species, planet.m_bar, mode="table",
                     grid_shape=(2, 2), build_device="cpu")
T0 = torch.tensor(inp["T_chem"])
cfg = SolverConfig(n_timesteps=2)
lt = make_layer_tables(grid.opacities, consts.pressures)
mmr_fn = chem.layer_mmr_interp(consts.pressures)


def kappa_all(temps, pressures):
    k, _ = kappa_from_layer_tables(lt, mmr_fn(temps), temps,
                                   consts.sigma_scat)
    return k


for c in (0, 5):
    one = solve_rc(T0[c], consts, p0, kappa_all, cfg)
    saved[f"chem/ref{c}/flux"] = one.flux
    saved[f"chem/ref{c}/final_temps"] = one.final_temps


def bomb(*a, **k):
    raise AssertionError("chem.mmr called in the sharded solve: the "
                         "layer-factored path was not used")


chem.mmr = bomb
for (nc, nb), m in meshes.items():
    res = solve_ensemble(T0, consts, p0, grid.opacities, chem, cfg, mesh=m)
    saved[f"chem/{nc}x{nb}/flux"] = res.flux.full_tensor()
    saved[f"chem/{nc}x{nb}/final_temps"] = res.final_temps.full_tensor()
if rank == 0:
    np.savez(os.path.join(out, "results.npz"),
             **{k: v.numpy() for k, v in saved.items()})
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def grid():
    g = Grid(Planet.from_hot_jupiter(), n_wl_bins=W, n_layers=L,
             T_ref=2400.0, dtype=torch.float64, device="cpu")
    g.load_opacities(opacities=load_example_opacity(
        g, scale_factor=1.0, dtype=torch.float64))
    return g


@pytest.fixture(scope="module")
def world2(grid, tmp_path_factory):
    """A world of two gloo ranks (each: one thread, 60 s collective
    timeout; the world: 180 s, then killed): the ranks' view of the
    world and every case's gathered results."""
    base = np.asarray(grid.init_temperatures)
    rng = np.random.RandomState(11)
    inputs = dict(T_freeze=np.stack([base, base * 1.08]),
                  T_chem=base[None, :] * rng.uniform(0.9, 1.1, (8, 1)))
    out = tmp_path_factory.mktemp("world2")
    np.savez(out / "inputs.npz", **inputs)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO)] + os.environ.get("PYTHONPATH", "").split(os.pathsep)))
    run_ranks(2, ["-c", _WORKER, out], timeout=180, env=env, cwd=REPO)
    views = [json.loads((out / f"rank{r}.json").read_text())
             for r in range(2)]
    with np.load(out / "results.npz") as z:
        return inputs, views, dict(z)


def test_initialize_distributed_single_process_noop():
    """One process: no process group is made (and no rendezvous
    attempted)."""
    import torch.distributed as dist
    initialize_distributed(num_processes=1)
    initialize_distributed()
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="coordinator_address"):
        initialize_distributed(num_processes=2)


def test_two_process_initialize_distributed(world2):
    """Both processes join one world of two, each with its own rank, on
    gloo (the default where CUDA is absent)."""
    _, views, _ = world2
    assert views == [{"rank": r, "world": 2, "backend": "gloo"}
                     for r in range(2)]


@pytest.mark.parametrize("shape", ["2x1", "1x2"])
def test_early_convergence_freezing(world2, grid, shape):
    """A column that converges early stays frozen while the other runs
    on (a 5 K threshold stops them after 13 and 9 iterations): each
    column's final temperatures and iteration count are its
    single-column solve's, on a columns mesh (each rank stops when its
    own column does) and on a bins mesh (both ranks run until both
    columns are done)."""
    inputs, _, got = world2
    n_iters = []
    for c in range(2):
        one = solve_rc(torch.tensor(inputs["T_freeze"][c]), grid._consts,
                       grid.planet.physics_params(), grid._kappa_fn,
                       SolverConfig(n_timesteps=30, convergence_dT=5.0))
        np.testing.assert_allclose(got[f"freeze/{shape}/final_temps"][c],
                                   one.final_temps.numpy(), rtol=1e-10)
        assert got[f"freeze/{shape}/n_iterations"][c] == int(
            one.n_iterations)
        n_iters.append(int(one.n_iterations))
    assert n_iters[0] != n_iters[1], n_iters   # the freeze is exercised


@pytest.mark.parametrize("shape", ["2x1", "1x2"])
def test_ensemble_table_chemistry_uses_factored_path(world2, shape):
    """Table chemistry with ``chem.mmr`` made to raise: the sharded solve
    still runs (the layer-factored evaluator) and equals the
    single-column solves of the factored κ."""
    _, _, got = world2
    for c in (0, 5):
        for f in ("flux", "final_temps"):
            np.testing.assert_allclose(got[f"chem/{shape}/{f}"][c],
                                       got[f"chem/ref{c}/{f}"], rtol=1e-10,
                                       err_msg=f"{c} {f}")
