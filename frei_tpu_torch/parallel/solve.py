"""Sharded batched radiative-convective solves on ``torch.distributed``.

Counterpart of ``frei_tpu.parallel.solve``.  One process per device (the
torchrun model): every rank calls the same function with the same global
inputs, solves its slice (its columns, and on a bins-sharded mesh its
wavelengths) through ``rt.solver.solve_rc_batched``, and returns DTensors
whose local pieces are that slice.  The columns dim needs no collective;
on a bins-sharded mesh each sweep sums its (B, 4, L-1) quadrature block
over the bins group once, and the ranks of a group leave the iteration
loop together.

Multi-process start-up: :func:`initialize_distributed` on every rank,
then :func:`~frei_tpu_torch.parallel.mesh.make_mesh`.  Keep the bins
shards within a host: ``make_mesh``'s rank order does this by
construction.
"""

from __future__ import annotations

from datetime import timedelta
from typing import Optional

import torch
import torch.distributed as dist

from ..diag import telemetry
from ..opacity.hotpath import build_kappa_model
from ..opacity.tables import OpacityStack
from ..rt.physics import PhysicsParams
from ..rt.solver import RTConstants, RTResult, SolverConfig, solve_rc_batched
from ..stellar.irradiation import f_toa_rows
from .mesh import BINS, COLUMNS, make_mesh

__all__ = ["initialize_distributed", "shard_solver_inputs", "solve_ensemble",
           "solve_population"]

#: fields of an ensemble's RTResult with a wavelength axis, by its index
#: (`frei_tpu/parallel/solve.py:305-319`); the others are replicated over
#: the bins dim
_BINS_AXIS = {"flux": 1, "dtaus": 2, "F_up": 2, "F_down": 2, "loop_F_up": 2,
              "loop_F_down": 2}


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: Optional[str] = None,
                           timeout: timedelta = timedelta(minutes=10)) -> None:
    """Join this process to a world of ``num_processes`` ranks, as rank
    ``process_id``, through the TCP rendezvous at ``coordinator_address``
    (``"host:port"``, rank 0's host).  A no-op on a single process.

    ``backend``: ``None`` means ``"nccl"`` where CUDA is available, else
    ``"gloo"``.  ``timeout`` bounds the rendezvous and every collective,
    so a rank that never arrives fails the others instead of hanging
    them."""
    if num_processes is None or num_processes <= 1:
        return
    if coordinator_address is None or process_id is None:
        raise ValueError("initialize_distributed needs coordinator_address "
                         "('host:port') and process_id for a world of "
                         f"{num_processes} processes")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend,
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id,
                            timeout=timeout)


def _dims(mesh):
    """(columns, bins) sizes of ``mesh`` and this rank's coordinates."""
    return (mesh.size(mesh.mesh_dim_names.index(COLUMNS)),
            mesh.size(mesh.mesh_dim_names.index(BINS)),
            mesh.get_local_rank(COLUMNS), mesh.get_local_rank(BINS))


def _device(mesh) -> torch.device:
    """This rank's device: the current CUDA device on a CUDA mesh."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _cut(n, parts, index, what):
    """Slice ``index`` of ``parts`` equal slices of an axis of ``n``."""
    if n % parts:
        raise ValueError(f"{what} of {n} does not split evenly over "
                         f"{parts} ranks of the mesh")
    size = n // parts
    return slice(index * size, (index + 1) * size)


def shard_solver_inputs(mesh, consts: RTConstants, stack: OpacityStack):
    """This rank's part of the per-configuration constants, on its
    device: its bins slice of ``lam_cm``, ``trapz_w``, ``sigma_scat``, a
    1-D ``F_toa`` and ``stack.values`` (the wavelength axis last);
    ``pressures``, ``stack.temps`` and ``stack.press_cgs`` whole.

    The slices are cut from the global trapezoid weights, never
    recomputed per shard: the shard sums then add up to the global
    quadrature.  With production-size tables this is what makes them
    fit: each device holds only its spectral slice."""
    _, n_bins, _, b = _dims(mesh)
    sl = _cut(consts.lam_cm.shape[0], n_bins, b, "the wavelength axis")
    device = _device(mesh)

    def part(x):
        return x[..., sl].to(device).contiguous()

    consts = RTConstants(lam_cm=part(consts.lam_cm),
                         trapz_w=part(consts.trapz_w),
                         pressures=consts.pressures.to(device),
                         sigma_scat=part(consts.sigma_scat),
                         F_toa=part(consts.F_toa))
    stack = stack._replace(values=part(stack.values),
                           temps=stack.temps.to(device),
                           press_cgs=stack.press_cgs.to(device))
    return consts, stack


def _local_columns(init_temps, mesh, dtype, device):
    """This rank's columns of ``init_temps``: of the global (C, L)
    profiles every rank holds, or of a DTensor on ``mesh``."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if isinstance(init_temps, DTensor):
        local = init_temps.redistribute(mesh, [Shard(0), Replicate()])
        return local.to_local().to(dtype=dtype, device=device)
    n_columns, _, c, _ = _dims(mesh)
    init_temps = torch.as_tensor(init_temps, dtype=dtype, device=device)
    return init_temps[_cut(init_temps.shape[0], n_columns, c,
                           "the columns axis")]


def _as_dtensors(res: RTResult, mesh, bins_axis=None) -> RTResult:
    """Each field of a rank's result as a DTensor on ``mesh``, sharded on
    columns and, where ``bins_axis`` gives a field a wavelength axis, on
    bins (replicated over bins otherwise)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    bins_axis = bins_axis or {}
    return RTResult(*(
        DTensor.from_local(x, mesh, [Shard(0), Shard(bins_axis[f])
                                     if f in bins_axis else Replicate()],
                           run_check=False)
        for f, x in zip(RTResult._fields, res)))


def solve_ensemble(init_temps, consts: RTConstants, params: PhysicsParams,
                   stack: OpacityStack, chem,
                   cfg: SolverConfig = SolverConfig(),
                   mesh=None) -> RTResult:
    """Solve an ensemble of columns, sharded over ``mesh``.

    Every rank passes the same global inputs: ``init_temps`` as (C, L)
    profiles (or a DTensor sharded on columns), the grid's ``consts``
    and ``stack`` (whole) and the chemistry.  Each rank solves its C /
    n_columns columns on its W / n_bins wavelengths, with the κ model
    rebuilt over its slice of the stack (``build_kappa_model``, the
    builder ``Grid`` uses, so the fused-κ hooks are the same), and gets
    a batched :class:`RTResult` of DTensors: ``flux`` sharded (columns,
    bins), the (C, L, W) slabs (columns, -, bins), every other field
    sharded on columns and replicated over bins.  ``.full_tensor()``
    gathers a field; ``.to_local()`` is this rank's piece.  Columns that
    converge early freeze while the rest iterate, as in one solve.

    ``mesh=None``: the world's :func:`make_mesh` where a process group
    exists; otherwise the solve is one device's, and the result is plain
    tensors, equal bit for bit to ``solve_rc_batched`` with the grid's κ
    model.

    Engines: the one ``cfg.engine`` names, resolved by
    ``solve_rc_batched`` with ``cfg.differentiable`` seen (``"auto"`` is
    ``"eager"`` then).  ``"eager"`` and ``"cuda"`` run on every mesh;
    ``"iteration"`` and ``"loop"`` on columns-only meshes (their kernels
    compute the update from their own quadratures, so a bins-sharded
    mesh is refused).  C and W must split evenly.

    ``cfg.differentiable``: the bins all-reduce carries gradients, and a
    rank's gradient of an input it holds whole (``init_temps`` on a bins
    mesh, ``params``, ``consts.F_toa``) is its part of the total: sum it
    over the mesh (``dist.all_reduce``).
    """
    device = consts.lam_cm.device
    if mesh is None:
        if not dist.is_initialized():
            kappa_all = build_kappa_model(stack, chem, consts.pressures,
                                          consts.sigma_scat)
            return solve_rc_batched(
                torch.as_tensor(init_temps, dtype=consts.lam_cm.dtype,
                                device=device),
                consts, params, kappa_all, cfg)
        mesh = make_mesh(device_type=device.type)
    n_bins = _dims(mesh)[1]
    consts, stack = shard_solver_inputs(mesh, consts, stack)
    T0 = _local_columns(init_temps, mesh, consts.lam_cm.dtype,
                        consts.lam_cm.device)
    kappa_all = build_kappa_model(stack, chem, consts.pressures,
                                  consts.sigma_scat)
    res = solve_rc_batched(T0, consts, params, kappa_all,
                           cfg._replace(bins_axis=BINS if n_bins > 1 else ""),
                           mesh=mesh)
    return _as_dtensors(res, mesh, _BINS_AXIS)


def solve_population(init_temps, grid, planets,
                     cfg: SolverConfig = SolverConfig(),
                     mesh=None) -> RTResult:
    """Retrieval or phase-curve population solve: one atmosphere per
    planet, each with its own irradiation (T_star, a/R*), gravity and
    mixing-length alpha, sharing the grid, opacities, chemistry and mean
    molecular weight (the composition is shared, so sharing m_bar, which
    sets the Rayleigh scattering and the MMR scale, is the consistent
    choice).

    Parameters
    ----------
    init_temps : (C, L) initial profiles [K], one per planet (or, with a
        mesh, a DTensor sharded on columns).
    grid : ``frei_tpu_torch.api.Grid`` with opacities loaded, on this
        rank's device.
    planets : sequence of C ``Planet`` objects.

    Returns a batched :class:`RTResult`: ``solve_rc_batched`` in
    population mode, per-planet F_toa (C, W), g and alpha (C,) on the
    grid's device.  The F_toa rows come from one batched
    ``stellar.irradiation.f_toa_rows`` evaluation on that device (in
    float64, cast to the grid's dtype), the builder of a ``Grid``'s own
    row, so on the ``"cuda"`` engine each column equals a shared-planet
    solve of its planet bit for bit.  ``mesh`` (a columns-only
    ``DeviceMesh``) shards the planets over the ranks: each builds the
    rows of its columns only and solves them, and the fields are
    DTensors sharded on columns.
    """
    with telemetry.span("frei.population.build"):
        cols = torch.tensor([(p.T_star, p.a_rstar, p.g, p.alpha, p.m_bar)
                             for p in planets], dtype=torch.float64)
        m_bar = planets[0].m_bar
        if bool(((cols[:, 4] - m_bar).abs() > 1e-30).any()):
            raise ValueError(
                "solve_population shares composition: all planets must "
                "have the same m_bar (it sets chemistry + Rayleigh); "
                "build separate grids for different compositions")
        consts = grid._consts
        dtype, device = consts.lam_cm.dtype, consts.lam_cm.device
        if mesh is None:
            T0 = torch.as_tensor(init_temps, dtype=dtype, device=device)
        else:
            n_columns, n_bins, c, _ = _dims(mesh)
            if n_bins > 1:
                raise ValueError(
                    "solve_population shards the 'columns' axis only; use a "
                    "(n_columns, 1) mesh (per-planet F_toa rows are column "
                    "state, not spectral constants)")
            T0 = _local_columns(init_temps, mesh, dtype, device)
            cols = cols[_cut(len(planets), n_columns, c, "the columns axis")]
        # this rank's four (C,) vectors in one upload; its rows on the device
        T_star, a_rstar, g, alpha = cols[:, :4].T.contiguous().to(device)
        f_toa = f_toa_rows(grid.rt_grid.lam_cm, T_star, a_rstar,
                           dtype)                             # (C, W)
        params = PhysicsParams(g=g.to(dtype),
                               m_bar=torch.as_tensor(m_bar, dtype=dtype,
                                                     device=device),
                               alpha=alpha.to(dtype), n_dof=5)
    res = solve_rc_batched(T0, consts._replace(F_toa=f_toa), params,
                           grid._kappa_fn, cfg)
    return res if mesh is None else _as_dtensors(res, mesh)
