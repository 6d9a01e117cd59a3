"""Radiative-convective fixed-point solver.

Counterpart of ``frei_tpu.rt.solver`` (reference driver loop
`frei/core.py:233-338`): alternate emit / absorb sweeps, record the
temperature history, declare a layer converged once its trajectory has
oscillated (more than ``n_zero_crossings`` sign changes of consecutive
history differences) or its last update is below ``convergence_dT``,
and finish with one more emit for the output spectrum.

The iteration is a Python loop over batched tensors.  Converged columns
freeze through ``torch.where`` selects, so every column follows the
trajectory it would follow alone.  Engines:

* ``"eager"``: the plain PyTorch sweeps of ``rt.sweeps`` (the
  counterpart of the JAX package's ``"xla"`` engine), on any device;
* ``"cuda"``: the hand-written sweep kernels of ``ops.sweep_cuda``,
  with the opacity contraction and the convergence freeze inside the
  kernels; CUDA tensors only;
* ``"iteration"`` (JAX ``"pallas-iteration"``): one kernel of
  ``ops.iteration_cuda`` per RC step, chemistry, opacity and both
  temperature updates included;
* ``"loop"`` (JAX ``"pallas-loop"``): one kernel runs the whole
  fixed-horizon loop, then one final emit.

The last two need a κ model with an ``iteration_hook`` and one shared
planet; on CPU tensors they run their kernels' plain twins.  ``"auto"``
picks ``"cuda"`` for CUDA tensors and ``"eager"`` otherwise.

``"eager"`` and ``"cuda"`` also solve a population, one planet per
column: per-column g, alpha, m_bar and F_toa (:func:`solve_rc_batched`).

On a bins-sharded mesh (``parallel.solve_ensemble`` sets
``cfg.bins_axis``) each rank solves a slice of the wavelengths:
``"eager"`` and ``"cuda"`` sum each sweep's quadratures over the bins
group, and the ranks of a group leave the loop together (one MAX
all-reduce of "some column still running" per iteration).
``"iteration"`` and ``"loop"`` refuse: their kernels compute the
temperature update from their own quadratures.

``SolverConfig(differentiable=True)`` makes the solve reverse-mode
differentiable (gradient-based retrieval, ``api.Grid.spectrum_fn``): it
runs on ``"eager"`` (the kernels have no backward), for exactly
``n_timesteps`` iterations, converged columns running on frozen through
the same selects, so its forward equals the ordinary solve bit for bit.
Activations are rematerialized in chunks of about sqrt(n_timesteps)
iterations, each iteration and each sweep inside a chunk checkpointed
again (``torch.utils.checkpoint``, the JAX package's nested
``jax.checkpoint``).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from ..diag import telemetry
from .physics import PhysicsParams
from .sweeps import absorb_sweep, emit_sweep

__all__ = ["SolverConfig", "RTConstants", "RTResult", "solve_rc",
           "solve_rc_batched"]

ENGINES = ("auto", "eager", "cuda", "iteration", "loop")
#: the JAX package's engine names (each also with "-interpret"), by
#: their counterpart here
_JAX_NAMES = {jax_name + suffix: ours
              for jax_name, ours in (("xla", "eager"), ("pallas", "cuda"),
                                     ("pallas-iteration", "iteration"),
                                     ("pallas-loop", "loop"))
              for suffix in ("", "-interpret")}


class SolverConfig(NamedTuple):
    """Solver controls (fields as in ``frei_tpu.rt.solver``)."""

    n_timesteps: int = 1           # max outer iterations (`core.py:233`)
    n_zero_crossings: int = 2      # oscillation threshold (`core.py:233`)
    convergence_dT: float = 3.0    # [K] (`core.py:233`)
    # the layer recurrence as a log-depth scan (rt.sweeps), for deep
    # grids: the "eager" engine and the standalone drivers take it; the
    # kernel engines run their own serial recurrence and ignore it, as
    # the JAX package's Pallas engines do
    associative: bool = False
    progress: bool = False         # print per-iteration telemetry
    engine: str = "auto"           # see ENGINES
    # the mesh dim the wavelengths are sharded over (``solve_rc_batched``'s
    # ``mesh``); set by ``parallel.solve_ensemble``
    bins_axis: str = ""
    # reverse-mode differentiable fixed-horizon solve ("eager" only)
    differentiable: bool = False
    # iterations per rematerialization chunk of the differentiable solve:
    # 0 = round(sqrt(n_timesteps)), 1 = a checkpoint every iteration.  The
    # backward keeps the state (two (B, L, W) flux slabs) at every chunk
    # boundary plus one chunk's iteration boundaries, ~(T/c + c) slabs
    remat_chunk: int = 0


class RTConstants(NamedTuple):
    """Per-configuration constants on the solve's device."""

    lam_cm: torch.Tensor       # (W,)
    trapz_w: torch.Tensor      # (W,)
    pressures: torch.Tensor    # (L,) BOA first [barye]
    sigma_scat: torch.Tensor   # (W,) Rayleigh opacity [cm^2/g]
    F_toa: torch.Tensor        # (W,) or (B, W) TOA stellar flux [erg/s/cm^3]


class RTResult(NamedTuple):
    """Solve outputs; batched solves carry a leading column axis."""

    flux: torch.Tensor            # (W,) emergent spectrum F_up[-1]
    final_temps: torch.Tensor     # (L,) temperatures after the final emit
    temp_history: torch.Tensor    # (2*n_timesteps, L), zero-padded tail
    n_history: torch.Tensor       # number of valid history rows
    dtaus: torch.Tensor           # (L, W) optical depths, final emit
    F_up: torch.Tensor            # (L, W)
    F_down: torch.Tensor          # (L, W)
    n_iterations: torch.Tensor    # outer iterations actually run
    converged: torch.Tensor       # (L,) per-layer convergence flags
    max_dT_history: torch.Tensor  # (n_timesteps,) max |dT| per iteration
    # pre-final-emit loop state: the exact resume point
    loop_temps: torch.Tensor      # (L,)
    loop_F_up: torch.Tensor       # (L, W)
    loop_F_down: torch.Tensor     # (L, W)


class _ConvState(NamedTuple):
    prev_T: torch.Tensor     # last history row (B, L)
    prev_sign: torch.Tensor  # sign of the last history diff (B, L)
    flips: torch.Tensor      # sign-flip counts (B, L) int32
    n_cols: torch.Tensor     # history rows recorded (B,) int32


class _LoopState(NamedTuple):
    temps: torch.Tensor      # (B, L)
    F_up: torch.Tensor       # (B, L, W)
    F_down: torch.Tensor     # (B, L, W)
    cs: _ConvState
    conv: torch.Tensor       # per-layer convergence flags (B, L)
    n_iters: torch.Tensor    # iterations run (B,) int32
    done: torch.Tensor       # converged columns (B,)


def _push_history(T_new, cs: _ConvState) -> _ConvState:
    """Record one temperature-history row and update the incremental
    zero-crossing statistics (equivalent to re-diffing the whole history
    as `core.py:306-311` does)."""
    s = torch.sign(T_new - cs.prev_T)
    can_flip = (cs.n_cols >= 2).unsqueeze(-1)  # a previous diff exists
    has_diff = (cs.n_cols >= 1).unsqueeze(-1)  # this diff is valid
    flips = cs.flips + (can_flip & (s != cs.prev_sign)).to(cs.flips.dtype)
    prev_sign = torch.where(has_diff, s, cs.prev_sign)
    return _ConvState(prev_T=T_new, prev_sign=prev_sign, flips=flips,
                      n_cols=cs.n_cols + 1)


def _resolve_engine(engine: str, device: torch.device,
                    differentiable: bool = False) -> str:
    if engine in _JAX_NAMES:
        raise ValueError(
            f"engine {engine!r} is the JAX package's name; this package's "
            f"counterpart is engine {_JAX_NAMES[engine]!r}")
    if engine not in ENGINES:
        raise ValueError(f"unknown sweep engine {engine!r} "
                         f"(expected one of {ENGINES})")
    if differentiable:
        # checked before the device, so every device gives this message
        if engine not in ("auto", "eager"):
            raise ValueError(
                f"cfg.differentiable needs engine 'eager' (or 'auto'), got "
                f"{engine!r}: the CUDA kernels have no reverse-mode "
                "autodiff rules")
        return "eager"
    if engine == "auto":
        return "cuda" if device.type == "cuda" else "eager"
    if engine == "cuda" and device.type != "cuda":
        raise ValueError("engine 'cuda' needs CUDA tensors; the solve's "
                         f"tensors are on {device}")
    return engine


def _per_column(consts, params) -> bool:
    return consts.F_toa.ndim != 1 or any(
        torch.as_tensor(x).ndim for x in (params.g, params.m_bar,
                                           params.alpha))


def _normalize_columns(consts, params, B, dtype, device):
    """Population mode (`frei_tpu/rt/solver.py:367-413`): any physics
    scalar may be a (B,) tensor and ``consts.F_toa`` may be (B, W), one
    planet per column; F_TOA is the only per-planet spectral input, and g,
    alpha and m_bar enter the dtau factors and the timestep physics.
    Scalars become 0-d tensors and per-column values (B, 1) column
    vectors, in the solve's dtype on its device; size-1 values broadcast
    to all columns and wrong lengths raise, here, before the engine
    branch, so that every engine sees the same inputs.

    A per-column m_bar reaches only the dtau and timestep physics:
    ``consts.sigma_scat`` and the MMR scale inside the κ model were built
    from the grid's one m_bar (``parallel.solve_population`` guards
    this)."""
    def cols(x, name):
        x = torch.as_tensor(x, dtype=dtype, device=device)
        if x.ndim == 0:
            return x
        x = x.reshape(-1, 1)
        if x.shape[0] == 1 and B > 1:
            x = x.expand(B, 1)
        elif x.shape[0] != B:
            raise ValueError(
                f"per-column {name} has length {x.shape[0]}, expected "
                f"{B} (one per column) or a scalar")
        return x

    params = PhysicsParams(g=cols(params.g, "params.g"),
                           m_bar=cols(params.m_bar, "params.m_bar"),
                           alpha=cols(params.alpha, "params.alpha"),
                           n_dof=params.n_dof)
    F_toa = consts.F_toa
    if F_toa.ndim == 2:
        if F_toa.shape[0] == 1 and B > 1:
            consts = consts._replace(F_toa=F_toa.expand(B, -1))
        elif F_toa.shape[0] != B:
            raise ValueError(
                f"per-column F_toa has {F_toa.shape[0]} rows, expected "
                f"{B} (one per column) or a 1-D shared row")
    return consts, params


def _check_whole_iteration(engine, cfg: SolverConfig, consts, params,
                           hook):
    """The JAX package's guards of its whole-iteration engines
    (`frei_tpu/rt/solver.py:444-476`), with this package's engine
    names."""
    if _per_column(consts, params):
        # the kernels bake F_toa / g into their constant pack
        raise ValueError(
            f"engine {engine!r} does not support per-column params / "
            "F_toa (population mode); use engine 'cuda' or 'eager'")
    if cfg.bins_axis:
        # the kernels compute the dT epilogue from their own quadratures
        # with no all-reduce over a bins-sharded mesh
        raise ValueError(
            f"engine {engine!r} does not support a bins-sharded mesh "
            "(cfg.bins_axis); use engine 'cuda'")
    if hook is None:
        raise ValueError(
            f"engine {engine!r} needs a layer-factored kappa model "
            "(kappa_all.iteration_hook)")


def _check_supported(cfg: SolverConfig, mesh):
    if cfg.differentiable and cfg.progress:
        # the backward pass would replay the prints of every iteration
        raise ValueError("cfg.progress prints from inside the loop, which "
                         "rematerialization replays; disable it for "
                         "differentiable solves")
    if cfg.differentiable and cfg.remat_chunk < 0:
        raise ValueError(f"remat_chunk must be >= 0 (0 = auto), got "
                         f"{cfg.remat_chunk}")
    if cfg.bins_axis and mesh is None:
        raise ValueError(
            f"cfg.bins_axis={cfg.bins_axis!r} names a dim of a device mesh, "
            "and no mesh was given: shard a solve with "
            "parallel.solve_ensemble, which slices the wavelengths and "
            "passes the mesh")


def _bins_group(cfg: SolverConfig, mesh):
    """The process group the quadratures are summed over: ``mesh``'s
    ``cfg.bins_axis`` dim, ``None`` when that has one rank or is unset."""
    if not cfg.bins_axis:
        return None
    group = mesh.get_group(cfg.bins_axis)
    return group if group.size() > 1 else None


def _some_running(done, group) -> bool:
    """Whether a column of the solve still runs.  Over a bins group the
    ranks must leave the loop together, or one would wait forever in the
    next sweep's all-reduce: they agree by a MAX all-reduce of the flag
    (their ``done`` flags are equal only if every rank got the same bits
    from the quadratures' all-reduce).  Ranks of different column groups
    may stop at different iterations."""
    running = ~done.all()
    if group is None:
        return bool(running)
    import torch.distributed as dist
    flag = running.to(torch.int32).reshape(1)
    dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=group)
    return bool(flag)


def solve_rc_batched(init_temps, consts: RTConstants, params: PhysicsParams,
                     kappa_all: Callable, cfg: SolverConfig = SolverConfig(),
                     init_fluxes=None, mesh=None) -> RTResult:
    """Batch-native radiative-convective solve over (B, L) initial
    profiles, with per-column trajectories identical to independent
    single-column solves.

    ``kappa_all(temps, pressures)`` maps (B, L) temperatures to the
    (B, L, W) total opacity; where it carries ``layer_parts =
    (ohs_fn, tab)`` the ``"cuda"`` engine hands the kernels the weight
    rows and layer tables instead, and the opacity slab is never built;
    the ``"iteration"`` and ``"loop"`` engines build their constants
    from its ``iteration_hook``.
    ``init_fluxes``: optional (F_up, F_down) pair, (B, L, W) each, to
    warm-start the flux state (e.g. from a result's ``loop_*`` fields).

    Population mode: ``params.g``, ``params.alpha`` and ``params.m_bar``
    may each be a scalar or a (B,) tensor, and ``consts.F_toa`` (W,),
    (1, W) or (B, W); a size-1 value is shared by every column.  The
    ``"iteration"`` and ``"loop"`` engines refuse per-column values.

    ``cfg.differentiable``: gradients reach ``init_temps``, every tensor
    field of ``params``, ``consts.F_toa`` and ``init_fluxes`` (see the
    module docstring); ``"auto"`` resolves to ``"eager"``, and the kernel
    engines refuse.

    ``mesh``: the ``DeviceMesh`` of a sharded solve, whose
    ``cfg.bins_axis`` dim this rank's wavelengths are a slice of (the
    inputs are the rank's slices: ``parallel.solve_ensemble`` cuts them).
    Each sweep's quadratures are then summed over that dim's group,
    differentiably: the gradient of a tensor every rank of the group
    holds whole (``init_temps``, ``params``) is this rank's part of it,
    and the caller sums it over the group.
    """
    B, L = init_temps.shape
    W = consts.lam_cm.shape[0]
    dtype, device = init_temps.dtype, init_temps.device
    engine = _resolve_engine(cfg.engine, device, cfg.differentiable)
    consts, params = _normalize_columns(consts, params, B, dtype, device)
    hook = getattr(kappa_all, "iteration_hook", None)
    if engine in ("iteration", "loop"):
        _check_whole_iteration(engine, cfg, consts, params, hook)
    _check_supported(cfg, mesh)
    group = _bins_group(cfg, mesh)

    if engine in ("iteration", "loop"):
        from ..ops.iteration_cuda import (make_iteration_pack,
                                          rc_iteration_kernel,
                                          rc_loop_kernel)
        pack = make_iteration_pack(consts, params, *hook)
        # the kernels take the scalars as arguments: one host read per
        # solve, not one per launch
        scal = PhysicsParams(*(float(x) for x in (
            params.g, params.m_bar, params.alpha)), n_dof=params.n_dof)
        # their final emit runs on the sweep kernels on a CUDA device and
        # on the eager sweeps otherwise
        sweeps = "cuda" if device.type == "cuda" else "eager"
    else:
        sweeps = engine

    if sweeps == "cuda":
        from ..ops.sweep_cuda import (absorb_sweep_cuda, emit_sweep_cuda,
                                      make_sweep_consts)
        sc = make_sweep_consts(consts, params)
        parts = getattr(kappa_all, "layer_parts", None)

        if parts is not None:
            ohs_fn, layer_tab = parts

            def kap_fn(temps):
                return (ohs_fn(temps), layer_tab)
        else:
            def kap_fn(temps):
                return kappa_all(temps, consts.pressures).contiguous()

        def emit(T, Fu, Fd, done=None, with_dtaus=False):
            return emit_sweep_cuda(T, Fu, Fd, kap_fn(T), sc,
                                   consts.pressures, params, done=done,
                                   with_dtaus=with_dtaus, bins_group=group)

        def absorb(T, Fu, Fd, done=None):
            return absorb_sweep_cuda(T, Fu, Fd, kap_fn(T), sc,
                                     consts.pressures, params, done=done,
                                     bins_group=group)
    else:
        sweep_kw = dict(sigma_scat=consts.sigma_scat, F_toa=consts.F_toa,
                        lam_cm=consts.lam_cm, trapz_w=consts.trapz_w,
                        pressures=consts.pressures, params=params,
                        associative=cfg.associative, bins_group=group)

        def emit(T, Fu, Fd, done=None, with_dtaus=False):
            r = emit_sweep(T, Fu, Fd, kappa_all(T, consts.pressures),
                           **sweep_kw)
            return (r.F_up, r.F_down, r.temps, r.dT) + (
                (r.dtaus,) if with_dtaus else ())

        def absorb(T, Fu, Fd, done=None):
            r = absorb_sweep(T, Fu, Fd, kappa_all(T, consts.pressures),
                             **sweep_kw)
            return r.F_up, r.F_down, r.temps, r.dT

        if cfg.differentiable:
            # a checkpoint per sweep, the opacity lookup included: the
            # backward of one sweep holds its ~10 (B, L, W)
            # intermediates, never both sweeps' sets at once
            # (`frei_tpu/rt/solver.py:544-553`)
            emit, absorb = _remat(emit), _remat(absorb)

    def col(done, x):
        return done.reshape(done.shape + (1,) * (x.ndim - 1))

    if init_fluxes is None:
        F_up = torch.zeros((B, L, W), dtype=dtype, device=device)
        F_down = torch.zeros((B, L, W), dtype=dtype, device=device)
    else:
        F_up = torch.as_tensor(init_fluxes[0], dtype=dtype,
                               device=device).contiguous()
        F_down = torch.as_tensor(init_fluxes[1], dtype=dtype,
                                 device=device).contiguous()
    temps = init_temps.contiguous()
    if engine == "loop":
        # the whole fixed-horizon loop in one kernel launch
        (temps, F_up, F_down, hist, maxdT, n_iters,
         conv) = rc_loop_kernel(temps, F_up, F_down, pack, scal,
                                cfg.n_timesteps, cfg.n_zero_crossings,
                                cfg.convergence_dT)
        telemetry.check_finite("loop kernel's outputs", temps, F_up, F_down)
        Fu_f, Fd_f, T_f, _, dtaus = emit(temps, F_up, F_down,
                                         with_dtaus=True)
        telemetry.check_finite("final emit sweep", Fu_f, Fd_f, T_f)
        return RTResult(
            flux=Fu_f[:, -1], final_temps=T_f, temp_history=hist,
            n_history=2 * n_iters, dtaus=dtaus, F_up=Fu_f, F_down=Fd_f,
            n_iterations=n_iters, converged=conv, max_dT_history=maxdT,
            loop_temps=temps, loop_F_up=F_up, loop_F_down=F_down)

    def body(it, st: _LoopState):
        """One RC iteration: the new loop state and this iteration's
        history rows (T after emit, T after absorb, max |dT|), zero for
        columns already converged.  Pure: nothing is written in place,
        so a checkpoint can replay it."""
        temps, F_up, F_down, cs, conv, n_iters, done = st
        if engine == "iteration":
            # one kernel per RC step, the flux freeze inside it
            T1, Fu2, Fd2, T2, dT2 = rc_iteration_kernel(
                temps, F_up, F_down, done, pack, scal)
            telemetry.check_finite(f"RC step of iteration {it}", T1, Fu2,
                                   Fd2, T2)
        else:
            # the "cuda" kernels apply the freeze to the slabs themselves
            Fu1, Fd1, T1, _ = emit(temps, F_up, F_down, done)
            telemetry.check_finite(f"emit sweep of iteration {it}", Fu1,
                                   Fd1, T1)
            Fu2, Fd2, T2, dT2 = absorb(T1, Fu1, Fd1, done)
            telemetry.check_finite(f"absorb sweep of iteration {it}", Fu2,
                                   Fd2, T2)
            if engine == "eager":
                Fu2 = torch.where(col(done, Fu2), F_up, Fu2)
                Fd2 = torch.where(col(done, Fd2), F_down, Fd2)
        cs1 = _push_history(T1, cs)
        cs2 = _push_history(T2, cs1)
        conv_layers = ((cs2.flips > cfg.n_zero_crossings)
                       | (torch.abs(dT2) < cfg.convergence_dT))  # (B, L)
        new_done = conv_layers.all(dim=-1)                       # (B,)

        keep = done[:, None]
        rows = (T1.masked_fill(keep, 0.0), T2.masked_fill(keep, 0.0),
                torch.abs(dT2).amax(dim=-1).masked_fill(done, 0.0))
        if cfg.progress:
            telemetry.progress_printer(it, torch.abs(dT2).max(),
                                       conv_layers.all(0).sum(), L)
        st = _LoopState(
            temps=torch.where(keep, temps, T2), F_up=Fu2, F_down=Fd2,
            cs=_ConvState(*(torch.where(col(done, new), old, new)
                            for new, old in zip(cs2, cs))),
            conv=torch.where(keep, conv, conv_layers),
            n_iters=torch.where(done, n_iters, it + 1).to(torch.int32),
            done=done | new_done)
        return st, rows

    st = _LoopState(
        temps=temps, F_up=F_up, F_down=F_down,
        cs=_ConvState(
            prev_T=temps,
            prev_sign=torch.zeros((B, L), dtype=dtype, device=device),
            flips=torch.zeros((B, L), dtype=torch.int32, device=device),
            n_cols=torch.zeros((B,), dtype=torch.int32, device=device)),
        conv=torch.zeros((B, L), dtype=torch.bool, device=device),
        n_iters=torch.zeros((B,), dtype=torch.int32, device=device),
        done=torch.zeros((B,), dtype=torch.bool, device=device))
    T = cfg.n_timesteps
    rows = []
    if cfg.differentiable:
        # exactly T iterations, no early exit (converged columns run on
        # frozen), in checkpointed chunks of checkpointed iterations
        # (`frei_tpu/rt/solver.py:688-728`)
        chunk = min(cfg.remat_chunk or max(1, round(T ** 0.5)), T)

        def run_chunk(first, n, st):
            out = []
            for it in range(first, first + n):
                st, r = _remat(body)(it, st)
                out.append(r)
            return st, out

        for first in range(0, T, chunk):
            st, out = _remat(run_chunk)(first, min(chunk, T - first), st)
            rows += out
    else:
        for it in range(T):
            if it and not _some_running(st.done, group):
                break
            st, r = body(it, st)
            rows.append(r)
    # the rows of iterations not run stay zero
    zero = init_temps.new_zeros((B, L))
    pad = T - len(rows)
    hist = (torch.stack([x for r in rows for x in r[:2]]
                        + [zero] * (2 * pad), dim=1)
            if T else init_temps.new_zeros((B, 0, L)))
    maxdT = (torch.stack([r[2] for r in rows] + [zero[:, 0]] * pad, dim=1)
             if T else init_temps.new_zeros((B, 0)))

    # final emit for the output spectrum (`core.py:323-333`), which also
    # returns the dtaus diagnostic (on the "cuda" engine the kernel writes
    # it, so the opacity slab is never materialized)
    Fu_f, Fd_f, T_f, _, dtaus = emit(st.temps, st.F_up, st.F_down,
                                     with_dtaus=True)
    telemetry.check_finite("final emit sweep", Fu_f, Fd_f, T_f)
    return RTResult(
        flux=Fu_f[:, -1], final_temps=T_f, temp_history=hist,
        n_history=st.cs.n_cols, dtaus=dtaus, F_up=Fu_f, F_down=Fd_f,
        n_iterations=st.n_iters, converged=st.conv, max_dT_history=maxdT,
        loop_temps=st.temps, loop_F_up=st.F_up, loop_F_down=st.F_down)


def _remat(fn):
    """``fn`` under non-reentrant activation checkpointing: its forward
    keeps only its inputs, and the backward replays it.  The
    non-reentrant form also carries gradients to tensors that ``fn``
    reaches through closures (``params``, ``F_toa``), which the
    reentrant form drops."""
    def run(*args, **kwargs):
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False, **kwargs)
    return run


def solve_rc(init_temps, consts: RTConstants, params: PhysicsParams,
             kappa_all: Callable,
             cfg: SolverConfig = SolverConfig()) -> RTResult:
    """Radiative-convective solve of one (L,) column: the batched solve
    at B = 1 (so ``"auto"`` runs the sweep kernels on a CUDA device),
    with the column axis dropped from every output."""
    res = solve_rc_batched(init_temps[None], consts, params, kappa_all, cfg)
    return RTResult(*(x[0] for x in res))
