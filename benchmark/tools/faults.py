"""Faults planted in the program underneath a run's timed path, each a
way an optimisation could go wrong: a run with one of them has to come
out not correct.  ``tests/test_bench_faults.py`` plants them on the CPU
at a small size; ``calibrate.py --fault`` on the card at a cell's own
size.  Each takes ``patch(obj, name, value)`` (pytest's
``monkeypatch.setattr``, or ``Patches.set``).  No cell exchanges
anything between chips, so that fault has none here."""

from __future__ import annotations

import torch


class Patches:
    """``patch`` outside pytest: ``set`` as ``monkeypatch.setattr``,
    ``undo`` puts every original back."""

    def __init__(self):
        self._saved = []

    def set(self, obj, name, value):
        self._saved.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    def undo(self):
        while self._saved:
            setattr(*self._saved.pop())


def _wrap_solves(patch, change):
    """Every path the entries reach ``solve_rc_batched`` by, its result
    passed through ``change``."""
    import frei_tpu_torch
    import frei_tpu_torch.api
    import frei_tpu_torch.parallel.solve as psolve
    import frei_tpu_torch.rt.solver as solver
    inner = solver.solve_rc_batched

    def broken(*args, **kw):
        return change(inner(*args, **kw))
    for mod in (frei_tpu_torch, frei_tpu_torch.api, psolve):
        patch(mod, "solve_rc_batched", broken)


def state_unchanged(patch):
    """Every absorb step, and the whole-loop kernel, return the state
    they were given."""
    import frei_tpu_torch.ops.iteration_cuda as iteration_cuda
    import frei_tpu_torch.rt.solver as solver
    result = solver.emit_sweep.__globals__["SweepResult"]

    def absorb(temps, F_up, F_down, k_all, *args, **kw):
        return result(F_up, F_down, temps, torch.zeros_like(temps),
                      torch.ones_like(k_all))
    patch(solver, "absorb_sweep", absorb)

    def loop(temps, F_up, F_down, pack, scal, n, *args):
        B, L = temps.shape
        z = temps.new_zeros
        return (temps, F_up, F_down, z((B, 2 * n, L)), z((B, n)),
                torch.full((B,), n, dtype=torch.int32),
                torch.zeros((B, L), dtype=torch.bool))
    patch(iteration_cuda, "rc_loop_kernel", loop)


def half_left_out(patch):
    """The second half of the batch answered with the first half's."""
    def change(res):
        h = res.flux.shape[0] // 2
        return res._replace(
            flux=torch.cat([res.flux[:h], res.flux[:h]]),
            final_temps=torch.cat([res.final_temps[:h],
                                   res.final_temps[:h]]))
    _wrap_solves(patch, change)


def answer_altered(patch):
    """One column's spectrum scaled by 1.1 where the solve returns it."""
    def change(res):
        return res._replace(flux=torch.cat([res.flux[:1] * 1.1,
                                            res.flux[1:]]))
    _wrap_solves(patch, change)


class _ScaledGradient(torch.autograd.Function):
    """The identity forward; the backward scales what flows through."""

    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


def _scale_gradient(patch, scale):
    """``Grid.spectrum_fn``'s spectra as they are, their gradient times
    ``scale``: the backward broken, the forward intact."""
    import frei_tpu_torch.api as api
    inner = api.Grid.spectrum_fn

    def spectrum_fn(self, *args, **kw):
        fn = inner(self, *args, **kw)
        return lambda T, params: _ScaledGradient.apply(fn(T, params),
                                                       scale)
    patch(api.Grid, "spectrum_fn", spectrum_fn)


def gradient_zeroed(patch):
    """A backward that returns nothing: dloss/dT0 all zeros."""
    _scale_gradient(patch, 0.0)


def gradient_halved(patch):
    """A backward that loses half of what flows through it."""
    _scale_gradient(patch, 0.5)


#: the faults every cell can have
FORWARD = (state_unchanged, half_left_out, answer_altered)
#: those only a cell whose timed path runs a backward can have
BACKWARD = (gradient_zeroed, gradient_halved)
BY_NAME = {f.__name__: f for f in FORWARD + BACKWARD}
