"""Carry the JAX package's objects over to this package.

Each function takes an object of ``frei_tpu`` (an opacity stack, layer
tables, solver constants, physics parameters or a solve result), reads
its arrays through ``np.asarray`` and returns this package's
counterpart as tensors of the given ``dtype`` on the given ``device``.
Nothing here imports JAX: any object with the same fields converts.
"""

from __future__ import annotations

import numpy as np
import torch

from ..opacity.tables import LayerKappaTables, OpacityStack
from ..rt.physics import PhysicsParams
from ..rt.solver import RTConstants

__all__ = ["to_opacity_stack", "to_layer_tables", "to_rt_constants",
           "to_physics_params", "to_resume_state"]


def _t(x, dtype, device):
    return torch.as_tensor(np.array(x), dtype=dtype, device=device)


def to_opacity_stack(stack, dtype=torch.float64,
                     device="cpu") -> OpacityStack:
    """An ``OpacityStack`` with the same tables, axes and species."""
    return OpacityStack(
        values=_t(stack.values, dtype, device),
        temps=_t(stack.temps, dtype, device),
        press_cgs=_t(stack.press_cgs, dtype, device),
        species=tuple(stack.species),
        masses_g=np.array(stack.masses_g, dtype=np.float64))


def to_layer_tables(lt, dtype=torch.float64,
                    device="cpu") -> LayerKappaTables:
    """``LayerKappaTables`` with the same (L, S*nT, W) tables."""
    return LayerKappaTables(tab=_t(lt.tab, dtype, device),
                            temps=_t(lt.temps, dtype, device),
                            n_species=int(lt.n_species))


def to_rt_constants(consts, dtype=torch.float64,
                    device="cpu") -> RTConstants:
    """``RTConstants`` with the same wavelength, quadrature, pressure,
    scattering and irradiation rows."""
    return RTConstants(*(_t(getattr(consts, f), dtype, device)
                         for f in RTConstants._fields))


def to_physics_params(params, dtype=torch.float64,
                      device="cpu") -> PhysicsParams:
    """``PhysicsParams``: scalar fields become Python floats, arrays
    (per-column parameters) tensors."""
    def field(x):
        a = np.asarray(x)
        return float(a) if a.ndim == 0 else _t(a, dtype, device)
    return PhysicsParams(g=field(params.g), m_bar=field(params.m_bar),
                         alpha=field(params.alpha),
                         n_dof=int(params.n_dof))


def to_resume_state(result, dtype=torch.float64, device="cpu"):
    """The exact resume point of a solve result: ``(temps,
    (F_up, F_down))`` from its pre-final-emit ``loop_*`` fields, ready
    for ``solve_rc_batched(temps, ..., init_fluxes=(F_up, F_down))``."""
    return (_t(result.loop_temps, dtype, device),
            (_t(result.loop_F_up, dtype, device),
             _t(result.loop_F_down, dtype, device)))
