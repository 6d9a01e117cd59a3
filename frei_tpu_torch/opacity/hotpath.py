"""The one place the hot-loop kappa model is wired.

Counterpart of ``frei_tpu.opacity.hotpath``: layer-factored opacity
tables, the hot-loop chemistry evaluator, the ``layer_parts`` hook
that routes the solver's ``"cuda"`` engine to the fused-kappa sweep
kernels (``ops/sweep_cuda.py``), and the ``iteration_hook`` that the
``"iteration"`` and ``"loop"`` engines build their constants from
(``ops/iteration_cuda.py``).
"""

from __future__ import annotations

from ..chemistry.fastchem import hot_loop_mmr_fn
from .tables import (OpacityStack, kappa_from_layer_tables, kappa_from_stack,
                     layer_interp_weights, make_layer_tables)

__all__ = ["build_kappa_model"]


def _supports_iteration_hook(chem) -> bool:
    """Capability check for the whole-iteration kernels:
    ``supports_layer_factoring()`` where the model defines it, else the
    presence of ``layer_ln_mmr_tables`` (e.g. ``MockChemistry``)."""
    probe = getattr(chem, "supports_layer_factoring", None)
    if probe is not None:
        return bool(probe())
    return hasattr(chem, "layer_ln_mmr_tables")


def build_kappa_model(stack: OpacityStack, chem, pressures, sigma_scat):
    """Build ``kappa_all(temps, pressures) -> (..., L, W)`` for the RC
    loop.  Multi-T-point stacks get the layer-factored path, whose
    closure carries ``layer_parts = (ohs_fn, tab)``: the sweep kernels
    take the weight rows and tables instead of the opacity slab and add
    sigma themselves, so the rows exclude it.  Where the chemistry
    serves layer-factored ln-MMR tables it also carries
    ``iteration_hook = (temps grid, tab, chem)``, else ``None``.
    Single-T-point stacks use the gather lookup (``kappa_from_stack``)
    and carry no hook."""
    if stack.values.shape[1] > 1:
        lt = make_layer_tables(stack, pressures)
        mmr_fn = hot_loop_mmr_fn(chem, pressures)

        def kappa_all(temps, pressures_in):
            del pressures_in  # fixed to the layer grid by design
            k, _ = kappa_from_layer_tables(lt, mmr_fn(temps), temps,
                                           sigma_scat)
            return k

        def ohs_fn(temps):
            return layer_interp_weights(lt, mmr_fn(temps), temps)

        kappa_all.layer_parts = (ohs_fn, lt.tab)
        kappa_all.iteration_hook = (
            (lt.temps, lt.tab, chem) if _supports_iteration_hook(chem)
            else None)
        return kappa_all

    def kappa_all(temps, pressures_in):
        mmr = chem.mmr(temps, pressures_in)
        k, _ = kappa_from_stack(stack, mmr, temps, pressures_in,
                                sigma_scat)
        return k

    return kappa_all
