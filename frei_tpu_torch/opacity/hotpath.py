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
from .tables import (LayerKappaTables, OpacityStack, kappa_from_layer_tables,
                     kappa_from_stack, layer_interp_weights,
                     make_layer_tables)

__all__ = ["build_kappa_model", "kappa_model_from_layer_tables"]


def _supports_iteration_hook(chem) -> bool:
    """Capability check for the whole-iteration kernels:
    ``supports_layer_factoring()`` where the model defines it, else the
    presence of ``layer_ln_mmr_tables`` (e.g. ``MockChemistry``)."""
    probe = getattr(chem, "supports_layer_factoring", None)
    if probe is not None:
        return bool(probe())
    return hasattr(chem, "layer_ln_mmr_tables")


def kappa_model_from_layer_tables(lt: LayerKappaTables, mmr_fn, chem,
                                  sigma_scat):
    """The κ closure over prebuilt layer tables, hooks attached:
    ``layer_parts = (ohs_fn, tab)`` (the sweep kernels take the weight
    rows and tables instead of the opacity slab and add sigma themselves,
    so the rows exclude it), ``iteration_hook = (temps grid, tab, chem)``
    where the chemistry serves layer-factored ln-MMR tables (else
    ``None``), and the ingredients a sharded solve rebuilds the closure
    from (``layer_tables``, ``mmr_fn``, ``chem``).

    Split out of :func:`build_kappa_model`, as in the JAX package: a
    caller holding a model's layer tables rebuilds it over a slice of
    them (``lt._replace(tab=lt.tab[..., w0:w1])``, with that slice of
    ``sigma_scat``) through the same code, so no entry point can lose a
    hook.  ``parallel.solve_ensemble`` builds each rank's model with
    :func:`build_kappa_model` over the rank's slice of the stack instead:
    the same tables bit for bit (the P-interpolation is elementwise along
    W), without any rank holding the whole tables."""

    def kappa_all(temps, pressures_in):
        del pressures_in  # fixed to the layer grid by design
        k, _ = kappa_from_layer_tables(lt, mmr_fn(temps), temps, sigma_scat)
        return k

    def ohs_fn(temps):
        return layer_interp_weights(lt, mmr_fn(temps), temps)

    kappa_all.layer_parts = (ohs_fn, lt.tab)
    kappa_all.iteration_hook = (
        (lt.temps, lt.tab, chem) if _supports_iteration_hook(chem) else None)
    kappa_all.layer_tables = lt
    kappa_all.mmr_fn = mmr_fn
    kappa_all.chem = chem
    return kappa_all


def build_kappa_model(stack: OpacityStack, chem, pressures, sigma_scat):
    """Build ``kappa_all(temps, pressures) -> (..., L, W)`` for the RC
    loop.  Multi-T-point stacks get the layer-factored path
    (:func:`kappa_model_from_layer_tables`, hooks attached).
    Single-T-point stacks use the gather lookup (``kappa_from_stack``)
    and carry no hook."""
    if stack.values.shape[1] > 1:
        return kappa_model_from_layer_tables(
            make_layer_tables(stack, pressures),
            hot_loop_mmr_fn(chem, pressures), chem, sigma_scat)

    def kappa_all(temps, pressures_in):
        mmr = chem.mmr(temps, pressures_in)
        k, _ = kappa_from_stack(stack, mmr, temps, pressures_in,
                                sigma_scat)
        return k

    return kappa_all
