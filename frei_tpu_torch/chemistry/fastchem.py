"""Hot-loop chemistry dispatch.

Only :func:`hot_loop_mmr_fn` of ``frei_tpu.chemistry.fastchem`` is
ported so far; the equilibrium solver itself (``FastChemJAX``) is
ROADMAP queue 1 item 10.
"""

from __future__ import annotations

__all__ = ["hot_loop_mmr_fn"]


def hot_loop_mmr_fn(chem, pressures_cgs):
    """Best MMR evaluator for a solver hot loop on the fixed layer
    pressure grid: the model's layer-factored ``layer_mmr_interp``
    when it advertises one (``supports_layer_factoring()``, where
    defined, must say yes), else ``chem.mmr(temps, pressures_cgs)``.

    The dispatch is an explicit capability check, not exception-driven,
    so an ``AttributeError`` inside a custom model propagates."""
    supports = getattr(chem, "supports_layer_factoring", None)
    fast = getattr(chem, "layer_mmr_interp", None)
    if fast is not None and (supports is None or supports()):
        return fast(pressures_cgs)

    def mmr_fn(temps):
        return chem.mmr(temps, pressures_cgs)

    return mmr_fn
