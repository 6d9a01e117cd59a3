"""The readings a cell's limits are set from, in one process on the card.

    python3 benchmark/tools/calibrate.py --workload <cell> \
        --seeds <n> [<n> ...] --control-seeds <n> [<n> ...] [--out FILE]

For each of ``--seeds``: the program's set-up at the cell's own size,
``check_calls`` calls kept as a run keeps them, and their gaps against
the float64 reference (the lower readings).  For each of
``--control-seeds``: the same inputs, with the reference computed in
the precision below the configuration's (``CONTROL_DTYPE``) put in
the program's place (the control: the
upper readings);
``--finite-control-seeds`` the same over the columns the control left
finite, with the count of those it did not.  ``--fault`` plants one of
``tools/faults.py``'s faults in the program for every seed;
``--override key=value`` changes a traffic parameter (a JSON value, or
a string), as ``engine=eager`` for a witness on another path.  Forward
readings also give each layer's widest |T - T_ref| / T_ref
(``layers``, bottom layer first).
One JSON line per seed on standard output and in ``--out``.  The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.tools import faults  # noqa: E402

#: the control's precision by the configuration's: the step below it that
#: would tempt a later change (float32 arithmetic for float64; bfloat16
#: storage and arithmetic for float32)
CONTROL_DTYPE = {"float64": "float32", "float32": "bfloat16"}


def control_dtype(ctx):
    """The control's torch dtype: the step below the cell's
    configuration."""
    import torch
    return getattr(torch, CONTROL_DTYPE[ctx.cfg["dtype"]])


def kept_calls(man, cell_name, seed, device, overrides=None, fault=None):
    """Set-up at the cell's size and ``check_calls`` calls kept as a run
    keeps them, with ``fault`` (a name in ``faults.BY_NAME``) planted;
    the program's state freed."""
    import torch

    from benchmark.harness import cell, pieces
    from benchmark.tools import faults
    patches = faults.Patches()
    if fault:
        faults.BY_NAME[fault](patches.set)
    try:
        ctx = cell.Context(cell_name, seed, device, man, overrides)
        entry = pieces.entry(ctx.traffic["entry"])
        state = entry.prepare(ctx)
        kept = {k: entry.call(ctx, state, k, True)
                for k in range(int(ctx.traffic["check_calls"]))}
    finally:
        patches.undo()
    del state
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    return ctx, entry, kept


def readings(ctx, entry, kept, control=False, layers=None) -> dict:
    """The gaps of the kept calls against the float64 reference: of the
    program's answers, or with ``control`` of the reference's own in
    the control's precision put in the program's place.  A list ``layers``
    receives each layer's widest temperature gap, where there are
    temperatures."""
    import torch
    if control:
        low = control_dtype(ctx)
        kept = {k: dict(rec, out=entry.reference(ctx, rec, low))
                for k, rec in kept.items()}
    worst, per_layer = {}, None
    for rec in kept.values():
        ref = entry.reference(ctx, rec, torch.float64)
        for name, v in entry.gaps(ctx, rec, ref).items():
            worst[name] = max(worst.get(name, float("-inf")), v)
        if "final_temps" in ref:
            tr = ref["final_temps"].double().cpu()
            t = rec["out"]["final_temps"].double().cpu()
            gap = torch.nan_to_num((t - tr).abs() / tr,
                                   nan=float("inf")).amax(0)
            per_layer = gap if per_layer is None else torch.maximum(
                per_layer, gap)
    if layers is not None and per_layer is not None:
        layers[:] = per_layer.tolist()
    return worst


def finite_columns_readings(ctx, entry, kept) -> dict:
    """The control's forward gaps over the columns it left finite, and
    how many it did not (a control that gives no number sets no upper
    reading: this says what it gives elsewhere)."""
    import torch
    low = control_dtype(ctx)
    worst, bad = {}, 0
    for rec in kept.values():
        got = entry.reference(ctx, rec, low)
        ref = entry.reference(ctx, rec, torch.float64)
        ok = (torch.isfinite(got["flux"]).all(1)
              & torch.isfinite(got["final_temps"]).all(1))
        bad += int((~ok).sum())
        cut = {k: v[ok] for k, v in got.items()}
        cut_ref = {k: v[ok] for k, v in ref.items()}
        for name, v in entry.gaps(ctx, {"out": cut}, cut_ref).items():
            worst[name] = max(worst.get(name, float("-inf")), v)
    return {"nonfinite_columns": bad, **worst}


def _pair(text):
    key, _, value = text.partition("=")
    try:
        return key, json.loads(value)
    except json.JSONDecodeError:
        return key, value


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--finite-control-seeds", type=int, nargs="*",
                    default=[])
    ap.add_argument("--fault", choices=sorted(faults.BY_NAME))
    ap.add_argument("--override", action="append", default=[])
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)

    import torch

    from benchmark.harness import pieces
    if not torch.cuda.is_available():
        print("calibrate.py needs a CUDA device", file=sys.stderr)
        return 2
    man = pieces.manifest(ROOT)
    jobs = ([("program", s) for s in args.seeds]
            + [("control", s) for s in args.control_seeds]
            + [("control_finite", s) for s in args.finite_control_seeds])
    overrides = dict(_pair(x) for x in args.override)
    for kind, seed in jobs:
        t0 = time.perf_counter()
        got = kept_calls(man, args.workload, seed, "cuda", overrides,
                         args.fault)
        layers = []
        gaps = (finite_columns_readings(*got) if kind == "control_finite"
                else readings(*got, control=kind == "control",
                              layers=layers))
        line = json.dumps({"workload": args.workload, "kind": kind,
                           "seed": seed, "fault": args.fault,
                           "overrides": overrides, "gaps": gaps,
                           "layers": layers,
                           "seconds": time.perf_counter() - t0})
        print(line, flush=True)
        if args.out:
            with args.out.open("a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
