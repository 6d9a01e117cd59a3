"""The four-species deployment on the card before any cell runs it: H2O,
Na, K and TiO on the seeded T- and P-dependent tables
(``reference/inputs.seeded_tp_opacity``) on the golden grid of
``hot_jupiter_r500_f64``, solved by the port and by the plain reference.

    python3 benchmark/tools/seeded_tp.py [--seeds <n> ...] \
        [--control-seeds <n> ...] [--out FILE]

Every species at the base configuration's one mock mixing ratio, which
is not the deployment's chemistry: the port's mock chemistry gives all
species one ratio, so per-species abundances wait on the program or on
equilibrium chemistry.  Set-up as a run's (the port's ``Grid`` from the
configuration, ``COLUMNS`` profiles drawn from each seed, two warm-up
calls), then ``CALLS`` timed calls of ``ITERATIONS`` iterations on the
``"loop"`` engine with both exits off, each ending in a synchronize
(their walls and ``max_memory_allocated``), then one call under
torch.profiler (the loop kernel's device time), and the
program's opacity at the first seed's profiles against the reference's
(``kappa_gap``, the widest relative gap).  With the program's state
freed: each seed's flux and final temperatures against the float64
reference in blocks of ``BLOCK`` columns (``flux_gap``,
``temps_gap``); the control, the reference in float32, for each of
``--control-seeds``; and the reference with its opacity in the form of
the program's layer tables (``hoisted_kappa``) against the bilinear
reference (``hoist_gaps``).  One JSON line per reading on standard
output and in ``--out``.  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import copy
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: the deployment's opacity block: the species of docs/quickstart.md:78
#: on the seeded tables; the axes are assumed (inputs.seeded_tp_opacity)
OPACITY = {"kind": "seeded_tp", "seed": 42,
           "species": ["1H2-16O", "23Na", "39K", "48Ti-16O"],
           "temps_K": {"min": 300, "max": 6000, "n": 30},
           "press_bar": {"min": 1e-7, "max": 1e3, "n": 21}}
#: the cell whose configuration (grid, planet, chemistry, dtype) and
#: traffic it takes
CELL, BASE = "hj_loop_f64", "hot_jupiter_r500_f64"
#: the reference's columns at a time, as the forward cells check
BLOCK = 4096
#: the card run: the cell's columns and iterations, timed calls
COLUMNS, ITERATIONS, CALLS = 8192, 20, 12


def config(**grid) -> dict:
    """``BASE`` with the four-species opacity, its grid changed by
    ``grid``."""
    from benchmark.harness import pieces
    cfg = copy.deepcopy(pieces.config(BASE))
    cfg["name"] = "hj4sp"
    cfg["opacity"] = copy.deepcopy(OPACITY)
    cfg["grid"].update(grid)
    return cfg


def context(cfg, seed, device, **traffic):
    """``CELL``'s run context with ``cfg`` in place of its configuration
    and ``traffic`` over its traffic: what ``harness/program.py`` reads
    of a run, for a configuration no cell names yet."""
    from benchmark.harness import cell
    from benchmark.reference import case, inputs
    ctx = cell.Context(CELL, seed, device, overrides=traffic)
    ctx.cfg, ctx.grid = cfg, inputs.grid_arrays(cfg["grid"])
    ctx.tables = case.opacity_tables(cfg, ctx.grid)
    return ctx


def hoisted_kappa(s, T):
    """``rt.kappa`` in the form of the program's layer tables
    (``make_layer_tables``, ``kappa_from_layer_tables``): the pressure
    axis interpolated onto the layers first, then per layer the
    mixing-ratio-weighted temperature weight rows contracted with the
    (S * nT, W) table.  The same as the bilinear lookup in real
    arithmetic; in floating point the sum runs in another order."""
    import torch

    from benchmark.reference import rt
    S, nT, _, W = s.table.shape
    L = s.pressures.shape[0]
    pj, pf, p_ok = rt._axis(s.table_P, s.pressures)
    w0 = ((1 - pf) * p_ok)[None, None, :, None]
    w1 = (pf * p_ok)[None, None, :, None]
    tab = w0 * s.table[:, :, pj] + w1 * s.table[:, :, pj + 1]  # S,nT,L,W
    tab = tab.permute(2, 0, 1, 3).reshape(L, S * nT, W)
    ti, tf, t_ok = rt._axis(s.table_T, T)
    one_hot = torch.nn.functional.one_hot
    rows = (one_hot(ti, nT) * ((1 - tf) * t_ok)[..., None]
            + one_hot(ti + 1, nT) * (tf * t_ok)[..., None])  # B, L, nT
    rows = (s.mmr[:, None] * rows[..., None, :]).flatten(-2)  # B, L, S*nT
    return torch.einsum("blk,lkw->blw", rows.to(tab.dtype), tab) + s.sigma


def hoisted_reference(*args, **kw):
    """``answers.forward`` with ``hoisted_kappa`` in the reference."""
    from benchmark.reference import answers, rt
    inner = rt.kappa
    rt.kappa = hoisted_kappa
    try:
        return answers.forward(*args, **kw)
    finally:
        rt.kappa = inner


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[2 ** 31 + 11])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    if CALLS < len(args.seeds):
        ap.error(f"{CALLS} calls cannot give every seed a call")

    import numpy as np
    import torch

    from benchmark.harness import cell, program, trace
    from benchmark.reference import answers, case, rt
    if not torch.cuda.is_available():
        print("seeded_tp.py needs a CUDA device", file=sys.stderr)
        return 2

    def emit(**rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if args.out:
            with args.out.open("a") as f:
                f.write(line + "\n")

    from frei_tpu_torch import solve_rc_batched
    from frei_tpu_torch.ops.iteration_cuda import plan_iteration
    cfg = config()
    g = cfg["grid"]
    ctx = context(cfg, args.seeds[0], "cuda", columns=COLUMNS,
                  iterations=ITERATIONS, pool=1)
    t0 = time.perf_counter()
    grid = program.make_grid(ctx)
    solver = program.fixed_horizon(ctx, engine="loop")
    consts = (grid._consts, grid.planet.physics_params(), grid._kappa_fn)
    pools = {}
    for seed in args.seeds:
        ctx.seed = seed
        (T0,), (T0_ref,) = program.profile_pool(ctx)
        pools[seed] = (T0, T0_ref)
    T0 = pools[args.seeds[0]][0]
    for _ in range(2):
        solve_rc_batched(T0, *consts, solver)
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    walls, outs = [], {}
    for k in range(CALLS):
        seed = args.seeds[k % len(args.seeds)]
        t1 = time.perf_counter()
        res = solve_rc_batched(pools[seed][0], *consts, solver)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t1)
        if seed not in outs:
            outs[seed] = {"flux": res.flux.cpu(),
                          "final_temps": res.final_temps.cpu()}
        del res     # one call's state alive at a time, as in a run
    peak = torch.cuda.max_memory_allocated()
    prof = trace.start()
    with torch.profiler.record_function(cell.CALL_SPAN):
        solve_rc_batched(T0, *consts, solver)
    t = trace.stop(prof)
    ref_consts, _ = case.build(cfg, ctx.tables, torch.float64, "cuda")
    p = torch.as_tensor(ctx.grid.pressures, dtype=ctx.dtype,
                        device="cuda")
    kappa_gap = 0.0
    for i in range(0, COLUMNS, BLOCK):
        kr = rt.kappa(ref_consts, T0[i:i + BLOCK].double())
        kp = grid._kappa_fn(T0[i:i + BLOCK], p)
        kappa_gap = max(kappa_gap, float(((kp - kr).abs() / kr).max()))
    S = len(cfg["opacity"]["species"])
    plan = plan_iteration(g["n_wl_bins"], g["n_layers"], S,
                          torch.finfo(ctx.dtype).bits // 8, loop=True)
    emit(kind="program", columns=COLUMNS, iterations=ITERATIONS,
         setup_s=setup, walls_s=walls,
         wall_median_s=float(np.median(walls)), memory_peak_bytes=peak,
         loop_kernel_s=(t.seconds("loop_kernel") / t.count("loop_kernel")
                        if t.count("loop_kernel") else None),
         device_ops=t.device_ops(), busy_s=t.busy_s(),
         window_s=t.window_s(), plan=plan._asdict(), kappa_gap=kappa_gap,
         card=torch.cuda.get_device_name(0))
    del grid, consts, pools, ref_consts, kr, kp
    gc.collect()
    torch.cuda.empty_cache()

    def reference(seed, dtype, fn=answers.forward):
        ctx.seed = seed
        (_,), (T0_ref,) = program.profile_pool(ctx)
        return fn(cfg, ctx.tables, T0_ref, None, ITERATIONS, dtype,
                  "cuda", BLOCK)

    for seed in args.seeds:
        t1 = time.perf_counter()
        ref = reference(seed, torch.float64)
        seconds = time.perf_counter() - t1
        extra = {}
        if seed == args.seeds[0]:
            extra["hoist_gaps"] = answers.forward_gaps(
                reference(seed, torch.float64, hoisted_reference), ref)
        emit(kind="reference", seed=seed,
             gaps=answers.forward_gaps(outs[seed], ref),
             reference_s=seconds, **extra)
    for seed in args.control_seeds:
        emit(kind="control", seed=seed, gaps=answers.forward_gaps(
            reference(seed, torch.float32), reference(seed, torch.float64)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
