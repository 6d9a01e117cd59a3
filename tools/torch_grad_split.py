"""How the gradient leg's wall splits: forward, recompute, backward.

    python3 tools/torch_grad_split.py [--columns 8192] [--runs 3] [--cpu]

bench.py's gradient leg on the card (``chip_smoke.py`` phase 5): float32,
500 bins x 30 layers, 20 iterations with the convergence exits off,
``loss = sum(flux^2) / 1e26`` of the differentiable solve and its
gradient with respect to the initial temperatures.  The solver's
checkpoints (``rt.solver._remat``) are wrapped here so that every replay
of a checkpointed function during the backward pass is timed at its
outermost level (a chunk's, then each iteration's, then each sweep's,
each closed by a synchronize): that sum is the recompute, and the
backward pass less the recompute is the backward operations.  Also times
the ordinary eager solve (no autograd) on the same columns, and reads
peak memory after the forward and after the backward.  After one
warm-up, ``--runs`` timed runs; prints one line per run, one JSON line
and the card's name and power limit.  ``--cpu`` runs a tiny rehearsal on
the host.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from frei_tpu_torch import Grid, Planet, load_example_opacity  # noqa: E402
from frei_tpu_torch.rt import solver as RS  # noqa: E402

N_BINS, N_LAYERS, N_ITERS = 500, 30, 20


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--columns", type=int, default=8192)
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--cpu", action="store_true")
    a = ap.parse_args()
    dev = torch.device("cpu" if a.cpu else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        sys.exit("torch_grad_split: no CUDA device (use --cpu to rehearse)")
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    replay = {"seconds": 0.0, "count": 0, "active": False}
    remat = RS._remat

    def timed_remat(fn):
        def timed(*args, **kwargs):
            # outside a backward pass, or inside a replay already timed
            if torch._C._current_graph_task_id() == -1 or replay["active"]:
                return fn(*args, **kwargs)
            sync()
            t0 = time.perf_counter()
            replay["active"] = True
            try:
                return fn(*args, **kwargs)
            finally:
                sync()
                replay["active"] = False
                replay["seconds"] += time.perf_counter() - t0
                replay["count"] += 1
        return remat(timed)

    RS._remat = timed_remat

    grid = Grid(Planet.from_hot_jupiter(), n_wl_bins=N_BINS,
                n_layers=N_LAYERS, T_ref=2400.0, dtype=torch.float32,
                device=dev)
    grid.load_opacities(opacities=load_example_opacity(grid,
                                                       scale_factor=1.0))
    # chip_smoke.columns: the profile x U(0.95, 1.05), seed 0
    rng = np.random.RandomState(0)
    T0 = torch.as_tensor(np.asarray(grid.init_temperatures)[None, :]
                         * rng.uniform(0.95, 1.05, (a.columns, 1)),
                         dtype=torch.float32, device=dev)
    args = (grid._consts, grid.planet.physics_params(), grid._kappa_fn)
    fixed = dict(n_timesteps=N_ITERS, n_zero_crossings=10 ** 6,
                 convergence_dT=0.0)
    cfg = RS.SolverConfig(differentiable=True, **fixed)

    rows = []
    for run in range(a.runs + 1):
        sync()
        t0 = time.perf_counter()
        RS.solve_rc_batched(T0, *args, RS.SolverConfig(engine="eager",
                                                       **fixed))
        sync()
        plain = time.perf_counter() - t0
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        T = T0.clone().requires_grad_(True)
        t0 = time.perf_counter()
        flux = RS.solve_rc_batched(T, *args, cfg).flux
        loss = (flux ** 2).sum() / 1e26
        sync()
        t1 = time.perf_counter()
        peak_fwd = torch.cuda.max_memory_allocated() / 1e9 if cuda else 0.0
        replay.update(seconds=0.0, count=0)
        (grad,) = torch.autograd.grad(loss, T)
        sync()
        backward = time.perf_counter() - t1
        peak = torch.cuda.max_memory_allocated() / 1e9 if cuda else 0.0
        assert torch.isfinite(grad).all(), "non-finite gradients"
        del flux, loss, grad, T
        row = dict(plain_forward=plain, forward=t1 - t0, backward=backward,
                   recompute=replay["seconds"],
                   backward_ops=backward - replay["seconds"],
                   replays=replay["count"], peak_gb_forward=peak_fwd,
                   peak_gb=peak)
        print(f"[split] run {run}{' (warm-up)' if run == 0 else ''}: "
              + ", ".join(f"{k} {v:.4f}" if isinstance(v, float)
                          else f"{k} {v}" for k, v in row.items()),
              flush=True)
        if run:
            rows.append(row)
    out = {k: [r[k] for r in rows] for k in rows[0]}
    out.update(columns=a.columns, device=str(dev),
               device_name=(torch.cuda.get_device_name(0) if cuda
                            else "host CPU"))
    print(json.dumps({"grad_split": out}))
    if cuda:
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip())


if __name__ == "__main__":
    main()
