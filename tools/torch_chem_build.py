"""Time the equilibrium chemistry table build: the card's kernel against
the host's plain build.

    python3 tools/torch_chem_build.py [--full] [--sweeps 20]

``FastChemTorch(mode="table")`` solves a (64 T x 32 P) table row by row
with Gauss-Seidel sweeps, each row warm-started from the one above: on
the card in one launch of the table kernel (``csrc/chemistry.cu`` via
``ops/chemistry_cuda``), on the host with the plain sweep
(``fastchem._GaussSeidel``) on one thread.  This script

* times one host sweep (``--sweeps`` of them, after one warm-up) at the
  row's 32-point float64 shape, on the default thread pool and on one
  thread (the host build's setting);
* times the kernel's default build of four species (frei's chemistry
  species) under the float64 and the float32 rule, :data:`REPEATS` times
  each, with its sweeps and time a sweep;
* times the kernel's serial chain: ``--sweeps`` sweeps of the default
  table's hottest row from the atomic start (no refinish, no settle) at
  16 and at 8 Newton steps an element, CUDA events around each; the
  difference is 8 Newton steps of every element of a sweep;
* with ``--full``, times the host's default builds and compares their
  tables and per-row sweeps with the kernel's.

Prints the card's name and power limit, then one JSON line.
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

from frei_tpu_torch.chemistry import fastchem as F  # noqa: E402
from frei_tpu_torch.ops import chemistry_cuda as CC  # noqa: E402

SPECIES = ("1H2-16O", "23Na", "48Ti-16O", "39K")
M_BAR = 2.4 * 1.67262192369e-24
RULES = {"float64": torch.float64, "float32": torch.float32}
#: the kernel's builds timed under each rule
REPEATS = 3


def host_sweep_ms(n, threads=None):
    """Mean ms of one host sweep of a warm 32-point row (the 1500 K row
    of the default grid after 20 cold sweeps)."""
    static = F._prepare_static(F.load_chem_table())
    T = torch.full((32,), 1500.0, dtype=torch.float64)
    P = torch.logspace(-8, 3, 32, dtype=torch.float64)
    _, z = F.equilibrium_log_pressures(F.load_chem_table(), T, P,
                                       n_sweeps=20)
    old = torch.get_num_threads()
    if threads:
        torch.set_num_threads(threads)
    try:
        with torch.inference_mode():
            gs = F._GaussSeidel(static, torch.float64, T.device, F.N_INNER)
            F._gs_solve(static, T, P, z, 1, F.N_INNER, gs=gs)   # warm-up
            t0 = time.perf_counter()
            F._gs_solve(static, T, P, z, n, F.N_INNER, gs=gs)
            return (time.perf_counter() - t0) / n * 1e3
    finally:
        torch.set_num_threads(old)


def chain_ms(n_sweeps, n_inner):
    """Card ms of ``n_sweeps`` sweeps of the default table's hottest row
    (32 points, from the atomic start) at ``n_inner`` Newton steps an
    element, by CUDA events; the median of three launches."""
    dev = torch.device("cuda")
    static = F._prepare_static(F.load_chem_table())
    gs = F._GaussSeidel(static, torch.float64, "cpu", F.N_INNER)
    f64 = dict(dtype=torch.float64)
    lists = CC.sweep_lists(static, gs, dev)
    lnK = F._ln_k(gs.coeffs, torch.tensor([[6000.0]], **f64)).to(dev)
    ln_P = torch.log(torch.logspace(-8, 3, 32, **f64)).to(dev)
    idx = torch.zeros(1, dtype=torch.int32, device=dev)
    times = []
    for _ in range(4):
        start, stop = (torch.cuda.Event(enable_timing=True)
                       for _ in range(2))
        start.record()
        CC.table_kernel(lists, lnK, ln_P, idx, n_cold=n_sweeps,
                        n_warm=n_sweeps, n_inner=n_inner,
                        refinish_tol=float("inf"), settle=False,
                        settle_sweeps=1, settle_tol=0.0, settle_blocks=1)
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    return float(np.median(times[1:]))


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sweeps", type=int, default=20)
    ap.add_argument("--full", action="store_true")
    args = ap.parse_args(argv)
    out = {"threads_default": torch.get_num_threads(),
           "cpu_ms_default_threads": host_sweep_ms(args.sweeps),
           "cpu_ms_one_thread": host_sweep_ms(args.sweeps, threads=1)}
    card = {}
    if torch.cuda.is_available():
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
        print(smi, flush=True)
        out["card"] = smi
        for rule, dtype in RULES.items():
            walls = []
            for _ in range(REPEATS):
                card[rule] = F.FastChemTorch(SPECIES, M_BAR, dtype=dtype)
                walls.append(card[rule].build_seconds)
            c = card[rule]
            out[f"kernel_build_s_{rule}"] = walls
            out[f"kernel_sweeps_{rule}"] = c.build_sweeps
            out[f"kernel_rows_refinished_{rule}"] = c.rows_refinished
            out[f"kernel_ms_per_sweep_{rule}"] = (
                1e3 * min(walls) / c.build_sweeps)
        t16, t8 = chain_ms(args.sweeps, 16), chain_ms(args.sweeps, 8)
        elements = len(F._prepare_static(F.load_chem_table())["order"])
        out.update(chain_ms_inner16=t16, chain_ms_inner8=t8,
                   chain_ms_per_sweep=t16 / args.sweeps,
                   chain_us_per_newton_step=(
                       1e3 * (t16 - t8) / (args.sweeps * 8 * elements)),
                   kernel_launches=CC.table_kernel.launches)
    if args.full:
        for rule, dtype in RULES.items():
            host = F.FastChemTorch(SPECIES, M_BAR, dtype=dtype,
                                   build_device="cpu")
            out[f"host_build_s_{rule}"] = host.build_seconds
            out[f"host_sweeps_{rule}"] = host.build_sweeps
            if rule in card:
                a, b = card[rule]._tab_lnvmr, host._tab_lnvmr
                out[f"table_max_abs_kernel_vs_host_{rule}"] = float(
                    (a - b).abs().max())
                out[f"row_sweeps_equal_{rule}"] = bool(
                    (card[rule].row_sweeps == host.row_sweeps).all())
    print(json.dumps({"chem_build": out}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
