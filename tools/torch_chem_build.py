"""Where to build the equilibrium chemistry table: host or card.

    python3 tools/torch_chem_build.py [--full] [--sweeps 20]

``FastChemTorch(mode="table")`` solves a (64 T x 32 P) table row by row:
each row is 32 points, each Gauss-Seidel sweep a few thousand small
tensor operations, so the build is bound by issuing them, not by
arithmetic.  This script times one sweep (``--sweeps`` of them, after one
warm-up) at the row's fixed 32-point float64 shape

* on the host CPU with the default thread pool and with one thread (the
  build's setting);
* on the card, issued eagerly and replayed from a CUDA graph;

checks that the graph replays give the eager sweep's bits on the card and
that the card's state matches the host's to rounding, and with ``--full``
times the whole default build (three opacity species) on the host and on
the card's CUDA graph and compares the two tables.  Prints one JSON line
(per-sweep ms, build walls in s) and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from frei_tpu_torch.chemistry import fastchem as F  # noqa: E402

SPECIES = ("1H2-16O", "23Na", "48Ti-16O")
M_BAR = 2.4 * 1.67262192369e-24


def row_state(device):
    """A warm row: the cold solve of the 1500 K row of the default grid."""
    T = torch.full((32,), 1500.0, dtype=torch.float64, device=device)
    P = torch.logspace(-8, 3, 32, dtype=torch.float64, device=device)
    _, z = F.equilibrium_log_pressures(F.load_chem_table(), T, P,
                                       n_sweeps=20)
    return T, P, z


def sweep_ms(device, n, graph, threads=None):
    """Mean ms of one sweep at the row's shape, and the state after n."""
    static = F._prepare_static(F.load_chem_table())
    T, P, z = row_state(device)
    old = torch.get_num_threads()
    if threads:
        torch.set_num_threads(threads)
    try:
        with torch.inference_mode():
            gs = F._GaussSeidel(static, torch.float64, device, 16)
            solver = {"gs": gs}
            if graph:
                solver["graphed"] = F._GraphedSweep(gs, 32, torch.float64,
                                                    device)
            F._gs_solve(static, T, P, z, 1, 16, **solver)   # warm-up
            if device.type == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            ln_p, zn, r = F._gs_solve(static, T, P, z, n, 16, **solver)
            float(r[-1])                                     # waits
            ms = (time.perf_counter() - t0) / n * 1e3
    finally:
        torch.set_num_threads(old)
    return ms, ln_p.cpu(), zn.cpu()


def build_wall(device):
    """The default build's wall on ``device`` (the card: the graph)."""
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    chem = F.FastChemTorch(SPECIES, M_BAR, build_device=device)
    return time.perf_counter() - t0, chem


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sweeps", type=int, default=20)
    ap.add_argument("--full", action="store_true")
    args = ap.parse_args(argv)
    cpu = torch.device("cpu")
    out = {"threads_default": torch.get_num_threads()}
    ms, ln_cpu, _ = sweep_ms(cpu, args.sweeps, False)
    out["cpu_ms_default_threads"] = ms
    ms, _, _ = sweep_ms(cpu, args.sweeps, False, threads=1)
    out["cpu_ms_one_thread"] = ms
    if torch.cuda.is_available():
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
        print(smi, flush=True)
        out["card"] = smi
        dev = torch.device("cuda")
        ms_e, ln_e, z_e = sweep_ms(dev, args.sweeps, False)
        ms_g, ln_g, z_g = sweep_ms(dev, args.sweeps, True)
        out.update(cuda_ms_eager=ms_e, cuda_ms_graph=ms_g,
                   graph_bits_equal=bool(torch.equal(ln_e, ln_g)
                                         and torch.equal(z_e, z_g)),
                   cuda_vs_cpu_max_abs=float((ln_e - ln_cpu).abs().max()))
    if args.full:
        wall, chem_cpu = build_wall(cpu)
        out["build_wall_cpu_s"] = wall
        if torch.cuda.is_available():
            wall, chem_gpu = build_wall(torch.device("cuda"))
            out["build_wall_cuda_graph_s"] = wall
            a, b = chem_cpu._tab_lnvmr, chem_gpu._tab_lnvmr
            out["table_max_rel_cuda_vs_cpu"] = float(
                ((a - b).abs() / a.abs()).max())
            out["table_residual"] = [chem_cpu.table_residual,
                                     chem_gpu.table_residual]
    print(json.dumps({"chem_build": out}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
