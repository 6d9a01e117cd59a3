"""Run one cell of the benchmark of frei_tpu_torch once, on the card.

    python3 benchmark/run.py --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1>

Set-up (the port's grid, the cell's inputs drawn from the seed, the
warm-up calls), then the cell's entry called back to back for
``--seconds``, each call ending in a synchronize, then the kept calls
checked against the plain reference.  The last line of standard output
is one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics``
(the cell's end-to-end metrics with ``--trace 0``, its per-layer
metrics with ``--trace 1``), ``device`` and, traced, ``breakdown``;
``checks`` (each compared number beside its limit) comes last.  Without
a CUDA device, or with fewer than the cell asks for, it exits 2 and
prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
#: the modules no run may hold, compared by their top-level name whole
FORBIDDEN = ("jax", "jaxlib", "flax", "frei_tpu")


def cache_dirs():
    """Every kernel cache at a fixed path inside the checkout (the port
    builds its own libraries into frei_tpu_torch/csrc/build/)."""
    base = ROOT / "benchmark" / ".cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(base / sub)


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def power_limit() -> str:
    try:
        p = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
        return p.stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"not read ({e})"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_dirs()
    sys.path.insert(0, str(ROOT))

    import torch

    from benchmark.harness import pieces
    man = pieces.manifest(ROOT)
    chips = pieces.cell(man, args.workload)["chips"]
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < chips:
        log(f"cell {args.workload} needs {chips} CUDA device(s); "
            f"found {cards}")
        return 2
    torch.set_num_threads(2)
    result = execute(man, args.workload, args.seed, args.seconds,
                     bool(args.trace), "cuda")
    held = forbidden_modules()
    if held:
        log(f"refused: the process holds {held}")
        return 3
    log(f"card: {power_limit()}")
    for name, c in result["checks"].items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


def execute(man, workload, seed, seconds, trace, device,
            overrides=None) -> dict:
    """One run of ``workload`` on ``device``: the result object."""
    import numpy as np
    import torch

    from benchmark.harness import cell, pieces
    on_card = torch.device(device).type == "cuda"
    t_ctx = time.perf_counter()
    ctx = cell.Context(workload, seed, device, man, overrides, spans=trace)
    entry = pieces.entry(ctx.traffic["entry"])
    state = entry.prepare(ctx)
    t_warm = time.perf_counter()
    for k in range(int(ctx.traffic["warmup_calls"])):
        t0 = time.perf_counter()
        entry.call(ctx, state, k, False)
        log(f"warm-up call {k}: {time.perf_counter() - t0:.4f} s")
    ctx.spans.clear()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - T_START
    log(f"set-up {setup_s:.4f} s: imports {t_ctx - T_START:.4f} s, inputs "
        f"and the program's set-up {t_warm - t_ctx:.4f} s, warm-up "
        f"{setup_s - (t_warm - T_START):.4f} s")

    w = cell.run_window(ctx, entry, state, seconds,
                        int(ctx.traffic["trace_calls"]) if trace else 0)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    q = np.percentile(w.walls, [0, 25, 50, 75, 95, 100]) * 1e3
    log(f"window {w.seconds:.4f} s, {len(w.walls)} calls, {w.failed} "
        f"failed, peak {peak} bytes; call walls min, quartiles, p95, max "
        f"{' '.join(f'{x:.2f}' for x in q)} ms")
    del state
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    checks = cell.judged(cell.check(ctx, entry, w.kept), ctx.limits)
    log(f"check of {len(w.kept)} kept calls: "
        f"{time.perf_counter() - t0:.4f} s")
    correct = (w.failed == 0 and bool(w.kept)
               and all(c["value"] <= c["limit"] for c in checks.values()))

    run = cell.Run(ctx, w, setup_s)
    kind = "per_layer" if trace else "end_to_end"
    metrics = cell.read_metrics(run, pieces.metrics_of(man, workload, kind))
    device_rec = {"platform": "gpu" if on_card else "cpu",
                  "kind": (torch.cuda.get_device_name(0) if on_card
                           else "cpu"),
                  "count": ctx.cell["chips"], "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": len(w.walls),
              "failed": w.failed, "metrics": metrics, "device": device_rec}
    if trace and w.trace is not None and w.trace.calls:
        device_rec.update(busy_s=w.trace.busy_s(),
                          window_s=w.trace.window_s())
        result["breakdown"] = {"device_ops": w.trace.device_ops(),
                               "idle_gaps": w.trace.idle_gaps()}
    result["checks"] = checks
    return result


if __name__ == "__main__":
    sys.exit(main())
