#!/usr/bin/env python3
"""Trials of the kappa lookup kernel on the card.

    python3 tools/torch_kappa_trials.py

At the float32 headline of ``chip_smoke.py`` phase 3c (8192 x 30 lookup
points x 500 bins, 2 species; ``chip_smoke.opacity_inputs``) it prints

* the card's write rate: ``torch.Tensor.fill_`` of a tensor the size of
  the (N, W) output, the yardstick of a kernel bound by its writes;
* where one call's time goes: each CUDA kernel's mean device time over
  20 calls of ``kappa_kernel`` under ``torch.profiler``, and the host's
  time to issue one call (the mean over 200 calls issued back to back);
* trial builds: copies of ``frei_tpu_torch/csrc/kappa.cu`` with one
  change each (``TRIALS``), written and built at once into
  ``csrc/build/`` beside the production library: the warps' stores not
  shifted onto 32-byte sectors (rows of 2000 bytes at W = 500); plain in
  place of evict-first stores; rows written in plan order, contiguous
  but the wrong ones (what the scattered rows of a bucket cost);
  registers capped for 8, 10 or 12 blocks per SM.  Each is timed (CUDA
  events, the mean of 20 calls) as the lookup and as the write-only
  variant with work items of 16, 32 and 64 points, in turns over two
  rounds;
* the same lookup at other row widths (W = 496 and 512, the table's
  rows cut or extended), the production, unshifted and plan-order builds
  beside ``fill_``: whether the rows' 16-byte (not 32-byte) alignment at
  W = 500 is what the scattered order costs.

It needs one CUDA device and prints one JSON line at the end.
"""

from __future__ import annotations

import json
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

ITEMS = (16, 32, 64)
_LOOKUP = "__global__ void __launch_bounds__(kThreads)\n    kappa_lookup_kernel("
# trial builds: each an exact replacement in the shipped source
TRIALS = {
    "warps unshifted": ("const int paired = vec &&",
                        "const int paired = 0 && vec &&"),
    "plain stores": ("__stcs(dst, x);", "*dst = x;"),
    "plan-order": ("const int n = order[start + q];",
                   "const int n = start + q;  // the wrong rows"),
    **{f"registers for {k} blocks": (
        _LOOKUP, _LOOKUP.replace("(kThreads)", f"(kThreads, {k})"))
       for k in (8, 10, 12)}}


def trial_source(text: str, trial: str) -> str:
    """The shipped source with the one change of ``trial``."""
    old, new = TRIALS[trial]
    if text.count(old) != 1:
        raise RuntimeError(f"trial {trial!r}: {old!r} is not in kappa.cu "
                           "exactly once")
    return text.replace(old, new)


def profile_call(fn, calls=20):
    """Mean device time per call of each CUDA kernel (and memset) that
    ``fn`` launches, in microseconds, by torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", 0)
        if t > 0:
            out[e.key] = t / calls
    return out


def trials():
    import torch

    import chip_smoke as cs
    from frei_tpu_torch.ops import kappa_cuda as KC
    from frei_tpu_torch.ops.cuda_build import (BUILD_DIR, build_library,
                                               load_library)
    smi = cs.subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(f"[trials] {smi}", flush=True)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    text = KC._SOURCE.read_text()
    srcs, libs = {}, {}
    for i, k in enumerate(TRIALS):
        srcs[k] = BUILD_DIR / f"kappa_trial{i}.cu"
        srcs[k].write_text(trial_source(text, k))
        libs[k] = BUILD_DIR / f"libfrei_kappa_trial{i}.so"
    include = ("-I", str(KC._SOURCE.parent))

    def build(k):
        return build_library(srcs[k], libs[k], include)
    with ThreadPoolExecutor(len(TRIALS) + 1) as pool:
        prod = pool.submit(KC.build)
        reports = dict(zip(TRIALS, pool.map(build, TRIALS)))
        reports["production"] = prod.result()
    for k, report in reports.items():
        for line in cs.ptxas_summary(report):
            if "kappa_lookup<float, mode 0, 16-byte>" in line:
                print(f"[trials] {k}: {line}", flush=True)
    # None: the production library, as kappa_kernel loads it
    builds = {"production": None,
              **{k: load_library(srcs[k], libs[k], KC.SIGNATURES)
                 for k in TRIALS}}

    args = cs.opacity_inputs(torch.float32, cs.N_COLUMNS)
    N, W = args[2].numel(), args[4].numel()
    res = {"card": smi}
    buf = torch.empty((N, W), dtype=torch.float32, device="cuda")
    res["fill_ms"] = cs.time_ms(lambda: buf.fill_(1.0), 20)
    del buf
    print(f"[trials] fill_ of {N} x {W} float32: {res['fill_ms']:.4f} ms "
          f"({N * W * 4 / res['fill_ms'] / 1e9:.3f} TB/s)", flush=True)

    # the production build: each kernel's device time, the host's issue
    res["profile_us"] = profile_call(lambda: KC.kappa_kernel(*args))
    for k, us in res["profile_us"].items():
        print(f"[trials] profile: {us:9.2f} us per call  {k}", flush=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        KC.kappa_variant("plan", *args)
    res["host_us_per_call"] = (time.perf_counter() - t0) / 200 * 1e6
    torch.cuda.synchronize()
    print(f"[trials] host time to issue one call: "
          f"{res['host_us_per_call']:.1f} us", flush=True)

    times = {f"{k} items={p}": {"lookup": [], "write": []}
             for k in builds for p in ITEMS}
    for _ in range(2):
        for k, lib in builds.items():
            for p in ITEMS:
                for v in ("lookup", "write"):
                    times[f"{k} items={p}"][v].append(cs.time_ms(
                        lambda v=v, p=p, lib=lib: KC.kappa_variant(
                            v, *args, item_points=p, library=lib), 20))
    for label, t in times.items():
        print(f"[trials] {label:34s} lookup "
              + ", ".join(f"{x:.4f}" for x in t["lookup"]) + " ms; write "
              + ", ".join(f"{x:.4f}" for x in t["write"]) + " ms",
              flush=True)
    res["trials_ms"] = times

    # other row widths: the table's rows cut or extended
    stack, mmr, T, P, sig = args
    widths = {}
    for W2 in (496, 500, 512):
        v = stack.values
        v = (v[..., :W2] if W2 <= W else
             torch.cat([v, v[..., :W2 - W]], -1)).contiguous()
        s2 = (sig[:W2] if W2 <= W else
              torch.cat([sig, sig[:W2 - W]])).contiguous()
        a2 = (stack._replace(values=v), mmr, T, P, s2)
        buf = torch.empty((N, W2), dtype=torch.float32, device="cuda")
        row = {"fill": cs.time_ms(lambda: buf.fill_(1.0), 20)}
        del buf
        for k in ("production", "warps unshifted", "plan-order"):
            row[k] = cs.time_ms(lambda k=k: KC.kappa_variant(
                "lookup", *a2, library=builds[k]), 20)
        widths[W2] = row
        print(f"[trials] W={W2}: fill_ {row['fill']:.4f} ms, lookup "
              + ", ".join(f"{k} {x:.4f}" for k, x in row.items()
                          if k != "fill") + " ms", flush=True)
    res["widths_ms"] = widths
    print(json.dumps({"kappa_trials": res}), flush=True)


if __name__ == "__main__":
    import torch
    if not torch.cuda.is_available():
        sys.exit("torch_kappa_trials: needs an NVIDIA GPU")
    trials()
