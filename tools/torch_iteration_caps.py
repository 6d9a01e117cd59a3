#!/usr/bin/env python3
"""Register-cap trials of the whole-iteration kernels on the card.

    python3 tools/torch_iteration_caps.py 3 4 5 6 7 8

Builds ``frei_tpu_torch/csrc/iteration.cu`` once per number of blocks
per SM that the float32 register cap is set for (the
``FREI_ITERATION_MIN_BLOCKS`` / ``FREI_LOOP_MIN_BLOCKS`` defines, both
set to it), all builds at once, into ``csrc/build/`` beside the
production library; prints ptxas's registers and spills of the float32
instantiations the headline runs (the iteration kernel at 4 wavelengths
per thread, the loop kernel at 2), then times ``rc_iteration_kernel`` (one
RC step) and ``rc_loop_kernel`` (20 iterations) of each build at the
headline shape (8192 x 500 x 30, float32; ``chip_smoke.whole_times``),
in turns over two rounds.  It needs one CUDA device and prints one
JSON line.
"""

from __future__ import annotations

import json
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def caps(ks):
    import chip_smoke as cs
    from frei_tpu_torch.ops import iteration_cuda as IC
    from frei_tpu_torch.ops.cuda_build import (BUILD_DIR, build_library,
                                               load_library)
    libs = {k: BUILD_DIR / f"libfrei_iteration_cap{k}.so" for k in ks}

    def build(k):
        return build_library(IC._SOURCE, libs[k], (
            f"-DFREI_ITERATION_MIN_BLOCKS={k}", f"-DFREI_LOOP_MIN_BLOCKS={k}"))
    with ThreadPoolExecutor(len(ks)) as pool:
        reports = dict(zip(ks, pool.map(build, ks)))
    for k in ks:
        for line in cs.ptxas_summary(reports[k]):
            if ("iteration<float, NPT=4, mode 0>" in line
                    or "loop<float, NPT=2>" in line):
                print(f"[caps] {k} blocks per SM: {line}", flush=True)
    times = {k: {"iteration": [], "loop": []} for k in ks}
    for _ in range(2):
        for k in ks:
            IC._lib = load_library(IC._SOURCE, libs[k], IC.SIGNATURES)
            t = cs.whole_times(plain=False)
            for name in ("iteration", "loop"):
                times[k][name].append(t[name]["ms"])
    print(json.dumps({"caps_ms": times}), flush=True)


if __name__ == "__main__":
    import torch
    if not torch.cuda.is_available():
        sys.exit("torch_iteration_caps: needs an NVIDIA GPU")
    caps([int(x) for x in sys.argv[1:]] or [3, 4, 5, 6, 7, 8])
