"""Float32 solves of an optically thin binned stack: JAX package vs port.

    JAX_PLATFORMS=cpu python tools/torch_thin_stack.py [--columns 2048]

Writes the two synthetic line-list stores that ``chip_smoke.py`` phase
4c bins (``1H2-16O`` and ``12C-16O``, 8 T x 8 P x 2e6 samples, 512 MB
each) into ``chip_smoke_data/thin_stack/`` (removed after), bins them
once onto the 500-bin x 30-layer grid with the port's host engine
(``groupies=True``, as ``Grid.load_opacities(path=...)`` does; the JAX
package's ETL gives the same tables bit for bit, see
``tests/test_torch_etl.py``), hands the same tables to both packages,
and solves the same float32 columns (``chip_smoke.columns``: the grid's
T(P) x U(0.95, 1.05), seed 0) for 20 fixed iterations on the CPU: JAX
``engine="xla"`` and the port's ``engine="eager"``.  Prints each
engine's count of columns with a non-finite flux, and the float64 count
of the port as a control.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time
from pathlib import Path

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import frei_tpu  # noqa: E402
from frei_tpu_torch import Grid, Planet  # noqa: E402
from frei_tpu_torch.opacity import etl  # noqa: E402

SPECIES = ("1H2-16O", "12C-16O")
TEMPS = tuple(np.linspace(500.0, 4000.0, 8))
PRESS_BAR = tuple(np.logspace(-6.0, 2.5, 8))
N_BINS, N_LAYERS, N_ITERS = 500, 30, 20


def initial_columns(init_temperatures, n, seed=0):
    rng = np.random.RandomState(seed)
    return np.asarray(init_temperatures)[None, :] * rng.uniform(
        0.95, 1.05, (n, 1))


def non_finite(flux):
    return int((~np.isfinite(np.asarray(flux))).any(1).sum())


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--columns", type=int, default=2048)
    args = ap.parse_args()
    torch.set_num_threads(4)
    work = ROOT / "chip_smoke_data" / "thin_stack"
    shutil.rmtree(work, ignore_errors=True)
    os.environ["FREI_TPU_CACHE"] = str(work / "cache")
    try:
        stores = work / "stores"
        for k, iso in enumerate(SPECIES):
            etl.make_synthetic_store(stores / f"{iso}__synthetic.ftop",
                                     isotopologue=iso, n_hr=2_000_000,
                                     temps=TEMPS, press_bar=PRESS_BAR,
                                     seed=7 + k)
        tg = Grid(Planet.from_hot_jupiter(), n_wl_bins=N_BINS,
                  n_layers=N_LAYERS, T_ref=2400.0, dtype=torch.float32,
                  device="cpu")
        tables = etl.binned_opacity_tables(tg.rt_grid, path=stores,
                                           engine="native", cache=False)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    kmax = max(float(np.max(v[0])) for v in tables.values())
    T0 = initial_columns(tg.init_temperatures, args.columns)
    kw = dict(n_timesteps=N_ITERS, n_zero_crossings=10 ** 6,
              convergence_dT=0.0)
    counts = {}

    jg = frei_tpu.Grid(frei_tpu.Planet.from_hot_jupiter(), n_wl_bins=N_BINS,
                       n_layers=N_LAYERS, T_ref=2400.0, dtype=jnp.float32)
    jg.load_opacities(opacities=tables)
    t0 = time.perf_counter()
    spec, *_ = jg.emission_spectra(T0, engine="xla", **kw)
    counts["jax xla float32"] = non_finite(spec.flux_cgs)
    print(f"jax xla float32: {time.perf_counter() - t0:.1f} s", flush=True)

    for dtype in (torch.float32, torch.float64):
        g = Grid(Planet.from_hot_jupiter(), n_wl_bins=N_BINS,
                 n_layers=N_LAYERS, T_ref=2400.0, dtype=dtype, device="cpu")
        g.load_opacities(opacities=tables)
        t0 = time.perf_counter()
        spec, *_ = g.emission_spectra(T0, engine="eager", **kw)
        name = f"port eager {str(dtype).split('.')[1]}"
        counts[name] = non_finite(spec.flux_cgs)
        print(f"{name}: {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps({"columns": args.columns, "iterations": N_ITERS,
                      "max_binned_opacity": kmax,
                      "non_finite_columns": counts}))


if __name__ == "__main__":
    main()
