"""On-disk caches: opacity stores and binned-opacity results.

A copy of ``frei_tpu.io.cache`` (numpy only).  The reference caches raw
opacity tables as netCDF in ``~/.frei`` (`frei/opacity.py:98,512-517`)
but re-runs the expensive resort-rebin on every ``load_opacities``
call.  Raw stores live under ``~/.frei_tpu/opacities`` and *binned*
results are cached keyed by a hash of the wavelength/pressure/
temperature grids and the source store fingerprints, so a retrieval
ensemble restart skips straight to the solve.  The variable
``FREI_TPU_CACHE``, the directories and the fingerprint are the JAX
package's own, so both packages share one store directory and one
binned cache.
"""

from __future__ import annotations

import hashlib
import os
import zipfile
from pathlib import Path

import numpy as np

__all__ = ["cache_root", "opacity_store_dir", "binned_cache_dir",
           "grid_fingerprint", "load_binned_cache", "save_binned_cache"]


def cache_root() -> Path:
    root = os.environ.get("FREI_TPU_CACHE")
    if root is None:
        root = os.path.join(os.path.expanduser("~"), ".frei_tpu")
    return Path(root)


def opacity_store_dir() -> Path:
    return cache_root() / "opacities"


def binned_cache_dir() -> Path:
    return cache_root() / "binned"


def grid_fingerprint(*arrays, extra: str = "") -> str:
    h = hashlib.sha256()
    for a in arrays:
        a = np.ascontiguousarray(np.asarray(a, dtype=np.float64))
        h.update(a.shape.__repr__().encode())
        h.update(a.tobytes())
    h.update(extra.encode())
    return h.hexdigest()[:24]


def load_binned_cache(key: str):
    path = binned_cache_dir() / f"{key}.npz"
    if not path.exists():
        return None
    try:
        with np.load(path, allow_pickle=False) as d:
            species = [str(s) for s in d["species"]]
            return {
                s: (d[f"values_{i}"], d["temps"], d["press_bar"])
                for i, s in enumerate(species)
            }
    except (OSError, ValueError, KeyError, zipfile.BadZipFile):
        # a truncated/garbage file (e.g. a writer killed mid-save
        # before atomic replace existed) is a MISS, not a permanent
        # poison: drop it and let the caller rebuild
        try:
            path.unlink()
        except OSError:
            pass
        return None


def save_binned_cache(key: str, tables: dict) -> Path:
    binned_cache_dir().mkdir(parents=True, exist_ok=True)
    path = binned_cache_dir() / f"{key}.npz"
    species = list(tables.keys())
    payload = {"species": np.array(species)}
    for i, s in enumerate(species):
        values, temps, press_bar = tables[s]
        payload[f"values_{i}"] = np.asarray(values, np.float32)
    payload["temps"] = np.asarray(tables[species[0]][1], np.float64)
    payload["press_bar"] = np.asarray(tables[species[0]][2], np.float64)
    # atomic publish: concurrent processes of a multi-host run may
    # save the same fingerprint — each writes its own temp file and
    # os.replace wins last, so a reader never sees a half-written zip
    # (the name must keep the .npz suffix or np.savez appends one)
    tmp = path.with_name(f".{path.stem}.{os.getpid()}.tmp.npz")
    try:
        np.savez_compressed(tmp, **payload)
        os.replace(tmp, path)
    finally:
        if tmp.exists():
            try:
                tmp.unlink()
            except OSError:
                pass
    return path
