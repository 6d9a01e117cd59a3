"""Opacity ETL: DACE binary ingest, the on-disk store, and the
streaming resort-rebin that produces solver-ready tables.

PyTorch counterpart of ``frei_tpu.opacity.etl``, with the reference's
pipeline (`frei/opacity.py`):

  DACE tarball -> .bin files (`download_molecule`, `opacity.py:491-517`)
  -> (T, P, wavelength) float32 cube assembled from filename-encoded
  metadata (`opacity_dir_to_netcdf`, `opacity.py:395-483`)
  -> resort-rebin to the run's wavelength bins with the grouped
  trapezoid kernel + bin-width x 1e-3 scaling (`opacity.py:124-148`)
  -> nearest-neighbor (T, P) interpolation with extrapolation onto the
  run grid (`opacity.py:27-30,141-146`).

The store is the JAX package's format (a directory of memmap-able
``.npy`` files plus ``meta.json``), so either package reads what the
other writes, and both share the binned-result cache of ``io.cache``.
The cube streams in (T, P)-row chunks through one of three rebin
engines:

* ``"eager"`` — ``ops.rebin.resort_rebin``, the kernel's plain twin, in
  torch on the stack's device (the JAX package's ``"xla"``);
* ``"native"`` — the threaded C++ host kernel (``frei_tpu_torch.native``);
* ``"cuda"`` — the CUDA kernel ``ops.rebin_cuda.rebin_kernel`` (the JAX
  package's ``"pallas"``), fed through pinned host buffers.
"""

from __future__ import annotations

import json
import mmap as _mmap
import os
import shutil
import tarfile
from glob import glob
from pathlib import Path

import numpy as np
import torch

from .. import constants as const
from ..chemistry.names import iso_to_species
from ..grids import RTGrid
from ..io.cache import (grid_fingerprint, load_binned_cache,
                        opacity_store_dir, save_binned_cache)

__all__ = [
    "OpacityStore", "opacity_dir_to_store", "load_store",
    "netcdf_to_store", "binned_opacity_tables", "binned_opacity_stack",
    "resolve_rebin_engine", "download_molecule", "download_atom",
    "make_synthetic_store",
]


class OpacityStore:
    """Memmap-backed raw opacity cube: (nT, nP, N) float32 in cm^2/g on
    an ascending wavelength grid in microns."""

    def __init__(self, path):
        self.path = Path(path)
        meta = json.loads((self.path / "meta.json").read_text())
        self.isotopologue = meta["isotopologue"]
        self.linelist = meta.get("linelist", "")
        self.temps = np.asarray(meta["temperatures_K"], np.float64)
        self.press_bar = np.asarray(meta["pressures_bar"], np.float64)
        self.wavelength_um = np.load(self.path / "wavelength_um.npy",
                                     mmap_mode="r")
        self.cube = np.load(self.path / "cube.npy", mmap_mode="r")

    @property
    def species(self):
        return iso_to_species(self.isotopologue)


def _write_store_header(out_path, isotopologue, linelist, temps,
                        press_bar, wavelength_um, shape):
    """The store's on-disk format (meta.json key set + float64
    wavelength axis), shared by the whole-cube and streaming writers and
    identical to the JAX package's."""
    out = Path(out_path)
    out.mkdir(parents=True, exist_ok=True)
    (out / "meta.json").write_text(json.dumps({
        "isotopologue": isotopologue,
        "linelist": linelist,
        "temperatures_K": list(map(float, temps)),
        "pressures_bar": list(map(float, press_bar)),
        "shape": list(shape),
    }, indent=1))
    np.save(out / "wavelength_um.npy",
            np.asarray(wavelength_um, np.float64))
    return out


def _write_store(out_path, isotopologue, linelist, temps, press_bar,
                 wavelength_um, cube):
    out = _write_store_header(out_path, isotopologue, linelist, temps,
                              press_bar, wavelength_um, np.shape(cube))
    np.save(out / "cube.npy", np.asarray(cube, np.float32))
    return out


def _parse_dace_filename(filename):
    """Extract (T [K], P [bar], wavenumber range) from a DACE bin-file
    name (`opacity.py:403-410`): fields are
    ``<prefix>_<wn_start>_<wn_end>_<T>_<sign><100*log10 P>.bin``."""
    parts = filename.split("_")
    temperature = int(parts[3])
    sign = 1 if parts[4][0] == "p" else -1
    pressure = 10.0 ** (sign * float(parts[4][1:].split(".")[0]) / 100.0)
    wl_start = int(parts[1])
    wl_end = int(parts[2])
    return temperature, pressure, wl_start, wl_end


def opacity_dir_to_store(opacity_dir, out_path, isotopologue="",
                         linelist=""):
    """Assemble a DACE .bin directory into a store
    (`opacity_dir_to_netcdf`, `opacity.py:395-483`).

    Wavelengths: the files tabulate an ascending wavenumber grid with
    0.01 cm^-1 steps; converted to microns, the first sample is dropped
    and the order reversed to ascending wavelength
    (`opacity.py:408-415,434-436`).  Single-pressure grids are mirrored
    in log P (`opacity.py:422-426,448-465`).
    """
    entries = []
    for dirpath, _, filenames in os.walk(opacity_dir):
        for fn in filenames:
            if not fn.endswith(".bin"):
                continue
            T, P, w0, w1 = _parse_dace_filename(fn)
            entries.append((T, P, w0, w1, os.path.join(dirpath, fn)))
    if not entries:
        raise FileNotFoundError(f"no .bin files under {opacity_dir}")
    w0, w1 = entries[0][2], entries[0][3]
    wlen = np.arange(w0, w1, 0.01)
    wavelength = (1.0 / wlen / 1e-4)[1:][::-1]   # ascending microns
    tgrid = np.sort(np.unique([e[0] for e in entries]))
    pgrid = np.sort(np.unique([e[1] for e in entries]))
    mirror = len(pgrid) == 1
    if mirror:
        pgrid = np.sort(np.concatenate(
            [pgrid, 10.0 ** (-np.log10(pgrid))]))
    cube = np.zeros((len(tgrid), len(pgrid), len(wavelength)),
                    dtype=np.float32)
    for T, P, _, _, path in entries:
        op = np.fromfile(path, dtype=np.float32)[1:][::-1]
        ti = int(np.argmin(np.abs(tgrid - T)))
        pis = [int(np.argmin(np.abs(pgrid - P)))]
        if mirror:
            pis.append(int(np.argmin(np.abs(
                pgrid - 10.0 ** (-np.log10(P))))))
        for pi in pis:
            cube[ti, pi, :] = op
    return _write_store(out_path, isotopologue, linelist, tgrid,
                        pgrid, wavelength, cube)


def netcdf_to_store(nc_path, out_path):
    """Convert a reference-style netCDF opacity file (as produced by
    ``frei``'s downloader into ``~/.frei``) to a store.  Requires the
    optional xarray package."""
    nc_path = str(nc_path)
    iso = os.path.basename(nc_path).split("__")[0]
    linelist = os.path.basename(nc_path).split("__")[-1].replace(
        ".nc", "")
    try:
        import xarray as xr
    except ImportError as err:
        raise ImportError(
            "converting reference netCDF opacities requires xarray"
        ) from err
    ds = xr.open_dataset(nc_path)
    temps = np.asarray(ds.temperature)
    press = np.asarray(ds.pressure)
    wav = np.asarray(ds.wavelength)
    cube = np.asarray(ds.opacity)
    order = np.argsort(wav)
    return _write_store(out_path, iso, linelist, temps, press,
                        wav[order], cube[..., order])


def load_store(path) -> OpacityStore:
    return OpacityStore(path)


def _nearest_indices(grid, points):
    """Nearest-neighbor with extrapolation (clamping), matching the
    reference's ``method='nearest', fill_value='extrapolate'`` interp
    (`opacity.py:27-30,141-146`)."""
    grid = np.asarray(grid, np.float64)
    return np.argmin(np.abs(grid[None, :] - np.asarray(
        points, np.float64)[:, None]), axis=1)


def _exact_bin_stats(wav, edges):
    """Per-bin sample statistics for the exact-average path: index range,
    sample count, span (last - first sample), and sample-mean wavelength
    of each right-closed bin ``(e_k, e_{k+1}]``.

    These depend only on the wavelength grid, so they are computed once
    on the host and shared by every (T, P) row."""
    # first sample strictly above the left edge / last sample <= right
    i0 = np.searchsorted(wav, edges[:-1], side="right")
    i1 = np.searchsorted(wav, edges[1:], side="right") - 1
    count = np.maximum(i1 - i0 + 1, 0)
    nonempty = count > 0
    i0n, i1n = i0[nonempty], i1[nonempty]
    span = wav[i1n] - wav[i0n]
    csum = np.concatenate([[0.0], np.cumsum(np.asarray(wav, np.float64))])
    mean = (csum[i1n + 1] - csum[i0n]) / count[nonempty]
    return nonempty, count[nonempty], span, mean


def _linear_extrap_weights(xs, targets):
    """Index/weight pairs for 1-D linear interpolation with linear
    extrapolation from the two nearest end points — scipy
    ``interp1d(..., fill_value='extrapolate')`` semantics, as the
    reference's final resampling onto the bin centers
    (`opacity.py:164-167`)."""
    xs = np.asarray(xs, np.float64)
    t = np.asarray(targets, np.float64)
    i = np.clip(np.searchsorted(xs, t) - 1, 0, len(xs) - 2)
    w = (t - xs[i]) / (xs[i + 1] - xs[i])
    return i, w


def _mmap_of(arr):
    """The underlying ``mmap`` object of a numpy memmap (None for
    in-memory arrays, e.g. tests constructing stores by hand)."""
    if os.environ.get("FREI_ETL_MADVISE", "1") == "0":
        return None
    return getattr(arr, "_mmap", None)


def _advise_sequential(arr):
    mm = _mmap_of(arr)
    if mm is not None:
        try:
            mm.madvise(_mmap.MADV_SEQUENTIAL)
        except (AttributeError, OSError, ValueError):  # pragma: no cover
            pass


def _advise_dontneed(arr, byte_start=None, byte_stop=None):
    """Drop the resident pages of ``arr``'s backing mmap in
    ``[byte_start, byte_stop)`` (data-relative; whole map if None).

    Range-limited on purpose: advising the WHOLE map away also discards
    the kernel's readahead of not-yet-consumed pages, which re-reads
    them from disk; dropping only the consumed range keeps streaming RSS
    at the chunk size without touching the readahead window."""
    mm = _mmap_of(arr)
    if mm is None:
        return
    try:
        if byte_start is None:
            mm.madvise(_mmap.MADV_DONTNEED)
            return
        page = _mmap.PAGESIZE
        data_off = getattr(arr, "offset", 0)
        lo = ((data_off + byte_start) // page) * page
        # round the end DOWN: the boundary page may hold the next
        # chunk's first bytes, and dropping it would discard readahead
        # just paid for (the next call's floor-rounded lo drops it once
        # it is fully consumed)
        hi = min(((data_off + byte_stop) // page) * page, len(mm))
        if hi > lo:
            mm.madvise(_mmap.MADV_DONTNEED, lo, hi - lo)
    except (AttributeError, OSError, ValueError):  # pragma: no cover
        pass


class _CudaRebin:
    """The ``"cuda"`` engine's streaming state for one store: the rebin
    plan (codes, widths and bin ranges, computed once), two pinned host
    buffers that chunks alternate through, and the (rows, bins) result on
    the card.  A chunk is copied from the memmap into a pinned buffer and
    sent to the card asynchronously, so the host reads the next chunk
    while the card copies and rebins this one; a buffer is reused only
    after its copy has finished (its event)."""

    def __init__(self, wav_c, edges_um, n_rows, row_chunk, device):
        from ..ops.rebin_cuda import make_rebin_plan
        self.device = device
        self.plan = make_rebin_plan(wav_c, edges_um, device=device)
        n = self.plan.n_samples
        rows = min(row_chunk, n_rows)
        self.buffers = [torch.empty((rows, n), dtype=torch.float32,
                                    pin_memory=True) for _ in range(2)]
        self.copied = [None, None]
        self.out = torch.empty((n_rows, self.plan.n_bins),
                               dtype=torch.float32, device=device)
        self.turn = 0

    def rebin(self, start, rows):
        from ..ops.rebin_cuda import rebin_kernel
        k = self.turn
        self.turn ^= 1
        if self.copied[k] is not None:
            self.copied[k].synchronize()
        buf = self.buffers[k][:rows.shape[0]]
        np.copyto(buf.numpy(), rows)
        with torch.cuda.device(self.device):
            chunk = buf.to(self.device, non_blocking=True)
            self.copied[k] = torch.cuda.Event()
            self.copied[k].record()
            self.out[start:start + rows.shape[0]] = rebin_kernel(chunk,
                                                                 self.plan)

    def result(self):
        return self.out.cpu().numpy()


def _rebin_store(store: OpacityStore, rt_grid: RTGrid, engine: str,
                 row_chunk: int = 64, groupies: bool = True, device=None):
    """Crop + grouped-trapezoid rebin + nearest (T, P) interpolation for
    one species store.

    ``groupies=True`` (the fast path the goldens are calibrated
    against): per-bin trapezoid INTEGRAL x bin width x 1e-3
    (`opacity.py:124-148`).

    ``groupies=False`` (the reference ``load_opacities`` DEFAULT,
    `core.py:199` -> `opacity.py:150-170`): per-bin trapezoid AVERAGE
    (integral / span of the samples in the bin, `mapfunc_exact`,
    `opacity.py:33-42`) located at the bin's sample-mean wavelength,
    then LINEAR interpolation with extrapolation onto the run's bin
    centers — which also fills empty bins.  A single-sample bin
    (reference: 0/0 -> NaN, never hit at line-list resolutions) takes
    the sample's value here.

    ``device`` is where the ``"eager"`` engine runs (default the CPU)
    and the CUDA device of the ``"cuda"`` engine (default the current
    one).  The scaling, the exact-average steps and the (T, P) mapping
    run on the host in float64 index arithmetic, as in the JAX package.
    """
    edges_um = rt_grid.wl_edges_cm / const.MICRON_TO_CM
    wav = np.asarray(store.wavelength_um)
    if groupies:
        # strict crop, as the reference's .where((wav > min) & (wav < max))
        lo, hi = np.searchsorted(wav, edges_um[0], side="right"), \
            np.searchsorted(wav, edges_um[-1], side="left")
    else:
        # groupby_bins drops out-of-bin samples itself; right-closed
        # intervals include a sample exactly at the last edge
        lo = np.searchsorted(wav, edges_um[0], side="right")
        hi = np.searchsorted(wav, edges_um[-1], side="right")
    wav_c = wav[lo:hi]
    nT, nP = store.cube.shape[:2]
    n_bins = rt_grid.n_wavelengths
    flat = store.cube.reshape(nT * nP, -1)
    out = np.empty((nT * nP, n_bins), dtype=np.float32)
    cuda_rebin = None

    if engine == "native":
        from ..native import grouped_trapezoid_native

        def rebin_rows(start, rows):
            out[start:start + rows.shape[0]] = grouped_trapezoid_native(
                rows, wav_c, edges_um)
    elif engine == "eager":
        from ..ops.rebin_cuda import make_rebin_plan, rebin_plain
        dev = torch.device("cpu" if device is None else device)
        # codes and panel widths on the float64 host coordinates
        # (float32 coordinates misassign edge-adjacent samples)
        plan = make_rebin_plan(wav_c, edges_um, device=dev)

        def rebin_rows(start, rows):
            # a copy: the memmap is read-only
            chunk = torch.as_tensor(np.array(rows, np.float32), device=dev)
            out[start:start + rows.shape[0]] = \
                rebin_plain(chunk, plan).cpu().numpy()
    elif engine == "cuda":
        dev = torch.device("cuda" if device is None else device)
        if dev.type != "cuda" or not torch.cuda.is_available():
            raise ValueError(f"rebin engine 'cuda' needs a CUDA device, "
                             f"got {dev}" + ("" if torch.cuda.is_available()
                                             else " (no CUDA device here)"))
        cuda_rebin = _CudaRebin(wav_c, edges_um, nT * nP, row_chunk, dev)
        rebin_rows = cuda_rebin.rebin
    else:
        raise ValueError(
            f"unknown rebin engine {engine!r} (expected one of "
            f"{sorted(_REBIN_ENGINES)})")

    _advise_sequential(store.cube)
    row_bytes = flat.shape[1] * store.cube.dtype.itemsize
    for start in range(0, nT * nP, row_chunk):
        stop = min(start + row_chunk, nT * nP)
        rebin_rows(start, flat[start:stop, lo:hi])
        # Drop the consumed chunk's file-backed pages: without this, a
        # multi-GB memmap read leaves every touched page resident and
        # "streaming" peaks at the STORE size, not the chunk size.  Rows
        # are read exactly once, so dropping the consumed range costs
        # nothing.
        _advise_dontneed(store.cube, start * row_bytes, stop * row_bytes)
    if cuda_rebin is not None:
        out = cuda_rebin.result()
    if groupies:
        binned = out.reshape(nT, nP, n_bins)
        width = np.diff(edges_um)
        binned = binned * (width * 1e-3).astype(np.float32)
    else:
        nonempty, count, span, mean_wl = _exact_bin_stats(wav_c, edges_um)
        if not nonempty.any():
            raise ValueError(
                f"store {store.isotopologue!r} has no samples inside "
                "the run's wavelength bins")
        avg = out[:, nonempty]
        single = count == 1
        if single.any():
            # limit value for a one-sample bin (reference yields NaN)
            i0 = np.searchsorted(wav_c, edges_um[:-1][nonempty],
                                 side="right")
            avg[:, single] = flat[:, lo:hi][:, i0[single]]
        avg[:, ~single] /= span[~single].astype(np.float32)
        if mean_wl.shape[0] == 1:
            out = np.repeat(avg, n_bins, axis=1)
        else:
            idx, w = _linear_extrap_weights(mean_wl, rt_grid.lam_micron)
            w32 = w.astype(np.float32)
            out = avg[:, idx] * (1.0 - w32) + avg[:, idx + 1] * w32
        binned = out.reshape(nT, nP, n_bins)

    ti = _nearest_indices(store.temps, rt_grid.init_temperatures)
    pi = _nearest_indices(store.press_bar, rt_grid.pressures_bar)
    values = binned[np.ix_(ti, pi)]          # (L_T, L_P, n_bins)
    return values, np.asarray(rt_grid.init_temperatures), \
        np.asarray(rt_grid.pressures_bar)


#: the rebin engines (module docstring)
_REBIN_ENGINES = {"eager", "native", "cuda"}

#: the JAX package's engine names, by their counterpart here (None: the
#: engine is on ROADMAP's list of code the port leaves out)
_JAX_ENGINES = {"xla": "eager", "pallas": "cuda", "matmul": None}


def resolve_rebin_engine(engine: str = "auto") -> str:
    """Resolve ``engine='auto'`` as the JAX package does: the threaded
    C++ host engine when g++ builds it, else the portable ``"eager"``
    engine.  The ETL streams a memmapped store from the host chunk by
    chunk, so which engine is fastest end to end depends on where the
    data is, not on kernel speed alone; ``PERF.md`` records the port's
    measured walls of ``"native"`` and ``"cuda"``.  Explicit names are
    validated (a typo must not silently run another engine)."""
    if engine == "auto":
        from ..native import native_available
        return "native" if native_available() else "eager"
    if engine in _JAX_ENGINES:
        ours = _JAX_ENGINES[engine]
        if ours is None:
            raise ValueError(
                f"rebin engine {engine!r} is on ROADMAP's list of code the "
                "port leaves out (the block-banded matrix-unit formulation "
                "of ops/rebin_matmul.py); use 'cuda', 'native' or 'eager'")
        raise ValueError(f"rebin engine {engine!r} is the JAX package's; "
                         f"its counterpart here is {ours!r}")
    if engine not in _REBIN_ENGINES:
        raise ValueError(
            f"unknown rebin engine {engine!r} (expected one of "
            f"{sorted(_REBIN_ENGINES)} or 'auto')")
    return engine


def binned_opacity_tables(rt_grid: RTGrid, species=None, path=None,
                          engine="auto", cache=True, groupies=True,
                          device=None):
    """Rebin every available species store onto the run grids.

    Returns ``{isotopologue: (values, temps_K, press_bar)}`` numpy
    arrays suitable for :func:`frei_tpu_torch.opacity.tables.
    make_opacity_stack`.  Equivalent of the reference ``binned_opacity``
    (`opacity.py:66-170`) with a binned-result disk cache shared with
    the JAX package.

    ``engine``: "auto" (threaded C++ when available, else "eager"),
    "eager", "native" or "cuda" (see the module docstring).  ``device``:
    where "eager" runs and which CUDA device "cuda" uses.

    ``path``: a directory containing ``*.ftop`` stores or a glob
    pattern over store paths (default: the user store dir).

    ``groupies`` selects between the reference's two rebin semantics
    (see :func:`_rebin_store`).
    """
    if path is None:
        path = str(opacity_store_dir() / "*.ftop")
    elif Path(path).is_dir():
        path = str(Path(path) / "*.ftop")
    paths = sorted(glob(str(path)))
    stores = [OpacityStore(p) for p in paths]
    if species is not None:
        wanted = set(species)
        stores = [s for s in stores
                  if s.species in wanted or s.isotopologue in wanted]
    if not stores:
        raise FileNotFoundError(
            f"no opacity stores matched {path!r}"
            + (f" for species {sorted(wanted)}" if species else "")
            + " — ingest with download_molecule()/opacity_dir_to_store()"
        )
    by_iso = {}
    for s in stores:
        if s.isotopologue in by_iso:
            other = by_iso[s.isotopologue]
            raise ValueError(
                f"two opacity stores for isotopologue "
                f"{s.isotopologue!r}: {other.path.name!r} (linelist "
                f"{other.linelist!r}) and {s.path.name!r} (linelist "
                f"{s.linelist!r}).  The binned tables are keyed by "
                "isotopologue, so one would silently shadow the "
                "other — narrow the `path=` glob (or move one store) "
                "to pick a linelist")
        by_iso[s.isotopologue] = s
    # the fingerprint carries the linelist too: swapping a store for a
    # same-shape different linelist must not serve stale cached tables
    key = grid_fingerprint(
        rt_grid.wl_edges_cm, rt_grid.pressures_cgs,
        rt_grid.init_temperatures,
        extra="|".join(f"{s.isotopologue}:{s.linelist}:{s.cube.shape}"
                       for s in stores)
        + ("" if groupies else "|exact"))
    engine = resolve_rebin_engine(engine)
    if cache:
        hit = load_binned_cache(key)
        if hit is not None:
            return hit
    tables = {}
    for s in stores:
        tables[s.isotopologue] = _rebin_store(s, rt_grid, engine,
                                              groupies=groupies,
                                              device=device)
    if cache:
        save_binned_cache(key, tables)
    return tables


def binned_opacity_stack(rt_grid: RTGrid, species=None, path=None,
                         engine="auto", cache=True, dtype=None,
                         groupies=True, device=None):
    """binned_opacity_tables -> :class:`OpacityStack` in ``dtype``
    (default float32) on ``device`` (default the card), where the
    ``"eager"`` and ``"cuda"`` engines also run."""
    from .tables import make_opacity_stack
    device = "cuda" if device is None else device
    tables = binned_opacity_tables(rt_grid, species=species, path=path,
                                   engine=engine, cache=cache,
                                   groupies=groupies, device=device)
    return make_opacity_stack(
        tables, dtype=torch.float32 if dtype is None else dtype,
        device=device)


# ---------------------------------------------------------------------------
# acquisition (network, optional `dace` package) — reference
# `opacity.py:345-392,491-546`

def _dace_download(kind, archive_name, **kwargs):
    try:
        from dace_query.opacity import Atom, Molecule  # noqa: F401
    except ImportError:
        try:
            from dace.opacity import Atom, Molecule  # noqa: F401
        except ImportError as err:
            raise ImportError(
                "downloading opacities requires the optional 'dace' "
                "client package; alternatively place DACE .bin files "
                "and call opacity_dir_to_store()"
            ) from err
    os.makedirs("tmp", exist_ok=True)
    if kind == "molecule":
        Molecule.download(output_directory="tmp",
                          output_filename=archive_name, **kwargs)
    else:
        Atom.download(output_directory="tmp",
                      output_filename=archive_name, **kwargs)
    return os.path.join("tmp", archive_name)


def _untar_bin_files(archive_name):
    """Extract only the ``.bin`` members, under tarfile's 'data'
    filter: a crafted archive member like ``../../x.bin`` must not
    escape tmp/."""
    def bin_members(members):
        for m in members:
            if os.path.splitext(m.name)[1] == ".bin":
                yield m
    with tarfile.open(archive_name, "r:gz") as tar:
        tar.extractall(path="tmp/.", members=bin_members(tar),
                       filter="data")


def download_molecule(isotopologue, linelist,
                      temperature_range=(500, 5000),
                      pressure_range=(-6, 1.5), version=1):
    """Download + ingest a molecular line list from DACE
    (`opacity.py:491-517`).  ~5-6 GB per molecule."""
    archive = _dace_download(
        "molecule", f"{isotopologue}__{linelist}.tar.gz",
        isotopologue=isotopologue, linelist=linelist,
        version=float(version), temperature_range=list(temperature_range),
        pressure_range=list(pressure_range))
    _untar_bin_files(archive)
    bin_dir = glob(os.path.join(
        "tmp", f"{isotopologue}__{linelist}*e2b"))[0]
    out = opacity_store_dir() / f"{isotopologue}__{linelist}.ftop"
    opacity_dir_to_store(bin_dir, out, isotopologue, linelist)
    os.remove(archive)
    shutil.rmtree(bin_dir)
    return out


def download_atom(atom, charge, linelist,
                  temperature_range=(500, 5000),
                  pressure_range=(-8, 1.5), version=1):
    """Download + ingest an atomic line list from DACE
    (`opacity.py:520-546`)."""
    archive = _dace_download(
        "atom", f"{atom}__{linelist}.tar.gz",
        element=atom, charge=int(charge), linelist=linelist,
        version=float(version), temperature_range=list(temperature_range),
        pressure_range=list(pressure_range))
    _untar_bin_files(archive)
    bin_dir = glob(os.path.join("tmp", f"{linelist}*e2b"))[0]
    out = opacity_store_dir() / f"{atom}_{int(charge)}__{linelist}.ftop"
    opacity_dir_to_store(bin_dir, out, atom, linelist)
    os.remove(archive)
    shutil.rmtree(bin_dir)
    return out


def make_synthetic_store(out_path, isotopologue="1H2-16O",
                         n_hr=200_000, temps=(1000.0, 2000.0, 3000.0),
                         press_bar=(1e-4, 1e-2, 1.0, 100.0), seed=7,
                         lam_range_um=(0.4, 11.0),
                         linelist="synthetic"):
    """Deterministic synthetic high-resolution store for tests and
    benchmarks (no multi-GB download needed), value for value the JAX
    package's.

    The cube is written one temperature row at a time through an
    ``open_memmap`` into a temporary name and renamed when complete, so
    generating even a reference-volume store never holds the cube in
    memory and an interrupted generation leaves no valid-looking cube
    of zeros."""
    rng = np.random.RandomState(seed)
    wav = np.linspace(lam_range_um[0], lam_range_um[1], n_hr)
    nT, nP = len(temps), len(press_bar)
    base = np.exp(-0.5 * (wav - 6.0) ** 2 / 4.0)
    lines = np.zeros_like(wav)
    for amp, mu, sig in zip(rng.uniform(0.1, 1.0, 40),
                            rng.uniform(0.5, 10.0, 40),
                            rng.uniform(2e-4, 2e-2, 40)):
        lines += amp * np.exp(-0.5 * (wav - mu) ** 2 / sig ** 2)
    out = _write_store_header(out_path, isotopologue, linelist, temps,
                              press_bar, wav, (nT, nP, n_hr))
    tmp = out / "cube.npy.tmp"
    cube = np.lib.format.open_memmap(
        tmp, mode="w+", dtype=np.float32, shape=(nT, nP, n_hr))
    pscale = 1.0 + 0.1 * np.log10(np.asarray(press_bar) / 1e-4)
    for i, T in enumerate(temps):
        row = base * (T / 2000.0) + lines
        for j in range(nP):
            cube[i, j] = row * pscale[j]
        cube.flush()
    del cube
    os.replace(tmp, out / "cube.npy")
    return out
