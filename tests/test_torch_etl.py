"""The opacity ETL of frei_tpu_torch against frei_tpu, case for case
with tests/test_etl.py: the store format (either package reads what the
other writes), DACE ingest, the streamed rebin on both packages'
engines, the shared binned cache, engine resolution, and
``Grid.load_opacities`` from a store.

Tolerances: the port's ``"eager"`` and ``"native"`` engines against the
JAX package's ``"xla"`` and ``"native"`` at rtol 2e-6 (the same float32
panels and host float64 codes; the native engines are one C++ source,
and the segment sums run in the same order, so in practice the tables
agree bit for bit); the exact path against a float64 transcription at
rtol 5e-5, as the JAX package holds its own."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import frei_tpu
from frei_tpu.grids import make_rt_grid as j_make_rt_grid
from frei_tpu.opacity import etl as jetl
from frei_tpu_torch import Grid, Planet
from frei_tpu_torch.grids import make_rt_grid
from frei_tpu_torch.native import native_available
from frei_tpu_torch.opacity import etl
from frei_tpu_torch.opacity.tables import make_opacity_stack

torch.set_num_threads(2)


@pytest.fixture()
def cache_env(tmp_path, monkeypatch):
    monkeypatch.setenv("FREI_TPU_CACHE", str(tmp_path / "cache"))
    return tmp_path


def _store_dir(cache_env):
    store_dir = cache_env / "cache" / "opacities"
    store_dir.mkdir(parents=True)
    return store_dir


def test_synthetic_store_roundtrip(cache_env):
    """The port writes the JAX package's store format, value for value,
    and each package reads the other's store."""
    p = etl.make_synthetic_store(cache_env / "syn.ftop", n_hr=5000)
    q = jetl.make_synthetic_store(cache_env / "jsyn.ftop", n_hr=5000)
    st = etl.OpacityStore(p)
    assert st.isotopologue == "1H2-16O"
    assert st.species == "H2O"
    assert st.cube.shape == (3, 4, 5000)
    assert np.all(np.diff(st.wavelength_um) > 0)
    for a, b in ((jetl.OpacityStore(p), etl.OpacityStore(q)),
                 (st, jetl.OpacityStore(q))):
        np.testing.assert_array_equal(a.cube, b.cube)
        np.testing.assert_array_equal(a.wavelength_um, b.wavelength_um)
        np.testing.assert_array_equal(a.temps, b.temps)
        np.testing.assert_array_equal(a.press_bar, b.press_bar)
        assert (a.isotopologue, a.linelist) == (b.isotopologue, b.linelist)
    assert (p / "meta.json").read_text() == (q / "meta.json").read_text()


def test_dace_bin_dir_ingest(cache_env):
    """Filename-metadata parsing and cube assembly (`opacity.py:395-483`
    semantics), including the [1:][::-1] wavelength handling; the store
    equals the JAX package's ingest of the same files."""
    bdir = cache_env / "bins"
    bdir.mkdir()
    wn0, wn1 = 10000, 10010     # 1000 wavenumber samples at 0.01 step
    n = len(np.arange(wn0, wn1, 0.01))
    rng = np.random.RandomState(0)
    for T in (1000, 2000):
        for ptag in ("p100", "n200"):
            data = rng.uniform(0.0, 1.0, n).astype(np.float32)
            data.tofile(bdir / f"Out_{wn0}_{wn1}_{T}_{ptag}.bin")
    assert etl._parse_dace_filename(f"Out_{wn0}_{wn1}_1000_n200.bin") \
        == jetl._parse_dace_filename(f"Out_{wn0}_{wn1}_1000_n200.bin")
    st = etl.OpacityStore(etl.opacity_dir_to_store(
        bdir, cache_env / "ing.ftop", "12C-16O"))
    ref = jetl.OpacityStore(jetl.opacity_dir_to_store(
        bdir, cache_env / "jing.ftop", "12C-16O"))
    assert st.cube.shape == (2, 2, n - 1)
    np.testing.assert_allclose(sorted(st.press_bar), [0.01, 10.0])
    np.testing.assert_allclose(sorted(st.temps), [1000, 2000])
    wav = np.asarray(st.wavelength_um)
    assert np.all(np.diff(wav) > 0)
    np.testing.assert_allclose(wav[-1], 1.0 / (wn0 + 0.01) / 1e-4)
    np.testing.assert_array_equal(st.cube, ref.cube)
    np.testing.assert_array_equal(wav, ref.wavelength_um)


def test_single_pressure_mirroring(cache_env):
    bdir = cache_env / "bins1p"
    bdir.mkdir()
    n = len(np.arange(5000, 5005, 0.01))
    np.ones(n, dtype=np.float32).tofile(bdir / "Out_5000_5005_1500_p200.bin")
    st = etl.OpacityStore(etl.opacity_dir_to_store(
        bdir, cache_env / "m.ftop", "Na"))
    np.testing.assert_allclose(sorted(st.press_bar), [0.01, 100.0])
    assert np.all(st.cube[0, 0] == st.cube[0, 1])
    with pytest.raises(FileNotFoundError, match="no .bin files"):
        etl.opacity_dir_to_store(cache_env / "cache", cache_env / "e.ftop")


_PAIRS = [("xla", "eager"), ("native", "native")]


@pytest.mark.parametrize("groupies", [True, False],
                         ids=["groupies", "exact"])
@pytest.mark.parametrize("engines", _PAIRS, ids=["eager", "native"])
def test_tables_match_jax(cache_env, engines, groupies):
    """A store written by the JAX package, binned by both packages."""
    jax_engine, engine = engines
    if engine == "native" and not native_available():
        pytest.skip("no C++ toolchain available")
    store_dir = _store_dir(cache_env)
    jetl.make_synthetic_store(store_dir / "1H2-16O__synthetic.ftop",
                              n_hr=20000)
    jetl.make_synthetic_store(store_dir / "23Na__synthetic.ftop",
                              isotopologue="23Na", n_hr=20000, seed=9,
                              lam_range_um=(0.8, 7.0))
    want = jetl.binned_opacity_tables(
        j_make_rt_grid(n_wl_bins=32, n_layers=4), engine=jax_engine,
        cache=False, groupies=groupies)
    got = etl.binned_opacity_tables(make_rt_grid(n_wl_bins=32, n_layers=4),
                                    engine=engine, cache=False,
                                    groupies=groupies)
    assert list(got) == list(want)
    for iso in want:
        for a, b in zip(got[iso], want[iso]):
            np.testing.assert_allclose(a, b, rtol=2e-6, atol=0)


def test_binned_stack_end_to_end(cache_env):
    """The default store directory, a stack on the CPU, and the cached
    second load, which the JAX package reads too (one shared cache)."""
    store_dir = _store_dir(cache_env)
    etl.make_synthetic_store(store_dir / "1H2-16O__synthetic.ftop",
                             n_hr=40000)
    grid = make_rt_grid(n_wl_bins=64, n_layers=8, T_ref=2400.0)
    stack = etl.binned_opacity_stack(grid, dtype=torch.float64,
                                     device="cpu")
    assert stack.species == ("1H2-16O",)
    assert stack.values.shape == (1, 8, 8, 64)
    assert stack.values.dtype == torch.float64
    v = stack.values.numpy()
    assert np.all(np.isfinite(v)) and v.max() > 0
    assert len(list((cache_env / "cache" / "binned").glob("*.npz"))) == 1
    again = etl.binned_opacity_tables(grid)
    jax_hit = jetl.binned_opacity_tables(
        j_make_rt_grid(n_wl_bins=64, n_layers=8, T_ref=2400.0))
    assert len(list((cache_env / "cache" / "binned").glob("*.npz"))) == 1
    for tabs in (again, jax_hit):
        np.testing.assert_array_equal(
            make_opacity_stack(tabs, dtype=torch.float64,
                               device="cpu").values.numpy(), v)


def test_species_filter_and_missing(cache_env):
    store_dir = _store_dir(cache_env)
    etl.make_synthetic_store(store_dir / "1H2-16O__synthetic.ftop",
                             n_hr=2000)
    grid = make_rt_grid(n_wl_bins=16, n_layers=4)
    t = etl.binned_opacity_tables(grid, species=["H2O"], cache=False)
    assert list(t) == ["1H2-16O"]
    t = etl.binned_opacity_tables(grid, species=["1H2-16O"], cache=False)
    assert list(t) == ["1H2-16O"]
    with pytest.raises(FileNotFoundError, match="TiO"):
        etl.binned_opacity_tables(grid, species=["TiO"], cache=False)


def test_duplicate_isotopologue_rejected(cache_env):
    store_dir = _store_dir(cache_env)
    etl.make_synthetic_store(store_dir / "1H2-16O__BT2.ftop", n_hr=2000)
    etl.make_synthetic_store(store_dir / "1H2-16O__POKAZATEL.ftop",
                             n_hr=2000)
    grid = make_rt_grid(n_wl_bins=16, n_layers=4)
    with pytest.raises(ValueError, match="isotopologue"):
        etl.binned_opacity_tables(grid, cache=False)


def test_corrupt_binned_cache_is_a_miss(cache_env):
    """A truncated/garbage cache file reads as a miss and is dropped;
    saves are atomic (temp file + os.replace) and the JAX package reads
    what the port saved."""
    from frei_tpu.io.cache import load_binned_cache as j_load
    from frei_tpu_torch.io.cache import (binned_cache_dir,
                                         load_binned_cache,
                                         save_binned_cache)
    binned_cache_dir().mkdir(parents=True, exist_ok=True)
    bad = binned_cache_dir() / "deadbeef.npz"
    bad.write_bytes(b"this is not a zip file")
    assert load_binned_cache("deadbeef") is None
    assert not bad.exists()              # dropped for rebuild
    tables = {"1H2-16O": (np.ones((2, 2, 4), np.float32),
                          np.array([1000.0, 2000.0]),
                          np.array([0.1, 1.0]))}
    save_binned_cache("cafe", tables)
    for got in (load_binned_cache("cafe"), j_load("cafe")):
        np.testing.assert_array_equal(got["1H2-16O"][0],
                                      tables["1H2-16O"][0])
    assert not list(binned_cache_dir().glob("*.tmp*"))


def test_auto_engine_resolution(monkeypatch):
    """'auto' keeps the JAX package's meaning (the C++ host engine, the
    portable engine without a toolchain); the JAX names are refused with
    the counterpart named, "matmul" as left out of the port, and a typo
    never runs an engine silently."""
    assert etl.resolve_rebin_engine("eager") == "eager"
    assert etl.resolve_rebin_engine("cuda") == "cuda"
    assert etl.resolve_rebin_engine("native") == "native"
    if native_available():
        assert etl.resolve_rebin_engine("auto") == "native"
    import frei_tpu_torch.native as native_mod
    monkeypatch.setattr(native_mod, "native_available", lambda: False)
    assert etl.resolve_rebin_engine("auto") == "eager"
    with pytest.raises(ValueError, match="leaves out"):
        etl.resolve_rebin_engine("matmul")
    with pytest.raises(ValueError, match="counterpart here is 'eager'"):
        etl.resolve_rebin_engine("xla")
    with pytest.raises(ValueError, match="counterpart here is 'cuda'"):
        etl.resolve_rebin_engine("pallas")
    with pytest.raises(ValueError, match="unknown rebin engine"):
        etl.resolve_rebin_engine("natve")


def test_cuda_engine_needs_a_cuda_device(cache_env):
    """The "cuda" engine raises for a CPU device (and with no card), and
    never falls back to another engine."""
    store_dir = _store_dir(cache_env)
    etl.make_synthetic_store(store_dir / "1H2-16O__synthetic.ftop",
                             n_hr=2000)
    grid = make_rt_grid(n_wl_bins=16, n_layers=4)
    with pytest.raises(ValueError, match="needs a CUDA device"):
        etl.binned_opacity_tables(grid, engine="cuda", cache=False,
                                  device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="needs a CUDA device"):
            etl.binned_opacity_tables(grid, engine="cuda", cache=False)


def test_reload_preserves_chemistry():
    """Reloading opacities without naming a chemistry keeps the
    configured model; chemistry="mock" resets it."""
    from frei_tpu_torch import load_example_opacity
    from frei_tpu_torch.chemistry.mocks import MockChemistry

    grid = Grid(Planet.from_hot_jupiter(), n_wl_bins=16, n_layers=4,
                T_ref=2400.0, device="cpu")
    stack = load_example_opacity(grid)

    class MarkerChem:
        def mmr(self, temps, pressures_cgs):
            return torch.full((1,) + tuple(temps.shape), 1e-3,
                              dtype=temps.dtype)

    marker = MarkerChem()
    grid.load_opacities(opacities=stack, chemistry=marker)
    assert grid.chemistry is marker
    grid.load_opacities(opacities=stack)          # reload, no kwarg
    assert grid.chemistry is marker               # preserved
    grid.load_opacities(opacities=stack, chemistry="mock")
    assert isinstance(grid.chemistry, MockChemistry)


def test_reload_from_store_keeps_chemistry(cache_env):
    """``force_reload`` rebins from the store, keeping the chemistry."""
    make = jetl.make_synthetic_store
    make(cache_env / "1H2-16O__syn.ftop", n_hr=20_000)
    grid = Grid(Planet.from_hot_jupiter(), n_wl_bins=16, n_layers=4,
                T_ref=2400.0, dtype=torch.float64, device="cpu")
    first = grid.load_opacities(path=str(cache_env / "*.ftop"))
    chem = grid.chemistry
    again = grid.load_opacities(path=str(cache_env / "*.ftop"),
                                force_reload=True, engine="eager")
    assert grid.chemistry is chem
    assert again is not first
    torch.testing.assert_close(again.values, first.values, rtol=2e-6,
                               atol=0)


def _exact_rebin_oracle(st, grid):
    """Float64 numpy transcription of the reference's groupies=False
    path (`frei/opacity.py:150-170` with ``mapfunc_exact``, `:33-42`)."""
    edges = np.asarray(grid.wl_edges_cm, np.float64) / 1e-4
    lam = np.asarray(grid.lam_micron, np.float64)
    wav = np.asarray(st.wavelength_um, np.float64)
    ti = np.argmin(np.abs(st.temps[None, :]
                          - grid.init_temperatures[:, None]), axis=1)
    pi = np.argmin(np.abs(st.press_bar[None, :]
                          - grid.pressures_bar[:, None]), axis=1)
    sub = np.asarray(st.cube, np.float64)[np.ix_(ti, pi)]
    xs, ys = [], []
    for k in range(len(edges) - 1):
        m = (wav > edges[k]) & (wav <= edges[k + 1])
        if not m.any():
            continue
        w = wav[m]
        integral = np.trapezoid(sub[..., m], w, axis=-1)
        xs.append(w.mean())
        ys.append(integral / (w.max() - w.min()))
    xs = np.asarray(xs)
    ys = np.stack(ys, axis=-1)
    out = np.empty(ys.shape[:-1] + (len(lam),))
    for j, t in enumerate(lam):
        i = min(max(int(np.searchsorted(xs, t)) - 1, 0), len(xs) - 2)
        f = (t - xs[i]) / (xs[i + 1] - xs[i])
        out[..., j] = ys[..., i] * (1 - f) + ys[..., i + 1] * f
    return out


def test_exact_rebin_matches_transcription(cache_env):
    """groupies=False against the float64 oracle, including empty bins
    (filled by the linear resampling) and out-of-range bin centers
    (linear extrapolation)."""
    store_dir = _store_dir(cache_env)
    p = etl.make_synthetic_store(store_dir / "1H2-16O__synthetic.ftop",
                                 n_hr=60_000, lam_range_um=(0.8, 7.0))
    grid = make_rt_grid(n_wl_bins=48, n_layers=6, T_ref=2400.0)
    t = etl.binned_opacity_tables(grid, cache=False, groupies=False,
                                  engine="eager")
    np.testing.assert_allclose(t["1H2-16O"][0],
                               _exact_rebin_oracle(etl.OpacityStore(p),
                                                   grid),
                               rtol=5e-5, atol=1e-10)


def test_exact_vs_groupies_scaling(cache_env):
    """For a constant-opacity cube the exact path gives back the
    constant, while groupies gives width^2 x 1e-3 x constant."""
    store_dir = _store_dir(cache_env)
    p = etl.make_synthetic_store(store_dir / "1H2-16O__synthetic.ftop",
                                 n_hr=50_000)
    np.save(p / "cube.npy", np.full_like(np.asarray(
        etl.OpacityStore(p).cube), 3.5))
    grid = make_rt_grid(n_wl_bins=32, n_layers=4)
    t_exact = etl.binned_opacity_tables(grid, cache=False, groupies=False)
    np.testing.assert_allclose(t_exact["1H2-16O"][0], 3.5, rtol=1e-5)
    t_grp = etl.binned_opacity_tables(grid, cache=False, groupies=True)
    assert not np.allclose(t_grp["1H2-16O"][0], 3.5, rtol=1e-3)


@pytest.mark.parametrize("groupies", [True, False],
                         ids=["groupies", "exact"])
def test_grid_load_opacities_matches_jax(cache_env, monkeypatch, groupies):
    """The slice end to end: stores -> ``Grid.load_opacities(path=)`` ->
    solve, in both packages (float64): the binned stacks at rtol 2e-6,
    the spectra at rtol 1e-6 (the tables' float32 rounding is shared,
    the solve is the same arithmetic)."""
    jetl.make_synthetic_store(cache_env / "1H2-16O__syn.ftop",
                              isotopologue="1H2-16O", n_hr=30_000)
    jetl.make_synthetic_store(cache_env / "23Na__syn.ftop",
                              isotopologue="23Na", n_hr=30_000, seed=9)
    path = str(cache_env / "*.ftop")
    jg = frei_tpu.Grid(frei_tpu.Planet.from_hot_jupiter(), n_wl_bins=32,
                       n_layers=6, T_ref=2400.0, dtype=jnp.float64)
    tg = Grid(Planet.from_hot_jupiter(), n_wl_bins=32, n_layers=6,
              T_ref=2400.0, dtype=torch.float64, device="cpu")
    js = jg.load_opacities(species=["H2O", "Na"], path=path,
                           groupies=groupies, engine="xla")
    monkeypatch.setenv("FREI_TPU_CACHE", str(cache_env / "cache-port"))
    ts = tg.load_opacities(species=["H2O", "Na"], path=path,
                           groupies=groupies, engine="eager")
    assert ts.species == js.species == ("1H2-16O", "23Na")
    np.testing.assert_allclose(ts.values.numpy(), np.asarray(js.values),
                               rtol=2e-6, atol=0)
    want = jg.emission_spectrum(n_timesteps=1)
    got = tg.emission_spectrum(n_timesteps=1)
    assert np.all(np.isfinite(got[0].flux_cgs))
    np.testing.assert_allclose(got[0].flux_cgs, want[0].flux_cgs,
                               rtol=1e-6)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-6)


def test_grid_load_opacities_species_filter(cache_env):
    make = etl.make_synthetic_store
    make(cache_env / "1H2-16O__syn.ftop", n_hr=30_000)
    make(cache_env / "23Na__syn.ftop", isotopologue="23Na", n_hr=30_000,
         seed=9)
    grid = Grid(Planet.from_hot_jupiter(), n_wl_bins=32, n_layers=6,
                T_ref=2400.0, dtype=torch.float64, device="cpu")
    stack = grid.load_opacities(species=["H2O"],
                                path=str(cache_env / "*.ftop"))
    assert stack.species == ("1H2-16O",)       # species filter applied
    assert stack.values.dtype == torch.float64
    assert hasattr(grid._kappa_fn, "iteration_hook")
    spec, *_ = grid.emission_spectrum(n_timesteps=1)
    assert np.all(np.isfinite(spec.flux_cgs))
    spec, *_ = grid.emission_spectra(
        np.asarray(grid.init_temperatures)[None, :], engine="loop")
    assert np.all(np.isfinite(spec.flux_cgs))


def test_emission_before_load_raises():
    grid = Grid(Planet.from_hot_jupiter(), n_wl_bins=16, n_layers=4,
                device="cpu")
    with pytest.raises(ValueError, match="load opacities"):
        grid.emission_spectrum()
    with pytest.raises(ValueError, match="load opacities"):
        grid.emission_spectra(np.zeros((2, 4)))


@pytest.mark.parametrize("entry", ["netcdf", "molecule", "atom"])
def test_optional_packages_refused_cleanly(cache_env, monkeypatch, entry):
    """The netCDF import needs xarray and the downloads the `dace`
    client; without them each raises ImportError naming the package
    before touching a file or the network."""
    import sys
    for mod in ("xarray", "dace_query", "dace_query.opacity", "dace",
                "dace.opacity"):
        monkeypatch.setitem(sys.modules, mod, None)
    monkeypatch.chdir(cache_env)
    call, match = {
        "netcdf": (lambda: etl.netcdf_to_store(
            cache_env / "1H2-16O__POKAZATEL.nc", cache_env / "o.ftop"),
            "xarray"),
        "molecule": (lambda: etl.download_molecule("1H2-16O", "POKAZATEL"),
                     "dace"),
        "atom": (lambda: etl.download_atom("Na", 0, "Kurucz"), "dace"),
    }[entry]
    with pytest.raises(ImportError, match=match):
        call()
    assert not (cache_env / "tmp").exists()
    assert not (cache_env / "o.ftop").exists()
