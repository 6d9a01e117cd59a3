"""Equilibrium chemistry of frei_tpu_torch against frei_tpu.

Mirrors ``tests/test_fastchem.py`` (the reference's maximum-VMR goldens
for H2O / Na / K / TiO at rtol 0.1, conservation, the committed
regression profile, convergence), the chemistry parts of
``tests/test_hotpath.py`` and ``tests/test_sweep_pallas.py``, and holds
the port against the JAX package on the same inputs:

* ``equilibrium_log_pressures`` on the reference's 100-point profile:
  the opacity species' VMRs at rtol 1e-8 (the two solvers sum each
  element's conservation over the same species in another order);
* the float32 ln-VMR table at ``grid_shape=(8, 6)`` at rtol 1e-6, and
  its layer-factored form at rtol 1e-6;
* ``layer_mmr_interp`` against ``mmr`` (rtol 1e-5: float32 rounding of
  two interpolation orders, as the JAX test holds them);
* table lookups against the JAX package's at rtol 1e-4: they take log10
  T and log10 P in float32, where the two libraries' log10 differ by an
  ulp (4.8e-7) at some points, and the ln VMR of the coarse (8, 6) table
  moves by up to ~60 per unit of log10 T;
* ``chemistry()`` at rtol 1e-8;
* an eager solve on equilibrium chemistry against the JAX "xla" engine,
  and the whole-iteration twins against the eager engine, at the JAX
  tests' tolerances for float32 chemistry in a float64 solve (flux rtol
  1e-4, temperatures 1e-5, `tests/test_sweep_pallas.py:375-391`).

Slow where the JAX package's own tests are slow.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from frei_tpu import Grid as JGrid  # noqa: E402
from frei_tpu import Planet as JPlanet  # noqa: E402
from frei_tpu import load_example_opacity as j_fixture  # noqa: E402
from frei_tpu import make_opacity_stack as j_stack  # noqa: E402
from frei_tpu.chemistry import fastchem as J  # noqa: E402
from frei_tpu.rt.solver import SolverConfig as JConfig  # noqa: E402
from frei_tpu.rt.solver import solve_rc_batched as j_solve  # noqa: E402
from frei_tpu_torch import Grid, Planet, make_opacity_stack  # noqa: E402
from frei_tpu_torch.chemistry import fastchem as F  # noqa: E402
from frei_tpu_torch.constants import BAR_TO_CGS  # noqa: E402
from frei_tpu_torch.opacity import hotpath  # noqa: E402
from frei_tpu_torch.rt.solver import SolverConfig, solve_rc_batched  # noqa: E402

torch.set_num_threads(2)

# the reference's test profile (`test_chemistry.py:12-13`)
P_BAR = np.logspace(-6, 2, 100)
T_K = 2400.0 * (P_BAR / 0.1) ** 0.1
GOLDEN_MAX_VMR = {"H2O1": 3e-4, "Na": 3e-6, "K": 1.8e-7, "O1Ti1": 1.4e-7}
M_BAR = 2.4 * 1.67262192369e-24
SPECIES = ("1H2-16O", "23Na", "48Ti-16O")
TESTS = Path(__file__).resolve().parent


@pytest.fixture(scope="module")
def profile_solution():
    table = F.load_chem_table()
    ln_p, z = F.equilibrium_log_pressures(table, torch.tensor(T_K),
                                          torch.tensor(P_BAR))
    return table, ln_p.numpy(), z.numpy()


@pytest.fixture(scope="module")
def tables():
    """The three species' (8, 6) tables, built by both packages."""
    return (J.FastChemJAX(SPECIES, M_BAR, grid_shape=(8, 6)),
            F.FastChemTorch(SPECIES, M_BAR, grid_shape=(8, 6),
                             build_device="cpu"))


def test_chem_table_copy_is_the_jax_package_file():
    """The port reads its own copy of the thermochemical tables, byte for
    byte the JAX package's."""
    ours = Path(F.__file__).parent / "data" / "chem_tables.npz"
    theirs = TESTS.parent / "frei_tpu" / "chemistry" / "data" / \
        "chem_tables.npz"
    assert ours.read_bytes() == theirs.read_bytes()
    assert F._DATA == ours


@pytest.mark.parametrize("hill,want", sorted(GOLDEN_MAX_VMR.items()))
def test_golden_max_abundances(profile_solution, hill, want):
    table, ln_p, _ = profile_solution
    i = table.species_index(hill)
    assert i != F.UNKNOWN_SPECIES
    vmr = np.exp(ln_p[:, i]) / P_BAR
    np.testing.assert_allclose(vmr.max(), want, rtol=0.1)


def test_conservation_and_pressure(profile_solution):
    """Mass action, element conservation, charge balance and the pressure
    closure hold at every profile point."""
    table, ln_p, z = profile_solution
    E = table.n_elements
    p = np.exp(ln_p)
    np.testing.assert_allclose(p.sum(axis=1), P_BAR, rtol=1e-8)
    nu = np.asarray(table.stoich)
    eps = np.asarray(table.abundances)
    M = np.exp(z[:, E])
    lhs = p[:, :E] + p[:, E:] @ nu
    rhs = eps[None, :] * M[:, None]
    ok = eps > 0
    np.testing.assert_allclose(lhs[:, ok], rhs[:, ok], rtol=1e-6)
    ie = E - 1
    charge = p[:, ie] + p[:, E:] @ nu[:, ie]
    ion_scale = np.abs(p[:, E:]) @ np.abs(nu[:, ie])
    assert np.all(np.abs(charge) <= 1e-6 * np.maximum(ion_scale, 1e-300))


def test_h2_dominates_at_depth(profile_solution):
    table, ln_p, _ = profile_solution
    iH2 = table.species_index("H2")
    iH = table.species_index("H")
    assert np.exp(ln_p[0, iH2]) / P_BAR[0] > 0.4
    assert np.exp(ln_p[0, iH]) < np.exp(ln_p[0, iH2]) * 1e-3


def test_golden_vmr_profiles(profile_solution):
    """Point-wise log10 VMRs of 14 species against the committed
    regression table (``tests/data/chem_profile_golden.npz``), 5e-4 in
    log10 as the JAX test holds them."""
    table, ln_p, _ = profile_solution
    d = np.load(TESTS / "data" / "chem_profile_golden.npz")
    idx = [table.species_index(str(h)) for h in d["species"]]
    assert all(i >= 0 for i in idx)
    got = (ln_p[:, idx] - np.log(P_BAR)[:, None]) / np.log(10.0)
    np.testing.assert_allclose(got, d["log10_vmr"], atol=5e-4)


def test_profile_matches_jax(profile_solution):
    """The whole 100-point solve against the JAX solver: the opacity
    species' VMRs at rtol 1e-8, every log pressure within 1e-9."""
    table, ln_p, z = profile_solution
    ref_p, ref_z = J.equilibrium_log_pressures(
        J.load_chem_table(), jnp.asarray(T_K), jnp.asarray(P_BAR))
    ref_p = np.asarray(ref_p)
    for hill in ("H2O1", "Na", "K", "O1Ti1", "H2", "C1O1", "C1H4"):
        i = table.species_index(hill)
        np.testing.assert_allclose(np.exp(ln_p[:, i]) / P_BAR,
                                   np.exp(ref_p[:, i]) / P_BAR, rtol=1e-8,
                                   err_msg=hill)
    np.testing.assert_allclose(ln_p, ref_p, rtol=0, atol=1e-9)
    np.testing.assert_allclose(z, np.asarray(ref_z), rtol=0, atol=1e-9)


def test_residual_history_convergence():
    """The Gauss-Seidel residual history falls, and its last value is
    tight."""
    _, _, r = F.equilibrium_log_pressures(
        F.load_chem_table(), torch.tensor(T_K[::7]),
        torch.tensor(P_BAR[::7]), return_residuals=True)
    r = r.numpy()
    assert r.shape == (60,)
    assert r[-1] < 1e-8, r[-1]
    assert r[-1] < r[0] * 1e-6


def test_table_builds_on_the_card_by_default():
    """The table is solved on the card unless the caller names another
    device: without CUDA the default raises and names the CPU."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default builds on the card")
    with pytest.raises(RuntimeError, match='build_device="cpu"'):
        F.FastChemTorch(["1H2-16O"], M_BAR, grid_shape=(4, 3))


def test_unknown_species_raises():
    with pytest.raises(ValueError, match="not in chemistry tables"):
        F.FastChemTorch(["Xx9"], 1.0, mode="exact")
    with pytest.raises(ValueError, match="unknown chemistry mode"):
        F.FastChemTorch(["1H2-16O"], 1.0, mode="fast")


def test_table_matches_jax(tables):
    """The float32 ln-VMR table and its axes at grid_shape (8, 6), and
    the build's convergence telemetry, against the JAX build."""
    jc, tc = tables
    np.testing.assert_allclose(tc._tab_lnvmr.numpy(),
                               np.asarray(jc._tab_lnvmr), rtol=1e-6)
    np.testing.assert_array_equal(tc._tab_logT.numpy(),
                                  np.asarray(jc._tab_logT))
    np.testing.assert_array_equal(tc._tab_logP.numpy(),
                                  np.asarray(jc._tab_logP))
    assert tc._tab_lnvmr.dtype == torch.float32
    assert tc.table_residual < 1e-6
    assert tc.table_residual == pytest.approx(jc.table_residual, rel=1e-3)


def _layer_temps(L=30, seed=7):
    """In-range, below-range and above-range (B, L) temperatures."""
    rng = np.random.RandomState(seed)
    return np.concatenate([rng.uniform(900.0, 4800.0, (6, L)),
                           np.full((1, L), 150.0), np.full((1, L), 9000.0)])


def test_vmr_from_table_matches_jax(tables):
    """Table-mode VMRs and MMRs at (B, L) points, clamped outside the
    table, against the JAX model's."""
    jc, tc = tables
    T = _layer_temps()
    P = np.logspace(-6, 2, 30) * BAR_TO_CGS
    got = tc.mmr(torch.tensor(T, dtype=torch.float32),
                 torch.tensor(P, dtype=torch.float32))
    ref = jc.mmr(jnp.asarray(T, jnp.float32), jnp.asarray(P, jnp.float32))
    assert got.shape == (3, 8, 30) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4)


def test_layer_tables_match_jax(tables):
    """``layer_ln_mmr_tables``: the (L, nTc, S) float32 ln-MMR table on
    the layer pressures, as the whole-iteration kernels read it."""
    jc, tc = tables
    press = np.logspace(-6, 2, 30) * BAR_TO_CGS
    jg, jt = jc.layer_ln_mmr_tables(jnp.asarray(press, jnp.float32))
    tg, tt = tc.layer_ln_mmr_tables(torch.tensor(press, dtype=torch.float32))
    assert tuple(tt.shape) == (30, 8, 3) and tt.dtype == torch.float32
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_layer_mmr_interp_matches_generic_path(tables, dtype):
    """The hot-loop evaluator (P interpolation hoisted, clipped 1-D log T
    interpolation) equals ``mmr(T, P)`` to float32 rounding, for batched
    and out-of-range temperatures, and the JAX evaluator; exact mode has
    none."""
    jc, tc = tables
    dt = getattr(torch, dtype)
    press = np.logspace(-6, 2, 30) * BAR_TO_CGS
    T = _layer_temps()
    fn = tc.layer_mmr_interp(torch.tensor(press, dtype=torch.float32))
    got = fn(torch.tensor(T, dtype=dt))
    assert got.dtype == dt and got.shape == (3, 8, 30)
    want = tc.mmr(torch.tensor(T, dtype=dt),
                  torch.tensor(press, dtype=torch.float32)[None].expand(8, -1))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5)
    ref = jc.layer_mmr_interp(jnp.asarray(press, jnp.float32))(
        jnp.asarray(T, getattr(jnp, dtype)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4)
    with pytest.raises(AttributeError, match="table mode"):
        F.FastChemTorch(SPECIES, M_BAR, mode="exact").layer_mmr_interp(press)


@pytest.mark.parametrize("mode", ["exact", "mock"])
def test_chemistry_entry_point_matches_jax(mode):
    """``chemistry()`` on eight profile points: MMRs and VMRs per
    isotopologue against the JAX entry point."""
    from frei_tpu.chemistry import chemistry as j_chemistry
    from frei_tpu_torch.chemistry import chemistry
    T, P = T_K[::13], P_BAR[::13]
    mmr, vmr = chemistry(T, P, SPECIES, return_vmr=True, mode=mode,
                         device="cpu")
    j_mmr, j_vmr = j_chemistry(T, P, SPECIES, return_vmr=True, mode=mode)
    assert set(mmr) == set(SPECIES)
    for s in SPECIES:
        np.testing.assert_allclose(vmr[s], np.asarray(j_vmr[s]), rtol=1e-8)
        np.testing.assert_allclose(mmr[s], np.asarray(j_mmr[s]), rtol=1e-8)
    assert set(chemistry(T, P, SPECIES[:1], mode=mode,
                         device="cpu")) == {SPECIES[0]}


def test_hot_loop_mmr_fn_dispatch():
    """An explicit capability dispatch: the generic path for an mmr-only
    model, a loud failure for a broken ``layer_mmr_interp``, and the
    generic path (no call to the factored one) for exact mode."""
    press = torch.tensor(np.logspace(-3, 2, 5))

    class Custom:
        def mmr(self, temps, pressures_cgs):
            return torch.ones((2,) + temps.shape)

    assert F.hot_loop_mmr_fn(Custom(), press)(
        torch.ones((3, 5))).shape == (2, 3, 5)

    class Broken:
        def mmr(self, temps, pressures_cgs):
            return temps

        def layer_mmr_interp(self, pressures_cgs):
            raise AttributeError("typo'd internal attribute")

    with pytest.raises(AttributeError, match="typo"):
        F.hot_loop_mmr_fn(Broken(), press)
    exact = F.FastChemTorch(["1H2-16O"], M_BAR, mode="exact")
    assert not exact.supports_layer_factoring()
    F.hot_loop_mmr_fn(exact, press)


# --------------------------------------------------------------------------
# The chemistry in the solve (tests/test_hotpath.py, test_sweep_pallas.py)
# --------------------------------------------------------------------------

W, L = 16, 5


@pytest.fixture(scope="module")
def grids(tables):
    """A three-species stack (the fixture's H2O table, scaled for Na and
    TiO) on a 16-bin, 5-layer grid with the (8, 6) equilibrium tables, in
    both packages, float64."""
    jc, tc = tables
    jg = JGrid(JPlanet.from_hot_jupiter(), n_wl_bins=W, n_layers=L,
               T_ref=2400.0, dtype=jnp.float64)
    s = j_fixture(jg, scale_factor=1.0, dtype=jnp.float64)
    v = np.asarray(s.values[0])
    T_ax, P_ax = np.asarray(s.temps), np.asarray(s.press_cgs) / BAR_TO_CGS
    data = {iso: (v * k, T_ax, P_ax) for iso, k in zip(SPECIES,
                                                       (1.0, 30.0, 300.0))}
    jg.load_opacities(opacities=j_stack(data, dtype=jnp.float64),
                      chemistry=jc)
    tg = Grid(Planet.from_hot_jupiter(), n_wl_bins=W, n_layers=L,
              T_ref=2400.0, dtype=torch.float64, device="cpu")
    tg.load_opacities(opacities=make_opacity_stack(data, dtype=torch.float64,
                                                   device="cpu"),
                      chemistry=tc)
    rng = np.random.RandomState(1)
    T0 = np.asarray(jg.init_temperatures)[None, :] * rng.uniform(
        0.95, 1.05, (3, 1))
    return jg, tg, T0


def test_grid_kappa_model_advertises_hooks(grids):
    """The κ model of a grid on equilibrium chemistry carries both hooks:
    the fused sweeps' weight rows and tables, and the whole-iteration
    kernels' (temperature grid, tables, chemistry) with the model's own
    64-point-style log T grid (here 8 points)."""
    _, tg, _ = grids
    k = tg._kappa_fn
    ohs_fn, tab = k.layer_parts
    assert tab.ndim == 3
    t_grid, tab2, chem = k.iteration_hook
    assert tab2 is tab and chem is tg.chemistry
    c_grid, c_tab = chem.layer_ln_mmr_tables(tg._consts.pressures)
    assert c_grid.shape == (8,) and tuple(c_tab.shape) == (L, 8, 3)
    T = torch.full((2, L), 2000.0, dtype=torch.float64)
    assert torch.isfinite(ohs_fn(T)).all()


def test_equilibrium_grid_uses_layer_factored_chemistry(grids):
    """Table-mode chemistry reaches the hot loop through the layer-factored
    evaluator: the κ model equals the layer tables contracted with
    ``layer_mmr_interp``'s mixing ratios."""
    from frei_tpu_torch.opacity.tables import (kappa_from_layer_tables,
                                               make_layer_tables)
    _, tg, T0 = grids
    chem, c = tg.chemistry, tg._consts
    assert isinstance(chem, F.FastChemTorch) and chem.supports_layer_factoring()
    T = torch.tensor(T0)
    lt = make_layer_tables(tg.opacities, c.pressures)
    want, _ = kappa_from_layer_tables(
        lt, chem.layer_mmr_interp(c.pressures)(T), T, c.sigma_scat)
    assert torch.equal(tg._kappa_fn(T, c.pressures), want)


def test_exact_mode_chemistry_gets_no_iteration_hook(grids):
    """Exact mode has no ``layer_ln_mmr_tables``: ``build_kappa_model``
    leaves the iteration hook unset, the fused sweeps keep theirs, and the
    whole-iteration engines refuse with their guard."""
    _, tg, T0 = grids
    chem = F.FastChemTorch(SPECIES, M_BAR, mode="exact")
    k = hotpath.build_kappa_model(tg.opacities, chem, tg._consts.pressures,
                                  tg._consts.sigma_scat)
    assert k.iteration_hook is None and k.layer_parts is not None
    with pytest.raises(ValueError, match="layer-factored"):
        solve_rc_batched(torch.tensor(T0[:1]), tg._consts,
                         tg.planet.physics_params(), k,
                         SolverConfig(engine="loop", n_timesteps=1))


def test_single_T_point_stack_falls_back(grids):
    """A one-temperature stack has nothing to factor: the generic lookup,
    with the chemistry's ``mmr``, and no hooks."""
    _, tg, _ = grids
    s = tg.opacities
    one_t = s._replace(values=s.values[:, :1], temps=s.temps[:1])
    k = hotpath.build_kappa_model(one_t, tg.chemistry, tg._consts.pressures,
                                  tg._consts.sigma_scat)
    assert not hasattr(k, "layer_parts")
    out = k(torch.full((L,), 2000.0, dtype=torch.float64),
            tg._consts.pressures)
    assert torch.isfinite(out).all()


def test_eager_solve_on_equilibrium_matches_xla(grids):
    """Three iterations on the equilibrium tables: the eager engine
    against the JAX "xla" engine (the layer-factored mixing ratios are
    float32 in both packages, from float32 log10 T that may differ by an
    ulp: flux rtol 1e-4, temperatures 1e-5), and κ that varies across
    layers (live chemistry, not a constant)."""
    jg, tg, T0 = grids
    ref = j_solve(jnp.asarray(T0), jg._consts, jg.planet.physics_params(),
                  jg._kappa_fn, JConfig(n_timesteps=3, engine="xla"))
    got = solve_rc_batched(torch.tensor(T0), tg._consts,
                           tg.planet.physics_params(), tg._kappa_fn,
                           SolverConfig(n_timesteps=3, engine="eager"))
    np.testing.assert_allclose(got.flux.numpy(), np.asarray(ref.flux),
                               rtol=1e-4)
    np.testing.assert_allclose(got.final_temps.numpy(),
                               np.asarray(ref.final_temps), rtol=1e-5)
    np.testing.assert_array_equal(got.n_iterations.numpy(),
                                  np.asarray(ref.n_iterations))
    col = tg._kappa_fn(torch.tensor(T0), tg._consts.pressures)[0, :, W // 2]
    assert float(np.ptp(col.numpy() / col.mean().item())) > 1e-3


@pytest.mark.parametrize("engine", ["iteration", "loop"])
def test_whole_iteration_twins_on_equilibrium_tables(grids, engine):
    """The ``"iteration"`` and ``"loop"`` engines (their kernels' plain
    twins on the CPU) on the equilibrium tables, three species on 8 log T
    points, against the eager engine at the JAX tests' tolerances (flux
    rtol 1e-4, temperatures 1e-5: the twins interpolate the float32
    ln-MMR tables at the solve's precision)."""
    _, tg, T0 = grids
    args = (tg._consts, tg.planet.physics_params(), tg._kappa_fn)
    ref = solve_rc_batched(torch.tensor(T0), *args,
                           SolverConfig(n_timesteps=3, engine="eager"))
    got = solve_rc_batched(torch.tensor(T0), *args,
                           SolverConfig(n_timesteps=3, engine=engine))
    np.testing.assert_allclose(got.flux.numpy(), ref.flux.numpy(), rtol=1e-4)
    np.testing.assert_allclose(got.final_temps.numpy(),
                               ref.final_temps.numpy(), rtol=1e-5)
    assert torch.isfinite(got.flux).all()


def test_to_spectrum1d_needs_specutils(grids):
    """``Spectrum.to_spectrum1d`` builds a ``specutils.Spectrum1D`` where
    specutils is installed; without it the import error names
    specutils."""
    from frei_tpu_torch import Spectrum
    spec = Spectrum(wavelength_um=np.linspace(1.0, 2.0, 4),
                    flux_cgs=np.arange(4.0))
    try:
        import specutils  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError, match="specutils"):
            spec.to_spectrum1d()
        return
    s1d = spec.to_spectrum1d()
    np.testing.assert_allclose(np.asarray(s1d.flux.value), spec.flux_cgs)
    np.testing.assert_allclose(np.asarray(s1d.spectral_axis.value),
                               spec.wavelength_um)


# --------------------------------------------------------------------------
# Slow lane: where the JAX package's own tests are slow
# --------------------------------------------------------------------------

@pytest.mark.slow
def test_warm_start_converges_faster():
    table = F.load_chem_table()
    T, P = torch.tensor(T_K[:10]), torch.tensor(P_BAR[:10])
    _, z = F.equilibrium_log_pressures(table, T, P)
    ln_p2, _ = F.equilibrium_log_pressures(table, T * 1.01, P, x0=z,
                                           n_sweeps=16)
    ln_p3, _ = F.equilibrium_log_pressures(table, T * 1.01, P, n_sweeps=60)
    np.testing.assert_allclose(ln_p2.numpy(), ln_p3.numpy(), rtol=1e-3,
                               atol=2e-2)


@pytest.mark.slow
def test_fastchem_model_table_vs_exact():
    """Table mode at the default 64 x 32 grid reproduces the exact solver
    within interpolation error on the in-range profile."""
    species = ["1H2-16O", "Na", "K", "48Ti-16O"]
    exact = F.FastChemTorch(species, M_BAR, mode="exact")
    tab = F.FastChemTorch(species, M_BAR, mode="table", build_device="cpu")
    P_cgs = torch.tensor(P_BAR * BAR_TO_CGS)
    T = torch.tensor(T_K)
    np.testing.assert_allclose(tab.vmr(T, P_cgs).numpy(),
                               exact.vmr(T, P_cgs).numpy(), rtol=0.05)


@pytest.mark.slow
def test_layer_mmr_interp_on_a_16x8_table():
    """``tests/test_fastchem.py``'s own case: a (16, 8) table, three
    species, in- and out-of-range float32 temperatures."""
    chem = F.FastChemTorch(["1H2-16O", "Na", "K"], M_BAR, grid_shape=(16, 8),
                           build_device="cpu")
    press = torch.tensor(np.logspace(-6, 2, 30) * BAR_TO_CGS,
                         dtype=torch.float32)
    T = torch.tensor(_layer_temps(), dtype=torch.float32)
    got = chem.layer_mmr_interp(press)(T)
    want = chem.mmr(T, press[None, :].expand(8, -1))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5)


@pytest.mark.slow
def test_table_mode_reports_convergence():
    chem = F.FastChemTorch(["1H2-16O"], M_BAR, grid_shape=(12, 8),
                           build_device="cpu")
    assert chem.table_residual < 1e-6


@pytest.mark.slow
def test_exact_mode_warm_start_hot_loop():
    """The exact-mode hot-loop pattern: the warm-start state threaded
    through RC-like steps of ~10 K each, 16 sweeps tracking the 60-sweep
    cold solve."""
    species = ["1H2-16O", "Na", "K"]
    chem = F.FastChemTorch(species, M_BAR, mode="exact")
    P_cgs = torch.tensor(P_BAR[::11] * BAR_TO_CGS)
    T = torch.tensor(T_K[::11])
    _, z, _ = chem.vmr_with_state(T, P_cgs)
    for _ in range(3):
        T = T * 1.004
        v_warm, z, r = chem.vmr_with_state(T, P_cgs, z0=z, n_sweeps=16)
        np.testing.assert_allclose(v_warm.numpy(),
                                   chem.vmr(T, P_cgs).numpy(), rtol=1e-3)
        assert float(r[-1]) < 1e-7
    with pytest.raises(AttributeError):
        F.FastChemTorch(["1H2-16O"], M_BAR, grid_shape=(8, 6),
                        build_device="cpu").vmr_with_state(T, P_cgs)


@pytest.mark.slow
def test_equilibrium_chemistry_with_cuda_engine_twins():
    """``tests/test_sweep_pallas.py:320-346``: ``Grid.load_opacities(
    chemistry="equilibrium")`` at the default 64 x 32 table, the eager
    engine against the ``"iteration"`` and ``"loop"`` twins, and κ that
    varies across layers."""
    grid = Grid(Planet.from_hot_jupiter(), n_wl_bins=32, n_layers=8,
                T_ref=2400.0, dtype=torch.float64, device="cpu")
    from frei_tpu_torch import load_example_opacity
    grid.load_opacities(opacities=load_example_opacity(
        grid, scale_factor=1.0, dtype=torch.float64),
        chemistry="equilibrium")
    assert isinstance(grid.chemistry, F.FastChemTorch)
    assert grid.chemistry._tab_lnvmr.shape == (64, 32, 1)
    rng = np.random.RandomState(1)
    T0 = torch.tensor(np.asarray(grid.init_temperatures)[None, :]
                      * rng.uniform(0.95, 1.05, (3, 1)))
    args = (grid._consts, grid.planet.physics_params(), grid._kappa_fn)
    rx = solve_rc_batched(T0, *args, SolverConfig(3, engine="eager"))
    for engine in ("iteration", "loop"):
        rp = solve_rc_batched(T0, *args, SolverConfig(3, engine=engine))
        np.testing.assert_allclose(rp.flux.numpy(), rx.flux.numpy(),
                                   rtol=1e-4, err_msg=engine)
        np.testing.assert_allclose(rp.final_temps.numpy(),
                                   rx.final_temps.numpy(), rtol=1e-5,
                                   err_msg=engine)
    k = grid._kappa_fn(T0, grid._consts.pressures).numpy()[0, :, 16]
    assert np.ptp(k / k.mean()) > 1e-3


@pytest.mark.slow
def test_multispecies_pipeline_with_whole_iteration_twins(tmp_path,
                                                          monkeypatch):
    """``tests/test_sweep_pallas.py:349-392``: three synthetic stores ->
    the rebin -> stacked tables -> equilibrium chemistry -> the eager
    engine against the ``"iteration"`` and ``"loop"`` twins, and against
    the JAX package's "xla" engine on its own build of the same stores."""
    from frei_tpu.opacity import binned_opacity_stack as j_binned
    from frei_tpu_torch.opacity.etl import (binned_opacity_stack,
                                            make_synthetic_store)
    monkeypatch.setenv("FREI_TPU_CACHE", str(tmp_path / "cache"))
    for iso, seed in [("1H2-16O", 7), ("23Na", 8), ("48Ti-16O", 9)]:
        make_synthetic_store(tmp_path / f"{iso}__syn.ftop",
                             isotopologue=iso, n_hr=40_000, seed=seed)
    grid = Grid(Planet.from_hot_jupiter(), n_wl_bins=40, n_layers=8,
                T_ref=2400.0, dtype=torch.float64, device="cpu")
    stack = binned_opacity_stack(grid.rt_grid, path=str(tmp_path / "*.ftop"),
                                 cache=False, dtype=torch.float64,
                                 device="cpu")
    assert stack.values.shape[0] == 3
    grid.load_opacities(opacities=stack, chemistry="equilibrium")
    rng = np.random.RandomState(2)
    T0 = np.asarray(grid.init_temperatures)[None, :] * rng.uniform(
        0.95, 1.05, (4, 1))
    args = (grid._consts, grid.planet.physics_params(), grid._kappa_fn)
    rx = solve_rc_batched(torch.tensor(T0), *args,
                          SolverConfig(3, engine="eager"))
    for engine in ("iteration", "loop"):
        rp = solve_rc_batched(torch.tensor(T0), *args,
                              SolverConfig(3, engine=engine))
        np.testing.assert_allclose(rp.flux.numpy(), rx.flux.numpy(),
                                   rtol=1e-4, err_msg=engine)
        np.testing.assert_allclose(rp.final_temps.numpy(),
                                   rx.final_temps.numpy(), rtol=1e-5,
                                   err_msg=engine)
    jg = JGrid(JPlanet.from_hot_jupiter(), n_wl_bins=40, n_layers=8,
               T_ref=2400.0, dtype=jnp.float64)
    jg.load_opacities(opacities=j_binned(jg.rt_grid,
                                         path=str(tmp_path / "*.ftop"),
                                         cache=False, dtype=jnp.float64),
                      chemistry="equilibrium")
    ref = j_solve(jnp.asarray(T0), jg._consts, jg.planet.physics_params(),
                  jg._kappa_fn, JConfig(n_timesteps=3, engine="xla"))
    np.testing.assert_allclose(rx.flux.numpy(), np.asarray(ref.flux),
                               rtol=1e-4)
    assert np.all(np.isfinite(rx.flux.numpy()))
