"""Opacity tables, mock chemistry and the hot-loop kappa model of
frei_tpu_torch against frei_tpu (float64).  Table values and weights
are the same arithmetic and are held bit-identically or at rtol 1e-14;
contractions at rtol 1e-12 (summation order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import frei_tpu.opacity.tables as jtab
from frei_tpu import Grid as JGrid
from frei_tpu import Planet as JPlanet
from frei_tpu.chemistry.mocks import MockChemistry as JMock
from frei_tpu.opacity.hotpath import build_kappa_model as j_build
from frei_tpu_torch import Grid, Planet
from frei_tpu_torch import load_example_opacity
from frei_tpu_torch.chemistry.mocks import MockChemistry
from frei_tpu_torch.io import convert
from frei_tpu_torch.opacity import tables as ttab
from frei_tpu_torch.opacity.hotpath import build_kappa_model

torch.set_num_threads(2)
L, W = 9, 40


@pytest.fixture(scope="module")
def grids():
    jg = JGrid(JPlanet.from_hot_jupiter(), n_wl_bins=W, n_layers=L,
               T_ref=2400.0, dtype=jnp.float64)
    tg = Grid(Planet.from_hot_jupiter(), n_wl_bins=W, n_layers=L,
              T_ref=2400.0, dtype=torch.float64, device="cpu")
    return jg, tg


def test_example_fixture_identical(grids):
    jg, tg = grids
    for scale in (1.0, 20.0):
        a = jtab.load_example_opacity(jg, scale_factor=scale,
                                      dtype=jnp.float64)
        b = load_example_opacity(tg, scale_factor=scale,
                                 dtype=torch.float64)
        assert a.species == b.species
        np.testing.assert_array_equal(a.masses_g, b.masses_g)
        for f in ("values", "temps", "press_cgs"):
            np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                          getattr(b, f).numpy())
    # the converter carries the JAX stack over unchanged
    c = convert.to_opacity_stack(a)
    np.testing.assert_array_equal(c.values.numpy(), b.values.numpy())


def _tables():
    """A two-species stack with distinct T and P dependence, given
    with descending axes and a duplicate coordinate."""
    rng = np.random.RandomState(1)
    T = np.array([3000.0, 2000.0, 1000.0, 2000.0, 500.0])
    P = np.array([1e-5, 1e-3, 1e-1, 10.0])
    return {"1H2-16O": (rng.rand(5, 4, W) + 0.1, T, P),
            "23Na": (rng.rand(5, 4, W) * 3, T, P)}


def test_stack_interp_and_layer_tables():
    jst = jtab.make_opacity_stack(_tables(), dtype=jnp.float64)
    tst = ttab.make_opacity_stack(_tables(), dtype=torch.float64,
                                  device="cpu")
    np.testing.assert_array_equal(np.asarray(jst.values), tst.values.numpy())
    np.testing.assert_array_equal(np.asarray(jst.temps), tst.temps.numpy())
    rng = np.random.RandomState(2)
    # points inside, exactly on both hull edges, one ULP outside within
    # the 8-ULP tolerance, and far outside (zero-filled)
    T = np.concatenate([rng.uniform(500, 3000, 20),
                        [500.0, 3000.0, np.nextafter(3000.0, 4e3),
                         np.nextafter(500.0, 0.0), 100.0, 9000.0]])
    P = np.concatenate([10.0 ** rng.uniform(0, 7, 20),
                        [1e1, 1e7, 1e5, 1e7, 1e3, 1e3]])
    jtab.set_interp_mode("gather")
    try:
        a = jtab.interp_tp(jst, jnp.asarray(T), jnp.asarray(P))
    finally:
        jtab.set_interp_mode(None)
    b = ttab.interp_tp(tst, torch.tensor(T), torch.tensor(P))
    np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-14)
    assert (b[:, -2:] == 0).all() and (b[:, 20:24] != 0).all()

    pressures = np.logspace(7, 1, L)
    jlt = jtab.make_layer_tables(jst, jnp.asarray(pressures))
    tlt = ttab.make_layer_tables(tst, torch.tensor(pressures))
    np.testing.assert_allclose(tlt.tab.numpy(), np.asarray(jlt.tab),
                               rtol=1e-14)
    lt2 = convert.to_layer_tables(jlt)
    np.testing.assert_array_equal(lt2.tab.numpy(), np.asarray(jlt.tab))

    temps = np.tile(T[None, -L:], (3, 1))
    temps[1, 0] = 500.0                      # exactly on the T hull edge
    temps[2, 1] = np.nextafter(500.0, 0.0)   # one ULP outside: kept
    mmr = np.stack([np.full((3, L), 1e-3), np.full((3, L), 2e-5)])
    wa = jtab.layer_interp_weights(jlt, jnp.asarray(mmr),
                                   jnp.asarray(temps))
    wb = ttab.layer_interp_weights(tlt, torch.tensor(mmr),
                                   torch.tensor(temps))
    np.testing.assert_array_equal(wb.numpy(), np.asarray(wa))
    assert wb[1, 0].abs().sum() > 0 and wb[2, 1].abs().sum() > 0
    sig = np.linspace(1e-3, 2e-3, W)
    ka, _ = jtab.kappa_from_layer_tables(jlt, jnp.asarray(mmr),
                                         jnp.asarray(temps),
                                         jnp.asarray(sig))
    kb, _ = ttab.kappa_from_layer_tables(tlt, torch.tensor(mmr),
                                         torch.tensor(temps),
                                         torch.tensor(sig))
    np.testing.assert_allclose(kb.numpy(), np.asarray(ka), rtol=1e-12)
    # the factored form equals the 4-corner bilinear lookup
    ks, _ = ttab.kappa_from_stack(
        tst, torch.tensor(mmr), torch.tensor(temps),
        torch.tensor(pressures)[None, :].expand(3, L), torch.tensor(sig))
    np.testing.assert_allclose(kb.numpy(), ks.numpy(), rtol=1e-10)


def test_single_temperature_stack():
    tabs = {"1H2-16O": (np.random.RandomState(4).rand(1, 3, W), [1500.0],
                        [1e-4, 1e-2, 1.0])}
    jst = jtab.make_opacity_stack(tabs, dtype=jnp.float64)
    tst = ttab.make_opacity_stack(tabs, dtype=torch.float64, device="cpu")
    P = np.array([1e2, 5e3, 1e6, 1e8])
    a = jtab.interp_tp(jst, jnp.full(4, 900.0), jnp.asarray(P))
    b = ttab.interp_tp(tst, torch.full((4,), 900.0, dtype=torch.float64),
                       torch.tensor(P))
    np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-14)


def test_mock_chemistry_and_kappa_model(grids):
    jg, tg = grids
    jst = jtab.load_example_opacity(jg, scale_factor=1.0, dtype=jnp.float64)
    tst = convert.to_opacity_stack(jst)
    m_bar = Planet.from_hot_jupiter().m_bar
    jchem, tchem = JMock(jst.masses_g, m_bar), MockChemistry(tst.masses_g,
                                                            m_bar)
    T = np.asarray(jg.init_temperatures)[None, :] * np.array(
        [[0.9], [1.0], [1.3]])
    p = np.asarray(jg.rt_grid.pressures_cgs)
    np.testing.assert_array_equal(
        tchem.mmr(torch.tensor(T), torch.tensor(p)).numpy(),
        np.asarray(jchem.mmr(jnp.asarray(T), jnp.asarray(p))))
    sig = np.linspace(1e-3, 2e-3, W)
    jk = j_build(jst, jchem, jnp.asarray(p), jnp.asarray(sig))
    tk = build_kappa_model(tst, tchem, torch.tensor(p), torch.tensor(sig))
    np.testing.assert_allclose(
        tk(torch.tensor(T), torch.tensor(p)).numpy(),
        np.asarray(jk(jnp.asarray(T), jnp.asarray(p))), rtol=1e-12)
    ohs_fn, tab = tk.layer_parts
    j_ohs, j_tab = jk.layer_parts
    np.testing.assert_array_equal(ohs_fn(torch.tensor(T)).numpy(),
                                  np.asarray(j_ohs(jnp.asarray(T))))
    np.testing.assert_array_equal(tab.numpy(), np.asarray(j_tab))
    # the grid wires the same model, with the hook the kernels key on
    tg.load_opacities(opacities=tst)
    assert hasattr(tg._kappa_fn, "layer_parts")
    assert isinstance(tg.chemistry, MockChemistry)


# --------------------------------------------------------------------------
# The batched kappa lookup (kernel #5's plain twin and the mode switch)
# --------------------------------------------------------------------------

def _kappa_case(n_p):
    """A two-species stack (5 T x ``n_p`` P points) and (3, 7) lookup
    points, some outside the hull in T (both ends) and in P."""
    rng = np.random.RandomState(11)
    T = np.array([500.0, 1000.0, 1800.0, 2500.0, 3000.0])
    P = np.array([1e-5, 1e-3, 1e-1, 10.0])[:n_p]
    tabs = {"1H2-16O": (rng.rand(5, n_p, W) + 0.1, T, P),
            "12C-16O": (rng.rand(5, n_p, W) * 3, T, P)}
    temps = rng.uniform(500.0, 3000.0, (3, 7))
    temps[0, 0], temps[1, 1], temps[2, 2] = 3000.0, 200.0, 4000.0
    press = np.tile(10.0 ** rng.uniform(1, 7, 7), (3, 1))
    if n_p > 1:
        press[2, 3] = 1e9                      # above the P hull
    else:
        press[:] = P[0] * 1e6                  # on the single P point
    mmr = rng.uniform(1e-5, 1e-3, (2, 3, 7))
    sig = np.linspace(1e-3, 2e-3, W)
    return tabs, temps, press, mmr, sig


@pytest.mark.parametrize("n_p", [4, 1], ids=["multi-P", "single-P"])
def test_kappa_twin_matches_jax_and_pallas_interpret(n_p):
    """The kernel's twin against JAX ``kappa_from_stack`` (gather) and
    the JAX TPU kernel ``kappa_pallas`` in interpret mode: float64,
    rtol 1e-10 (the same blend, summed in another order), points outside
    the hull carrying sigma alone; a one-point P axis included."""
    from frei_tpu.ops.kappa_pallas import kappa_pallas
    from frei_tpu_torch.ops import kappa_cuda

    tabs, temps, press, mmr, sig = _kappa_case(n_p)
    jst = jtab.make_opacity_stack(tabs, dtype=jnp.float64)
    tst = ttab.make_opacity_stack(tabs, dtype=torch.float64, device="cpu")
    jtab.set_interp_mode("gather")
    try:
        want, _ = jtab.kappa_from_stack(jst, jnp.asarray(mmr),
                                        jnp.asarray(temps),
                                        jnp.asarray(press),
                                        jnp.asarray(sig))
    finally:
        jtab.set_interp_mode(None)
    pallas, _ = kappa_pallas(jst, jnp.asarray(mmr), jnp.asarray(temps),
                             jnp.asarray(press), jnp.asarray(sig),
                             interpret=True)
    args = (torch.tensor(mmr), torch.tensor(temps), torch.tensor(press),
            torch.tensor(sig))
    got, s = kappa_cuda.kappa_plain(tst, *args)
    assert got.shape == (3, 7, W) and torch.equal(s, args[-1])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), rtol=1e-10)
    outside = [(1, 1), (2, 2)] + ([(2, 3)] if n_p > 1 else [])
    for c, l in outside:
        assert torch.equal(got[c, l], args[-1])
    # on CPU tensors the wrapper and kappa_from_stack run the twin and
    # launch (and count) nothing
    n0 = kappa_cuda.kappa_kernel.launches
    assert torch.equal(kappa_cuda.kappa_kernel(tst, *args)[0], got)
    assert torch.equal(ttab.kappa_from_stack(tst, *args)[0], got)
    assert kappa_cuda.kappa_kernel.launches == n0


def test_interp_mode_switch():
    """``set_interp_mode``: "gather" and None run the twin on the CPU;
    "cuda" demands a stack on a CUDA device; the JAX package's TPU
    formulations are refused with their counterpart named."""
    tabs, temps, press, mmr, sig = _kappa_case(4)
    tst = ttab.make_opacity_stack(tabs, dtype=torch.float64, device="cpu")
    args = (torch.tensor(mmr), torch.tensor(temps), torch.tensor(press),
            torch.tensor(sig))
    ref, _ = ttab.kappa_from_stack(tst, *args)
    try:
        ttab.set_interp_mode("gather")
        assert torch.equal(ttab.kappa_from_stack(tst, *args)[0], ref)
        ttab.set_interp_mode("cuda")
        with pytest.raises(ValueError, match="needs the stack on a CUDA"):
            ttab.kappa_from_stack(tst, *args)
    finally:
        ttab.set_interp_mode(None)
    for mode, ours in (("onehot", "gather"), ("pallas", "cuda")):
        with pytest.raises(ValueError, match=f"counterpart here is '{ours}'"):
            ttab.set_interp_mode(mode)
    with pytest.raises(ValueError, match="unknown interp mode"):
        ttab.set_interp_mode("gathr")
    assert ttab._INTERP_MODE is None
