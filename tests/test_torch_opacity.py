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
              T_ref=2400.0, dtype=torch.float64)
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
    tst = ttab.make_opacity_stack(_tables(), dtype=torch.float64)
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
    tst = ttab.make_opacity_stack(tabs, dtype=torch.float64)
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
