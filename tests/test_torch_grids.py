"""Host grids and per-configuration constants of frei_tpu_torch against
frei_tpu: bit-identical (the numpy code is copied, not imported), as
tests/test_grids.py pins them for the JAX package."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import frei_tpu.grids as jg  # noqa: E402
import frei_tpu.opacity.rayleigh as jr  # noqa: E402
import frei_tpu.ops.planck as jp  # noqa: E402
import frei_tpu.stellar.irradiation as ji  # noqa: E402
import frei_tpu.units as ju  # noqa: E402
import frei_tpu_torch.grids as tg  # noqa: E402
import frei_tpu_torch.opacity.rayleigh as tr  # noqa: E402
import frei_tpu_torch.ops.planck as tp  # noqa: E402
import frei_tpu_torch.stellar.irradiation as ti  # noqa: E402
import frei_tpu_torch.units as tu  # noqa: E402
from frei_tpu import constants as jc  # noqa: E402
from frei_tpu_torch import constants as tc  # noqa: E402

torch.set_num_threads(2)


def test_constants_identical():
    names = [n for n in vars(jc) if not n.startswith("_")]
    assert names == [n for n in vars(tc) if not n.startswith("_")]
    for n in names:
        assert getattr(jc, n) == getattr(tc, n), n


@pytest.mark.parametrize("kw", [
    dict(), dict(n_wl_bins=37, n_layers=9, T_ref=2400.0),
    dict(lam_micron=np.linspace(0.7, 3.0, 11), pressures_bar=[10, 1, 0.1],
         init_temperatures=[1500.0, 1200.0, 1000.0])])
def test_make_rt_grid_identical(kw):
    a = jg.make_rt_grid(**kw)
    b = tg.make_rt_grid(**kw)
    assert a._fields == b._fields
    for f in a._fields:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    np.testing.assert_array_equal(a.lam_micron, b.lam_micron)
    np.testing.assert_array_equal(a.pressures_bar, b.pressures_bar)


def test_grid_builders_and_validation_identical():
    for fn in ("wavelength_grid",):
        for x, y in zip(getattr(jg, fn)(0.5, 10.0, 101),
                        getattr(tg, fn)(0.5, 10.0, 101)):
            np.testing.assert_array_equal(x, y)
    p = tg.pressure_grid(30, -6.0, np.log10(200.0))
    np.testing.assert_array_equal(p, jg.pressure_grid(30, -6.0,
                                                      np.log10(200.0)))
    np.testing.assert_array_equal(tg.temperature_grid(p, 2400.0),
                                  jg.temperature_grid(p, 2400.0))
    x = np.logspace(0, 1, 37)
    np.testing.assert_array_equal(tg.trapezoid_weights(x),
                                  jg.trapezoid_weights(x))
    for bad in (dict(pressures_bar=[1.0, 10.0, 100.0]),
                dict(pressures_bar=[1.0, 0.1])):
        with pytest.raises(ValueError):
            tg.make_rt_grid(**bad)


def test_units_identical():
    for fn, x in [("to_kelvin", 300.0), ("to_bar", [1.0, 2.0]),
                  ("to_barye", 0.5), ("to_micron", 1.5), ("to_cm", 2.0),
                  ("to_cgs_gravity", 24.8), ("to_gram", 2.4),
                  ("flux_cgs", 3.0)]:
        np.testing.assert_array_equal(getattr(tu, fn)(x),
                                      getattr(ju, fn)(x))


def test_irradiation_rayleigh_planck():
    lam = jg.make_rt_grid().lam_cm
    np.testing.assert_array_equal(ti.f_toa_np(lam, 5800.0, 6.45),
                                  ji.f_toa_np(lam, 5800.0, 6.45))
    np.testing.assert_array_equal(tr.rayleigh_total(lam, 4e-24),
                                  jr.rayleigh_total(lam, 4e-24))
    np.testing.assert_array_equal(tp.planck_lambda_np(2000.0, lam),
                                  jp.planck_lambda_np(2000.0, lam))
    # device Planck in float64: the same expression; XLA's and ATen's
    # expm1 and pow differ by a few ulp, hence rtol 1e-13
    T = np.array([[500.0], [1500.0], [4000.0]])
    a = np.asarray(jp.planck_lambda(jnp.asarray(T), jnp.asarray(lam)))
    b = tp.planck_lambda(torch.tensor(T), torch.tensor(lam)).numpy()
    np.testing.assert_allclose(b, a, rtol=1e-13, atol=0)
    np.testing.assert_allclose(
        tp.bb_flux(torch.tensor(T), torch.tensor(lam)).numpy(),
        np.asarray(jp.bb_flux(jnp.asarray(T), jnp.asarray(lam))),
        rtol=1e-13)
    np.testing.assert_allclose(
        ti.f_toa(torch.tensor(lam), 5800.0, 6.45).numpy(),
        ji.f_toa_np(lam, 5800.0, 6.45), rtol=1e-13)
