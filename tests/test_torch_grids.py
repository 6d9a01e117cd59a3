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


#: (T_star [K], a/R*) of the population of tests/test_parallel.py
STARS = [(5800.0, 5.0), (4500.0, 9.0), (6300.0, 6.4), (5000.0, 4.0)]
#: bins of the row-against-batch checks: a multiple of 16, so that
#: ATen's CPU loop evaluates every expm1 of a row, alone or in a batch,
#: in its vector body (its scalar tail rounds expm1 apart)
VECTOR_BINS = 496


def _stars():
    T, a = (torch.tensor(x, dtype=torch.float64) for x in zip(*STARS))
    return jg.make_rt_grid().lam_cm, T, a


def test_f_toa_rows_are_per_planet_rows_bit_for_bit():
    """The batched builder's row c is ``f_toa`` of planet c on the same
    device, and the builder's row at C = 1, bit for bit; it counts the
    rows it builds."""
    lam, T, a = _stars()
    lam = lam[:VECTOR_BINS]
    before = ti.f_toa_rows.rows
    rows = ti.f_toa_rows(lam, T, a, torch.float64)
    assert ti.f_toa_rows.rows - before == len(STARS)
    assert rows.dtype == torch.float64 and rows.shape == (len(STARS),
                                                          lam.size)
    lam_t = torch.tensor(lam)
    for c in range(len(STARS)):
        assert torch.equal(rows[c], ti.f_toa(lam_t, T[c], a[c])), c
        assert torch.equal(rows[c], ti.f_toa_rows(
            lam, T[c:c + 1], a[c:c + 1], torch.float64)[0]), c


def test_f_toa_rows_against_the_host_twin():
    """Against ``f_toa_np`` row by row at rtol 2e-15: ATen's expm1 and
    its scalar divisions (a reciprocal and a product) round apart from
    numpy's by a few ulp, which expm1 carries up by its exponent, to
    1.27e-15 (9 ulp) for these stars over 0.5-10 um on an AVX512 host
    and 1.67e-15 on an H100."""
    lam, T, a = _stars()
    want = np.stack([ti.f_toa_np(lam, t, r) for t, r in STARS])
    np.testing.assert_allclose(ti.f_toa_rows(lam, T, a, torch.float64)
                               .numpy(), want, rtol=2e-15, atol=0)


def test_f_toa_rows_cast_after_a_float64_evaluation():
    """A float32 grid's rows are the float64 rows cast, bit for bit, not
    a float32 evaluation of the same expression."""
    lam, T, a = _stars()
    rows = ti.f_toa_rows(lam, T, a, torch.float32)
    assert rows.dtype == torch.float32
    assert torch.equal(rows, ti.f_toa_rows(lam, T, a, torch.float64)
                       .to(torch.float32))
    in_f32 = ti.f_toa(torch.tensor(lam, dtype=torch.float32),
                      T.float()[:, None], a.float()[:, None])
    assert not torch.equal(rows, in_f32)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_grid_f_toa_is_the_builders_row(dtype):
    """``Grid``'s shared planet is a population of one: its F_toa is the
    builder's row for the planet, in the grid's dtype, bit for bit."""
    from frei_tpu_torch import Grid, Planet, load_example_opacity
    p = Planet(a_rstar=6.0, m_bar=2.4, g=15.0, T_star=5500.0)
    grid = Grid(p, n_wl_bins=24, n_layers=7, T_ref=2400.0, dtype=dtype,
                device="cpu")
    grid.load_opacities(opacities=load_example_opacity(
        grid, scale_factor=1.0, dtype=dtype))
    F_toa = grid._consts.F_toa
    assert F_toa.dtype == dtype and F_toa.shape == (24,)
    assert torch.equal(F_toa, ti.f_toa_rows(
        grid.rt_grid.lam_cm, [p.T_star], [p.a_rstar], dtype)[0])
