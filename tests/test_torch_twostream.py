"""Two-stream couplers and radiative-convective physics of
frei_tpu_torch against frei_tpu, float64, rtol 1e-12 (the same
expressions in the same association order; XLA and ATen differ only in
the last bits of their transcendental functions)."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import frei_tpu.ops.twostream as jt  # noqa: E402
import frei_tpu.rt.physics as jph  # noqa: E402
import frei_tpu_torch.ops.twostream as tt  # noqa: E402
import frei_tpu_torch.rt.physics as tph  # noqa: E402

torch.set_num_threads(2)
RTOL = 1e-12


def _pair(x):
    return jnp.asarray(x), torch.tensor(x)


def _close(a, b, name="", atol_frac=0.0):
    a = np.asarray(a)
    np.testing.assert_allclose(np.asarray(b), a, rtol=RTOL,
                               atol=atol_frac * float(np.abs(a).max()),
                               err_msg=name)


@pytest.fixture(scope="module")
def layers():
    rng = np.random.RandomState(7)
    n = 400
    dtau = 10.0 ** rng.uniform(-9, 2, n)       # thin to thick layers
    om = rng.uniform(0.0, 0.5, n)              # both sides of 0.1
    B1 = rng.uniform(1e8, 1e13, n)
    B2 = rng.uniform(1e8, 1e13, n)
    F1 = rng.uniform(0, 1e13, n)
    F2 = rng.uniform(0, 1e13, n)
    return dtau, om, B1, B2, F1, F2


def test_e_correction(layers):
    _, om, *_ = layers
    for g0 in (0.0, 0.3):
        a = jt.e_correction(jnp.asarray(om), g0)
        b = tt.e_correction(torch.tensor(om), g0)
        _close(a, b, f"g0={g0}")


@pytest.mark.parametrize("form", ["general", "g0"])
def test_couplers(layers, form):
    dtau, om, B1, B2, *_ = layers
    if form == "general":
        a = jt.two_stream_couplers(*(jnp.asarray(x)
                                     for x in (dtau, om, B1, B2)), g_0=0.0)
        b = tt.two_stream_couplers(*(torch.tensor(x)
                                     for x in (dtau, om, B1, B2)), g_0=0.0)
    else:
        a = jt.two_stream_couplers_g0(*(jnp.asarray(x)
                                        for x in (dtau, om, B1, B2)))
        b = tt.two_stream_couplers_g0(*(torch.tensor(x)
                                        for x in (dtau, om, B1, B2)))
    # the reflection coupler b = (chi_p_xi - chi) / chi is a difference
    # of O(1) terms that cancel in thin layers: its last bits are held
    # relative to the field's largest value (atol 1e-12 x max)
    for f in a._fields:
        _close(getattr(a, f), getattr(b, f), f, atol_frac=1e-12)


def test_g0_form_equals_general_form(layers):
    dtau, om, B1, B2, *_ = layers
    args = [torch.tensor(x) for x in (dtau, om, B1, B2)]
    a = tt.two_stream_couplers(*args, g_0=0.0)
    b = tt.two_stream_couplers_g0(*args)
    for f in a._fields:
        x = getattr(a, f).numpy()
        np.testing.assert_allclose(getattr(b, f).numpy(), x, rtol=1e-9,
                                   atol=1e-12 * float(np.abs(x).max()),
                                   err_msg=f)


def test_propagate_fluxes(layers):
    dtau, om, B1, B2, F1, F2 = layers
    a = jt.propagate_fluxes(*(jnp.asarray(x) for x in (F1, F2, B1, B2,
                                                       dtau)),
                            omega_0=jnp.asarray(om))
    b = tt.propagate_fluxes(*(torch.tensor(x) for x in (F1, F2, B1, B2,
                                                        dtau)),
                            omega_0=torch.tensor(om))
    for x, y in zip(a, b):
        _close(x, y, atol_frac=1e-12)
    # scalar omega_0 (the reference's default call)
    a = jt.propagate_fluxes(*(jnp.asarray(x) for x in (F1, F2, B1, B2,
                                                       dtau)))
    b = tt.propagate_fluxes(*(torch.tensor(x) for x in (F1, F2, B1, B2,
                                                        dtau)))
    for x, y in zip(a, b):
        _close(x, y, atol_frac=1e-12)


def test_physics_functions():
    rng = np.random.RandomState(3)
    n = 300
    T1 = rng.uniform(500, 4000, n)
    # every third layer super-adiabatic (T1 >> T2), the rest stable
    T2 = np.where(np.arange(n) % 3 == 0, T1 * 0.3, T1 * 1.05)
    p1 = 10.0 ** rng.uniform(0, 8, n)
    p2 = p1 * rng.uniform(0.3, 0.9, n)
    s = rng.uniform(1e9, 1e13, (4, n))
    jpar = jph.PhysicsParams()
    tpar = tph.PhysicsParams(*jpar)
    jT1, tT1 = _pair(T1)
    jT2, tT2 = _pair(T2)
    jp1, tp1 = _pair(p1)
    jp2, tp2 = _pair(p2)
    _close(jph.c_p(jpar), tph.c_p(tpar))
    _close(jph.gamma_adiabatic(jpar), tph.gamma_adiabatic(tpar))
    for fn in ("delta_z", "rho_p"):
        _close(getattr(jph, fn)(jT1, jp1, jp2, jpar),
               getattr(tph, fn)(tT1, tp1, tp2, tpar), fn)
    _close(jph.delta_tau(jp1 * 0 + 3.0, jp1, jp2, jpar.g),
           tph.delta_tau(tp1 * 0 + 3.0, tp1, tp2, tpar.g))
    _close(jph.mixing_length(jT1, jpar), tph.mixing_length(tT1, tpar))
    for fn in ("gamma_lapse", "delta_gamma", "convective_flux"):
        _close(getattr(jph, fn)(jT1, jT2, jp1, jp2, jpar),
               getattr(tph, fn)(tT1, tT2, tp1, tp2, tpar), fn)
    assert (tph.convective_flux(tT1, tT2, tp1, tp2, tpar) == 0).any()
    js = [jnp.asarray(x) for x in s]
    ts = [torch.tensor(x) for x in s]
    # a zero net flux on some layers exercises the double select
    js[0] = js[0].at[::5].set(js[1][::5] + js[2][::5] - js[3][::5])
    ts[0][::5] = ts[1][::5] + ts[2][::5] - ts[3][::5]
    jdiv, jdz = jph.div_bol_net_flux(*js, jT2 * 0 + jT1, jT1 * 1.05, jp1,
                                     jp2, jpar)
    tdiv, tdz = tph.div_bol_net_flux(*ts, tT2 * 0 + tT1, tT1 * 1.05, tp1,
                                     tp2, tpar)
    _close(jdiv, tdiv, "div")
    _close(jdz, tdz, "dz")
    assert (tdiv == 0).any()
    jdt = jph.radiative_timestep(jT1, jT2, jp1, jp2, jdiv, jdz, jpar)
    tdt = tph.radiative_timestep(tT1, tT2, tp1, tp2, tdiv, tdz, tpar)
    _close(jdt, tdt, "dt")
    _close(jph.delta_temperature(jdiv, jdt, jT1, jp1, jp2, jpar),
           tph.delta_temperature(tdiv, tdt, tT1, tp1, tp2, tpar), "dT")
