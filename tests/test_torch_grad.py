"""Reverse-mode differentiable solves of frei_tpu_torch
(``SolverConfig(differentiable=True)``), mirroring ``tests/test_grad.py``.

Pinned here, in float64 on the CPU:

* the differentiable forward equals the ordinary eager solve bit for
  bit in every ``RTResult`` field, with columns converging early (the
  fixed horizon keeps running them frozen), for every remat chunk;
* gradients with respect to gravity, mixing length and the initial
  temperatures match central differences at rtol 1e-5, and
  ``Grid.spectrum_fn`` carries them to per-column g and F_toa;
* the flux matches the JAX package's differentiable ``"xla"`` solve at
  rtol 1e-9 (the two sum the quadratures in another order), and the
  gradients ``jax.grad`` at rtol 1e-7;
* the kernel engines refuse with "autodiff", bins sharding with its
  ROADMAP item;
* the float32 traps of the JAX package's record: a finite timestep
  gradient at zero divergence, and finite gravity gradients of the
  physics helpers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from frei_tpu import Grid as JGrid  # noqa: E402
from frei_tpu import Planet as JPlanet  # noqa: E402
from frei_tpu import load_example_opacity as j_fixture  # noqa: E402
from frei_tpu.rt.physics import PhysicsParams as JParams  # noqa: E402
from frei_tpu.rt.solver import SolverConfig as JConfig  # noqa: E402
from frei_tpu.rt.solver import solve_rc_batched as j_solve  # noqa: E402
from frei_tpu_torch import Grid, Planet  # noqa: E402
from frei_tpu_torch.io import convert  # noqa: E402
from frei_tpu_torch.rt import physics  # noqa: E402
from frei_tpu_torch.rt.physics import PhysicsParams  # noqa: E402
from frei_tpu_torch.rt.solver import (SolverConfig, solve_rc,  # noqa: E402
                                      solve_rc_batched)

torch.set_num_threads(2)
W, L, B = 16, 5, 3
F64 = torch.float64


@pytest.fixture(scope="module")
def setup():
    """The JAX test's fixture: 16 bins x 5 layers, three columns of the
    initial profile x U(0.9, 1.1) (seed 3); the port's grid on the JAX
    grid's opacity stack."""
    jg = JGrid(JPlanet.from_hot_jupiter(), n_wl_bins=W, n_layers=L,
               T_ref=2400.0, dtype=jnp.float64)
    jg.load_opacities(opacities=j_fixture(jg, scale_factor=1.0,
                                          dtype=jnp.float64))
    grid = Grid(Planet.from_hot_jupiter(), n_wl_bins=W, n_layers=L,
                T_ref=2400.0, dtype=F64, device="cpu")
    grid.load_opacities(opacities=convert.to_opacity_stack(jg.opacities))
    rng = np.random.RandomState(3)
    T0 = (np.asarray(grid.init_temperatures)[None, :]
          * rng.uniform(0.9, 1.1, (B, 1)))
    return jg, grid, T0


def _fixed_cfg(**kw):
    # convergence exits off: finite differences must not cross the
    # discrete stopping rule
    return SolverConfig(n_timesteps=3, n_zero_crossings=10 ** 6,
                        convergence_dT=0.0, **kw)


def _args(grid):
    return grid._consts, grid.planet.physics_params(), grid._kappa_fn


@pytest.mark.parametrize("chunk", [0, 3, 1])
def test_differentiable_forward_bit_identical(setup, chunk):
    """The fixed horizon equals the early-exit loop with live
    convergence (a 60 K threshold converges columns early): the auto
    chunk (2 at T = 4), a chunk with a remainder (3 at T = 4), and a
    checkpoint every iteration."""
    _, grid, T0 = setup
    T0 = torch.tensor(T0)
    cfg = dict(n_timesteps=4, convergence_dT=60.0)
    ref = solve_rc_batched(T0, *_args(grid), SolverConfig(**cfg))
    assert int(ref.n_iterations.max()) < 4, \
        "the test needs early convergence to exercise the frozen body"
    dif = solve_rc_batched(T0, *_args(grid), SolverConfig(
        differentiable=True, remat_chunk=chunk, **cfg))
    for f in ref._fields:
        assert torch.equal(getattr(ref, f), getattr(dif, f)), f


def test_negative_remat_chunk_raises(setup):
    """A negative chunk would run no iteration; it must refuse."""
    _, grid, T0 = setup
    with pytest.raises(ValueError, match="remat_chunk"):
        solve_rc_batched(torch.tensor(T0), *_args(grid), SolverConfig(
            n_timesteps=4, differentiable=True, remat_chunk=-1))


def test_differentiable_forward_bit_identical_single_column(setup):
    _, grid, T0 = setup
    T = torch.tensor(T0[0])
    cfg = dict(n_timesteps=4, convergence_dT=60.0)
    r1 = solve_rc(T, *_args(grid), SolverConfig(**cfg))
    d1 = solve_rc(T, *_args(grid), SolverConfig(differentiable=True, **cfg))
    for f in r1._fields:
        assert torch.equal(getattr(r1, f), getattr(d1, f)), f


def _loss_fn(grid):
    p0 = grid.planet.physics_params()
    w = torch.linspace(0.5, 1.5, W, dtype=F64)  # no cancellation across bins
    cfg = _fixed_cfg(differentiable=True)

    def loss(g, alpha, T):
        par = PhysicsParams(g=g, m_bar=p0.m_bar, alpha=alpha, n_dof=p0.n_dof)
        res = solve_rc_batched(T, grid._consts, par, grid._kappa_fn, cfg)
        return (res.flux * w).sum() / 1e12
    return loss


@pytest.mark.parametrize("wrt", ["g", "alpha", "T0"])
def test_grad_matches_finite_differences(setup, wrt):
    """d(loss)/d(g), d/d(alpha), d/d(T0[1, 2]) against central
    differences at rtol 1e-5 (`tests/test_grad.py:94-130`)."""
    _, grid, T0 = setup
    loss = _loss_fn(grid)
    p0 = grid.planet.physics_params()
    x = {"g": torch.tensor(p0.g, dtype=F64),
         "alpha": torch.tensor(p0.alpha, dtype=F64),
         "T0": torch.tensor(T0)}
    leaf = x[wrt].clone().requires_grad_(True)
    x_in = dict(x, **{wrt: leaf})
    (got,) = torch.autograd.grad(loss(x_in["g"], x_in["alpha"],
                                      x_in["T0"]), leaf)
    assert torch.isfinite(got).all()

    def at(v):      # the loss with x[wrt] replaced by v
        with torch.no_grad():
            return float(loss(*(v if k == wrt else x[k] for k in x)))
    if wrt == "T0":
        e = torch.zeros_like(x["T0"])
        e[1, 2] = 1.0
        h = 1e-3
        fd = (at(x["T0"] + h * e) - at(x["T0"] - h * e)) / (2.0 * h)
        got = got[1, 2]
    else:
        h = float(x[wrt]) * 1e-6
        fd = (at(x[wrt] + h) - at(x[wrt] - h)) / (2.0 * h)
    np.testing.assert_allclose(float(got), fd, rtol=1e-5)


def test_grid_spectrum_fn_grad_per_column_irradiation(setup):
    """``Grid.spectrum_fn``: gradients reach a per-column F_toa and
    per-column g, and column 0's g-gradient is its finite difference
    (columns do not feel each other's g)."""
    _, grid, T0 = setup
    T0 = torch.tensor(T0)
    fn = grid.spectrum_fn(n_timesteps=2, n_zero_crossings=10 ** 6,
                          convergence_dT=0.0)
    p0 = grid.planet.physics_params()
    ftoa = (grid._consts.F_toa.expand(B, W)
            * torch.tensor([0.8, 1.0, 1.2], dtype=F64)[:, None])
    g_cols = torch.full((B,), p0.g, dtype=F64)

    def loss(ft, g):
        par = PhysicsParams(g=g, m_bar=p0.m_bar, alpha=p0.alpha,
                            n_dof=p0.n_dof)
        return (fn(T0, par, F_toa=ft) ** 2).sum() / 1e26

    ft = ftoa.clone().requires_grad_(True)
    g = g_cols.clone().requires_grad_(True)
    gf, gg = torch.autograd.grad(loss(ft, g), (ft, g))
    assert gf.shape == (B, W) and torch.isfinite(gf).all()
    assert gg.shape == (B,) and torch.isfinite(gg).all()
    h = float(p0.g) * 1e-6
    e = torch.zeros(B, dtype=F64)
    e[0] = h
    with torch.no_grad():
        dg = (loss(ftoa, g_cols + e) - loss(ftoa, g_cols - e)) / (2 * h)
    np.testing.assert_allclose(float(gg[0]), float(dg), rtol=1e-5)


@pytest.mark.parametrize("engine", ["cuda", "iteration", "loop"])
def test_differentiable_rejects_kernel_engines(setup, engine):
    """The kernels carry no backward: refused with the same message on
    every device (checked before the CUDA-tensor test)."""
    _, grid, T0 = setup
    with pytest.raises(ValueError, match="autodiff"):
        solve_rc_batched(torch.tensor(T0), *_args(grid), SolverConfig(
            engine=engine, differentiable=True, n_timesteps=1))


def test_differentiable_auto_runs_eager_and_refuses_the_rest(setup):
    """``"auto"`` resolves to ``"eager"``; bins sharding still names its
    ROADMAP item, and progress printing is refused."""
    _, grid, T0 = setup
    T0 = torch.tensor(T0)
    cfg = SolverConfig(n_timesteps=2, differentiable=True)
    got = solve_rc_batched(T0, *_args(grid), cfg)
    ref = solve_rc_batched(T0, *_args(grid), SolverConfig(
        n_timesteps=2, engine="eager"))
    assert torch.equal(got.flux, ref.flux)
    with pytest.raises(NotImplementedError, match="item 14"):
        solve_rc_batched(T0, *_args(grid), cfg._replace(bins_axis="bins"))
    with pytest.raises(ValueError, match="progress"):
        solve_rc_batched(T0, *_args(grid), cfg._replace(progress=True))


@pytest.fixture(scope="module")
def jax_grads(setup):
    """The JAX package's differentiable ``"xla"`` solve of the same
    columns with a per-column F_toa, its flux and ``jax.grad`` of the
    weighted flux sum with respect to g, alpha, T0 and F_toa; and the
    port's."""
    jg, grid, T0 = setup
    p0 = jg.planet.physics_params()
    ft = np.asarray(jg._consts.F_toa)[None, :] * np.array(
        [[0.8], [1.0], [1.2]])
    w = np.linspace(0.5, 1.5, W)
    jcfg = JConfig(n_timesteps=3, n_zero_crossings=10 ** 6,
                   convergence_dT=0.0, engine="xla", differentiable=True)

    def jflux(g, a, T, f):
        par = JParams(g=g, m_bar=p0.m_bar, alpha=a, n_dof=p0.n_dof)
        return j_solve(T, jg._consts._replace(F_toa=f), par, jg._kappa_fn,
                       jcfg).flux

    x0 = (jnp.float64(p0.g), jnp.float64(p0.alpha), jnp.asarray(T0),
          jnp.asarray(ft))
    want = jax.grad(lambda *x: jnp.sum(jflux(*x) * w) / 1e12,
                    argnums=(0, 1, 2, 3))(*x0)
    want_flux = np.asarray(jflux(*x0))

    leaves = [torch.tensor(np.asarray(x), dtype=F64).requires_grad_(True)
              for x in x0]
    par = PhysicsParams(g=leaves[0], m_bar=p0.m_bar, alpha=leaves[1],
                        n_dof=p0.n_dof)
    flux = solve_rc_batched(
        leaves[2], grid._consts._replace(F_toa=leaves[3]), par,
        grid._kappa_fn, _fixed_cfg(differentiable=True)).flux
    got = torch.autograd.grad((flux * torch.tensor(w)).sum() / 1e12, leaves)
    return (dict(zip(["g", "alpha", "T0", "F_toa"], want)),
            dict(zip(["g", "alpha", "T0", "F_toa"], got)),
            want_flux, flux.detach().numpy())


def test_differentiable_flux_matches_jax(jax_grads):
    *_, want, got = jax_grads
    np.testing.assert_allclose(got, want, rtol=1e-9)


@pytest.mark.parametrize("wrt", ["g", "alpha", "T0", "F_toa"])
def test_grad_matches_jax(jax_grads, wrt):
    """The port's gradients against ``jax.grad`` at rtol 1e-7 (alpha's is
    zero in both: no layer of this grid convects)."""
    want, got, *_ = jax_grads
    a = np.asarray(want[wrt])
    np.testing.assert_allclose(got[wrt].numpy(), a, rtol=1e-7,
                               atol=1e-12 * float(np.abs(a).max()))


def test_radiative_timestep_grad_finite_at_zero_divergence(setup):
    """At ``div == 0`` the untaken branch of the timestep prefactor is
    ``1e5 / 0**0.9``; the double select keeps its cotangent out of the
    gradient (`tests/test_grad.py:214-240`), in float64 and float32."""
    p = setup[1].planet.physics_params()
    for dtype, values in ((F64, (0.0, 1e-3)), (torch.float32, (0.0,))):
        def t(v):
            return torch.tensor(v, dtype=dtype)
        for v in values:
            div = t(v).requires_grad_(True)
            (g,) = torch.autograd.grad(physics.radiative_timestep(
                t(1800.0), t(1750.0), t(2.0e6), t(1.0e6), div, t(1.0e7),
                p).sum(), div)
            assert torch.isfinite(g), (dtype, v, float(g))


@pytest.mark.parametrize("name", ["delta_z", "mixing_length", "rho_p",
                                  "convective_flux"])
def test_physics_g_gradients_finite_at_float32(setup, name):
    """``m_bar * g`` is a ~1e-20 CGS product whose reverse-mode quotient
    rule overflows float32: the sequential divisions keep every gravity
    gradient finite (`tests/test_grad.py:243-275`)."""
    _, grid, _ = setup
    p0 = grid.planet.physics_params()
    press = grid._consts.pressures.to(torch.float32)
    T1 = torch.full((press.shape[0] - 1,), 1800.0)
    p1, p2 = press[:-1], press[1:]
    g = torch.tensor(p0.g, dtype=torch.float32, requires_grad=True)
    par = PhysicsParams(g=g, m_bar=torch.tensor(p0.m_bar, dtype=torch.float32),
                        alpha=torch.tensor(p0.alpha, dtype=torch.float32),
                        n_dof=p0.n_dof)
    out = {"delta_z": lambda: physics.delta_z(T1, p1, p2, par),
           "mixing_length": lambda: physics.mixing_length(T1, par),
           "rho_p": lambda: physics.rho_p(T1, p1, p2, par),
           "convective_flux": lambda: physics.convective_flux(
               T1, T1 * 0.9, p1, p2, par)}[name]()
    (grad,) = torch.autograd.grad(out.sum(), g)
    assert torch.isfinite(grad), (name, float(grad))
