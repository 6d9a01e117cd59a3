"""Sweep kernels of frei_tpu_torch against frei_tpu.

The plain PyTorch twins of the CUDA sweep kernels
(``frei_tpu_torch.ops.sweep_cuda``) run here on the CPU and are held
against the JAX package's Pallas sweep kernels, run through the Pallas
interpreter as its own tests run them, and against its vmapped XLA
sweeps.  The kernels themselves are held against the twins on the card
by ``tests/test_torch_cuda.py``.

Tolerances (float64): rtol 1e-7 with atol 1e-9 x max|x|, as
``tests/test_sweep_pallas.py`` uses between the JAX engines: the Pallas
kernels evaluate expm1 by a series (~3e-10 relative) and the XLA sweeps
use the general coupler form and an unhoisted Planck argument, equal in
real arithmetic; the adaptive timestep amplifies the difference in dT.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from frei_tpu import Grid, Planet, load_example_opacity  # noqa: E402
from frei_tpu.ops import sweep_pallas as sp  # noqa: E402
from frei_tpu.rt import sweeps as jax_sweeps  # noqa: E402
from frei_tpu_torch.io import convert  # noqa: E402
from frei_tpu_torch.ops import sweep_cuda as sc_mod  # noqa: E402
from frei_tpu_torch.rt.physics import PhysicsParams  # noqa: E402
from frei_tpu_torch.rt.sweeps import emit_dtaus  # noqa: E402

torch.set_num_threads(2)

B, L, W = 3, 7, 24
DONE = np.array([False, True, False])


def _close(ref, got, name):
    ref = np.asarray(ref)
    got = got.detach().cpu().numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-7,
                               atol=1e-9 * float(np.abs(ref).max()),
                               err_msg=name)


@pytest.fixture(scope="module")
def setup():
    planet = Planet.from_hot_jupiter()
    grid = Grid(planet, n_wl_bins=W, n_layers=L, T_ref=2400.0,
                dtype=jnp.float64)
    grid.load_opacities(opacities=load_example_opacity(
        grid, scale_factor=1.0, dtype=jnp.float64))
    p0 = planet.physics_params()
    params = PhysicsParams(g=jnp.float64(p0.g), m_bar=jnp.float64(p0.m_bar),
                           alpha=jnp.float64(p0.alpha), n_dof=p0.n_dof)
    rng = np.random.RandomState(0)
    T = np.asarray(grid.init_temperatures)[None, :] * rng.uniform(
        0.9, 1.1, (B, 1))
    Fu = rng.rand(B, L, W) * 1e10
    Fd = rng.rand(B, L, W) * 1e10
    ohs_fn, tab = grid._kappa_fn.layer_parts
    ohs = np.asarray(ohs_fn(jnp.asarray(T)))
    K = np.asarray(grid._kappa_fn(jnp.asarray(T), grid._consts.pressures))

    consts_t = convert.to_rt_constants(grid._consts)
    par = convert.to_physics_params(p0)
    params_t = par._replace(g=torch.tensor(par.g, dtype=torch.float64),
                            m_bar=torch.tensor(par.m_bar,
                                               dtype=torch.float64),
                            alpha=torch.tensor(par.alpha,
                                               dtype=torch.float64))
    return dict(grid=grid, params=params, T=T, Fu=Fu, Fd=Fd, ohs=ohs,
                tab=np.asarray(tab), K=K, consts_t=consts_t,
                params_t=params_t,
                sc_t=sc_mod.make_sweep_consts(consts_t, params_t))


def _kappa(s, fused, lib):
    if lib == "jax":
        return ((jnp.asarray(s["ohs"]), jnp.asarray(s["tab"])) if fused
                else jnp.asarray(s["K"]))
    return ((torch.tensor(s["ohs"]), torch.tensor(s["tab"])) if fused
            else torch.tensor(s["K"]))


@pytest.mark.parametrize("fused", [False, True], ids=["kappa", "fused"])
@pytest.mark.parametrize("direction", ["emit", "absorb"])
def test_plain_twin_matches_pallas_kernel(setup, direction, fused):
    """Whole output slabs and the (B, 4, L-1) quadratures, with one
    column frozen by ``done``; the temperature epilogue is held against
    the XLA sweeps below."""
    s = setup
    grid = s["grid"]
    scj = sp.make_sweep_consts(grid._consts, s["params"])
    kern = sp._emit_kernel if direction == "emit" else sp._absorb_kernel
    dtf = scj.dtf_emit if direction == "emit" else scj.dtf_absorb
    done_j = jnp.asarray(DONE)
    args_j = (jnp.asarray(s["T"]), _kappa(s, fused, "jax"),
              jnp.asarray(s["Fu"]), jnp.asarray(s["Fd"]))
    ref = sp._run_sweep(kern, dtf, *args_j, scj, 2, True, done=done_j)
    wrap = (sc_mod.emit_kernel if direction == "emit"
            else sc_mod.absorb_kernel)
    T, Fu, Fd = (torch.tensor(s[k]) for k in ("T", "Fu", "Fd"))
    kap = _kappa(s, fused, "torch")
    done = torch.tensor(DONE)
    got = wrap(T, Fu, Fd, kap, s["sc_t"], done)
    for name, a, b in zip(["F_up", "F_down", "sums"], ref, got):
        _close(a, b, f"{direction} {name}")
    # frozen column: both slabs come back unchanged
    assert torch.equal(got[0][1], Fu[1]) and torch.equal(got[1][1], Fd[1])


@pytest.mark.parametrize("direction", ["emit", "absorb"])
def test_done_mask_variants_agree(setup, direction):
    """``done=None`` and an all-False mask give identical bits, and the
    materialized and fused opacity forms agree."""
    s = setup
    wrap = (sc_mod.emit_kernel if direction == "emit"
            else sc_mod.absorb_kernel)
    T, Fu, Fd = (torch.tensor(s[k]) for k in ("T", "Fu", "Fd"))
    a = wrap(T, Fu, Fd, _kappa(s, True, "torch"), s["sc_t"])
    b = wrap(T, Fu, Fd, _kappa(s, True, "torch"), s["sc_t"],
             torch.zeros(B, dtype=torch.bool))
    c = wrap(T, Fu, Fd, _kappa(s, False, "torch"), s["sc_t"])
    for x, y, z in zip(a, b, c):
        assert torch.equal(x, y)
        np.testing.assert_allclose(z.numpy(), x.numpy(), rtol=1e-12)


@pytest.mark.parametrize("direction", ["emit", "absorb"])
def test_plain_twin_matches_xla_sweeps(setup, direction):
    s = setup
    c = s["grid"]._consts
    kw = dict(sigma_scat=c.sigma_scat, F_toa=c.F_toa, lam_cm=c.lam_cm,
              trapz_w=c.trapz_w, pressures=c.pressures, params=s["params"])
    xla = (jax_sweeps.emit_sweep if direction == "emit"
           else jax_sweeps.absorb_sweep)
    ref = jax.vmap(lambda t, fu, fd, k: xla(t, fu, fd, k, **kw))(
        jnp.asarray(s["T"]), jnp.asarray(s["Fu"]), jnp.asarray(s["Fd"]),
        jnp.asarray(s["K"]))
    full = (sc_mod.emit_sweep_cuda if direction == "emit"
            else sc_mod.absorb_sweep_cuda)
    got = full(*(torch.tensor(s[k]) for k in ("T", "Fu", "Fd")),
               _kappa(s, True, "torch"), s["sc_t"],
               s["consts_t"].pressures, s["params_t"])
    for name, a, b in zip(["F_up", "F_down", "temps", "dT"],
                          [ref.F_up, ref.F_down, ref.temps, ref.dT], got):
        _close(a, b, f"{direction} {name}")


@pytest.mark.parametrize("fused", [False, True], ids=["kappa", "fused"])
def test_emit_dtaus_output_matches_jax(setup, fused):
    """The dtaus diagnostic the final emit returns (both engines of the
    solve take it from there) against JAX ``emit_dtaus``; the rest of
    the emit output is unchanged by asking for it."""
    s = setup
    ref = jax_sweeps.emit_dtaus(jnp.asarray(s["K"]),
                                s["grid"]._consts.pressures, s["params"])
    _close(ref, emit_dtaus(torch.tensor(s["K"]), s["consts_t"].pressures,
                           s["params_t"]), "emit_dtaus")
    args = [torch.tensor(s[k]) for k in ("T", "Fu", "Fd")]
    kap = _kappa(s, fused, "torch")
    *outs, dtaus = sc_mod.emit_kernel(*args, kap, s["sc_t"], with_dtaus=True)
    _close(ref, dtaus, "emit_kernel dtaus")
    for x, y in zip(outs, sc_mod.emit_kernel(*args, kap, s["sc_t"])):
        assert torch.equal(x, y)


@pytest.mark.parametrize("W, npt, threads", [
    (1, 1, 32), (33, 1, 64), (256, 2, 128), (257, 4, 96), (500, 4, 128),
    (1000, 8, 128), (2048, 8, 256)])
def test_plan_block_shape(W, npt, threads):
    """Wavelengths per thread: the smallest power of two up to 8 that
    leaves at most 128 per block (256 at 8, up to W = 2048); threads: a
    whole number of warps covering them."""
    plan = sc_mod.plan_sweep(W, 30, 30, 4, True)
    assert (plan.npt, plan.threads) == (npt, threads)
    assert plan.threads * plan.npt >= W


def test_plan_headline_and_layout():
    """The headline sweep (W 500, L 30, K 30, float32, fused) stages the
    stale flux row and two table rows one layer ahead; the bytes are the
    kernel's layout, 16-byte aligned section by section."""
    plan = sc_mod.plan_sweep(500, 30, 30, 4, True)
    assert plan == sc_mod.SweepPlan(threads=128, npt=4, depth=1, rows=3,
                                    smem=plan.smem)
    a16 = lambda n: -(-n // 16) * 16  # noqa: E731
    want = (a16(30 * 30 * 4) + a16(30 * 30 * 4) + a16(30 * 4)  # weights
            + a16(30 * 4) + a16(29 * 4)                       # 1/T, dtf
            + a16((3 * 29 + 1) * 4 * 4)                       # partials
            + a16(2 * 3 * 512 * 4))                           # the ring
    assert plan.smem == want
    # the materialized form stages one kappa row and no weights
    mat = sc_mod.plan_sweep(500, 30, 0, 4, False)
    assert (mat.depth, mat.rows) == (1, 2)
    assert mat.smem == (a16(30 * 4) + a16(29 * 4) + a16((3 * 29 + 1) * 4 * 4)
                        + a16(2 * 2 * 512 * 4))


@pytest.mark.parametrize("W, L, K, elem, fused", [
    (2048, 30, 70, 8, True), (2048, 30, 0, 8, False), (1000, 30, 70, 8, True),
    (500, 30, 30, 8, True), (2048, 3, 30, 4, True)])
def test_plan_shrinks_to_fit(W, L, K, elem, fused):
    """Wide float64 rows: the plan stages fewer kappa rows, then a
    shallower ring, to stay under the shared-memory target, and every
    plan fits the card's 227 KB."""
    plan = sc_mod.plan_sweep(W, L, K, elem, fused)
    assert plan.smem <= sc_mod.SMEM_TARGET or plan.depth == 0
    assert plan.smem <= sc_mod.SMEM_LIMIT
    assert plan.smem == sc_mod.sweep_smem_bytes(
        fused, L, K, elem, plan.threads, plan.npt, plan.depth, plan.rows)
    full = sc_mod.plan_sweep(W, L, K, elem, fused, depth=0)
    assert (full.depth, full.rows) == (0, 1)


def test_plan_options_and_refusal():
    """The ring is 0 or 1 layers deep (depth 0 stages only the flux row);
    other depths, weight rows too large for shared memory and rows past
    2048 wavelengths are refused."""
    p0 = sc_mod.plan_sweep(500, 30, 30, 4, True, depth=0)
    assert (p0.depth, p0.rows, p0.npt, p0.threads) == (0, 1, 4, 128)
    for depth in (-1, 2, 3):
        with pytest.raises(ValueError, match="0 or 1 layers deep"):
            sc_mod.plan_sweep(500, 30, 30, 4, True, depth=depth)
    with pytest.raises(ValueError, match="weight rows"):
        sc_mod.plan_sweep(500, 60, 400, 8, True)
    with pytest.raises(ValueError, match="block shape"):
        sc_mod.plan_sweep(2049, 30, 30, 4, True)


def test_wrapper_counts_no_launch_on_cpu(setup):
    """On CPU tensors the wrappers run the plain twins: no launch."""
    s = setup
    before = (sc_mod.emit_kernel.launches, sc_mod.absorb_kernel.launches)
    sc_mod.emit_kernel(*(torch.tensor(s[k]) for k in ("T", "Fu", "Fd")),
                       _kappa(s, True, "torch"), s["sc_t"])
    assert (sc_mod.emit_kernel.launches,
            sc_mod.absorb_kernel.launches) == before
