"""The CUDA kernels against their plain PyTorch twins, on the card: the
emit/absorb sweeps (``csrc/sweep.cu``, for one shared planet and with
per-column constants), the whole-iteration and
whole-loop kernels (``csrc/iteration.cu``), the grouped trapezoid rebin
(``csrc/rebin.cu``), the batched kappa lookup (``csrc/kappa.cu``) and
the equilibrium chemistry table build (``csrc/chemistry.cu``, against
the host build of the same table and, under the float32 rule, a stored
copy of the JAX build's);
then ``chip_smoke.py`` phase 4f's checks on the card: the differentiable
solve (forward bit for bit the eager solve, gradients against the CPU's
at rtol 1e-8), the associative scan, the standalone drivers and
checkpoint resume on ``"cuda"`` and ``"eager"``; and a population solve
on ``"cuda"`` bit for bit its planets' own ``Grid`` solves.

Needs an NVIDIA GPU and nvcc; skipped without a GPU.  Imports no JAX,
so it runs where the JAX package is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerances, on whole output slabs and the (B, 4, L-1) quadratures:
float64 rtol 1e-10 (the kernel sums the quadratures in another order
and contracts multiply-adds into FMAs); float32 rtol 1e-4 (the same,
plus float32 rounding of expm1, rsqrt and the divisions carried along
the layer recurrence).  An absolute term of 1e-13 (float64) or 1e-7
(float32) of the largest value covers entries near zero.  A step of the
iteration kernels is held piecewise (``_hold_step``): slabs and
quadratures against the twin's sweeps, with the absorb sweep run at the
kernel's own T1, and the temperatures against the torch epilogue on the
kernel's own quadratures (rtol 1e-10 / 1e-5).  The rebin kernel sums in
float64 and is held against the float64 twin at rtol 1e-12 (float64
rows) or 1e-6 (float32 rows, one rounding of each bin); the kappa kernel
against the gather twin at rtol 1e-10 (float64) or 1e-5 plus 1e-7 of
the largest value (float32, summation order).
"""

from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from frei_tpu_torch import Grid, Planet, load_example_opacity  # noqa: E402
from frei_tpu_torch.ops import sweep_cuda as S  # noqa: E402
from frei_tpu_torch.rt.physics import PhysicsParams  # noqa: E402

B, L, W = 5, 7, 300     # W > 256: two wavelengths per thread


def _grid(dtype, dev):
    grid = Grid(Planet.from_hot_jupiter(), n_wl_bins=W, n_layers=L,
                T_ref=2400.0, dtype=dtype, device=dev)
    grid.load_opacities(opacities=load_example_opacity(
        grid, scale_factor=1.0, dtype=dtype))
    return grid


def _inputs(dtype, dev, grid=None):
    grid = grid or _grid(dtype, dev)
    p = grid.planet.physics_params()
    params = PhysicsParams(
        *(torch.as_tensor(x, dtype=dtype, device=dev)
          for x in (p.g, p.m_bar, p.alpha)), n_dof=p.n_dof)
    rng = np.random.RandomState(0)
    T = torch.as_tensor(np.asarray(grid.init_temperatures)[None, :]
                        * rng.uniform(0.9, 1.1, (B, 1)), dtype=dtype,
                        device=dev)
    Fu, Fd = (torch.as_tensor(rng.rand(B, L, W) * 1e13, dtype=dtype,
                              device=dev) for _ in range(2))
    ohs_fn, tab = grid._kappa_fn.layer_parts
    kaps = {"fused": (ohs_fn(T), tab),
            "materialized": grid._kappa_fn(T, grid._consts.pressures)
            .contiguous()}
    done = torch.tensor([False, True, False, False, True], device=dev)
    return S.make_sweep_consts(grid._consts, params), T, Fu, Fd, kaps, done


class _Consts:
    """The fields of ``RTConstants`` that ``make_sweep_consts`` reads."""

    def __init__(self, L, W, dtype, dev, rng):
        def t(a):
            return torch.as_tensor(a, dtype=dtype, device=dev)
        lam = np.geomspace(0.5e-4, 10e-4, W)          # cm
        self.pressures = t(np.geomspace(200.0, 1e-6, L) * 1e6)
        self.lam_cm = t(lam)
        self.sigma_scat = t(1e-4 * (0.5e-4 / lam) ** 4)
        self.F_toa = t(rng.uniform(0.5, 1.5, W) * 1e12)
        self.trapz_w = t(np.full(W, 1e-6) if W == 1
                         else np.gradient(lam) * rng.uniform(0.9, 1.1, W))


def _sweep_case(dtype, dev, B_, L_, W_, K, frozen):
    """Seeded sweep inputs at any shape, independent of the grid: a T(P)
    profile x U(0.9, 1.1) per column, random flux states, weight rows
    with two adjacent non-zero T weights per species (K = S x nT, as
    ``layer_interp_weights`` makes them; K = 70 is two species of 35 and
    needs three ballot chunks), positive tables, and ``frozen`` columns
    ("none", "some", "all")."""
    rng = np.random.RandomState(B_ * 1000 + L_ * 10 + W_ + K)
    consts = _Consts(L_, W_, dtype, dev, rng)
    p = PhysicsParams(*(torch.as_tensor(x, dtype=dtype, device=dev)
                        for x in (2478.0, 2.3 * 1.6605e-24, 0.1)), n_dof=5)
    sc = S.make_sweep_consts(consts, p)
    prof = 2400.0 * np.geomspace(1.6, 0.6, L_)
    T = prof[None, :] * rng.uniform(0.9, 1.1, (B_, 1))
    Fu, Fd = (rng.rand(B_, L_, W_) * 1e13 for _ in range(2))
    S_, nT = (2, K // 2) if K == 70 else (1, K)
    ohs = np.zeros((B_, L_, K))
    for s in range(S_):
        t = rng.randint(0, nT - 1, (B_, L_))
        f = rng.uniform(0.0, 1.0, (B_, L_))
        mmr = rng.uniform(1e-4, 1e-3, (B_, L_))
        bb, ll = np.meshgrid(np.arange(B_), np.arange(L_), indexing="ij")
        ohs[bb, ll, s * nT + t] = (1 - f) * mmr
        ohs[bb, ll, s * nT + t + 1] = f * mmr
    tab = rng.uniform(0.1, 3.0, (L_, K, W_)) * 10.0 ** rng.uniform(
        -2, 3, (L_, 1, W_))

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=dev).contiguous()
    ohs_t, tab_t = t(ohs), t(tab)
    kaps = {"fused": (ohs_t, tab_t),
            "materialized": (torch.einsum("blk,lkw->blw", ohs_t, tab_t)
                             + sc.sigma).contiguous()}
    done = {"none": np.zeros(B_, bool), "all": np.ones(B_, bool),
            "some": np.arange(B_) % 3 == 1}[frozen]
    return (sc, t(T), t(Fu), t(Fd), kaps,
            torch.as_tensor(done, device=dev))


# (B, L, W, K, frozen columns): every NPT (W 1 .. 2048), rows that are
# not a multiple of 16 bytes (W 33, 500 in float64 ... ), one column,
# L = 3 and 30, one and two species (K 30, 70), and the ring's plans
# from depth 0 (W 2048, float64, K 70) to the full ring
_SWEEP_CASES = {
    "B5-L7-W300-K7": None,             # the grid fixture (below)
    "B1-L3-W1-K30-none": (1, 3, 1, 30, "none"),
    "B4-L30-W33-K70-all": (4, 30, 33, 70, "all"),
    "B3-L30-W256-K30-some": (3, 30, 256, 30, "some"),
    "B6-L30-W500-K70-some": (6, 30, 500, 70, "some"),
    "B2-L3-W1000-K30-none": (2, 3, 1000, 30, "none"),
    "B3-L30-W2048-K70-some": (3, 30, 2048, 70, "some"),
    "B2-L30-W2048-K30-none": (2, 30, 2048, 30, "none"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(_SWEEP_CASES))
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("direction", ["emit", "absorb"])
def test_kernel_matches_plain_twin(direction, dtype, case):
    """Slabs and sums (and the final emit's dtaus) against the twin, fused
    and materialized opacity, with and without the freeze; repeated
    launches give identical bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the sweep kernels run only on "
                    "the card")
    dt = getattr(torch, dtype)
    dev = torch.device("cuda")
    rtol, atol = (1e-10, 1e-13) if dtype == "float64" else (1e-4, 1e-7)
    if _SWEEP_CASES[case] is None:
        sc, T, Fu, Fd, kaps, done = _inputs(dt, dev)
    else:
        sc, T, Fu, Fd, kaps, done = _sweep_case(dt, dev, *_SWEEP_CASES[case])
    wrap = S.emit_kernel if direction == "emit" else S.absorb_kernel
    plain = S.emit_plain if direction == "emit" else S.absorb_plain
    for form, kap in kaps.items():
        for d in (done, None):
            n0 = wrap.launches
            got = wrap(T, Fu, Fd, kap, sc, d)
            torch.cuda.synchronize()
            assert wrap.launches == n0 + 1
            ref = plain(T, Fu, Fd, kap, sc, d)
            for name, a, b in zip(["F_up", "F_down", "sums"], ref, got):
                a, b = a.cpu().numpy(), b.cpu().numpy()
                np.testing.assert_allclose(
                    b, a, rtol=rtol, atol=atol * float(np.abs(a).max()),
                    err_msg=f"{direction} {form} done={d is not None} "
                            f"{name}")
            if d is not None:       # frozen columns keep their rows
                assert torch.equal(got[0][d], Fu[d])
                assert torch.equal(got[1][d], Fd[d])
        if direction == "emit":     # the final emit's dtaus diagnostic
            *_, d_got = wrap(T, Fu, Fd, kap, sc, None, with_dtaus=True)
            *_, d_ref = plain(T, Fu, Fd, kap, sc, None, with_dtaus=True)
            np.testing.assert_allclose(d_got.cpu().numpy(),
                                       d_ref.cpu().numpy(), rtol=rtol,
                                       err_msg=f"{form} dtaus")
        # repeated launches give identical bits (no atomics)
        again = wrap(T, Fu, Fd, kap, sc, done)
        first = wrap(T, Fu, Fd, kap, sc, done)
        assert all(torch.equal(x, y) for x, y in zip(again, first))


def _population_consts(sc, B_, seed):
    """Per-column constants (population mode) from a shared planet's:
    each column's dtau factors divided by its own gravity factor and its
    F_toa scaled, read by the kernels at a row stride."""
    rng = np.random.RandomState(seed)

    def col(a):
        return torch.as_tensor(a, dtype=sc.c1.dtype,
                               device=sc.c1.device)[:, None]
    g = col(rng.uniform(0.4, 2.0, B_))
    f = col(rng.uniform(0.5, 1.5, B_))
    return sc._replace(
        dtf_emit=(sc.dtf_emit[None, :] / g).contiguous(),
        dtf_absorb=(sc.dtf_absorb[None, :] / g).contiguous(),
        f_toa=(sc.f_toa[None, :] * f).contiguous())


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(_SWEEP_CASES))
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("direction", ["emit", "absorb"])
def test_population_kernel_matches_plain_twin(direction, dtype, case):
    """Per-column dtau factors (B, L-1) and F_toa (B, W) against the twin
    at the shapes and tolerances above, fused and materialized, frozen
    columns kept; B copies of the shared constants give the shared
    kernel's bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the sweep kernels run only on "
                    "the card")
    dt = getattr(torch, dtype)
    dev = torch.device("cuda")
    rtol, atol = (1e-10, 1e-13) if dtype == "float64" else (1e-4, 1e-7)
    if _SWEEP_CASES[case] is None:
        sc, T, Fu, Fd, kaps, done = _inputs(dt, dev)
    else:
        sc, T, Fu, Fd, kaps, done = _sweep_case(dt, dev, *_SWEEP_CASES[case])
    B_ = T.shape[0]
    scp = _population_consts(sc, B_, B_ + Fu.shape[2])
    same = sc._replace(**{k: getattr(sc, k).expand(B_, -1).contiguous()
                          for k in ("dtf_emit", "dtf_absorb", "f_toa")})
    wrap = S.emit_kernel if direction == "emit" else S.absorb_kernel
    plain = S.emit_plain if direction == "emit" else S.absorb_plain
    kws = ({}, {"with_dtaus": True}) if direction == "emit" else ({},)
    for form, kap in kaps.items():
        for kw in kws:
            got = wrap(T, Fu, Fd, kap, scp, done, **kw)
            ref = plain(T, Fu, Fd, kap, scp, done, **kw)
            for name, a, b in zip(["F_up", "F_down", "sums", "dtaus"], ref,
                                  got):
                a, b = a.cpu().numpy(), b.cpu().numpy()
                np.testing.assert_allclose(
                    b, a, rtol=rtol, atol=atol * float(np.abs(a).max()),
                    err_msg=f"{direction} {form} {kw} {name}")
            assert torch.equal(got[0][done], Fu[done])
            shared = wrap(T, Fu, Fd, kap, sc, done, **kw)
            copies = wrap(T, Fu, Fd, kap, same, done, **kw)
            assert all(torch.equal(x, y) for x, y in zip(shared, copies)), \
                f"{form} {kw}: copies of the planet differ from the shared"


@pytest.mark.cuda
def test_kernel_rejects_bad_arguments():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the sweep kernels run only on "
                    "the card")
    sc, T, Fu, Fd, kaps, done = _inputs(torch.float32, torch.device("cuda"))
    with pytest.raises(ValueError, match="contiguous"):
        S.emit_kernel(T, Fu.transpose(1, 2).contiguous().transpose(1, 2),
                      Fd, kaps["materialized"], sc)
    with pytest.raises(TypeError):
        S.emit_kernel(T.double(), Fu, Fd, kaps["materialized"], sc)
    with pytest.raises(ValueError, match="done"):
        S.emit_kernel(T, Fu, Fd, kaps["materialized"], sc, done.float())


# --------------------------------------------------------------------------
# The whole-iteration kernels (csrc/iteration.cu)
# --------------------------------------------------------------------------

class _TableChemistry:
    """Seeded temperature-dependent ln-MMR tables (L, 6, S) on a log10 T
    grid narrower than the columns' temperatures (both clip ends)."""

    def __init__(self, L=L, S=1):
        self.L, self.S = L, S

    def layer_ln_mmr_tables(self, pressures_cgs):
        rng = np.random.RandomState(7)
        return (np.linspace(3.0, 3.4, 6),
                np.log(1e-3 * rng.uniform(0.5, 2.0, (self.L, 6, self.S))))


def _iteration_inputs(dtype, dev):
    from frei_tpu_torch.ops import iteration_cuda as IC
    grid = _grid(dtype, dev)
    sc, T, Fu, Fd, _, done = _inputs(dtype, dev, grid)
    k_tgrid, k_tab, _ = grid._kappa_fn.iteration_hook
    params = grid.planet.physics_params()
    pack = IC.make_iteration_pack(grid._consts, params, k_tgrid, k_tab,
                                  _TableChemistry())
    T = T.clone()
    T[4] *= 1.5      # hot layers past the kappa T grid: zero-filled
    return pack, params, T, Fu, Fd, done


def _iteration_case(dtype, dev, B_, L_, W_, S_, frozen, chem=None):
    """Seeded iteration inputs at any shape, independent of the grid: a
    T(P) profile x U(0.9, 1.1) per column (the hottest bottom layers past
    the kappa T grid: zero-filled), random flux states, positive layer
    tables of S_ species on 8 temperatures, the seeded chemistry tables
    (or ``chem``'s layer tables), and ``frozen`` columns ("none", "some",
    "all")."""
    from frei_tpu_torch.ops import iteration_cuda as IC
    rng = np.random.RandomState(B_ * 1000 + L_ * 10 + W_ + S_)
    consts = _Consts(L_, W_, dtype, dev, rng)
    params = PhysicsParams(*(torch.as_tensor(x, dtype=dtype, device=dev)
                             for x in (2478.0, 2.3 * 1.6605e-24, 0.1)),
                           n_dof=5)
    nT = 8
    k_tgrid = np.linspace(800.0, 4000.0, nT)
    k_tab = rng.uniform(0.1, 3.0, (L_, S_ * nT, W_)) * 10.0 ** rng.uniform(
        -2, 1, (L_, 1, W_))
    pack = IC.make_iteration_pack(
        consts, params, torch.as_tensor(k_tgrid, dtype=dtype, device=dev),
        torch.as_tensor(k_tab, dtype=dtype, device=dev),
        _TableChemistry(L_, S_) if chem is None else chem)
    prof = 2400.0 * np.geomspace(1.6, 0.6, L_)
    T = prof[None, :] * rng.uniform(0.9, 1.1, (B_, 1))
    Fu, Fd = (rng.rand(B_, L_, W_) * 1e13 for _ in range(2))
    done = {"none": np.zeros(B_, bool), "all": np.ones(B_, bool),
            "some": np.arange(B_) % 3 == 1}[frozen]

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=dev).contiguous()
    return (pack, params, t(T), t(Fu), t(Fd),
            torch.as_tensor(done, device=dev))


# (B, L, W, S, frozen columns): every NPT (W 1 .. 2048), rows that are not
# a multiple of 16 bytes (W 1, 33, 513), L = 3 and 30, one and two
# species, and the ring's plans from the flux row only (W 2048) to every
# species staged
_ITERATION_CASES = {
    "B5-L7-W300-S1-grid": None,           # the grid fixture (below)
    "B1-L3-W1-S1-none": (1, 3, 1, 1, "none"),
    "B4-L30-W33-S2-all": (4, 30, 33, 2, "all"),
    "B6-L30-W500-S2-some": (6, 30, 500, 2, "some"),
    "B3-L3-W512-S1-some": (3, 3, 512, 1, "some"),
    "B2-L30-W513-S1-none": (2, 30, 513, 1, "none"),
    "B3-L30-W2048-S2-some": (3, 30, 2048, 2, "some"),
    "B2-L30-W500-S1-none": (2, 30, 500, 1, "none"),
}


def _iteration_case_inputs(case, dtype, dev):
    if _ITERATION_CASES[case] is None:
        return _iteration_inputs(dtype, dev)
    return _iteration_case(dtype, dev, *_ITERATION_CASES[case])


def _hold_step(got, T, Fu, Fd, done, pack, params, rtol, atol, t_rtol):
    """One kernel step ``(T1, F_up, F_down, T2, dT2 or None, sums)``
    against the twin's arithmetic: the emit twin at T, the absorb twin
    at the kernel's own T1 (float32 updates of optically thin layers are
    rounding noise in any engine and must not seed the comparison), and
    the torch epilogue on the kernel's own quadratures."""
    from frei_tpu_torch.ops import iteration_cuda as IC
    T1, Fu2, Fd2, T2, dT2, sums = got
    p, pp, sc = IC._pressures(pack), IC._pinned(params, T), pack.sc
    Fu1, Fd1, s_e = S.emit_plain(T, Fu, Fd, IC._sweep_kappa(T, pack), sc,
                                 done)
    ref = S.absorb_plain(T1, Fu1, Fd1, IC._sweep_kappa(T1, pack), sc, done)
    T1_epi, _ = S.emit_epilogue(T, sums[:, 0], p, pp)
    T2_epi, dT2_epi = S.absorb_epilogue(T1, sums[:, 1], p, pp)
    checks = [("F_up", Fu2, ref[0], rtol, atol),
              ("F_down", Fd2, ref[1], rtol, atol),
              ("emit sums", sums[:, 0], s_e, rtol, atol),
              ("absorb sums", sums[:, 1], ref[2], rtol, atol),
              ("T1", T1, T1_epi, t_rtol, 0.0), ("T2", T2, T2_epi, t_rtol, 0.0)]
    if dT2 is not None:
        checks.append(("dT2", dT2, dT2_epi, t_rtol, t_rtol))
    for name, a, b, rt, at in checks:
        a, b = a.cpu().numpy(), b.cpu().numpy()
        np.testing.assert_allclose(a, b, rtol=rt,
                                   atol=at * float(np.abs(b).max()),
                                   err_msg=name)


_TOLS = {"float64": (1e-10, 1e-13, 1e-10), "float32": (1e-4, 1e-7, 1e-5)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(_ITERATION_CASES))
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_iteration_kernel_matches_plain_twin(dtype, case):
    """One RC step against the twin's arithmetic (``_hold_step``), frozen
    columns' slabs bit-identical to the inputs, identical bits on a
    repeated launch and without the quadratures diagnostic."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the iteration kernels run only "
                    "on the card")
    from frei_tpu_torch.ops import iteration_cuda as IC
    pack, params, T, Fu, Fd, done = _iteration_case_inputs(
        case, getattr(torch, dtype), torch.device("cuda"))
    n0 = IC.rc_iteration_kernel.launches
    got = IC.rc_iteration_kernel(T, Fu, Fd, done, pack, params,
                                 with_sums=True)
    torch.cuda.synchronize()
    assert IC.rc_iteration_kernel.launches == n0 + 1
    _hold_step(got, T, Fu, Fd, done, pack, params, *_TOLS[dtype])
    assert torch.equal(got[1][done], Fu[done])
    assert torch.equal(got[2][done], Fd[done])
    again = IC.rc_iteration_kernel(T, Fu, Fd, done, pack, params,
                                   with_sums=True)
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    # without the diagnostic: the same step
    plain = IC.rc_iteration_kernel(T, Fu, Fd, done, pack, params)
    assert all(torch.equal(x, y) for x, y in zip(got, plain))


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(_ITERATION_CASES))
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_loop_kernel_matches_plain_twin(dtype, case):
    """One iteration of the loop held as the iteration kernel's step; in
    float64 on the grid fixture, three iterations from zero fluxes with a
    threshold between two columns' second-iteration max|dT|, so some
    columns freeze early."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the iteration kernels run only "
                    "on the card")
    from frei_tpu_torch.ops import iteration_cuda as IC
    dt = getattr(torch, dtype)
    pack, params, T, Fu, Fd, _ = _iteration_case_inputs(
        case, dt, torch.device("cuda"))
    # one iteration: a step held as the iteration kernel's
    n0 = IC.rc_loop_kernel.launches
    tout, fu, fd, hist, maxdt, n_it, conv, sums = IC.rc_loop_kernel(
        T, Fu, Fd, pack, params, 1, 10 ** 6, 0.0, with_sums=True)
    torch.cuda.synchronize()
    assert IC.rc_loop_kernel.launches == n0 + 1
    assert torch.equal(tout, hist[:, 1]) and (n_it == 1).all()
    _hold_step((hist[:, 0], fu, fd, tout, None, sums), T, Fu, Fd, None,
               pack, params, *_TOLS[dtype])
    # no step: the state is the inputs
    got0 = IC.rc_loop_kernel(T, Fu, Fd, pack, params, 0, 10 ** 6, 0.0)
    assert torch.equal(got0[0], T) and torch.equal(got0[1], Fu) \
        and torch.equal(got0[2], Fd) and (got0[5] == 0).all()
    if dtype == "float32" or _ITERATION_CASES[case] is not None:
        return
    _hold_early_convergence(T, Fu, pack, params, 3, hold_state=True)


def _hold_early_convergence(T, Fu, pack, params, n_steps, hold_state):
    """``n_steps`` iterations from zero fluxes with a threshold between two
    columns' second-iteration max|dT|: n_iters, the converged flags and
    the history mask exact against the twin, identical bits on a repeated
    launch, and with ``hold_state`` the state at float64 tolerances (over
    several iterations the optically thin top layers' updates amplify
    the summation order, so a trajectory is held step by step in
    ``chip_smoke.py`` phase 3b; here only where it is known to hold)."""
    from frei_tpu_torch.ops import iteration_cuda as IC
    Fz = torch.zeros_like(Fu)
    probe = IC.rc_loop_plain(T, Fz, Fz, pack, params, n_steps, 10 ** 6, 0.0)
    v = torch.sort(probe[4][:, 1]).values
    cdT = float(0.5 * (v[1] + v[2]))
    got = IC.rc_loop_kernel(T, Fz, Fz, pack, params, n_steps, 2, cdT)
    ref = IC.rc_loop_plain(T, Fz, Fz, pack, params, n_steps, 2, cdT)
    assert ref[5].min() < n_steps
    assert torch.equal(got[5], ref[5]) and torch.equal(got[6], ref[6])
    assert torch.equal(got[3] != 0, ref[3] != 0)
    assert all(bool(torch.isfinite(x).all()) for x in got[:5])
    for name, a, b in zip(["temps", "F_up", "F_down", "hist", "max_dT"],
                          got if hold_state else (), ref):
        a, b = a.cpu().numpy(), b.cpu().numpy()
        np.testing.assert_allclose(a, b, rtol=1e-10,
                                   atol=1e-13 * float(np.abs(b).max()),
                                   err_msg=name)
    again = IC.rc_loop_kernel(T, Fz, Fz, pack, params, n_steps, 2, cdT)
    assert all(torch.equal(x, y) for x, y in zip(got, again))


_EQUILIBRIUM = {}


def _equilibrium_chemistry():
    """``FastChemTorch`` table mode for the three species of the JAX
    package's multi-species test (`tests/test_sweep_pallas.py:357`), then
    K, frei's fourth chemistry golden species: the default 64 x 32 table
    built on the card once per module."""
    from frei_tpu_torch.chemistry.fastchem import FastChemTorch
    if "chem" not in _EQUILIBRIUM:
        _EQUILIBRIUM["chem"] = FastChemTorch(
            ("1H2-16O", "23Na", "48Ti-16O", "39K"), 2.4 * 1.67262192369e-24)
    return _EQUILIBRIUM["chem"]


class _FirstSpecies:
    """The equilibrium tables cut to their first ``n`` species."""

    def __init__(self, chem, n):
        self.chem, self.n = chem, n

    def layer_ln_mmr_tables(self, pressures_cgs):
        grid, tab = self.chem.layer_ln_mmr_tables(pressures_cgs)
        return grid, tab[..., :self.n].contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, S_", [("float64", 1), ("float64", 3),
                                       ("float32", 1), ("float32", 3),
                                       ("float64", 4)])
@pytest.mark.parametrize("kernel", ["iteration", "loop"])
def test_whole_iteration_kernels_on_equilibrium_tables(kernel, dtype, S_):
    """One RC step of the iteration kernel, or one iteration of the loop
    kernel, on equilibrium ln-MMR tables (64 log T points) of one, three
    and (in float64, where the loop's ring stages every species) four
    species, held as above (``_hold_step``), 500 bins x 30 layers, six
    columns."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the iteration kernels run only "
                    "on the card")
    from frei_tpu_torch.ops import iteration_cuda as IC
    dt = getattr(torch, dtype)
    dev = torch.device("cuda")
    chem = _equilibrium_chemistry()
    model = chem if S_ == 4 else _FirstSpecies(chem, S_)
    pack, params, T, Fu, Fd, done = _iteration_case(dt, dev, 6, 30, 500, S_,
                                                    "some", chem=model)
    assert tuple(pack.c_tab.shape) == (30, S_, 64)
    if kernel == "iteration":
        got = IC.rc_iteration_kernel(T, Fu, Fd, done, pack, params,
                                     with_sums=True)
        _hold_step(got, T, Fu, Fd, done, pack, params, *_TOLS[dtype])
        return
    tout, fu, fd, hist, maxdt, n_it, conv, sums = IC.rc_loop_kernel(
        T, Fu, Fd, pack, params, 1, 10 ** 6, 0.0, with_sums=True)
    assert torch.equal(tout, hist[:, 1]) and (n_it == 1).all()
    _hold_step((hist[:, 0], fu, fd, tout, None, sums), T, Fu, Fd, None,
               pack, params, *_TOLS[dtype])


@pytest.mark.cuda
def test_loop_kernel_converges_early_at_the_new_layout():
    """The early-convergence case at 500 bins, 30 layers, two species and
    six columns in float64 (4 wavelengths per thread, two species
    staged): counters, flags and history mask exact against the twin."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the iteration kernels run only "
                    "on the card")
    pack, params, T, Fu, _, _ = _iteration_case(
        torch.float64, torch.device("cuda"), 6, 30, 500, 2, "none")
    _hold_early_convergence(T, Fu, pack, params, 4, hold_state=False)


@pytest.mark.cuda
def test_card_plans_of_the_float64_loop():
    """On the card, the loop kernel at 500 bins x 30 layers in float64
    holds one block an SM with the flux row alone: one species keeps the
    3-row ring it had under the 36 KB target, four species stage every
    table row (9 rows, 84,240 bytes) at that one block."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the occupancy comes from the card")
    from frei_tpu_torch.ops import iteration_cuda as IC
    F = torch.empty((1, 30, 500), dtype=torch.float64, device="cuda")
    for S_, want in ((1, IC.IterationPlan(256, 2, 1, 3, 34368)),
                     (4, IC.IterationPlan(256, 2, 1, 9, 84240))):
        plan = IC._card_plan(F, (1, 30, 500, S_), True)
        assert plan == want
        flux_row = IC.iteration_smem_bytes(30, S_, 8, 256, 2, 1, 1)
        blocks = [IC.card_blocks_per_sm(F.device, 8, True, 256, 2, n)
                  for n in (flux_row, plan.smem)]
        assert blocks == [1, 1]


@pytest.mark.cuda
def test_loop_kernel_stages_every_species(monkeypatch):
    """At the four-species float64 deployment's shape (500 bins x 30
    layers, 20 iterations from zero fluxes, the equilibrium tables of four
    species; 256 columns), the plan sized by the card stages every
    species (none read from L2 a launch) and the 3-row plan of the 36 KB
    target one (three from L2); both give the same bits: temperatures,
    fluxes, history, max|dT|, iteration counts and converged flags."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the iteration kernels run only "
                    "on the card")
    from frei_tpu_torch.ops import iteration_cuda as IC
    pack, params, T, Fu, _, _ = _iteration_case(
        torch.float64, torch.device("cuda"), 256, 30, 500, 4, "none",
        chem=_equilibrium_chemistry())
    Fz = torch.zeros_like(Fu)

    def run():
        n0 = (IC.rc_loop_kernel.launches, IC.rc_loop_kernel.l2_species)
        out = IC.rc_loop_kernel(T, Fz, Fz, pack, params, 20, 10 ** 6, 0.0)
        torch.cuda.synchronize()
        return out, (IC.rc_loop_kernel.launches - n0[0],
                     IC.rc_loop_kernel.l2_species - n0[1])

    def target(F_up, dims, loop):
        _, L_, W_, S_ = dims[:4]
        return IC.plan_iteration(W_, L_, S_, F_up.element_size(), loop)
    got, counts = run()
    assert counts == (1, 0)
    assert all(bool(torch.isfinite(x).all()) for x in got[:5])
    monkeypatch.setattr(IC, "_card_plan", target)
    assert target(Fz, (256, 30, 500, 4), True).rows == 3
    ref, counts = run()
    assert counts == (1, 3)
    names = ("temps", "F_up", "F_down", "hist", "max_dT", "n_iters",
             "converged")
    for name, a, b in zip(names, got, ref):
        assert torch.equal(a, b), name


#: eight planets (a/R*, m_bar [m_p], g [m/s^2], T*, alpha), bench.py's
#: bounds, cycled over a population's columns
_PLANETS8 = ((5.0, 2.4, 24.79, 5800.0, 1.0), (9.0, 2.4, 10.0, 4500.0, 1.5),
             (6.4, 2.4, 50.0, 6300.0, 1.0), (4.0, 2.4, 15.0, 5000.0, 0.8),
             (7.5, 2.4, 35.0, 6000.0, 1.2), (5.5, 2.4, 20.0, 5500.0, 1.0),
             (8.2, 2.4, 12.0, 4800.0, 1.4), (6.0, 2.4, 28.0, 5900.0, 0.9))


def _four_species_grid():
    """A float64 grid at 500 bins x 30 layers with the four equilibrium
    species (``_equilibrium_chemistry``) on seeded tables of distinct T
    and P dependence; its κ model has the iteration hook."""
    grid = Grid(Planet.from_hot_jupiter(), n_wl_bins=500, n_layers=30,
                T_ref=2400.0, dtype=torch.float64, device="cuda")
    g = grid.rt_grid
    chem = _equilibrium_chemistry()
    rng = np.random.RandomState(13)
    tdep = np.linspace(0.5, 1.5, 30)[:, None, None]
    pdep = np.linspace(0.8, 1.2, 30)[None, :, None]
    grid.load_opacities(opacities={
        iso: (rng.uniform(0.1, 1.0, (30, 30, 500)) * tdep * pdep
              * 10.0 ** k, g.init_temperatures, g.pressures_bar)
        for k, iso in enumerate(chem.isotopologues)}, chemistry=chem)
    assert grid._kappa_fn.iteration_hook is not None
    return grid, grid._kappa_fn


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["loop", "iteration"])
def test_population_on_whole_iteration_engines_is_each_planets_solve(
        engine):
    """A population of 8192 columns, the eight planets of ``_PLANETS8``
    cycled over them, with four species in equilibrium, float64, 20
    iterations (both exits off) through ``solve_population``'s rows
    (``f_toa_rows``, per-column g and alpha): every column bit for bit
    its planet's shared-planet solve of the same profiles on the same
    engine, one launch (a step) with per-column rows counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the iteration kernels run only "
                    "on the card")
    from frei_tpu_torch.ops import iteration_cuda as IC
    from frei_tpu_torch.rt.solver import SolverConfig, solve_rc_batched
    from frei_tpu_torch.stellar.irradiation import f_toa_rows
    grid, kappa = _four_species_grid()
    planets = [Planet(*p) for p in _PLANETS8] * 1024
    n = len(planets)
    rng = np.random.RandomState(17)
    T0 = torch.as_tensor(np.asarray(grid.init_temperatures)[None, :]
                         * rng.uniform(0.95, 1.05, (n, 1)),
                         dtype=torch.float64, device="cuda")
    col = torch.tensor([(p.T_star, p.a_rstar, p.g, p.alpha)
                        for p in planets], dtype=torch.float64,
                       device="cuda").T.contiguous()
    lam = grid.rt_grid.lam_cm
    cfg = SolverConfig(n_timesteps=20 if engine == "loop" else 5,
                       n_zero_crossings=10 ** 6, convergence_dT=0.0,
                       engine=engine)
    wrapper = IC.rc_loop_kernel if engine == "loop" \
        else IC.rc_iteration_kernel
    n0 = (wrapper.launches, wrapper.per_column)
    pop = solve_rc_batched(
        T0, grid._consts._replace(F_toa=f_toa_rows(lam, col[0], col[1],
                                                   torch.float64)),
        PhysicsParams(g=col[2], m_bar=planets[0].m_bar, alpha=col[3]),
        kappa, cfg)
    torch.cuda.synchronize()
    launches = 1 if engine == "loop" else cfg.n_timesteps
    assert (wrapper.launches - n0[0], wrapper.per_column - n0[1]) == (
        launches, launches)
    for j, p in enumerate(planets[:8]):
        row = f_toa_rows(lam, col[0, j:j + 1], col[1, j:j + 1],
                         torch.float64)[0]
        one = solve_rc_batched(T0, grid._consts._replace(F_toa=row),
                               p.physics_params(), kappa, cfg)
        torch.cuda.synchronize()
        for f in ("flux", "final_temps", "temp_history", "max_dT_history",
                  "dtaus", "loop_temps", "loop_F_up", "loop_F_down",
                  "n_iterations"):
            assert torch.equal(getattr(pop, f)[j::8],
                               getattr(one, f)[j::8]), (engine, j, f)


@pytest.mark.cuda
def test_iteration_kernels_reject_bad_arguments():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the iteration kernels run only "
                    "on the card")
    from frei_tpu_torch.ops import iteration_cuda as IC
    pack, params, T, Fu, Fd, done = _iteration_inputs(torch.float32,
                                                      torch.device("cuda"))
    with pytest.raises(ValueError, match="contiguous"):
        IC.rc_iteration_kernel(
            T, Fu.transpose(1, 2).contiguous().transpose(1, 2), Fd, done,
            pack, params)
    with pytest.raises(TypeError):
        IC.rc_loop_kernel(T.double(), Fu, Fd, pack, params, 1, 2, 3.0)
    with pytest.raises(ValueError, match="done"):
        IC.rc_iteration_kernel(T, Fu, Fd, done.float(), pack, params)
    # per-column physics: one value a column or one for all, and a g per
    # column only with the pack's per-column dtau factors
    with pytest.raises(ValueError, match="need 5 values"):
        IC.rc_loop_kernel(T, Fu, Fd, pack,
                          params._replace(alpha=torch.full((4,), 0.1)),
                          1, 2, 3.0)
    with pytest.raises(ValueError, match="per-column dtau factors"):
        IC.rc_loop_kernel(T, Fu, Fd, pack,
                          params._replace(g=torch.full((5,), params.g)),
                          1, 2, 3.0)


# --------------------------------------------------------------------------
# The equilibrium chemistry table build (csrc/chemistry.cu)
# --------------------------------------------------------------------------

_CHEM = (("1H2-16O", "23Na", "48Ti-16O", "39K"), 2.4 * 1.67262192369e-24)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 6), (6, 40)])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_chemistry_table_kernel_matches_host_build(dtype, shape):
    """The table built by the kernel (one launch) against the plain host
    build of the same table, to 1e-11 in ln VMR under both rules (they
    take the same sweeps and differ by summation order alone: 5.7e-14
    and 3.8e-15 measured on an H100); each row's sweeps equal, or one
    settle block apart; the refinished rows counted alike.  The float32
    rule is the JAX package's build: at (8, 6) its table is held against
    the JAX build's as ``test_table_matches_jax`` holds the host build,
    at rtol 1e-6, through the stored copy of it that
    ``test_stored_jax_table_is_the_jax_build`` keeps true.  A 40-point
    row takes two points a warp."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the table kernel runs only on "
                    "the card")
    from frei_tpu_torch.chemistry import fastchem as F
    from frei_tpu_torch.ops import chemistry_cuda as CC
    dt = getattr(torch, dtype)
    n0 = CC.table_kernel.launches
    card = F.FastChemTorch(*_CHEM, grid_shape=shape, dtype=dt)
    assert CC.table_kernel.launches == n0 + 1
    host = F.FastChemTorch(*_CHEM, grid_shape=shape, dtype=dt,
                           build_device="cpu")
    got, want = card._tab_lnvmr.numpy(), host._tab_lnvmr.numpy()
    assert np.abs(got - want).max() <= 1e-11
    if dtype == "float32" and shape == (8, 6):
        jax = np.load(Path(__file__).resolve().parent / "data"
                      / "chem_table_jax_8x6.npz")
        n = len(jax["species"])
        assert tuple(jax["species"]) == _CHEM[0][:n]
        np.testing.assert_allclose(got[..., :n], jax["ln_vmr"], rtol=1e-6)
    block = F.SETTLE_SWEEPS if dtype == "float64" else 0
    assert np.abs(card.row_sweeps - host.row_sweeps).max() <= block
    assert card.build_sweeps == int(card.row_sweeps.sum())
    assert card.rows_refinished == host.rows_refinished
    assert card.table_residual <= 1e-8 and host.table_residual <= 1e-8
    assert card.build_seconds > 0


@pytest.mark.cuda
def test_chemistry_table_kernel_raises_where_the_host_build_raises():
    """An unreachable T range fails the kernel build as it fails the host
    build: under the float32 rule the final closure stays above 1e-6
    (both builds, one message); under the float64 rule the hottest row of
    4-8 K still moves after 500 settle blocks (by 1.65 in the host build,
    which takes ~100 s to say so; the kernel about two seconds)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the table kernel runs only on "
                    "the card")
    from frei_tpu_torch.chemistry import fastchem as F
    kw = dict(grid_shape=(4, 3), T_range=(50.0, 100.0))
    msg = r"did not converge: final pressure-closure residual 2\.\d\de-05"
    for device in ("cuda", "cpu"):
        with pytest.raises(RuntimeError, match=msg):
            F.FastChemTorch(*_CHEM, build_device=device, **kw)
    with pytest.raises(RuntimeError, match=r"row at T = 8\.0 K still moved "
                       r"by .+ after 4000 settling sweeps"):
        F.FastChemTorch(*_CHEM, grid_shape=(2, 1), T_range=(4.0, 8.0),
                        dtype=torch.float64)


@pytest.mark.cuda
def test_chemistry_table_kernel_rejects_bad_arguments():
    """The wrapper takes CUDA float64 tables and int32 indices only."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the table kernel runs only on "
                    "the card")
    from frei_tpu_torch.chemistry import fastchem as F
    from frei_tpu_torch.ops import chemistry_cuda as CC
    static = F._prepare_static(F.load_chem_table())
    dev = torch.device("cuda")
    gs = F._GaussSeidel(static, torch.float64, "cpu", F.N_INNER)
    lists = CC.sweep_lists(static, gs, dev)
    S = static["nu"].shape[0]
    lnK = torch.zeros((2, S), dtype=torch.float64, device=dev)
    ln_P = torch.zeros(3, dtype=torch.float64, device=dev)
    idx = torch.zeros(1, dtype=torch.int32, device=dev)
    rule = dict(n_cold=60, n_warm=16, n_inner=16, refinish_tol=1e-8,
                settle=False, settle_sweeps=8, settle_tol=1e-12,
                settle_blocks=500)
    n0 = CC.table_kernel.launches
    for bad, err, match in ((dict(lnK=lnK.cpu()), RuntimeError, "CUDA"),
                            (dict(ln_P=ln_P.cpu()), RuntimeError, "CUDA"),
                            (dict(lnK=lnK.float()), TypeError, "float64"),
                            (dict(out_idx=idx.long()), TypeError, "int32"),
                            (dict(lnK=lnK[:, 1:].contiguous()), ValueError,
                             "species"),
                            (dict(ln_P=ln_P[:0]), ValueError, "points")):
        args = dict(lnK=lnK, ln_P=ln_P, out_idx=idx) | bad
        with pytest.raises(err, match=match):
            CC.table_kernel(lists, args["lnK"], args["ln_P"],
                            args["out_idx"], **rule)
    with pytest.raises(ValueError, match="at least one sweep"):
        CC.table_kernel(lists, lnK, ln_P, idx, **(rule | dict(n_warm=0)))
    assert CC.table_kernel.launches == n0


# --------------------------------------------------------------------------
# The grouped trapezoid rebin (csrc/rebin.cu)
# --------------------------------------------------------------------------

def _rebin_case(dev):
    """Ragged sizes (R = 5 rows, N = 4099 samples), samples past both
    end edges, an empty bin and a one-sample bin."""
    from frei_tpu_torch.ops import rebin_cuda as RC
    rng = np.random.RandomState(4)
    x = np.sort(rng.uniform(0.4, 11.0, 4099))
    edges = np.geomspace(0.5, 10.0, 61)
    gap = x[2001] - x[2000]
    edges = np.sort(np.concatenate([edges, [x[1000] - 1e-9, x[1000],
                                            x[2000] + gap / 3,
                                            x[2000] + 2 * gap / 3]]))
    values = rng.lognormal(0.0, 1.0, (5, 4099))
    plan = RC.make_rebin_plan(x, edges, device=dev)
    counts = (plan.stop - plan.start).cpu().numpy()
    assert 0 in counts and 1 in counts
    return RC, plan, values


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_rebin_kernel_matches_plain_twin(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the rebin kernel runs only on "
                    "the card")
    dev = torch.device("cuda")
    RC, plan, values = _rebin_case(dev)
    rows = torch.as_tensor(values, dtype=getattr(torch, dtype), device=dev)
    n0 = RC.rebin_kernel.launches
    got = RC.rebin_kernel(rows, plan)
    torch.cuda.synchronize()
    assert RC.rebin_kernel.launches == n0 + 1
    assert got.dtype == rows.dtype and got.shape == (5, plan.n_bins)
    ref = RC.rebin_plain(rows.double(), plan)
    np.testing.assert_allclose(got.double().cpu().numpy(),
                               ref.cpu().numpy(),
                               rtol=1e-12 if dtype == "float64" else 1e-6)
    empty = (plan.stop - plan.start) <= 1
    assert (got[:, empty] == 0).all()
    again = RC.rebin_kernel(rows, plan)
    assert torch.equal(got, again)       # no atomics: identical bits
    # a single row, and rows that are a slice of a larger slab
    one = RC.rebin_kernel(rows[3:4].contiguous(), plan)
    assert torch.equal(one[0], got[3])


@pytest.mark.cuda
def test_rebin_kernel_rejects_bad_arguments():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the rebin kernel runs only on "
                    "the card")
    dev = torch.device("cuda")
    RC, plan, values = _rebin_case(dev)
    rows = torch.as_tensor(values, dtype=torch.float32, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        RC.rebin_kernel(rows.t().contiguous().t(), plan)
    with pytest.raises(ValueError, match="expected"):
        RC.rebin_kernel(rows[:, 1:], plan)
    with pytest.raises(TypeError):
        RC.rebin_kernel(rows.half(), plan)
    with pytest.raises(TypeError, match="plan"):
        RC.rebin_kernel(rows, RC.make_rebin_plan(
            np.linspace(0.4, 11.0, 4099), np.geomspace(0.5, 10.0, 61)))


# --------------------------------------------------------------------------
# The batched kappa lookup (csrc/kappa.cu)
# --------------------------------------------------------------------------

def _kappa_case(dtype, dev, n_p):
    """Two species on 6 T x ``n_p`` P points, (7, 9) lookup points with
    some outside the hull, a ragged W of 300."""
    from frei_tpu_torch.opacity.tables import make_opacity_stack
    rng = np.random.RandomState(8)
    T = np.linspace(600.0, 3200.0, 6)
    P = np.logspace(-5, 2, 5)[:n_p]
    stack = make_opacity_stack(
        {"1H2-16O": (rng.rand(6, n_p, W) + 0.1, T, P),
         "12C-16O": (rng.rand(6, n_p, W) * 2, T, P)}, dtype=dtype,
        device=dev)
    temps = rng.uniform(400.0, 3400.0, (7, 9))
    press = np.tile(10.0 ** rng.uniform(0, 9, 9), (7, 1))
    if n_p == 1:
        press[:] = P[0] * 1e6
    mmr = rng.uniform(1e-5, 1e-3, (2, 7, 9))
    sig = np.linspace(1e-3, 2e-3, W)

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=dev)
    return stack, t(mmr), t(temps), t(press), t(sig)


@pytest.mark.cuda
@pytest.mark.parametrize("n_p", [5, 1], ids=["multi-P", "single-P"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_kappa_kernel_matches_plain_twin(dtype, n_p):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kappa kernel runs only on "
                    "the card")
    from frei_tpu_torch.opacity import tables
    from frei_tpu_torch.ops import kappa_cuda as KC
    dt = getattr(torch, dtype)
    stack, mmr, T, P, sig = _kappa_case(dt, torch.device("cuda"), n_p)
    n0 = KC.kappa_kernel.launches
    got, _ = tables.kappa_from_stack(stack, mmr, T, P, sig)
    torch.cuda.synchronize()
    assert KC.kappa_kernel.launches == n0 + 1      # routed to the kernel
    ref, _ = KC.kappa_plain(stack, mmr, T, P, sig)
    rtol, atol = (1e-10, 0.0) if dtype == "float64" else (1e-5, 1e-7)
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                               rtol=rtol,
                               atol=atol * float(ref.abs().max()))
    again, _ = KC.kappa_kernel(stack, mmr, T, P, sig)
    assert torch.equal(got, again)
    # "gather" forces the twin, with no launch
    try:
        tables.set_interp_mode("gather")
        plain, _ = tables.kappa_from_stack(stack, mmr, T, P, sig)
    finally:
        tables.set_interp_mode(None)
    assert torch.equal(plain, ref)
    assert KC.kappa_kernel.launches == n0 + 2


@pytest.mark.cuda
def test_kappa_kernel_rejects_bad_arguments():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kappa kernel runs only on "
                    "the card")
    from frei_tpu_torch.ops import kappa_cuda as KC
    stack, mmr, T, P, sig = _kappa_case(torch.float32,
                                        torch.device("cuda"), 5)
    with pytest.raises(TypeError):
        KC.kappa_kernel(stack, mmr, T, P, sig.double())
    with pytest.raises(ValueError, match="sigma_scat has shape"):
        KC.kappa_kernel(stack, mmr, T, P, sig[:-1])
    with pytest.raises(ValueError, match="species"):
        KC.kappa_kernel(stack, mmr[:1], T, P, sig)
    with pytest.raises(ValueError, match="nT >= 2"):
        KC.kappa_kernel(stack._replace(values=stack.values[:, :1].contiguous(),
                                       temps=stack.temps[:1]),
                        mmr, T, P, sig)
    with pytest.raises(ValueError, match="contiguous"):
        KC.kappa_kernel(stack._replace(
            values=stack.values.transpose(1, 2).contiguous().transpose(1, 2)),
            mmr, T, P, sig)


def _kappa_skew_case(case, dtype, dev):
    """The plan's edge cases on the card: W of 1, 7 or 301 (no 16-byte
    pieces) or 302 (float64 rows 16 bytes past whole 32-byte sectors: the
    warps' stores shifted onto sectors), every point in one cell (N >>
    ITEM_POINTS), every point in its own cell, every point outside the
    hull, no point at all, a one-point P axis, and more cells than the
    plan counts in shared memory (70 T x 60 P); two species on 6 T x 5 P
    points otherwise."""
    from frei_tpu_torch.opacity.tables import make_opacity_stack
    rng = np.random.RandomState(21)
    w = {"W=1": 1, "W=7": 7, "W=301": 301, "W=302": 302}.get(case, 64)
    n_t, n_p = {"single-P": (6, 1), "many-cells": (70, 60)}.get(case,
                                                                 (6, 5))
    T_ax = np.linspace(600.0, 3200.0, n_t)
    P_ax = np.logspace(-5, 2, n_p)
    stack = make_opacity_stack(
        {"1H2-16O": (rng.rand(n_t, n_p, w) + 0.1, T_ax, P_ax),
         "12C-16O": (rng.rand(n_t, n_p, w) * 2, T_ax, P_ax)}, dtype=dtype,
        device=dev)
    shape = (0, 9) if case == "empty" else (40, 30)
    T = rng.uniform(400.0, 3400.0, shape)
    P = 10.0 ** rng.uniform(0, 9, shape)
    if case == "one-cell":
        T = rng.uniform(1150.0, 1600.0, shape)
        P = rng.uniform(1e2, 5e2, shape)
    elif case == "distinct":
        i, j = np.meshgrid(np.arange(5), np.arange(4), indexing="ij")
        T = 0.5 * (T_ax[i] + T_ax[i + 1])
        P = np.sqrt(P_ax[j] * P_ax[j + 1]) * 1e6
    elif case == "outside":
        T = rng.uniform(3300.0, 5000.0, shape)
    elif case == "single-P":
        P = np.full(shape, P_ax[0] * 1e6)
    mmr = rng.uniform(1e-5, 1e-3, (2,) + T.shape)

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=dev)
    return stack, t(mmr), t(T), t(P), t(np.linspace(1e-3, 2e-3, w))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["W=1", "W=7", "W=301", "W=302",
                                  "one-cell", "distinct", "outside",
                                  "empty", "single-P", "many-cells"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_kappa_kernel_and_plan_at_the_edges(dtype, case):
    """The kernel against the gather twin (tolerances as above) at odd
    widths and skewed points, repeated launches identical, points outside
    the hull exactly sigma; its plan against the plan's twin: keys,
    fractions and offsets exact, the order a permutation that lists the
    points bucket by bucket."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kappa kernel runs only on "
                    "the card")
    from frei_tpu_torch.ops import kappa_cuda as KC
    dt = getattr(torch, dtype)
    args = _kappa_skew_case(case, dt, torch.device("cuda"))
    stack, mmr, T, P, sig = args
    got, _ = KC.kappa_kernel(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, KC.kappa_kernel(*args)[0])
    ref, _ = KC.kappa_plain(*args)
    assert got.shape == ref.shape
    rtol, atol = (1e-10, 0.0) if dtype == "float64" else (1e-5, 1e-7)
    scale = float(ref.abs().max()) if ref.numel() else 0.0
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                               rtol=rtol, atol=atol * scale)
    want = KC.kappa_plan_plain(stack, T, P)
    _, plan, _ = KC._launch(*args)
    torch.cuda.synchronize()
    M = stack.values.shape[1] * stack.values.shape[2]
    outside = (want.key == M).reshape(got.shape[:-1])
    assert (got[outside] == sig).all()
    for field in ("key", "frac", "offsets", "item_offsets"):
        assert torch.equal(getattr(plan, field), getattr(want, field)), field
    order = plan.order.long()
    assert torch.equal(torch.sort(order).values,
                       torch.arange(order.numel(), device=order.device))
    assert torch.equal(plan.key[order], want.key[want.order.long()])
    if case == "outside":
        assert outside.all()
    if case == "one-cell":
        assert (want.key == want.key[0]).all() and not outside.any()


# ---- the differentiable solve and item 13's paths on the card (phase 4f)

def _diff_setup(dev, B_=16, seed=2):
    """A float64 grid on ``dev`` and B_ columns of its profile x U(0.8,
    1.2), which stop early (after one iteration) at a 15 K threshold."""
    grid = _grid(torch.float64, dev)
    rng = np.random.RandomState(seed)
    T = torch.as_tensor(np.asarray(grid.init_temperatures)[None, :]
                        * rng.uniform(0.8, 1.2, (B_, 1)),
                        dtype=torch.float64, device=dev)
    p = grid.planet.physics_params()
    params = PhysicsParams(
        *(torch.as_tensor(x, dtype=torch.float64, device=dev)
          for x in (p.g, p.m_bar, p.alpha)), n_dof=p.n_dof)
    return grid, T, (grid._consts, params, grid._kappa_fn)


def _diff_grads(grid, T):
    """d(sum(flux w) / 1e12)/d(g, alpha, T) of the differentiable solve,
    3 iterations, exits off."""
    from frei_tpu_torch.rt.solver import SolverConfig, solve_rc_batched
    p0 = grid.planet.physics_params()
    w = torch.linspace(0.5, 1.5, W, dtype=torch.float64, device=T.device)
    x = [torch.tensor(v, dtype=torch.float64, device=T.device,
                      requires_grad=True) for v in (p0.g, p0.alpha)]
    T = T.clone().requires_grad_(True)
    par = PhysicsParams(g=x[0], m_bar=p0.m_bar, alpha=x[1], n_dof=p0.n_dof)
    flux = solve_rc_batched(T, grid._consts, par, grid._kappa_fn,
                            SolverConfig(n_timesteps=3,
                                         n_zero_crossings=10 ** 6,
                                         convergence_dT=0.0,
                                         differentiable=True)).flux
    return torch.autograd.grad((flux * w).sum() / 1e12, x + [T])


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: phase 4f's checks run on the card")


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [0, 3, 1])
def test_differentiable_forward_on_the_card(chunk):
    """The differentiable forward equals the ordinary eager solve on the
    card in every field, with columns stopping early."""
    from frei_tpu_torch.rt.solver import SolverConfig, solve_rc_batched
    _need_card()
    grid, T, args = _diff_setup(torch.device("cuda"))
    kw = dict(n_timesteps=4, convergence_dT=15.0)
    ref = solve_rc_batched(T, *args, SolverConfig(engine="eager", **kw))
    assert int(ref.n_iterations.min()) < 4
    got = solve_rc_batched(T, *args, SolverConfig(differentiable=True,
                                                  remat_chunk=chunk, **kw))
    for f in ref._fields:
        assert torch.equal(getattr(ref, f), getattr(got, f)), f
    with pytest.raises(ValueError, match="autodiff"):
        solve_rc_batched(T, *args, SolverConfig(engine="cuda",
                                                differentiable=True, **kw))


@pytest.mark.cuda
def test_differentiable_grads_card_against_cpu():
    """The card's gradients against the port's on the CPU, rtol 1e-8."""
    _need_card()
    got = _diff_grads(*_diff_setup(torch.device("cuda"), B_=4)[:2])
    want = _diff_grads(*_diff_setup(torch.device("cpu"), B_=4)[:2])
    for a, b in zip(got, want):
        assert torch.isfinite(a).all()
        b = b.numpy()
        np.testing.assert_allclose(a.cpu().numpy(), b, rtol=1e-8,
                                   atol=1e-12 * float(np.abs(b).max()))


@pytest.mark.cuda
def test_associative_scan_on_the_card():
    """``associative=True`` against the sequential scan on the card,
    4 iterations of the grid's profile: flux rtol 1e-10, temperatures
    1e-12."""
    from frei_tpu_torch.rt.solver import SolverConfig, solve_rc_batched
    _need_card()
    grid, _, args = _diff_setup(torch.device("cuda"))
    T = torch.as_tensor(grid.init_temperatures, dtype=torch.float64,
                        device="cuda")[None]
    ra = solve_rc_batched(T, *args, SolverConfig(4, engine="eager",
                                                 associative=True))
    rs = solve_rc_batched(T, *args, SolverConfig(4, engine="eager"))
    np.testing.assert_allclose(ra.flux.cpu().numpy(), rs.flux.cpu().numpy(),
                               rtol=1e-10)
    np.testing.assert_allclose(ra.final_temps.cpu().numpy(),
                               rs.final_temps.cpu().numpy(), rtol=1e-12)


@pytest.mark.cuda
@pytest.mark.parametrize("direction", ["emit", "absorb"])
def test_standalone_drivers_on_the_card(direction):
    """The standalone drivers on the card against sweeps by hand from
    the reference's self-seeds, rtol 1e-12."""
    from frei_tpu_torch import absorb, absorb_sweep, emit, emit_sweep
    from frei_tpu_torch.ops.planck import bb_flux
    _need_card()
    grid, _, (consts, params, kappa) = _diff_setup(torch.device("cuda"))
    T0 = torch.as_tensor(grid.init_temperatures, dtype=torch.float64,
                         device="cuda")
    drive, sweep = ((emit, emit_sweep) if direction == "emit"
                    else (absorb, absorb_sweep))
    r = drive(T0, consts, params, kappa, n_timesteps=3,
              convergence_thresh=0.0)
    Fu = torch.zeros((L, W), dtype=torch.float64, device="cuda")
    Fd = torch.zeros_like(Fu)
    Fd[-1] = consts.F_toa
    if direction == "absorb":
        Fu[0] = bb_flux(T0[0], consts.lam_cm)
    T, Fu, Fd = T0[None], Fu[None], Fd[None]
    for _ in range(3):
        s = sweep(T, Fu, Fd, kappa(T, consts.pressures),
                  sigma_scat=consts.sigma_scat, F_toa=consts.F_toa,
                  lam_cm=consts.lam_cm, trapz_w=consts.trapz_w,
                  pressures=consts.pressures, params=params)
        T, Fu, Fd = s.temps, s.F_up, s.F_down
    assert int(r.n_history) == 4
    for a, b in ((r.final_temps, T[0]), (r.F_up, Fu[0]), (r.F_down, Fd[0])):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                   rtol=1e-12)


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["cuda", "eager"])
def test_checkpoint_resume_on_the_card(engine, tmp_path):
    """3 iterations, saved, resumed for 3 more on the card: 6 continuous
    iterations bit for bit."""
    from frei_tpu_torch.io.checkpoint import resume_state, save_solution
    from frei_tpu_torch.rt.solver import SolverConfig, solve_rc_batched
    _need_card()
    _, T, args = _diff_setup(torch.device("cuda"))
    kw = dict(engine=engine, n_zero_crossings=10 ** 6, convergence_dT=0.0)
    full = solve_rc_batched(T, *args, SolverConfig(6, **kw))
    part = solve_rc_batched(T, *args, SolverConfig(3, **kw))
    temps, fluxes = resume_state(save_solution(tmp_path / "c.npz", part))
    resumed = solve_rc_batched(temps, *args, SolverConfig(3, **kw),
                               init_fluxes=fluxes)
    for f in ("flux", "final_temps", "F_up", "F_down"):
        assert torch.equal(getattr(full, f), getattr(resumed, f)), f


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["cuda", "iteration", "loop"])
def test_kernel_launches_are_spanned(engine):
    """Under the profiler every launch of the solver's kernels on the
    card is one ``frei.kernel.*`` span on the host, as many as the
    wrappers' ``.launches`` counted, each inside the one ``frei.solve``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from frei_tpu_torch.ops import iteration_cuda as It
    from frei_tpu_torch.rt.solver import SolverConfig, solve_rc_batched
    _need_card()
    grid, T, _ = _diff_setup(torch.device("cuda"))
    args = (grid._consts, grid.planet.physics_params(), grid._kappa_fn)
    wrappers = {"emit": S.emit_kernel, "absorb": S.absorb_kernel,
                "iteration": It.rc_iteration_kernel,
                "loop": It.rc_loop_kernel}
    before = {k: f.launches for k, f in wrappers.items()}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        solve_rc_batched(T, *args, SolverConfig(
            3, n_zero_crossings=10 ** 6, convergence_dT=0.0, engine=engine))
        torch.cuda.synchronize()
    host = [e for e in prof.events() if e.device_type == DeviceType.CPU
            and e.name.startswith("frei.")]
    (solve,) = [e.time_range for e in host if e.name == "frei.solve"]
    launched = 0
    for k, f in wrappers.items():
        spans = [e.time_range for e in host if e.name == f"frei.kernel.{k}"]
        assert len(spans) == f.launches - before[k], k
        assert all(solve.start <= s.start and s.end <= solve.end
                   for s in spans), k
        launched += len(spans)
    assert launched == {"cuda": 7, "iteration": 4, "loop": 2}[engine]


@pytest.mark.cuda
def test_population_columns_are_their_planets_grid_solves():
    """``solve_population`` of four planets on ``"cuda"``, float64, three
    iterations, its sweeps on the kernels: each column bit for bit its
    planet's own ``Grid`` solve (both F_toa rows come from the device
    builder ``stellar.irradiation.f_toa_rows``)."""
    from frei_tpu_torch.parallel import solve_population
    from frei_tpu_torch.rt.solver import SolverConfig, solve_rc_batched
    _need_card()
    dev = torch.device("cuda")
    grid = _grid(torch.float64, dev)
    planets = [Planet(*p) for p in ((5.0, 2.4, 24.79, 5800.0, 1.0),
                                    (9.0, 2.4, 10.0, 4500.0, 1.5),
                                    (6.4, 2.4, 50.0, 6300.0, 1.0),
                                    (4.0, 2.4, 15.0, 5000.0, 0.8))]
    rng = np.random.RandomState(11)
    T0 = torch.as_tensor(np.asarray(grid.init_temperatures)[None, :]
                         * rng.uniform(0.9, 1.1, (len(planets), 1)),
                         dtype=torch.float64, device=dev)
    cfg = SolverConfig(3, engine="cuda")
    launched = S.emit_kernel.launches
    res = solve_population(T0, grid, planets, cfg)
    assert S.emit_kernel.launches > launched
    for c, p in enumerate(planets):
        own = Grid(p, n_wl_bins=W, n_layers=L, T_ref=2400.0,
                   dtype=torch.float64, device=dev)
        own.load_opacities(opacities=grid.opacities)
        one = solve_rc_batched(T0[c:c + 1], own._consts, p.physics_params(),
                               own._kappa_fn, cfg)
        for f in ("flux", "final_temps", "F_up", "F_down", "dtaus",
                  "temp_history", "n_iterations"):
            assert torch.equal(getattr(res, f)[c], getattr(one, f)[0]), (c, f)
