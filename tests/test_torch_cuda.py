"""The CUDA kernels against their plain PyTorch twins, on the card: the
emit/absorb sweeps (``csrc/sweep.cu``), the whole-iteration and
whole-loop kernels (``csrc/iteration.cu``), the grouped trapezoid rebin
(``csrc/rebin.cu``) and the batched kappa lookup (``csrc/kappa.cu``).

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

import numpy as np
import pytest
import torch

from frei_tpu_torch import Grid, Planet, load_example_opacity
from frei_tpu_torch.ops import sweep_cuda as S
from frei_tpu_torch.rt.physics import PhysicsParams

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


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["tma", "persistent"])
@pytest.mark.parametrize("direction", ["emit", "absorb"])
def test_sweep_variants_give_the_sweeps_bits(direction, variant):
    """The measurement variants that compute the whole sweep (its ring
    filled by TMA bulk copies; a persistent grid, here with fewer blocks
    than the 1000 columns) give the sweep's bits, fused and materialized,
    some columns frozen."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the sweep kernels run only on "
                    "the card")
    dev = torch.device("cuda")
    sc, T, Fu, Fd, kaps, done = _sweep_case(torch.float32, dev, 1000, 30,
                                            500, 70, "some")
    for form, kap in kaps.items():
        want = S.sweep_variant(direction, "sweep", T, Fu, Fd, kap, sc, done)
        got = S.sweep_variant(direction, variant, T, Fu, Fd, kap, sc, done)
        assert all(torch.equal(x, y) for x, y in zip(got, want)), form


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


def _iteration_case(dtype, dev, B_, L_, W_, S_, frozen):
    """Seeded iteration inputs at any shape, independent of the grid: a
    T(P) profile x U(0.9, 1.1) per column (the hottest bottom layers past
    the kappa T grid: zero-filled), random flux states, positive layer
    tables of S_ species on 8 temperatures, the seeded chemistry tables,
    and ``frozen`` columns ("none", "some", "all")."""
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
        _TableChemistry(L_, S_))
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
    with pytest.raises(ValueError, match="scalar physics"):
        IC.rc_loop_kernel(T, Fu, Fd, pack,
                          params._replace(g=torch.full((5,), params.g)),
                          1, 2, 3.0)


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
