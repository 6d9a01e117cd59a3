"""The CUDA sweep kernels against their plain PyTorch twins, on the card.

Needs an NVIDIA GPU and nvcc; skipped without a GPU.  Imports no JAX,
so it runs where the JAX package is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerances, on whole output slabs and the (B, 4, L-1) quadratures:
float64 rtol 1e-10 (the kernel sums the quadratures in another order
and contracts multiply-adds into FMAs); float32 rtol 1e-4 (the same,
plus float32 rounding of expm1, rsqrt and the divisions carried along
the layer recurrence).  An absolute term of 1e-13 (float64) or 1e-7
(float32) of the largest value covers entries near zero.
"""

import numpy as np
import pytest
import torch

from frei_tpu_torch import Grid, Planet, load_example_opacity
from frei_tpu_torch.ops import sweep_cuda as S
from frei_tpu_torch.rt.physics import PhysicsParams

B, L, W = 5, 7, 300     # W > 256: two wavelengths per thread


def _inputs(dtype, dev):
    planet = Planet.from_hot_jupiter()
    grid = Grid(planet, n_wl_bins=W, n_layers=L, T_ref=2400.0, dtype=dtype,
                device=dev)
    grid.load_opacities(opacities=load_example_opacity(
        grid, scale_factor=1.0, dtype=dtype))
    p = planet.physics_params()
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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("direction", ["emit", "absorb"])
def test_kernel_matches_plain_twin(direction, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the sweep kernels run only on "
                    "the card")
    dt = getattr(torch, dtype)
    rtol, atol = (1e-10, 1e-13) if dtype == "float64" else (1e-4, 1e-7)
    sc, T, Fu, Fd, kaps, done = _inputs(dt, torch.device("cuda"))
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
