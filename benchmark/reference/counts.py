"""Frozen operation and byte counts of the solve's kernels, and the
published peaks they are held against.

Started from chip_smoke.py's ``SWEEP_FLOPS``, ``PEAK_BYTES``,
``PEAK_FP32``, ``sweep_bytes``, ``rc_bytes`` and ``bound``, and changed
so that a count describes the sweep's or the loop's own inputs and
outputs at the cell's shapes, whatever engine implements them: each
input byte is read once and each output byte written once; the opacity
is the layer tables (L, S*nT, W) and the table's temperatures, never a
materialized slab or weight rows; a population adds its per-column dtau
factors (B, L-1) and F_toa (B, W).

Float operations, counted from csrc/twostream.cuh ``couplers_g0`` and
the sweep body of csrc/sweep.cu (a multiply, add, subtract, division,
square root, rsqrt, expm1, log or power each counts one; an FMA two):

per (column, swept layer, wavelength), ``ELEMENT_FLOPS`` = 70 + 4 S:
  opacity row: S species x two weighted table rows, plus sigma   4 S
  dtau = kappa * dtf                                              1
  omega0 = sigma / (sigma + kappa)                                2
  Planck row: c1 / expm1(x * (1 / T))                             3
  couplers: d, rsqrt(E d), k_hat, ratio, zp, zm (9); expm1 and
    its argument (3); 1 + em (1); zm T + zp (2); chi (2); psi (2);
    chi + xi (4); the gradient term (8); s_up and s_down raw (8);
    1 / (d chi), 1 / chi, pi (1 - omega0) / (d chi) (6); xi (1);
    a, b, s_up, s_down (4)                                       50
  recurrence: two affine maps of two FMAs each                    8
  three new quadratures, one FMA each                             6
  E's polynomial (5) is needed only where omega0 > 0.1: at these
  configurations the layers outside the table's hull and a few of the
  shortest wavelengths.  It is not counted, so a share errs low by at
  most 5 / 74.

per (column, swept layer), ``LAYER_FLOPS`` = 43 + 2 S: the ΔT epilogue
of rt/physics.py (dz 4, rho 1, the lapse rate 3, the mixing length 2,
the convective flux 8, the divergence 5, the timestep 13, dT and
T - dT 3: 39), 1 / T (1) and the temperature interpolation weights
(3 + 2 S); per-configuration constants (c_p, log(p1 / p2), the dtau
factors) are not counted.
"""

from __future__ import annotations

#: NVIDIA H100 SXM data sheet, 700 W: HBM3 bytes / s, and float
#: operations / s outside the tensor cores
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}
ELEM_BYTES = {"float32": 4, "float64": 8}


def element_flops(S: int) -> int:
    return 70 + 4 * S


def layer_flops(S: int) -> int:
    return 43 + 2 * S


def sweep_flops(B, L, W, S) -> int:
    """One emit or absorb sweep: L - 1 swept layers."""
    return B * (L - 1) * (W * element_flops(S) + layer_flops(S))


def _consts_bytes(B, L, W, S, nT, per_column) -> int:
    """Elements of everything a sweep reads besides the state: the layer
    tables and their temperatures, the (W,) rows (wavelengths, trapezoid
    weights, sigma, and F_toa where it is shared), the pressures, and a
    population's per-column dtau factors and F_toa."""
    n = L * S * nT * W + nT + 3 * W + L
    n += B * (L - 1) + B * W if per_column else W
    return n


def sweep_bytes(direction, B, L, W, S, nT, elem, per_column=False,
                with_dtaus=False) -> int:
    """One sweep with no column frozen.  Reads: the temperatures and the
    flux rows it needs (emit: F_up rows 0-1 and F_down rows 0 and
    2..L-1, L + 1 rows; absorb: F_up rows 0..L-2 and F_down row L-1, L
    rows).  Writes: both (B, L, W) slabs and the new temperatures, and
    on the final emit the (B, L, W) dtaus."""
    rows = (L + 1 if direction == "emit" else L) + 2 * L
    rows += L if with_dtaus else 0
    n = rows * B * W + 2 * B * L + _consts_bytes(B, L, W, S, nT, per_column)
    return n * elem


def loop_flops(B, L, W, S, n_iters) -> int:
    """The whole fixed-horizon loop: an emit and an absorb an iteration."""
    return 2 * n_iters * sweep_flops(B, L, W, S)


def loop_bytes(B, L, W, S, nT, elem, n_iters) -> int:
    """The whole loop in one pass: the temperatures and the L + 1 flux
    rows the first emit needs in; the final slabs and temperatures, the
    (B, 2 n, L) history, the (B, n) max |dT|, the iteration counts and
    the (B, L) convergence flags out (every later sweep reads what an
    earlier one wrote)."""
    per_col = ((L + 1) + 2 * L) * W + 2 * L + 2 * n_iters * L + n_iters \
        + 1 + L
    return (B * per_col + _consts_bytes(B, L, W, S, nT, False)) * elem


def bound_s(n_bytes, n_flops, dtype="float32"):
    """(seconds, "bytes" or "operations"): the larger of the bytes over
    the HBM rate and the operations over the float peak."""
    tb, tf = n_bytes / PEAK_BYTES, n_flops / PEAK_FLOPS[dtype]
    return (tb, "bytes") if tb >= tf else (tf, "operations")
