"""Resort-rebin: grouped trapezoid reduction of high-resolution opacity
onto the run's wavelength bins.

PyTorch counterpart of ``frei_tpu.ops.rebin``, with the reference's
semantics (numba ``Trapz`` driven through pandas bin codes,
`frei/interp.py:156-202,270-307`, called per species in
`frei/opacity.py:124-148`):

* samples are assigned to right-closed bins ``(e_k, e_{k+1}]``
  (``pd.cut`` defaults, `interp.py:284`);
* adjacent sample pairs contribute a trapezoid panel ``(y_i + y_{i+1})
  / 2 * (x_{i+1} - x_i)`` only when BOTH samples fall in the same bin
  (`interp.py:181-192`) — panels straddling a bin edge are dropped;
* empty bins yield the fill value 0 (`interp.py:246-267`);
* the reference then multiplies by the bin width and 1e-3
  (`opacity.py:137-139`).

The segment sum is an ``index_add_`` over ``n_bins + 1`` slots, the last
one parking the dropped panels.  :func:`resort_rebin` is the plain twin
of the CUDA kernel in ``ops/rebin_cuda.py``.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["bin_codes", "bin_codes_np", "resort_rebin",
           "reference_bin_scaling", "grouped_aggregate"]


def bin_codes(x, edges):
    """Right-closed bin codes: x in (edges[k], edges[k+1]] -> k;
    outside any bin -> -1.  Matches ``pd.cut`` (`interp.py:284-286`)."""
    x = torch.as_tensor(x)
    edges = torch.as_tensor(edges, dtype=x.dtype, device=x.device)
    idx = torch.searchsorted(edges, x.contiguous(), right=False) - 1
    in_range = (x > edges[0]) & (x <= edges[-1])
    return torch.where(in_range, idx, -1)


def bin_codes_np(x, edges):
    """Host float64 twin of :func:`bin_codes`.

    ETL precomputation: at line-list resolution (dx/x ~ 1e-6) float32
    coordinates misplace samples within ~1 ulp of a bin edge, so bin
    ASSIGNMENT is decided on the float64 host coordinates even when the
    summation runs in float32."""
    x = np.asarray(x, np.float64)
    edges = np.asarray(edges, np.float64)
    idx = np.searchsorted(edges, x, side="left") - 1
    return np.where((x > edges[0]) & (x <= edges[-1]), idx, -1)


def resort_rebin(values, x, edges, *, codes=None, dx=None):
    """Grouped trapezoid integral of ``values`` over ``x`` per bin.

    ``values`` is (..., N) (leading axes batch over e.g. the (T, P)
    table grid), ``x`` (N,) ascending, ``edges`` (B + 1,) ascending.
    ``codes`` optionally gives precomputed bin codes (use
    :func:`bin_codes_np` when ``values`` are float32 and the coordinates
    high-resolution); ``dx`` precomputed panel widths ``diff(x)``
    (difference in float64 on the host: ``fl32(x1) - fl32(x0)`` at
    line-list resolution carries up to ~10% relative error per panel).
    With both given, ``x`` is not read and may be None.

    Returns (..., B) per-bin trapezoid integrals (0 for empty bins) in
    the dtype of ``values``.
    """
    values = torch.as_tensor(values)
    dtype, device = values.dtype, values.device
    n_bins = int(np.shape(edges)[0]) - 1
    if codes is None:
        codes = bin_codes(torch.as_tensor(x, dtype=dtype, device=device),
                          edges)
    codes = torch.as_tensor(codes, device=device)
    if dx is None:
        x = torch.as_tensor(x, dtype=dtype, device=device)
        dx = x[1:] - x[:-1]
    dx = torch.as_tensor(dx, device=device).to(dtype)
    left = codes[:-1]
    same = (left == codes[1:]) & (left >= 0)
    panels = 0.5 * (values[..., :-1] + values[..., 1:]) * dx
    panels = torch.where(same, panels, 0.0)
    seg = torch.where(same, left, n_bins)    # park dropped panels
    flat = panels.reshape(-1, panels.shape[-1])
    out = flat.new_zeros((flat.shape[0], n_bins + 1))
    out.index_add_(1, seg, flat)
    return out[:, :n_bins].reshape(panels.shape[:-1] + (n_bins,))


def reference_bin_scaling(binned, edges, dtype=None):
    """The reference's post-rebin scaling: the per-bin integral times the
    bin width and 1e-3 (`opacity.py:137-139`)."""
    edges = torch.as_tensor(edges, dtype=binned.dtype if dtype is None
                            else dtype, device=binned.device)
    width = edges[1:] - edges[:-1]
    return binned * width * 1e-3


def grouped_aggregate(values, x, edges, op: str = "trapz", *,
                      codes=None, fill=0.0):
    """Grouped aggregation of samples into wavelength bins: ``op`` in
    {"trapz", "sum", "mean", "max", "min", "count"}, batched over
    leading axes (the reference's numpy_groupies surface,
    `interp.py:223-243`).

    ``trapz`` uses the pair-within-bin semantics of
    :func:`resort_rebin`; the others aggregate the per-sample values
    whose coordinate falls in the (right-closed) bin.  Empty bins get
    ``fill``."""
    if op == "trapz":
        return resort_rebin(values, x, edges, codes=codes)
    values = torch.as_tensor(values)
    n_bins = int(np.shape(edges)[0]) - 1
    if codes is None:
        codes = bin_codes(torch.as_tensor(x, dtype=values.dtype,
                                          device=values.device), edges)
    codes = torch.as_tensor(codes, device=values.device)
    valid = codes >= 0
    seg = torch.where(valid, codes, n_bins)
    flat = values.reshape(-1, values.shape[-1])
    count = torch.zeros(n_bins + 1, dtype=values.dtype,
                        device=values.device).index_add_(
        0, seg, valid.to(values.dtype))[:n_bins]
    empty = count == 0
    out_shape = values.shape[:-1] + (n_bins,)
    if op == "count":
        return count.expand(out_shape)
    reduce = {"sum": "sum", "mean": "sum", "max": "amax", "min": "amin"}
    if op not in reduce:
        raise ValueError(f"unknown aggregation op {op!r}")
    out = flat.new_zeros((flat.shape[0], n_bins + 1))
    out = out.scatter_reduce(1, seg.expand(flat.shape), flat, reduce[op],
                             include_self=False)[:, :n_bins]
    if op == "mean":
        out = out / torch.clamp(count, min=1.0)
    return torch.where(empty, torch.as_tensor(fill, dtype=out.dtype),
                       out).reshape(out_shape)
