#!/usr/bin/env python3
"""Smoke run of frei_tpu_torch's main path on one NVIDIA GPU.

    python3 chip_smoke.py              # every phase (one card)
    python3 chip_smoke.py --sweeps     # build sweep.cu; phases 3, 3d, 3f
    python3 chip_smoke.py --iteration  # build iteration.cu; phases 3b, 3e
    python3 chip_smoke.py --kappa      # build kappa.cu; phase 3c's kappa part
    python3 chip_smoke.py --differentiable   # build sweep.cu; phase 4f and
                                             # phase 5's gradient leg
    python3 chip_smoke.py --parallel   # build sweep.cu, iteration.cu;
                                       # phase 4g
    python3 chip_smoke.py --ab-leg     # one leg of a parent/change pair
    python3 chip_smoke.py --ab-leg kappa   # the same, the kappa lookup alone

Phases, one report line each, any failure raising (non-zero exit):

1. device: a CUDA device must be present (no CPU fallback); prints
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``;
2. build: compiles ``frei_tpu_torch/csrc/sweep.cu``, ``csrc/iteration.cu``,
   ``csrc/rebin.cu`` and ``csrc/kappa.cu`` with nvcc and the host rebin
   library ``csrc/rebin_host.cc`` with g++, all at once, and prints the
   build time and ptxas's register report;
3. kernel parity: each sweep kernel against its plain PyTorch twin on
   the card, fused and materialized opacity, some columns frozen, emit
   both as the solve's emits run it and with the final emit's dtaus:
   float64 at 64 columns (rtol 1e-10), float32 at 8192 columns (rtol
   1e-4 on slabs, sums and the emit's dtaus; 1e-5 on temperatures, plus
   the change the sums' own difference makes to the update, see
   :func:`phase_parity`), with each kernel's time against its twin's at
   the 8192-column shape, no column frozen (the main path's inputs);
3d. where a sweep's time goes: the sweep kernels against their
   measurement variants (a copy with the same loads and stores, the
   arithmetic alone, no quadratures, the ring at depth 0, the ring
   filled by TMA bulk copies, a persistent grid; see
   :func:`phase_sweep_variants`);
3f. per-column sweeps (population mode): the sweep kernels with
   per-column dtau factors and F_toa (bench.py's population draws)
   against their twins, float64 at 64 columns (rtol 1e-10) and float32
   at 8192 (phase 3's tolerances); eight copies of one planet bit for bit
   the shared-planet kernels; the per-column sweep's time beside the
   shared one's (:func:`phase_population_sweeps`);
3b. whole-iteration parity: the iteration kernel against its twin on
   one RC step (float64 at 64 columns, every third frozen, rtol 1e-10;
   float32 at 8192 columns), and the loop kernel against its twin
   (float64 at 64 columns over 3 iterations with some columns converging
   early; float32 at 8192 columns for 1 iteration); see
   :func:`hold_step` for how a step is held; each kernel's time against
   its twin's at the headline shape; then both kernels on equilibrium
   chemistry (:func:`phase_iteration_chemistry`: ``FastChemTorch``'s
   default table for ``1H2-16O``, ``23Na``, ``48Ti-16O`` built on the
   card, its layer ln-MMR tables on 64 log T points for one and for three
   species, float64 at 64 columns, rtol 1e-10);
3e. where an RC step's time goes: the iteration kernel against its
   measurement variants (the arithmetic alone, a copy with the step's
   loads and stores, the step without its serial phases, the ring at
   depth 0) and the loop kernel with no step (the slab copy its first
   step folds in), each with its share of the bytes bound; see
   :func:`phase_iteration_variants`;
3c. the opacity plane's kernels against their twins: the rebin kernel on
   a device-resident 64-row x 2e6-sample float32 slab into the run's 500
   bins, against the float64 twin (rtol 1e-6 plus 1e-6 of the largest
   value) and the native host engine, plus ragged sizes; the kappa
   lookup kernel (:func:`phase_kappa`) in float64 at 64 columns (rtol
   1e-10) and in float32 at 8192 columns x 30 layers x 500 bins (rtol
   1e-5 plus 1e-7 of the largest value), some points outside the hull,
   and in the cases of :func:`kappa_case` (every point in one cell, on
   the table's P points, one point a cell, every point outside, odd W,
   eight species on a 28 x 23 grid; float32, some float64 too), each
   with repeated launches identical, outside points exactly sigma and
   its plan held against the plan's twin; the kappa kernel's time in 10
   rounds of 20 calls, the sha256 of its output and its measurement
   variants (the plan alone, write-only, staging only, the first
   version's gather from L2, the plan's torch twin); each kernel's time
   against its twin's, and the TPU kernels' own one-hot products timed
   as one ``torch.matmul`` each (their ``library_ms``);
4. goldens: ``Grid(planet)`` with no device named (it lands on the
   card) + the synthetic fixture +
   ``emission_spectrum(n_timesteps=1)`` reproduce the published peak
   wavelength, peak flux and effective temperature through the kernels,
   and a float64 batched solve on the kernels agrees with the eager
   engine;
4b. the same goldens through ``Grid.emission_spectra`` on the
   ``"loop"`` and ``"iteration"`` engines;
4d. population: ``solve_population`` of eight planets, float64, 3
   iterations on ``"cuda"``, each column against its planet's own
   ``Grid`` solve (rtol 1e-12, bit-equal counted) and ``"eager"`` (rtol
   1e-9) (:func:`phase_population`);
4e. equilibrium chemistry: ``Grid(planet)`` with no device named and
   ``chemistry="equilibrium"`` (the default table's build wall); float64
   solves of 64 columns x 3 iterations on ``"cuda"``, ``"iteration"``
   and ``"loop"`` against ``"eager"`` (flux rtol 1e-7 / 1e-4); the four
   maximum-VMR goldens of the exact solver on the card
   (:func:`phase_chemistry`);
4f. the differentiable solve, the associative scan, the standalone
   drivers and checkpoints (queue 1 items 11 and 13,
   :func:`phase_differentiable`), float64 at 500 bins x 30 layers: the
   differentiable forward bit for bit the ``"eager"`` solve with columns
   stopping at different iterations; gradients against central
   differences (rtol 1e-5) and against the port on the CPU (rtol 1e-8);
   ``associative=True`` against the sequential scan; ``absorb`` /
   ``emit`` against sweeps by hand (rtol 1e-12); 3 + 3 iterations
   resumed from a ``save_solution`` file bit for bit 6, on ``"cuda"``
   and ``"eager"`` (~20 s);
4c. the opacity plane end to end: two synthetic line-list stores
   (``1H2-16O``, ``12C-16O``; 8 T x 8 P x 2e6 samples, 512 MB each) under
   a fresh ``FREI_TPU_CACHE``; ``Grid(device="cuda").load_opacities(
   path=..., engine=...)`` on the ``"native"`` and ``"cuda"`` engines in
   turns, timed, the tables agreeing to rtol 1e-6; a float64 8192-column
   solve on the ``"loop"`` engine on that stack (finite flux; float32
   solves of this optically thin stack on ``"loop"``, ``"cuda"`` and
   ``"eager"`` are counted, see
   :func:`phase_etl`); ``kappa_from_stack`` through the kappa kernel at
   the final temperatures against the layer tables (rtol 1e-10).
   Launch counts are set to 0 before the path and read after it; the
   stores live in ``chip_smoke_data/`` in the checkout, removed after;
5. headline: the batched solve of 8192 columns x 500 bins x 30 layers,
   20 fixed iterations, float32, on the ``"loop"``, ``"iteration"``,
   ``"cuda"`` and ``"eager"`` engines: columns x bins per second, peak
   memory, launch counts (every count set to 0 before each engine's
   run and read after it); then the same for bench.py's two other solve
   legs: the population (bench.py's draws, one planet per column) on
   ``"cuda"`` and ``"eager"``, and the headline on phase 4e's
   equilibrium chemistry on all four engines; then bench.py's gradient
   leg (:func:`phase_gradient_leg`): d(sum flux^2)/d(T0) through the
   differentiable ``"eager"`` solve at 6144 and 8192 columns (walls split
   into forward and backward, peak memory, every launch count 0, finite
   gradients).

4g. the parallel plane (queue 1 item 14, :func:`phase_parallel`), after
   phase 5: ``parallel.solve_ensemble`` on NCCL in a world of one, a
   (1, 1) mesh at the headline on ``"loop"``, ``"iteration"`` and
   ``"cuda"``, bit for bit ``solve_rc_batched`` (sha256), both walls;
   then this file started twice (``--parallel-rank``), a world of two
   gloo ranks on this card (NCCL refuses two ranks on one card): float64
   (2, 1) and (1, 2) meshes on ``"cuda"``, (2, 1) on ``"loop"`` and
   ``"iteration"`` against one-process solves (rtol 1e-10; the top
   layer's temperature 1e-8),
   ``"iteration"`` refused on (1, 2), the sharded gradients summed over
   the ranks (rtol 1e-10), and float32 on (1, 2) at the headline (250
   bins a rank through the sweep kernels): held after one iteration,
   finite after 20, its wall and the all-reduce's share.  Every launch
   count is set to 0 before each of the plane's solves and read after.

(4d, 4e and 4f run after 4c.)  The second-to-last line is a JSON record of
the kernels (time, plain twin, bound and what bounds it, library call,
launches on the main path, and on the population, chemistry and parallel
legs); the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch

N_COLUMNS, N_BINS, N_LAYERS, N_ITERS = 8192, 500, 30, 20
PARITY64_COLUMNS = 64
# the ETL's row chunk and a line-list store's wavelength axis (the
# H2O-sized store of docs/opacities.md has 2e6 samples)
ETL_ROWS, ETL_SAMPLES = 64, 2_000_000
# the rebin kernel's timing, as the kappa kernel's: rounds of calls
REBIN_ROUNDS, REBIN_CALLS = 10, 20
# phase 4f: columns of the differentiable forward check, of the gradient
# checks; phase 5's gradient leg: bench.py's size (a 16 GB chip's
# ceiling) and the headline's
DIFF_COLUMNS, GRAD_COLUMNS = 64, 8
GRAD_LEG_COLUMNS = (6144, N_COLUMNS)
# phase 4c's stores: 8 T x 8 P rows each, cut from the reference volume's
# 28 x 23 to fit the run's time and disk
ETL_SPECIES = ("1H2-16O", "12C-16O")
ETL_TEMPS = tuple(np.linspace(500.0, 4000.0, 8))
ETL_PRESS_BAR = tuple(np.logspace(-6.0, 2.5, 8))


def log(msg):
    print(msg, flush=True)


def rel_err(got, ref):
    """Largest elementwise |got - ref| / |ref| (0 where both are 0) and
    the largest absolute error."""
    d = (got - ref).abs()
    rel = torch.where(ref != 0, d / ref.abs(),
                      torch.where(d == 0, 0.0, float("inf")))
    return float(rel.max()), float(d.max())


def check_close(name, got, ref, rtol, atol):
    """Elementwise |got - ref| <= rtol |ref| + atol, all finite.  Returns
    the largest |got - ref| / (rtol |ref| + atol): at most 1 on a pass."""
    bound = rtol * ref.abs() + atol
    d = (got - ref).abs()
    over = ~((d <= bound) | (d == 0))
    if over.any() or not torch.isfinite(got).all():
        idx = over.nonzero()[:4].tolist()
        raise AssertionError(
            f"{name}: {int(over.sum())} elements outside rtol {rtol} / "
            f"atol (first at {idx}: "
            f"{[float(got[tuple(i)]) for i in idx]} vs "
            f"{[float(ref[tuple(i)]) for i in idx]}), or non-finite")
    return float(torch.where(d == 0, 0.0, d / bound).max())


def ptxas_summary(report):
    """One line per kernel instantiation from ``nvcc -Xptxas -v``:
    registers and spills, named as ``emit<float, NPT=2, mode 0>`` or
    ``kappa_lookup<float, mode 0, 16-byte>``."""
    out, kern, spill = [], None, ""
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '.*?"
                      r"((?:emit|absorb|iteration|loop|rebin|kappa)"
                      r"(?:_[a-z]+)?)_kernel(?:I([fd]))?"
                      r"(?:Li(\d+)E)?(?:L[ib](\d+)E)?", line)
        if m and m[1].startswith("kappa"):
            args = ([{"f": "float", "d": "double"}[m[2]]] if m[2] else []) \
                + ([f"mode {m[3]}"] if m[3] else []) \
                + ([{"1": "16-byte", "0": "element-wise"}[m[4]]]
                   if m[4] else [])
            kern = m[1] + (f"<{', '.join(args)}>" if args else "")
        elif m:
            kern = (f"{m[1]}<{'float' if m[2] == 'f' else 'double'}"
                    + (f", NPT={m[3]}" if m[3] else "")
                    + (f", mode {m[4]}" if m[4] else "") + ">")
        elif "spill" in line:
            spill = line.strip()
        elif "registers" in line and kern:
            regs = re.search(r"Used (\d+) registers", line)
            out.append(f"{kern}: {regs[1]} registers; {spill}")
            kern = None
    return out or [ln.strip() for ln in report.splitlines()
                   if "registers" in ln or "spill" in ln]


def update_numerator(sums, temps, pressures, params, emit):
    """Numerator of each layer's flux divergence (Malik Eq. 23): the
    difference of the four quadratures plus the convective flux, padded
    with ones on the layer each sweep leaves unchanged.  In an optically
    thin layer it is a difference of nearly equal fluxes."""
    from frei_tpu_torch.rt import physics
    from frei_tpu_torch.rt.sweeps import top_pressure
    p = pressures
    if emit:
        T1 = temps[:, 1:]
        T2 = torch.cat([temps[:, 2:], temps[:, -1:]], dim=1)
        p1, p2 = p[1:], top_pressure(p)
    else:
        T1, T2, p1, p2 = temps[:, :-1], temps[:, 1:], p[:-1], p[1:]
    bu2, bd2, bu1, bd1 = sums.unbind(1)
    num = ((bu2 - bd2) - (bu1 - bd1)
           + physics.convective_flux(T1, T2, p1, p2, params))
    pad = torch.ones_like(num[:, :1])
    return torch.cat([pad, num] if emit else [num, pad], dim=1)


def time_ms(fn, n):
    """Mean device time of ``fn`` over ``n`` calls, after a warm-up, by
    CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def make_grid(dtype, device="cuda"):
    from frei_tpu_torch import Grid, Planet, load_example_opacity
    grid = Grid(Planet.from_hot_jupiter(), n_wl_bins=N_BINS,
                n_layers=N_LAYERS, T_ref=2400.0, dtype=dtype, device=device)
    grid.load_opacities(opacities=load_example_opacity(
        grid, scale_factor=1.0, dtype=dtype))
    return grid


def columns(grid, n, seed=0):
    """bench.py's initial profiles: the grid's T(P) x U(0.95, 1.05)."""
    rng = np.random.RandomState(seed)
    base = np.asarray(grid.rt_grid.init_temperatures)
    T0 = base[None, :] * rng.uniform(0.95, 1.05, (n, 1))
    return torch.as_tensor(T0, dtype=grid.dtype, device=grid.device)


def solver_args(grid):
    from frei_tpu_torch.rt.physics import PhysicsParams
    p = grid.planet.physics_params()
    params = PhysicsParams(
        *(torch.as_tensor(x, dtype=grid.dtype, device=grid.device)
          for x in (p.g, p.m_bar, p.alpha)), n_dof=p.n_dof)
    return grid._consts, params, grid._kappa_fn


def sweep_inputs(grid, n):
    """Sweep inputs at the main path's shapes: bench.py-like columns
    x U(0.9, 1.1), seeded random flux states of the emergent flux's
    magnitude (as frei_tpu's own kernel tests use: a random state keeps
    the temperature update well conditioned, where a state near
    equilibrium makes dT a difference of nearly equal quadratures), and
    every third column frozen."""
    consts, params, kappa_fn = solver_args(grid)
    rng = np.random.RandomState(3)
    T = columns(grid, n, seed=3) * torch.as_tensor(
        rng.uniform(0.9 / 0.95, 1.1 / 1.05, (n, 1)), dtype=grid.dtype,
        device=grid.device)
    Fu, Fd = (torch.as_tensor(rng.rand(n, N_LAYERS, N_BINS) * 1e13,
                              dtype=grid.dtype, device=grid.device)
              for _ in range(2))
    done = torch.zeros(n, dtype=torch.bool, device=grid.device)
    done[::3] = True
    ohs_fn, tab = kappa_fn.layer_parts
    kap = {"fused": (ohs_fn(T), tab),
           "materialized": kappa_fn(T, consts.pressures).contiguous()}
    return T.contiguous(), Fu, Fd, kap, done, params


def hold_sweep(label, got, ref, T, p, params, epi, emit, rtol, t_rtol,
               atol_frac):
    """One sweep's outputs against its twin's; returns (max abs error of
    slabs, sums and dtaus, max err/bound).

    Slabs and sums: rtol, plus atol_frac of the largest value for entries
    near zero.  Temperatures and dT come from the sums through the same
    torch epilogue.  At fixed T and p the update goes as sign(num)
    |num|^0.1, num the numerator of the flux divergence: a difference of
    four quadratures that nearly cancel in optically thin layers.
    Numerators that differ by r <= 0.1 move dT by at most 0.105 r |dT|, so
    dT is held at rtol plus 0.2 r |dT|.  Where r > 0.1 (float32, the
    optically thin top layers only) float32 quadratures cannot resolve the
    update in any engine: those layers are counted and must lie in the top
    three, and are not compared."""
    dtype = T.dtype
    t_got, dT_got = epi(T, got[2], p, params)
    t_ref, dT_ref = epi(T, ref[2], p, params)
    num_ref = update_numerator(ref[2], T, p, params, emit)
    num_got = update_numerator(got[2], T, p, params, emit)
    r_num = (num_got - num_ref).abs() / num_ref.abs()
    resolved = r_num <= 0.1
    t_atol = torch.where(resolved, 0.2 * dT_ref.abs() * r_num, float("inf"))
    loose = sorted(set((~resolved).nonzero()[:, 1].tolist()))
    log(f"[parity] {label} layers whose update float{dtype.itemsize * 8} "
        f"quadratures cannot resolve (r > 0.1): {int((~resolved).sum())} "
        f"of {resolved.numel()}, all in layers {loose}")
    assert all(l >= N_LAYERS - 3 for l in loose), loose
    if dtype == torch.float64:
        assert not loose, loose
    checks = [("F_up", got[0], ref[0]), ("F_down", got[1], ref[1]),
              ("sums", got[2], ref[2]), ("temps", t_got, t_ref)]
    if len(got) > 3:
        checks.append(("dtaus", got[3], ref[3]))
    if dtype == torch.float64:
        checks.append(("dT", dT_got, dT_ref))
    abs_err, worst = 0.0, 0.0
    for field, a, b in checks:
        if field in ("temps", "dT"):
            q = check_close(f"{label} {field}", a, b, t_rtol, t_atol)
            r, ab = rel_err(a[resolved], b[resolved])
            field += " (resolved layers)"
        else:
            q = check_close(f"{label} {field}", a, b, rtol,
                            atol_frac * float(b.abs().max()))
            r, ab = rel_err(a, b)
            abs_err, worst = max(abs_err, ab), max(worst, q)
        log(f"[parity] {label} {field:6s} max rel {r:.3e} max abs {ab:.3e} "
            f"max err/bound {q:.3f}")
    return abs_err, worst


def phase_parity(dtype, n, rtol, t_rtol, atol_frac, timing):
    """Each kernel against its twin; returns per-kernel records.  The
    emit kernel is held as the solve's emits run it (no dtaus: the
    instantiation that is timed) and as its final emit (with dtaus)."""
    from frei_tpu_torch.ops import sweep_cuda as S
    grid = make_grid(dtype)
    T, Fu, Fd, kaps, done, params = sweep_inputs(grid, n)
    sc = S.make_sweep_consts(grid._consts, params)
    p = grid._consts.pressures
    out = {}
    for name, wrap, plain, epi in (
            ("emit", S.emit_kernel, S.emit_plain, S.emit_epilogue),
            ("absorb", S.absorb_kernel, S.absorb_plain, S.absorb_epilogue)):
        rec = {"max_abs_err": 0.0, "err_over_tol": 0.0}
        kws = ({}, {"with_dtaus": True}) if name == "emit" else ({},)
        for form, kap in kaps.items():
            for kw in kws:
                got = wrap(T, Fu, Fd, kap, sc, done, **kw)
                torch.cuda.synchronize()
                ref = plain(T, Fu, Fd, kap, sc, done, **kw)
                label = (f"{name + ('+dtaus' if kw else ''):12s} {form:12s} "
                         f"{str(dtype):13s} B={n:5d}")
                ab, q = hold_sweep(label, got, ref, T, p, params, epi,
                                   name == "emit", rtol, t_rtol, atol_frac)
                rec["max_abs_err"] = max(rec["max_abs_err"], ab)
                rec["err_over_tol"] = max(rec["err_over_tol"], q)
            if timing:
                # the main path's inputs: no column frozen
                live = torch.zeros_like(done)
                ms = time_ms(lambda: wrap(T, Fu, Fd, kap, sc, live), 10)
                plain_ms = time_ms(lambda: plain(T, Fu, Fd, kap, sc, live),
                                   3)
                log(f"[timing] {name:6s} {form:12s} kernel {ms:.4f} ms, "
                    f"plain twin {plain_ms:.4f} ms (B={n}, L={N_LAYERS}, "
                    f"W={N_BINS}, {dtype}, no column frozen)")
                rec[f"ms_{form}"] = ms
                rec[f"plain_ms_{form}"] = plain_ms
                rec[f"bytes_{form}"] = sweep_bytes(name, kap, Fu)
        out[name] = rec
    return out


# an element of a swept layer costs about this many float operations
# (an FMA counts two, expm1, rsqrt and a division one each): the fused
# kappa row (5), dtau and omega0 (3), the Planck row (3), the g0
# couplers (55), the recurrence (8) and three quadratures (6)
SWEEP_FLOPS = 80
# NVIDIA H100 SXM peaks (data sheet, 700 W): HBM bytes/s, FP32 FLOP/s
# outside the tensor cores
PEAK_BYTES, PEAK_FP32 = 3.35e12, 67e12


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def sweep_bytes(direction, kap, Fu):
    """Bytes one sweep must move with no column frozen, each input read
    once and each output written once: emit reads F_down rows 0 and
    2..L-1 and F_up rows 0-1 (L + 1 rows), absorb F_up rows 0..L-2 and
    F_down row L-1 (L rows); both write two (B, L, W) slabs and the
    (B, 4, L-1) sums; the opacity is the (B, L, K) weight rows plus the
    (L, K, W) tables, or L - 1 rows of the materialized slab; plus
    temperatures and the (W,) rows."""
    B, L, W = Fu.shape
    e = Fu.element_size()
    rows = (L + 1 if direction == "emit" else L) + (L - 1) * (
        not isinstance(kap, tuple))
    opac = nbytes(*kap) if isinstance(kap, tuple) else 0
    return (rows + 2 * L) * B * W * e + opac + (
        B * 4 * (L - 1) + B * L + 5 * W + L - 1) * e


def rc_bytes(Fu, pack, n_iters):
    """Bytes an RC step (``n_iters`` = 1) or the whole loop must move:
    the slabs as one emit sweep reads and writes them (the absorb sweep
    reads the emit's own output, kept on chip), the temperatures in and
    the step's outputs (T1, T2, dT2; or the loop's history, max|dT|,
    counters and flags), and the pack's tables and rows once."""
    B, L, W = Fu.shape
    e = Fu.element_size()
    pack_bytes = sum(nbytes(t) for t in (*pack.sc, *pack[1:]))
    per_col = ((L + 1) + 2 * L) * W + L + (
        3 * L if n_iters == 1 else 2 * n_iters * L + n_iters + 2 * L)
    return B * per_col * e + pack_bytes


def bound(bytes_, flops):
    """(bound_ms, bound_by): the larger of bytes over the HBM rate and
    float operations over the FP32 peak."""
    tb, tf = bytes_ / PEAK_BYTES * 1e3, flops / PEAK_FP32 * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def phase_sweep_variants():
    """Where a sweep's time goes, float32 at the headline shape on the
    main path's inputs (no column frozen): the kernel against its
    variants (csrc/sweep.cu): without the quadratures, the arithmetic
    alone, a copy with the same loads and stores, the ring at depth 0
    (every load in its own layer), the ring filled by TMA bulk copies,
    and a persistent grid.  The TMA and persistent variants compute the
    whole sweep and must give its bits.  Returns {direction: {label: ms}}."""
    from frei_tpu_torch.ops import sweep_cuda as S
    grid = make_grid(torch.float32)
    T, Fu, Fd, kaps, done, params = sweep_inputs(grid, N_COLUMNS)
    sc = S.make_sweep_consts(grid._consts, params)
    live = torch.zeros_like(done)
    K = kaps["fused"][0].shape[-1]
    cases = [("sweep", "fused", {}), ("sweep", "materialized", {}),
             ("no_sums", "fused", {}), ("arith", "fused", {}),
             ("copy", "fused", {}), ("copy", "materialized", {}),
             ("copy", "fused", {"depth": 0}), ("sweep", "fused", {"depth": 0}),
             ("tma", "fused", {}), ("tma", "materialized", {}),
             ("persistent", "fused", {})]
    out = {}
    for direction in ("emit", "absorb"):
        out[direction] = {}
        for variant, form, kw in cases:
            kap = kaps[form]
            tb = sweep_bytes(direction, kap, Fu) / PEAK_BYTES * 1e3

            def run(variant=variant, kap=kap, kw=kw):
                return S.sweep_variant(direction, variant, T, Fu, Fd, kap, sc,
                                       live, **kw)
            if variant in ("tma", "persistent"):
                got, want = run(), run("sweep")
                assert all(torch.equal(x, y) for x, y in zip(got, want)), \
                    f"{direction} {variant} {form} differs from the sweep"
            plan = S.plan_sweep(N_BINS, N_LAYERS, K, 4, form == "fused",
                                **kw)
            ms = time_ms(run, 10)
            label = f"{variant} {form}" + "".join(
                f" {k}={v}" for k, v in kw.items())
            out[direction][label] = ms
            log(f"[variants] {direction:6s} {label:28s} {ms:.4f} ms, "
                f"{tb / ms:.3f} of the bytes bound ({tb:.4f} ms); plan "
                f"{plan._asdict()}")
    return out


def population_draws(n, seed=1):
    """bench.py's population leg (`bench.py:174-178`): a/R* U(4, 9), g
    U(10, 50) m s^-2, T* U(4500, 6300) K, alpha U(0.8, 1.5), from
    ``RandomState(1)``."""
    rng = np.random.RandomState(seed)
    return (rng.uniform(4.0, 9.0, n), rng.uniform(10.0, 50.0, n),
            rng.uniform(4500.0, 6300.0, n), rng.uniform(0.8, 1.5, n))


def population_args(grid, n):
    """The solver's constants and parameters for ``n`` planets of
    :func:`population_draws`, one per column: per-planet F_toa (n, W), g
    (CGS) and alpha (n,), built once as ``solve_population`` builds them,
    the grid's m_bar shared."""
    from frei_tpu_torch.stellar.irradiation import f_toa_np
    a_rstar, g_si, t_star, alpha = population_draws(n)
    lam = np.asarray(grid.rt_grid.lam_cm)
    consts, params, kappa_fn = solver_args(grid)

    def dev(x):
        return torch.as_tensor(x, dtype=grid.dtype, device=grid.device)
    f_toa = dev(np.stack([f_toa_np(lam, t, a)
                          for t, a in zip(t_star, a_rstar)]))
    return (consts._replace(F_toa=f_toa),
            params._replace(g=dev(g_si * 100.0), alpha=dev(alpha)), kappa_fn)


def phase_population_sweeps():
    """Phase 3f: the sweep kernels with per-column constants (population
    mode: dtau factors (B, L-1) and F_toa (B, W) read at a row stride)
    against their twins, fused and materialized, every third column
    frozen: float64 at 64 columns (rtol 1e-10), float32 at 8192 (phase
    3's tolerances); eight copies of one planet against the shared-planet
    kernels, bit for bit; the per-column sweep's time beside the shared
    one's (float32, 8192 columns, fused, no column frozen, in turns
    shared, per-column, per-column, shared).  Returns {direction: ms}."""
    from frei_tpu_torch.ops import sweep_cuda as S
    for dtype, n, rtol, t_rtol, atol_frac in (
            (torch.float64, PARITY64_COLUMNS, 1e-10, 1e-10, 1e-13),
            (torch.float32, N_COLUMNS, 1e-4, 1e-5, 1e-7)):
        grid = make_grid(dtype)
        T, Fu, Fd, kaps, done, _ = sweep_inputs(grid, n)
        consts, params, _ = population_args(grid, n)
        params = params._replace(g=params.g[:, None],
                                 alpha=params.alpha[:, None])
        sc = S.make_sweep_consts(consts, params)
        assert tuple(sc.dtf_emit.shape) == (n, N_LAYERS - 1)
        assert tuple(sc.f_toa.shape) == (n, N_BINS)
        p = grid._consts.pressures
        for name, wrap, plain, epi in (
                ("emit", S.emit_kernel, S.emit_plain, S.emit_epilogue),
                ("absorb", S.absorb_kernel, S.absorb_plain,
                 S.absorb_epilogue)):
            kws = ({}, {"with_dtaus": True}) if name == "emit" else ({},)
            for form, kap in kaps.items():
                for kw in kws:
                    got = wrap(T, Fu, Fd, kap, sc, done, **kw)
                    torch.cuda.synchronize()
                    ref = plain(T, Fu, Fd, kap, sc, done, **kw)
                    label = (f"population {name + ('+dtaus' if kw else '')}"
                             f" {form} {str(dtype)} B={n}")
                    hold_sweep(label, got, ref, T, p, params, epi,
                               name == "emit", rtol, t_rtol, atol_frac)

    # eight copies of the hot Jupiter: the shared kernels' bits
    grid = make_grid(torch.float32)
    T, Fu, Fd, kaps, done, params = sweep_inputs(grid, 8)
    c = grid._consts
    sc = S.make_sweep_consts(c, params)
    sc8 = S.make_sweep_consts(
        c._replace(F_toa=c.F_toa.expand(8, -1)),
        params._replace(g=params.g.expand(8, 1)))
    for form, kap in kaps.items():
        for wrap, kw in ((S.emit_kernel, {}), (S.emit_kernel,
                                               {"with_dtaus": True}),
                         (S.absorb_kernel, {})):
            a = wrap(T, Fu, Fd, kap, sc, done, **kw)
            b = wrap(T, Fu, Fd, kap, sc8, done, **kw)
            assert all(torch.equal(x, y) for x, y in zip(a, b)), \
                f"identical planets differ from the shared sweep ({form})"
    log("[population] eight identical planets: every sweep output equals "
        "the shared-planet kernel's bit for bit (fused and materialized, "
        "emit with and without dtaus, absorb)")

    # the per-column sweep's time beside the shared one's
    grid = make_grid(torch.float32)
    T, Fu, Fd, kaps, done, params = sweep_inputs(grid, N_COLUMNS)
    live = torch.zeros_like(done)
    consts, pparams, _ = population_args(grid, N_COLUMNS)
    sc = S.make_sweep_consts(grid._consts, params)
    scp = S.make_sweep_consts(consts, pparams._replace(g=pparams.g[:, None]))
    kap = kaps["fused"]
    out = {}
    for name, wrap in (("emit", S.emit_kernel), ("absorb", S.absorb_kernel)):
        times = {"shared": [], "per-column": []}
        for which in ("shared", "per-column", "per-column", "shared"):
            s = sc if which == "shared" else scp
            times[which].append(time_ms(
                lambda s=s: wrap(T, Fu, Fd, kap, s, live), 10))
        out[name] = {k: float(np.mean(v)) for k, v in times.items()}
        log(f"[timing] {name:6s} fused population (per-column dtf, F_toa) "
            f"{', '.join(f'{x:.4f}' for x in times['per-column'])} ms, "
            f"shared planet {', '.join(f'{x:.4f}' for x in times['shared'])}"
            f" ms (B={N_COLUMNS}, float32, in turns S, P, P, S)")
    return out


def sweep_digest():
    """sha256 of the sweep kernels' outputs on phase 3's float32 inputs
    (fused and materialized opacity, every third column frozen): equal
    digests on two checkouts mean bit-identical sweeps."""
    import hashlib
    from frei_tpu_torch.ops import sweep_cuda as S
    grid = make_grid(torch.float32)
    T, Fu, Fd, kaps, done, params = sweep_inputs(grid, N_COLUMNS)
    sc = S.make_sweep_consts(grid._consts, params)
    h = hashlib.sha256()
    for wrap in (S.emit_kernel, S.absorb_kernel):
        for kap in kaps.values():
            for t in wrap(T, Fu, Fd, kap, sc, done):
                h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()


def ab_leg(kappa_only=False):
    """One leg of a parent/change comparison, on whatever checkout holds
    this file: each sweep kernel's time (phase 3's float32 timing) and a
    digest of its outputs, the whole-iteration kernels' times (one RC
    step, one 20-iteration loop), the headline on the "loop",
    "iteration" and "cuda" engines, and the kappa lookup's float32
    headline (:func:`kappa_times`: rounds of calls and the output's
    sha256); with ``kappa_only`` the kappa lookup alone.  Calls only
    wrappers every checkout of the port has.  Prints one JSON line."""
    from frei_tpu_torch.ops import iteration_cuda as IC
    from frei_tpu_torch.ops import kappa_cuda as KC
    from frei_tpu_torch.ops import sweep_cuda as S
    root = str(Path(__file__).resolve().parent.name)
    if kappa_only:
        KC.build()
        ms, digest = kappa_times()
        print(json.dumps({"ab_leg": {"root": root, "kappa_ms": ms,
                                     "kappa_sha256": digest}}), flush=True)
        return
    with ThreadPoolExecutor(3) as pool:
        list(pool.map(lambda m: m.build(), (S, IC, KC)))
    recs = phase_parity(torch.float32, N_COLUMNS, 1e-4, 1e-5, 1e-7,
                        timing=True)
    whole = whole_times(plain=False)
    head = phase_headline(("loop", "iteration", "cuda"), runs=5)
    kappa_ms, kappa_digest = kappa_times()
    print(json.dumps({"ab_leg": {
        "root": root,
        "ms": {k: r["ms_fused"] for k, r in recs.items()},
        "ms_materialized": {k: r["ms_materialized"] for k, r in recs.items()},
        "sweep_sha256": sweep_digest(),
        "whole_ms": {k: r["ms"] for k, r in whole.items()},
        "walls": {e: h["walls"] for e, h in head.items()},
        "kappa_ms": kappa_ms, "kappa_sha256": kappa_digest}}), flush=True)


def hold_temps(label, got, ref, dT_ref, num_got, num_ref, t_rtol):
    """Temperatures after an update, held as phase 3 holds them: rtol
    ``t_rtol`` plus the change the quadratures' own difference makes to
    the update (numerators that differ by r <= 0.1 move dT by at most
    0.105 r |dT|); layers with r > 0.1 cannot be resolved by the
    quadratures' precision, must lie in the top three layers (none in
    float64) and are counted, not compared.  Returns max err/bound."""
    r_num = (num_got - num_ref).abs() / num_ref.abs()
    resolved = r_num <= 0.1
    t_atol = torch.where(resolved, 0.2 * dT_ref.abs() * r_num,
                         float("inf"))
    loose = sorted(set((~resolved).nonzero()[:, 1].tolist()))
    q = check_close(label, got, ref, t_rtol, t_atol)
    r, ab = rel_err(got[resolved], ref[resolved])
    log(f"[parity] {label}: layers unresolved by the quadratures "
        f"{int((~resolved).sum())} of {resolved.numel()} (layers {loose}); "
        f"resolved max rel {r:.3e} max abs {ab:.3e} max err/bound {q:.3f}")
    assert all(l >= N_LAYERS - 3 for l in loose), loose
    if got.dtype == torch.float64:
        assert not loose, loose
    return q


def hold_step(label, got, T, Fu, Fd, done, pack, params, rtol, t_rtol,
              atol_frac, max_dT=None):
    """Hold one RC step of a kernel, ``got = (T1, F_up, F_down, T2, dT2
    or None, sums)``, against the plain twin's arithmetic on the same
    inputs:

    * the emit sweep of the twin at ``T`` and its absorb sweep at the
      kernel's own T1 (so an unresolved T1 of an optically thin layer,
      rounding noise in any engine, does not move the slabs it seeds):
      slabs and both sweeps' quadratures at rtol plus atol_frac x max;
    * the in-kernel epilogue: T1, T2 and dT2 (or the loop's ``max_dT``
      of the step) against the torch epilogue on the kernel's own
      quadratures, at ``t_rtol`` (every layer);
    * T1 and T2 against the twin's, by :func:`hold_temps`.

    Returns (max abs error of slabs and sums, max err/bound)."""
    from frei_tpu_torch.ops import iteration_cuda as IC
    from frei_tpu_torch.ops import sweep_cuda as S
    T1, Fu2, Fd2, T2, dT2, sums = got
    sc, pp, p = pack.sc, IC._pinned(params, T), IC._pressures(pack)
    Fu1, Fd1, s_e = S.emit_plain(T, Fu, Fd, IC._sweep_kappa(T, pack), sc,
                                 done)
    T1_ref, dT1_ref = S.emit_epilogue(T, s_e, p, pp)
    Fu2_ref, Fd2_ref, s_a = S.absorb_plain(T1, Fu1, Fd1,
                                           IC._sweep_kappa(T1, pack), sc,
                                           done)
    T2_ref, dT2_ref = S.absorb_epilogue(T1, s_a, p, pp)
    abs_err, worst = 0.0, 0.0
    for field, a, b in (("F_up", Fu2, Fu2_ref), ("F_down", Fd2, Fd2_ref),
                        ("emit sums", sums[:, 0], s_e),
                        ("absorb sums", sums[:, 1], s_a)):
        q = check_close(f"{label} {field}", a, b, rtol,
                        atol_frac * float(b.abs().max()))
        r, ab = rel_err(a, b)
        abs_err, worst = max(abs_err, ab), max(worst, q)
        log(f"[parity] {label} {field:11s} max rel {r:.3e} max abs "
            f"{ab:.3e} max err/bound {q:.3f}")
    T1_epi, _ = S.emit_epilogue(T, sums[:, 0], p, pp)
    T2_epi, dT2_epi = S.absorb_epilogue(T1, sums[:, 1], p, pp)
    epi = [("T1", T1, T1_epi, 0.0), ("T2", T2, T2_epi, 0.0)]
    if dT2 is not None:
        epi.append(("dT2", dT2, dT2_epi,
                    t_rtol * float(dT2_epi.abs().max())))
    if max_dT is not None:
        epi.append(("max_dT", max_dT, dT2_epi.abs().amax(1), 0.0))
    for field, a, b, atol in epi:
        q = check_close(f"{label} epilogue {field}", a, b, t_rtol, atol)
        log(f"[parity] {label} in-kernel epilogue {field:3s} vs torch's on "
            f"the kernel's sums: max rel {rel_err(a, b)[0]:.3e} max "
            f"err/bound {q:.3f}")
    emit_num = (update_numerator(sums[:, 0], T, p, pp, True),
                update_numerator(s_e, T, p, pp, True))
    absorb_num = (update_numerator(sums[:, 1], T1, p, pp, False),
                  update_numerator(s_a, T1, p, pp, False))
    worst = max(worst,
                hold_temps(f"{label} T1", T1, T1_ref, dT1_ref, *emit_num,
                           t_rtol),
                hold_temps(f"{label} T2", T2, T2_ref, dT2_ref, *absorb_num,
                           t_rtol))
    return abs_err, worst


def iteration_inputs(grid, n):
    """Phase 3's sweep inputs (seeded random flux states, every third
    column frozen) and the grid's iteration pack."""
    from frei_tpu_torch.ops import iteration_cuda as IC
    T, Fu, Fd, _, done, params = sweep_inputs(grid, n)
    pack = IC.make_iteration_pack(grid._consts, params,
                                  *grid._kappa_fn.iteration_hook)
    return T, Fu, Fd, done, pack, params


def scalars(params):
    """Physics scalars as Python floats, as the solver passes them to the
    whole-iteration kernels."""
    return params._replace(g=float(params.g), m_bar=float(params.m_bar),
                           alpha=float(params.alpha))


def whole_times(plain):
    """The whole-iteration kernels' times at the headline shape, float32,
    no column frozen: one RC step of ``rc_iteration_kernel`` on phase 3's
    random states, and a 20-iteration ``rc_loop_kernel`` from the
    solver's state (bench.py's columns, zero fluxes); with ``plain``
    their twins' too.  Calls only wrappers every checkout of the port
    has.  Returns {kernel: {"ms", "bytes"[, "plain_ms"]}}."""
    from frei_tpu_torch.ops import iteration_cuda as IC
    grid = make_grid(torch.float32)
    T, Fu, Fd, done, pack, params = iteration_inputs(grid, N_COLUMNS)
    scal = scalars(params)
    live = torch.zeros_like(done)   # the main path's inputs
    it = {"ms": time_ms(lambda: IC.rc_iteration_kernel(
        T, Fu, Fd, live, pack, scal), 10), "bytes": rc_bytes(Fu, pack, 1)}
    if plain:
        it["plain_ms"] = time_ms(lambda: IC.rc_iteration_plain(
            T, Fu, Fd, live, pack, scal), 2)
    log(f"[timing] iteration kernel {it['ms']:.4f} ms"
        + (f", plain twin {it['plain_ms']:.4f} ms" if plain else "")
        + f" per RC step (B={N_COLUMNS}, L={N_LAYERS}, W={N_BINS}, "
        f"float32, no column frozen)")
    del Fu, Fd
    T0 = columns(grid, N_COLUMNS)
    Fz = torch.zeros((N_COLUMNS, N_LAYERS, N_BINS), dtype=torch.float32,
                     device=grid.device)
    loop = {"ms": time_ms(lambda: IC.rc_loop_kernel(
        T0, Fz, Fz, pack, scal, N_ITERS, 10 ** 6, 0.0), 3),
        "bytes": rc_bytes(Fz, pack, N_ITERS)}
    if plain:
        loop["plain_ms"] = time_ms(lambda: IC.rc_loop_plain(
            T0, Fz, Fz, pack, scal, N_ITERS, 10 ** 6, 0.0), 1)
    log(f"[timing] loop kernel {loop['ms']:.4f} ms"
        + (f", plain twin {loop['plain_ms']:.4f} ms" if plain else "")
        + f" per {N_ITERS}-iteration loop (B={N_COLUMNS}, L={N_LAYERS}, "
        f"W={N_BINS}, float32)")
    return {"iteration": it, "loop": loop}


def phase_iteration_variants():
    """Where an RC step's time goes, float32 at the headline shape on the
    main path's inputs (no column frozen): the iteration kernel against
    its variants (csrc/iteration.cu): the arithmetic, quadratures and
    serial phases alone, a copy with the step's loads and stores, the step
    without its serial phases, and the ring at depth 0; then the loop
    kernel with no step, the slab copy its first step folds in.  The
    "step" variant must give the wrapper's bits.  Returns {label: ms}."""
    from frei_tpu_torch.ops import iteration_cuda as IC
    grid = make_grid(torch.float32)
    T, Fu, Fd, done, pack, params = iteration_inputs(grid, N_COLUMNS)
    scal = scalars(params)
    live = torch.zeros_like(done)
    S_ = pack.k_tab.shape[1]
    tb = rc_bytes(Fu, pack, 1) / PEAK_BYTES * 1e3
    got = IC.rc_iteration_variant("step", T, Fu, Fd, live, pack, scal)
    want = IC.rc_iteration_kernel(T, Fu, Fd, live, pack, scal)
    assert all(torch.equal(x, y) for x, y in zip(got, want)), \
        "the step variant differs from the iteration kernel"
    del got, want
    out = {}
    for variant, kw in (("step", {}), ("arith", {}), ("copy", {}),
                        ("no_serial", {}), ("step", {"depth": 0}),
                        ("copy", {"depth": 0})):
        ms = time_ms(lambda v=variant, kw=kw: IC.rc_iteration_variant(
            v, T, Fu, Fd, live, pack, scal, **kw), 10)
        label = variant + "".join(f" {k}={v}" for k, v in kw.items())
        plan = IC.plan_iteration(N_BINS, N_LAYERS, S_, 4, **kw)
        out[label] = ms
        log(f"[variants] iteration {label:12s} {ms:.4f} ms, {tb / ms:.3f} "
            f"of the bytes bound ({tb:.4f} ms); plan {plan._asdict()}")
    Fz = torch.zeros_like(Fu)
    ms = time_ms(lambda: IC.rc_loop_kernel(T, Fz, Fz, pack, scal, 0, 10 ** 6,
                                           0.0), 10)
    out["loop n_timesteps=0"] = ms
    log(f"[variants] loop with no step (the slab copy): {ms:.4f} ms")
    return out


def phase_iteration_parity():
    """The whole-iteration kernels against their twins; returns
    per-kernel records with the float32 headline-shape times."""
    from frei_tpu_torch.ops import iteration_cuda as IC
    it_rec = {"max_abs_err": 0.0, "err_over_tol": 0.0}
    # one RC step: float64 at 64 columns, float32 at the headline width
    for dtype, n, rtol, t_rtol, atol_frac in (
            (torch.float64, PARITY64_COLUMNS, 1e-10, 1e-10, 1e-13),
            (torch.float32, N_COLUMNS, 1e-4, 1e-5, 1e-7)):
        T, Fu, Fd, done, pack, params = iteration_inputs(make_grid(dtype),
                                                         n)
        got = IC.rc_iteration_kernel(T, Fu, Fd, done, pack, params,
                                     with_sums=True)
        torch.cuda.synchronize()
        again = IC.rc_iteration_kernel(T, Fu, Fd, done, pack, params,
                                       with_sums=True)
        assert all(torch.equal(a, b) for a, b in zip(got, again)), \
            "repeated iteration launches differ"
        frozen = done.nonzero()[:, 0]
        assert torch.equal(got[1][frozen], Fu[frozen]) and torch.equal(
            got[2][frozen], Fd[frozen]), "frozen columns moved"
        err, q = hold_step(f"iteration {str(dtype):13s} B={n:5d}", got, T,
                           Fu, Fd, done, pack, params, rtol, t_rtol,
                           atol_frac)
        it_rec["max_abs_err"] = max(it_rec["max_abs_err"], err)
        it_rec["err_over_tol"] = max(it_rec["err_over_tol"], q)

    # the whole loop, float64: 64 columns, 3 iterations from the solver's
    # state (zero fluxes), a threshold between two columns' second
    # iteration max|dT| so that some columns freeze early
    g64 = make_grid(torch.float64)
    T = columns(g64, PARITY64_COLUMNS, seed=4)
    Fz = torch.zeros((PARITY64_COLUMNS, N_LAYERS, N_BINS),
                     dtype=torch.float64, device=g64.device)
    _, params = solver_args(g64)[:2]
    pack = IC.make_iteration_pack(g64._consts, params,
                                  *g64._kappa_fn.iteration_hook)
    probe = IC.rc_loop_plain(T, Fz, Fz, pack, params, 3, 10 ** 6, 0.0)
    v = torch.sort(probe[4][:, 1]).values
    k = PARITY64_COLUMNS // 2
    cdT = float(0.5 * (v[k] + v[k + 1]))
    # counters, flags and the history mask: exact against the twin's
    # whole loop
    ref = IC.rc_loop_plain(T, Fz, Fz, pack, params, 3, 2, cdT)
    runs = [IC.rc_loop_kernel(T, Fz, Fz, pack, params, n, 2, cdT,
                              with_sums=True) for n in range(4)]
    torch.cuda.synchronize()
    got = runs[3]
    log(f"[parity] loop float64 B={PARITY64_COLUMNS} 3 iterations, "
        f"convergence_dT {cdT:.4f} K: n_iters counts "
        f"{torch.bincount(ref[5], minlength=4).tolist()}")
    assert ref[5].min() < 3, "no column converged early"
    for field, a, b in (("n_iters", got[5], ref[5]),
                        ("converged", got[6], ref[6]),
                        ("history mask", got[3] != 0, ref[3] != 0)):
        assert torch.equal(a, b), f"loop float64 {field} differs"
    d = max(rel_err(a, b)[0] for a, b in zip(got[:5], ref[:5]))
    log(f"[parity] loop float64 whole trajectory vs the twin's: max rel "
        f"{d:.3e} (updates of the optically thin top layers amplify "
        f"summation order; held step by step below)")
    # the trajectory, step by step: a run of n iterations is the 3-
    # iteration run cut after n, and each step, from the kernel's own
    # state, is held as the iteration kernel's step is
    rec = {"max_abs_err": 0.0, "err_over_tol": 0.0}
    for n in range(1, 4):
        prev, cur = runs[n - 1], runs[n]
        assert torch.equal(cur[3][:, :2 * n], got[3][:, :2 * n]), \
            f"loop cut after {n} iterations left another history"
        live = cur[5] == n
        assert torch.equal(cur[0][~live], prev[0][~live]) and torch.equal(
            cur[1][~live], prev[1][~live]), "a converged column moved"
        err, q = hold_step(
            f"loop float64 step {n} B={int(live.sum())}",
            (cur[3][live, 2 * n - 2], cur[1][live], cur[2][live],
             cur[3][live, 2 * n - 1], None, cur[7][live]),
            prev[0][live], prev[1][live], prev[2][live], None, pack,
            params, 1e-10, 1e-10, 1e-13, max_dT=cur[4][live, n - 1])
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        rec["err_over_tol"] = max(rec["err_over_tol"], q)

    # the whole loop, float32 at the headline width, one iteration from
    # phase 3's random states: a step held as above
    T, Fu, Fd, _, pack, params = iteration_inputs(make_grid(torch.float32),
                                                  N_COLUMNS)
    got = IC.rc_loop_kernel(T, Fu, Fd, pack, params, 1, 10 ** 6, 0.0,
                            with_sums=True)
    torch.cuda.synchronize()
    tout, fu, fd, hist, maxdt, n_iters, conv, sums = got
    assert torch.equal(tout, hist[:, 1]) and (n_iters == 1).all() \
        and not conv.any()
    err, q = hold_step(f"loop 1 iteration float32 B={N_COLUMNS}",
                       (hist[:, 0], fu, fd, tout, None, sums), T, Fu, Fd,
                       None, pack, params, 1e-4, 1e-5, 1e-7,
                       max_dT=maxdt[:, 0])
    rec["max_abs_err"] = max(rec["max_abs_err"], err)
    rec["err_over_tol"] = max(rec["err_over_tol"], q)

    # times at the headline shape
    times = whole_times(plain=True)
    it_rec.update(times["iteration"])
    rec.update(times["loop"])
    it_rec["flops"] = 2 * SWEEP_FLOPS * N_COLUMNS * (N_LAYERS - 1) * N_BINS
    rec["flops"] = N_ITERS * it_rec["flops"]
    return {"iteration": it_rec, "loop": rec}


# the isotopologues of the JAX package's multi-species equilibrium test
# (`tests/test_sweep_pallas.py:357`)
CHEM_SPECIES = ("1H2-16O", "23Na", "48Ti-16O")


class FirstSpecies:
    """A layer-factored chemistry model cut to its first ``n`` species
    (the whole-iteration kernels read only ``layer_ln_mmr_tables``)."""

    def __init__(self, chem, n):
        self.chem, self.n = chem, n

    def supports_layer_factoring(self):
        return True

    def layer_ln_mmr_tables(self, pressures_cgs):
        grid, tab = self.chem.layer_ln_mmr_tables(pressures_cgs)
        return grid, tab[..., :self.n].contiguous()

    def layer_mmr_interp(self, pressures_cgs):
        fn = self.chem.layer_mmr_interp(pressures_cgs)
        return lambda temps: fn(temps)[:self.n]


def chem_stack(grid, species, seed=13):
    """A seeded stack of ``species`` on the run grid's (T, P) points, with
    distinct T and P dependence (no stores are written)."""
    from frei_tpu_torch.opacity.tables import make_opacity_stack
    g = grid.rt_grid
    rng = np.random.RandomState(seed)
    shape = (N_LAYERS, N_LAYERS, N_BINS)
    tdep = np.linspace(0.5, 1.5, N_LAYERS)[:, None, None]
    pdep = np.linspace(0.8, 1.2, N_LAYERS)[None, :, None]
    return make_opacity_stack(
        {iso: (rng.uniform(0.1, 1.0, shape) * tdep * pdep * 10.0 ** k,
               g.init_temperatures, g.pressures_bar)
         for k, iso in enumerate(species)}, dtype=grid.dtype,
        device=grid.device)


def phase_iteration_chemistry():
    """Phase 3b on equilibrium chemistry: ``FastChemTorch`` table mode for
    the three species of :data:`CHEM_SPECIES` (the default 64 x 32 table,
    built on the card), its layer ln-MMR tables (nTc = 64) in the
    whole-iteration kernels' pack for one species and for three, a seeded
    stack of those species; float64 at 64 columns, every third frozen:
    one ``rc_iteration`` step and a one-iteration ``rc_loop``, each held
    against the twin by :func:`hold_step` (rtol 1e-10).  Returns the
    build's wall and the errors per kernel."""
    from frei_tpu_torch.chemistry.fastchem import FastChemTorch
    from frei_tpu_torch.opacity.hotpath import build_kappa_model
    from frei_tpu_torch.ops import iteration_cuda as IC
    t0 = time.perf_counter()
    chem = FastChemTorch(CHEM_SPECIES, 2.4 * 1.67262192369e-24)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    log(f"[chemistry] FastChemTorch table of {CHEM_SPECIES} (64 T x 32 P) "
        f"built on the card in {wall:.2f} s, residual "
        f"{chem.table_residual:.3e}")
    grid = make_grid(torch.float64)
    c = grid._consts
    recs = {k: {"max_abs_err": 0.0, "err_over_tol": 0.0}
            for k in ("iteration", "loop")}
    for S_ in (1, 3):
        stack = chem_stack(grid, CHEM_SPECIES[:S_])
        model = chem if S_ == 3 else FirstSpecies(chem, S_)
        kappa = build_kappa_model(stack, model, c.pressures, c.sigma_scat)
        T, Fu, Fd, _, done, params = sweep_inputs(grid, PARITY64_COLUMNS)
        pack = IC.make_iteration_pack(c, params, *kappa.iteration_hook)
        assert tuple(pack.c_tgrid.shape) == (64,), pack.c_tgrid.shape
        assert tuple(pack.c_tab.shape) == (N_LAYERS, S_, 64)
        label = f"equilibrium S={S_} nTc=64 float64 B={PARITY64_COLUMNS}"
        got = IC.rc_iteration_kernel(T, Fu, Fd, done, pack, params,
                                     with_sums=True)
        torch.cuda.synchronize()
        err, q = hold_step(f"iteration {label}", got, T, Fu, Fd, done, pack,
                           params, 1e-10, 1e-10, 1e-13)
        recs["iteration"] = {"max_abs_err": max(
            recs["iteration"]["max_abs_err"], err), "err_over_tol": max(
            recs["iteration"]["err_over_tol"], q)}
        tout, fu, fd, hist, maxdt, n_it, conv, sums = IC.rc_loop_kernel(
            T, Fu, Fd, pack, params, 1, 10 ** 6, 0.0, with_sums=True)
        torch.cuda.synchronize()
        assert torch.equal(tout, hist[:, 1]) and (n_it == 1).all()
        err, q = hold_step(f"loop 1 iteration {label}",
                           (hist[:, 0], fu, fd, tout, None, sums), T, Fu, Fd,
                           None, pack, params, 1e-10, 1e-10, 1e-13,
                           max_dT=maxdt[:, 0])
        recs["loop"] = {"max_abs_err": max(recs["loop"]["max_abs_err"], err),
                        "err_over_tol": max(recs["loop"]["err_over_tol"], q)}
    return wall, recs


# the population of the JAX package's parallel tests
# (`tests/test_parallel.py:239-249`): a/R*, m_bar [m_p], g [m/s^2], T*, alpha
POPULATION8 = ((5.0, 2.4, 24.79, 5800.0, 1.0), (9.0, 2.4, 10.0, 4500.0, 1.5),
               (6.4, 2.4, 50.0, 6300.0, 1.0), (4.0, 2.4, 15.0, 5000.0, 0.8),
               (7.5, 2.4, 35.0, 6000.0, 1.2), (5.5, 2.4, 20.0, 5500.0, 1.0),
               (8.2, 2.4, 12.0, 4800.0, 1.4), (6.0, 2.4, 28.0, 5900.0, 0.9))


def phase_population():
    """Phase 4d: ``solve_population`` of the eight planets of
    :data:`POPULATION8`, float64, 3 iterations, on the ``"cuda"`` engine
    (its sweep kernels' launches counted); each column against a
    shared-planet ``Grid`` solve of its planet on ``"cuda"`` (rtol 1e-12;
    bit-equal counted) and against ``"eager"`` (rtol 1e-9)."""
    from frei_tpu_torch import Grid, Planet
    from frei_tpu_torch.ops import sweep_cuda as S
    from frei_tpu_torch.parallel import solve_population
    from frei_tpu_torch.rt.solver import SolverConfig, solve_rc_batched
    planets = [Planet(*p) for p in POPULATION8]
    grid = make_grid(torch.float64)
    rng = np.random.RandomState(11)
    T0 = torch.as_tensor(np.asarray(grid.init_temperatures)[None, :]
                         * rng.uniform(0.9, 1.1, (8, 1)),
                         dtype=torch.float64, device=grid.device)
    cfg = SolverConfig(3, engine="cuda")
    n0 = (S.emit_kernel.launches, S.absorb_kernel.launches)
    res = solve_population(T0, grid, planets, cfg)
    torch.cuda.synchronize()
    n1 = (S.emit_kernel.launches - n0[0], S.absorb_kernel.launches - n0[1])
    assert n1[0] > 0 and n1[1] > 0, "the population bypassed the kernels"
    eager = solve_population(T0, grid, planets, cfg._replace(engine="eager"))
    equal = 0
    for c, p in enumerate(planets):
        g1 = Grid(p, n_wl_bins=N_BINS, n_layers=N_LAYERS, T_ref=2400.0,
                  dtype=torch.float64, device="cuda")
        g1.load_opacities(opacities=grid.opacities)
        one = solve_rc_batched(T0[c:c + 1], g1._consts, p.physics_params(),
                               g1._kappa_fn, cfg)
        same = all(torch.equal(getattr(res, f)[c], getattr(one, f)[0])
                   for f in ("flux", "final_temps", "F_up", "F_down",
                             "dtaus", "temp_history"))
        equal += same
        for f in ("flux", "final_temps", "dtaus"):
            check_close(f"population planet {c} {f} vs its own grid",
                        getattr(res, f)[c], getattr(one, f)[0], 1e-12, 0.0)
            check_close(f"population planet {c} {f} vs eager",
                        getattr(res, f)[c], getattr(eager, f)[c], 1e-9,
                        1e-12 * float(getattr(eager, f)[c].abs().max()))
        assert torch.equal(res.n_iterations[c], one.n_iterations[0])
    fr = max(rel_err(res.flux[c], eager.flux[c])[0] for c in range(8))
    log(f"[population] solve_population of {len(planets)} planets, float64, "
        f"3 iterations on cuda (launches emit {n1[0]} absorb {n1[1]}): "
        f"{equal} of {len(planets)} columns bit-equal to their planet's own "
        f"Grid solve on cuda (all within rtol 1e-12); flux vs eager max rel "
        f"{fr:.3e} (rtol 1e-9)")


# the reference's chemistry test profile (`tests/test_fastchem.py:19-24`)
CHEM_GOLDEN_MAX_VMR = {"H2O1": 3e-4, "Na": 3e-6, "K": 1.8e-7, "O1Ti1": 1.4e-7}


def phase_chemistry():
    """Phase 4e: ``Grid(planet)`` with no device named, the fixture and
    ``chemistry="equilibrium"`` (the default 64 x 32 table, built on the
    grid's device), its build's wall; float64 solves of 64 columns x 3
    iterations on that chemistry on ``"cuda"``, ``"iteration"`` and
    ``"loop"`` against ``"eager"`` (flux rtol 1e-7 for ``"cuda"``, 1e-4
    for the others: their kernels interpolate the float32 ln-MMR tables at
    the solve's precision); the four maximum-VMR goldens of the exact
    solver on the card.  Returns (the chemistry model, its build wall)."""
    from frei_tpu_torch import Grid, Planet, load_example_opacity
    from frei_tpu_torch.chemistry.fastchem import (FastChemTorch,
                                                   equilibrium_log_pressures,
                                                   load_chem_table)
    from frei_tpu_torch.rt.solver import SolverConfig, solve_rc_batched
    wrappers = kernel_wrappers()
    grid = Grid(Planet.from_hot_jupiter(), T_ref=2400.0)
    assert grid.device.type == "cuda", grid.device
    stack = load_example_opacity(grid, scale_factor=1.0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    grid.load_opacities(opacities=stack, chemistry="equilibrium")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    chem = grid.chemistry
    assert isinstance(chem, FastChemTorch) and chem.mode == "table"
    assert tuple(chem._tab_lnvmr.shape) == (64, 32, 1)
    log(f"[chemistry] Grid(planet).load_opacities(chemistry=\"equilibrium\")"
        f": the default 64 x 32 table built on the card in {wall:.2f} s "
        f"(residual {chem.table_residual:.3e})")

    g64 = Grid(Planet.from_hot_jupiter(), n_wl_bins=N_BINS,
               n_layers=N_LAYERS, T_ref=2400.0, dtype=torch.float64,
               device="cuda")
    g64.load_opacities(opacities=load_example_opacity(
        g64, scale_factor=1.0, dtype=torch.float64), chemistry=chem)
    T0 = columns(g64, PARITY64_COLUMNS, seed=2)
    args = solver_args(g64)
    ref = solve_rc_batched(T0, *args, SolverConfig(3, engine="eager"))
    kinds = {"cuda": ("emit_sweep", "absorb_sweep"),
             "iteration": ("rc_iteration",), "loop": ("rc_loop",)}
    for engine, (f_rtol, t_rtol) in (("cuda", (1e-7, 1e-8)),
                                     ("iteration", (1e-4, 1e-5)),
                                     ("loop", (1e-4, 1e-5))):
        for w in wrappers.values():
            w.launches = 0
        got = solve_rc_batched(T0, *args, SolverConfig(3, engine=engine))
        torch.cuda.synchronize()
        assert all(wrappers[k].launches > 0 for k in kinds[engine]), engine
        qf = check_close(f"equilibrium {engine} flux", got.flux, ref.flux,
                         f_rtol, 1e-9 * float(ref.flux.abs().max()))
        qt = check_close(f"equilibrium {engine} temps", got.final_temps,
                         ref.final_temps, t_rtol, 0.0)
        log(f"[chemistry] float64 {PARITY64_COLUMNS}-column 3-iteration "
            f"solve on equilibrium chemistry, {engine} vs eager: flux max rel "
            f"{rel_err(got.flux, ref.flux)[0]:.3e} (rtol {f_rtol}, err/bound "
            f"{qf:.3f}), temps max rel "
            f"{rel_err(got.final_temps, ref.final_temps)[0]:.3e} (rtol "
            f"{t_rtol}, err/bound {qt:.3f})")
    k = g64._kappa_fn(T0, g64._consts.pressures)[0, :, N_BINS // 2]
    assert float((k.max() - k.min()) / k.mean()) > 1e-3, "constant chemistry"

    # the goldens: the exact solver on the card, the reference's profile
    P_bar = np.logspace(-6, 2, 100)
    table = load_chem_table()
    ln_p, _ = equilibrium_log_pressures(
        table, torch.tensor(2400.0 * (P_bar / 0.1) ** 0.1, device="cuda"),
        torch.tensor(P_bar, device="cuda"))
    for hill, want in CHEM_GOLDEN_MAX_VMR.items():
        i = table.species_index(hill)
        got = float((torch.exp(ln_p[:, i]).cpu() / torch.tensor(P_bar)).max())
        log(f"[chemistry] max VMR of {hill} over the reference profile, exact "
            f"solve on the card: {got:.4e} (golden {want:.1e}, rtol 0.1)")
        assert abs(got - want) <= 0.1 * want, (hill, got, want)
    return chem, wall


def phase_goldens_whole(engine):
    """The goldens through ``Grid.emission_spectra`` on ``engine``."""
    from frei_tpu_torch import Spectrum, effective_temperature
    from frei_tpu_torch.ops import iteration_cuda as IC
    wrap = {"loop": IC.rc_loop_kernel,
            "iteration": IC.rc_iteration_kernel}[engine]
    grid = make_grid(torch.float32)
    n0 = wrap.launches
    spec, temps, hist, dtaus = grid.emission_spectra(
        np.asarray(grid.init_temperatures)[None, :], n_timesteps=1,
        engine=engine)
    n = wrap.launches - n0
    flux = spec.flux_cgs[0]
    i = int(np.argmax(flux))
    lam_peak, peak = float(spec.wavelength_um[i]), float(flux[i])
    T_eff = effective_temperature(
        grid, Spectrum(wavelength_um=spec.wavelength_um, flux_cgs=flux),
        dtaus[0], temps[0])
    log(f"[goldens] engine={engine}: peak {lam_peak:.4f} um, flux "
        f"{peak:.4e} erg/s/cm^3, T_eff {T_eff:.1f} K, {engine} kernel "
        f"launches {n}")
    assert abs(lam_peak - 1.1518) < 0.02, lam_peak
    assert abs(peak - 1.296e13) < 0.1e13, peak
    assert abs(T_eff - 2400.0) < 200.0, T_eff
    assert n > 0, f"goldens on {engine} bypassed its kernel"
    assert hist.shape == (1, N_LAYERS, 2)


def phase_goldens():
    from frei_tpu_torch import (Grid, Planet, effective_temperature,
                                load_example_opacity)
    from frei_tpu_torch.ops import sweep_cuda as S
    from frei_tpu_torch.rt.solver import SolverConfig, solve_rc_batched
    # the user's call: no device named, so the grid lands on the card
    grid = Grid(Planet.from_hot_jupiter(), T_ref=2400.0)
    assert grid.device.type == "cuda", grid.device
    grid.load_opacities(opacities=load_example_opacity(grid,
                                                       scale_factor=1.0))
    n0 = (S.emit_kernel.launches, S.absorb_kernel.launches)
    spec, temps, hist, dtaus = grid.emission_spectrum(n_timesteps=1)
    n1 = (S.emit_kernel.launches, S.absorb_kernel.launches)
    i = int(np.argmax(spec.flux_cgs))
    lam_peak, peak = float(spec.wavelength_um[i]), float(spec.flux_cgs[i])
    T_eff = effective_temperature(grid, spec, dtaus, temps)
    log(f"[goldens] peak {lam_peak:.4f} um, flux {peak:.4e} erg/s/cm^3, "
        f"T_eff {T_eff:.1f} K, launches emit {n1[0] - n0[0]} absorb "
        f"{n1[1] - n0[1]}")
    assert abs(lam_peak - 1.1518) < 0.02, lam_peak
    assert abs(peak - 1.296e13) < 0.1e13, peak
    assert abs(T_eff - 2400.0) < 200.0, T_eff
    assert n1[0] > n0[0] and n1[1] > n0[1], "goldens bypassed the kernels"
    assert hist.shape == (N_LAYERS, 2)

    # end to end on the kernels vs the eager engine, float64: frei_tpu's
    # own Pallas-vs-XLA trajectory test (2 iterations, same tolerances)
    g64 = make_grid(torch.float64)
    T0 = columns(g64, 16, seed=1)
    args = solver_args(g64)
    rk = solve_rc_batched(T0, *args, SolverConfig(2, engine="cuda"))
    re = solve_rc_batched(T0, *args, SolverConfig(2, engine="eager"))
    fr = rel_err(rk.flux, re.flux)[0]
    tr = rel_err(rk.final_temps, re.final_temps)[0]
    dr = rel_err(rk.dtaus, re.dtaus)[0]
    log(f"[goldens] float64 16-column 2-iteration solve, cuda vs eager: "
        f"flux max rel {fr:.3e}, temps max rel {tr:.3e}, dtaus max rel "
        f"{dr:.3e}")
    check_close("solve flux", rk.flux, re.flux, 1e-7,
                1e-9 * float(re.flux.abs().max()))
    check_close("solve dtaus", rk.dtaus, re.dtaus, 1e-10, 0.0)
    check_close("solve temps", rk.final_temps, re.final_temps, 1e-8, 0.0)
    assert torch.equal(rk.n_iterations, re.n_iterations)


def opacity_inputs(dtype, n, seed=5):
    """Kappa lookup inputs at the main path's shapes: a seeded
    two-species stack on the run grid's (T, P) points with distinct T and
    P dependence, the columns of :func:`columns` x U(0.9, 1.1) with every
    16th column at 1.6x and every 16th (offset 8) at 0.5x (outside the T
    hull), the layer pressures x U(0.5, 2) per point (outside the P hull
    at both ends), seeded mixing ratios and the grid's sigma."""
    from frei_tpu_torch.opacity.tables import make_opacity_stack
    grid = make_grid(dtype)
    g = grid.rt_grid
    rng = np.random.RandomState(seed)
    shape = (N_LAYERS, N_LAYERS, N_BINS)
    tdep = np.linspace(0.5, 1.5, N_LAYERS)[:, None, None]
    pdep = np.linspace(0.8, 1.2, N_LAYERS)[None, :, None]
    tables = {iso: (rng.uniform(0.1, 1.0, shape) * tdep * pdep * (k + 1),
                    g.init_temperatures, g.pressures_bar)
              for k, iso in enumerate(ETL_SPECIES)}
    stack = make_opacity_stack(tables, dtype=dtype, device=grid.device)
    T = columns(grid, n, seed=seed) * torch.as_tensor(
        rng.uniform(0.9, 1.1, (n, 1)), dtype=dtype, device=grid.device)
    T[::16] *= 1.6
    T[8::16] *= 0.5
    P = grid._consts.pressures * torch.as_tensor(
        rng.uniform(0.5, 2.0, (n, N_LAYERS)), dtype=dtype,
        device=grid.device)
    mmr = torch.as_tensor(rng.uniform(1e-5, 1e-3, (2, n, N_LAYERS)),
                          dtype=dtype, device=grid.device)
    return stack, mmr, T.contiguous(), P.contiguous(), grid._consts.sigma_scat


def phase_opacity_parity(edges_um):
    """The rebin and kappa kernels against their twins; returns
    per-kernel records with their times and their twins' at the main
    path's shapes."""
    from frei_tpu_torch.native import grouped_trapezoid_native
    from frei_tpu_torch.ops import rebin_cuda as RC
    dev = torch.device("cuda")
    rec = {"rebin": {"max_abs_err": 0.0, "err_over_tol": 0.0}}

    def hold(kernel, label, got, ref, rtol, atol):
        q = check_close(label, got, ref, rtol, atol)
        r, ab = rel_err(got, ref)
        rec[kernel]["max_abs_err"] = max(rec[kernel]["max_abs_err"], ab)
        rec[kernel]["err_over_tol"] = max(rec[kernel]["err_over_tol"], q)
        log(f"[parity] {label}: max rel {r:.3e} max abs {ab:.3e} max "
            f"err/bound {q:.3f}")

    # rebin, ragged: 3 rows x 777 samples, edges past both ends, an
    # empty and a one-sample bin; float64 and float32 rows
    rng = np.random.RandomState(9)
    x = np.sort(rng.uniform(0.0, 1.0, 777))
    edges = np.sort(np.concatenate([np.linspace(-0.01, 1.01, 12),
                                    [x[100], x[100] - 1e-12,
                                     x[300] + (x[301] - x[300]) / 3,
                                     x[300] + 2 * (x[301] - x[300]) / 3]]))
    plan = RC.make_rebin_plan(x, edges, device=dev)
    counts = (plan.stop - plan.start).cpu()
    assert (counts == 0).any() and (counts == 1).any()
    vals = torch.as_tensor(rng.uniform(0, 1, (3, 777)), device=dev)
    for dtype, rtol in ((torch.float64, 1e-12), (torch.float32, 1e-6)):
        rows = vals.to(dtype)
        got = RC.rebin_kernel(rows, plan)
        torch.cuda.synchronize()
        ref = RC.rebin_plain(rows.double(), plan)
        hold("rebin", f"rebin ragged R=3 N=777 {dtype}", got.double(), ref,
             rtol, 0.0)
        assert (got[:, counts <= 1] == 0).all()

    # rebin at the ETL's chunk: 64 rows x 2e6 float32 samples, uniform in
    # wavelength as a line-list store, into the run grid's bins
    x = np.linspace(0.4, 11.0, ETL_SAMPLES)
    plan = RC.make_rebin_plan(x, edges_um, device=dev)
    gen = torch.Generator(device=dev).manual_seed(6)
    rows = torch.randn((ETL_ROWS, ETL_SAMPLES), generator=gen,
                       device=dev).exp_()
    got = RC.rebin_kernel(rows, plan)
    torch.cuda.synchronize()
    assert torch.equal(got, RC.rebin_kernel(rows, plan)), \
        "repeated rebin launches differ"
    ref = RC.rebin_plain(rows.double(), plan)
    scale = float(ref.abs().max())
    hold("rebin", f"rebin R={ETL_ROWS} N={ETL_SAMPLES} float32 vs the "
         f"float64 twin", got.double(), ref, 1e-6, 1e-6 * scale)
    del ref
    native = torch.as_tensor(grouped_trapezoid_native(
        rows.cpu().numpy(), x, edges_um), device=dev)
    hold("rebin", f"rebin R={ETL_ROWS} N={ETL_SAMPLES} float32 vs the "
         f"native host engine", got, native, 1e-6, 1e-6 * scale)
    # in rounds, as the kappa kernel is timed: the median and every round
    rounds = [time_ms(lambda: RC.rebin_kernel(rows, plan), REBIN_CALLS)
              for _ in range(REBIN_ROUNDS)]
    rec["rebin"]["ms"] = float(np.median(rounds))
    rec["rebin"]["ms_rounds"] = rounds
    rec["rebin"]["plain_ms"] = time_ms(lambda: RC.rebin_plain(rows, plan),
                                       3)
    # the bytes the kernel must move (rows, panel widths, bin ranges in;
    # bins out), a trapezoid panel's 4 operations per sample
    rec["rebin"]["bytes"] = (nbytes(rows, plan.dx, plan.start, plan.stop)
                             + ETL_ROWS * plan.n_bins * rows.element_size())
    rec["rebin"]["flops"] = 4 * ETL_ROWS * ETL_SAMPLES
    # the TPU kernel's own body, timed as one library call: the samples
    # times a (samples, bins) one-hot of their bin codes (4 GB, built in
    # advance), by torch.matmul in full float32
    onehot = rows.new_zeros((plan.n_samples, plan.n_bins))
    inside = plan.codes >= 0
    onehot[torch.arange(plan.n_samples, device=dev)[inside],
           plan.codes[inside]] = 1.0
    rec["rebin"]["library_ms"] = time_ms(lambda: torch.matmul(rows, onehot),
                                         5)
    del onehot
    log(f"[timing] rebin kernel {REBIN_ROUNDS} rounds of {REBIN_CALLS} "
        f"calls: min {min(rounds):.4f} median {rec['rebin']['ms']:.4f} max "
        f"{max(rounds):.4f} ms ({', '.join(f'{x:.4f}' for x in rounds)}); "
        f"plain twin "
        f"{rec['rebin']['plain_ms']:.4f} ms, one-hot torch.matmul "
        f"{rec['rebin']['library_ms']:.4f} ms ({ETL_ROWS} x {ETL_SAMPLES} "
        f"float32 samples -> {plan.n_bins} bins, device-resident)")
    del rows

    # the kappa kernel: every case, its plan, times and variants
    rec["kappa"] = phase_kappa()
    return rec


def kappa_library_ms(stack, T, P):
    """The TPU kernel's own body timed as one library call: the (N, nT nP)
    bilinear one-hot weights of the lookup points (4 corners per row,
    masked outside the hull, built in advance) times the (nT nP, S W)
    table, by torch.matmul in full float32."""
    from frei_tpu_torch.opacity.tables import _axis_weights
    S_, nT, nP, W = stack.values.shape
    ti, tf, t_ok = (x.reshape(-1) for x in _axis_weights(stack.temps, T))
    pj, pf, p_ok = (x.reshape(-1) for x in _axis_weights(stack.press_cgs, P))
    N = ti.numel()
    m = (t_ok & p_ok).to(T.dtype)
    onehot = T.new_zeros((N, nT * nP))
    rows = torch.arange(N, device=T.device)
    for dt_, dp_, w in ((0, 0, (1 - tf) * (1 - pf)), (1, 0, tf * (1 - pf)),
                        (0, 1, (1 - tf) * pf), (1, 1, tf * pf)):
        col = ((ti + dt_).clamp(max=nT - 1) * nP
               + (pj + dp_).clamp(max=nP - 1))
        onehot.index_put_((rows, col), w * m, accumulate=True)
    tab = stack.values.permute(1, 2, 0, 3).reshape(nT * nP, S_ * W)
    tab = tab.contiguous()
    return time_ms(lambda: torch.matmul(onehot, tab), 5)


# the kappa headline's timing: rounds of calls (the spread between
# calls is a question of its own, PERF.md section 7)
KAPPA_ROUNDS, KAPPA_CALLS = 10, 20
# eight species of the S=8 kappa case
KAPPA_SPECIES8 = ("1H2-16O", "12C-16O", "12C-1H4", "12C-16O2", "14N-1H3",
                  "1H-12C-14N", "1H2-32S", "48Ti-16O")


def kappa_case(case, dtype):
    """Phase 3c's kappa cases beside the headline's (:func:`opacity_inputs`):

    * ``"one-cell"``: every one of 8192 x 30 points in one (T, P) cell;
    * ``"layer-grid"``: every point on the table's P points, the layer
      pressures broadcast over the columns as phase 4c's caller passes
      them (8192 x 30);
    * ``"distinct"``: one point in each cell's interior;
    * ``"outside"``: every point outside the hull, half above it in T and
      half below (1024 x 30);
    * ``"odd-W"``: W = 499 (float32) or 7 (float64), 1024 x 30 points, no
      16-byte pieces;
    * ``"S=8"``: eight species on the reference H2O store's 28 T x 23 P
      grid (``tools/etl_volume.py``), 2048 x 30 points x 500 bins.

    Returns ``(stack, mmr, T, P, sigma)`` on the card."""
    from frei_tpu_torch.opacity.tables import make_opacity_stack
    dev = torch.device("cuda")
    rng = np.random.RandomState(12)

    def dv(a):
        return torch.as_tensor(a, dtype=dtype, device=dev)

    if case in ("one-cell", "layer-grid", "distinct", "outside"):
        n = N_COLUMNS if case in ("one-cell", "layer-grid") else 1024
        stack, _, T, P, sig = opacity_inputs(dtype, n)
        temps, press = stack.temps, stack.press_cgs
        if case == "one-cell":
            T = temps[12] + (temps[13] - temps[12]) * dv(
                rng.uniform(0.01, 0.99, T.shape))
            P = press[5] + (press[6] - press[5]) * dv(
                rng.uniform(0.01, 0.99, T.shape))
        elif case == "layer-grid":
            P = press.flip(0).expand(n, N_LAYERS)
        elif case == "distinct":
            T = (0.5 * (temps[:-1] + temps[1:]))[:, None].expand(
                -1, len(press) - 1)
            P = (0.5 * (press[:-1] + press[1:]))[None, :].expand_as(T)
        else:
            T = torch.where(torch.as_tensor(rng.rand(*T.shape) < 0.5,
                                            device=dev),
                            temps[-1] * dv(rng.uniform(1.01, 2.0, T.shape)),
                            temps[0] * dv(rng.uniform(0.1, 0.99, T.shape)))
        mmr = dv(rng.uniform(1e-5, 1e-3, (2,) + tuple(T.shape)))
        return stack, mmr, T, P, sig
    if case == "odd-W":
        W, n, names = (499 if dtype == torch.float32 else 7), 1024, \
            ETL_SPECIES
        t_ax, p_ax = np.linspace(500.0, 3500.0, 30), np.logspace(-6, 2.5, 30)
        T = rng.uniform(400.0, 3600.0, (n, N_LAYERS))
        P = 10.0 ** rng.uniform(-6.5, 3.0, (n, N_LAYERS)) * 1e6
    else:
        W, n, names = N_BINS, 2048, KAPPA_SPECIES8
        t_ax, p_ax = np.linspace(100.0, 3500.0, 28), np.logspace(-8, 3, 23)
        T = rng.uniform(50.0, 3600.0, (n, N_LAYERS))
        P = 10.0 ** rng.uniform(-8.5, 3.5, (n, N_LAYERS)) * 1e6
    tables = {iso: (rng.uniform(0.1, 1.0, (len(t_ax), len(p_ax), W))
                    * (k + 1), t_ax, p_ax) for k, iso in enumerate(names)}
    stack = make_opacity_stack(tables, dtype=dtype, device=dev)
    mmr = dv(rng.uniform(1e-5, 1e-3, (len(names), n, N_LAYERS)))
    return stack, mmr, dv(T), dv(P), dv(np.linspace(1e-3, 2e-3, W))


def hold_kappa_plan(label, plan, ref):
    """The CUDA plan against its twin: keys, fractions and both offset
    scans exact; the order a permutation listing the points bucket by
    bucket (inside a bucket the kernel's order is open)."""
    assert torch.equal(plan.key, ref.key), f"{label}: keys differ"
    assert torch.equal(plan.frac, ref.frac), f"{label}: fractions differ"
    assert torch.equal(plan.offsets, ref.offsets), f"{label}: offsets"
    assert torch.equal(plan.item_offsets, ref.item_offsets), \
        f"{label}: work-item offsets differ"
    order = plan.order.long()
    assert torch.equal(torch.sort(order).values,
                       torch.arange(order.numel(), device=order.device)), \
        f"{label}: the order is not a permutation"
    assert torch.equal(plan.key[order], ref.key[ref.order.long()]), \
        f"{label}: a point outside its bucket"


def kappa_times(rounds=KAPPA_ROUNDS):
    """The float32 headline lookup (8192 x 30 points x 500 bins, 2
    species) through ``kappa_kernel``, which every checkout of the port
    has: ``rounds`` means of ``KAPPA_CALLS`` calls each, by CUDA events,
    and the sha256 of its output."""
    import hashlib
    from frei_tpu_torch.ops import kappa_cuda as KC
    args = opacity_inputs(torch.float32, N_COLUMNS)
    ms = [time_ms(lambda: KC.kappa_kernel(*args), KAPPA_CALLS)
          for _ in range(rounds)]
    out = KC.kappa_kernel(*args)[0]
    torch.cuda.synchronize()
    return ms, hashlib.sha256(out.cpu().numpy().tobytes()).hexdigest()


def phase_kappa():
    """Phase 3c's kappa part: the kernel against the gather twin in every
    case (the headline's inputs in float64 at 64 columns and float32 at
    8192, and each of :func:`kappa_case` in float32, some in float64 too):
    float64 rtol 1e-10, float32 rtol 1e-5 plus 1e-7 of the largest value,
    repeated launches identical, points outside the hull exactly sigma;
    the CUDA plan against its twin (:func:`hold_kappa_plan`); then at the
    float32 headline the kernel's time in rounds, its variants (the plan
    alone, write-only, staging only, the first version's gather), the
    plan's torch twin, the plain twin and one library call.  Returns the
    kernel's record."""
    from frei_tpu_torch.ops import kappa_cuda as KC
    rec = {"max_abs_err": 0.0, "err_over_tol": 0.0}
    cases = [("headline", torch.float64), ("headline", torch.float32),
             ("one-cell", torch.float32), ("layer-grid", torch.float32),
             ("distinct", torch.float64), ("distinct", torch.float32),
             ("outside", torch.float32), ("odd-W", torch.float32),
             ("odd-W", torch.float64), ("S=8", torch.float32),
             ("S=8", torch.float64)]
    for case, dtype in cases:
        if case == "headline":
            args = opacity_inputs(dtype, PARITY64_COLUMNS
                                  if dtype == torch.float64 else N_COLUMNS)
        else:
            args = kappa_case(case, dtype)
        stack, mmr, T, P, sig = args
        S_, nT, nP, W = stack.values.shape
        label = (f"kappa {case:10s} {str(dtype):13s} points "
                 f"{tuple(T.shape)} S={S_} {nT}x{nP} W={W}")
        got, _ = KC.kappa_kernel(*args)
        torch.cuda.synchronize()
        assert torch.equal(got, KC.kappa_kernel(*args)[0]), \
            f"{label}: repeated launches differ"
        ref, _ = KC.kappa_plain(*args)
        plan_ref = KC.kappa_plan_plain(stack, T, P)
        hold_kappa_plan(label, KC.kappa_variant("plan", *args)[1], plan_ref)
        out = (plan_ref.key == nT * nP).reshape(got.shape[:-1])
        assert (got[out] == sig).all() and (ref[out] == sig).all(), \
            f"{label}: a point outside the hull is not sigma"
        rtol, atol_frac = ((1e-10, 0.0) if dtype == torch.float64
                           else (1e-5, 1e-7))
        q = check_close(label, got, ref, rtol,
                        atol_frac * float(ref.abs().max()))
        r, ab = rel_err(got, ref)
        rec["max_abs_err"] = max(rec["max_abs_err"], ab)
        rec["err_over_tol"] = max(rec["err_over_tol"], q)
        items = int(plan_ref.item_offsets[-1])
        full = int((torch.diff(plan_ref.offsets) > 0).sum())
        log(f"[parity] {label}: {int(out.sum())} of {out.numel()} points "
            f"outside the hull, {full} buckets, {items} work items; max "
            f"rel {r:.3e} max abs {ab:.3e} max err/bound {q:.3f}; plan as "
            f"its twin")
        del got, ref

    # the float32 headline: times in rounds, variants, twins
    ms, digest = kappa_times()
    rec["ms"] = float(np.median(ms))
    rec["ms_rounds"] = ms
    rec["sha256"] = digest
    args = opacity_inputs(torch.float32, N_COLUMNS)
    stack, mmr, T, P, sig = args
    S_ = stack.values.shape[0]
    rec["plain_ms"] = time_ms(lambda: KC.kappa_plain(*args), 3)
    # the stack, the points and sigma in, (N, W) out; per output value and
    # species 4 corner multiply-adds and the mixing ratio's (10
    # operations), plus sigma
    rec["bytes"] = (nbytes(stack.values, mmr, T, P, sig)
                    + T.numel() * N_BINS * T.element_size())
    rec["flops"] = (10 * S_ + 1) * T.numel() * N_BINS
    rec["library_ms"] = kappa_library_ms(stack, T, P)
    tb = rec["bytes"] / PEAK_BYTES * 1e3
    lookup, _ = KC.kappa_variant("lookup", *args)
    gather, _ = KC.kappa_variant("gather", *args)
    torch.cuda.synchronize()
    same = torch.equal(lookup, gather)
    del lookup, gather
    variants = {v: time_ms(lambda v=v: KC.kappa_variant(v, *args),
                           KAPPA_CALLS)
                for v in ("lookup", "plan", "write", "stage", "gather")}
    variants["torch plan"] = time_ms(
        lambda: KC.kappa_plan_plain(stack, T, P), 5)
    rec["variants"] = variants
    log(f"[timing] kappa kernel (wrapper) {KAPPA_ROUNDS} rounds of "
        f"{KAPPA_CALLS} calls: min {min(ms):.4f} median {rec['ms']:.4f} "
        f"max {max(ms):.4f} ms ({', '.join(f'{x:.4f}' for x in ms)}); "
        f"plain twin {rec['plain_ms']:.4f} ms, one-hot torch.matmul "
        f"{rec['library_ms']:.4f} ms ({N_COLUMNS} x {N_LAYERS} points x "
        f"{N_BINS} bins, {S_} species, float32); output sha256 {digest}")
    for v, x in variants.items():
        log(f"[variants] kappa {v:10s} {x:.4f} ms, {tb / x:.3f} of the "
            f"bytes bound ({tb:.4f} ms)")
    log(f"[variants] kappa lookup and the first version's gather give the "
        f"same bits: {same}")
    return rec


def phase_etl(root):
    """The opacity plane end to end under a fresh ``FREI_TPU_CACHE`` in
    ``root``: stores -> ``Grid.load_opacities`` on the native and cuda
    engines (in turns, each with its own binned cache, so every load
    rebins) -> an 8192-column ``"loop"`` solve -> ``kappa_from_stack``
    through the kappa kernel.  Returns the walls and the path's launch
    counts."""
    from frei_tpu_torch import Grid, Planet
    from frei_tpu_torch.opacity.etl import make_synthetic_store
    from frei_tpu_torch.opacity.tables import (kappa_from_layer_tables,
                                               kappa_from_stack,
                                               make_layer_tables)
    wrappers = kernel_wrappers()
    stores = root / "stores"
    t0 = time.perf_counter()
    for k, iso in enumerate(ETL_SPECIES):
        make_synthetic_store(stores / f"{iso}__synthetic.ftop",
                             isotopologue=iso, n_hr=ETL_SAMPLES,
                             temps=ETL_TEMPS, press_bar=ETL_PRESS_BAR,
                             seed=7 + k)
    gb = 4 * len(ETL_SPECIES) * len(ETL_TEMPS) * len(ETL_PRESS_BAR) \
        * ETL_SAMPLES / 1e9
    log(f"[etl] wrote {len(ETL_SPECIES)} stores ({gb:.3f} GB: "
        f"{len(ETL_TEMPS)} T x {len(ETL_PRESS_BAR)} P x {ETL_SAMPLES} "
        f"samples each) in {time.perf_counter() - t0:.1f} s")

    walls = {"native": [], "cuda": []}
    grids = {}
    for turn, engine in enumerate(("native", "cuda", "cuda", "native")):
        os.environ["FREI_TPU_CACHE"] = str(root / f"cache{turn}")
        grid = Grid(Planet.from_hot_jupiter(), n_wl_bins=N_BINS,
                    n_layers=N_LAYERS, T_ref=2400.0, dtype=torch.float32,
                    device="cuda")
        for w in wrappers.values():
            w.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stack = grid.load_opacities(path=stores, engine=engine)
        torch.cuda.synchronize()
        walls[engine].append(time.perf_counter() - t0)
        n = wrappers["resort_rebin"].launches
        log(f"[etl] engine={engine:6s} load_opacities of "
            f"{len(ETL_SPECIES)} stores: {walls[engine][-1]:.4f} s, rebin "
            f"kernel launches {n}")
        assert stack.values.shape == (len(ETL_SPECIES), N_LAYERS, N_LAYERS,
                                      N_BINS)
        assert stack.values.is_cuda and torch.isfinite(stack.values).all()
        assert (n > 0) == (engine == "cuda"), (engine, n)
        grids.setdefault(engine, grid)
    cuda, native = grids["cuda"].opacities, grids["native"].opacities
    q = check_close("etl cuda vs native tables", cuda.values, native.values,
                    1e-6, 0.0)
    log(f"[etl] cuda vs native tables: max rel "
        f"{rel_err(cuda.values, native.values)[0]:.3e}, max err/bound "
        f"{q:.3f}")

    # float32 solves on this stack: its binned opacities are tiny
    # (groupies scaling: integral x bin width x 1e-3, <= 7.4e-6 cm^2/g),
    # so the top layers are optically thin and their float32 updates are
    # rounding noise (phase 3) that drives some columns negative within
    # 20 iterations, on every engine, the eager one included.  Counted,
    # not asserted.
    T0 = columns(grids["cuda"], N_COLUMNS)
    for engine in ("loop", "cuda", "eager"):
        spec, *_ = grids["cuda"].emission_spectra(
            T0, n_timesteps=N_ITERS, n_zero_crossings=10 ** 6,
            convergence_dT=0.0, engine=engine)
        bad = int((~np.isfinite(spec.flux_cgs)).any(1).sum())
        log(f"[etl] float32 {N_ITERS}-iteration solve on the binned stack, "
            f"engine={engine}: {bad} of {N_COLUMNS} columns non-finite "
            f"(optically thin top layers; not asserted)")

    # the path, counted from 0: the ETL load through the rebin kernel, a
    # float64 solve of 8192 columns on the "loop" engine, and the batched
    # lookup through the kappa kernel at the final temperatures
    grid = Grid(Planet.from_hot_jupiter(), n_wl_bins=N_BINS,
                n_layers=N_LAYERS, T_ref=2400.0, dtype=torch.float64,
                device="cuda")
    os.environ["FREI_TPU_CACHE"] = str(root / "cache-path")
    for w in wrappers.values():
        w.launches = 0
    grid.load_opacities(path=stores, engine="cuda")
    T0 = columns(grid, N_COLUMNS)
    t0 = time.perf_counter()
    spec, temps, _, _ = grid.emission_spectra(
        T0, n_timesteps=N_ITERS, n_zero_crossings=10 ** 6,
        convergence_dT=0.0, engine="loop")
    wall = time.perf_counter() - t0
    assert spec.flux_cgs.shape == (N_COLUMNS, N_BINS)
    assert np.all(np.isfinite(spec.flux_cgs)), "non-finite flux"
    T = grid.last_result.final_temps
    p = grid._consts.pressures
    sig = grid._consts.sigma_scat
    mmr = grid.chemistry.mmr(T, p)
    k_kernel, _ = kappa_from_stack(grid.opacities, mmr, T,
                                   p.expand_as(T), sig)
    torch.cuda.synchronize()
    launches = {k: w.launches for k, w in wrappers.items()}
    log(f"[etl] float64 {N_COLUMNS}-column {N_ITERS}-iteration loop solve "
        f"on the binned stack: {wall:.4f} s, flux finite, peak "
        f"{float(spec.flux_cgs.max()):.4e}, final T in "
        f"[{float(T.min()):.1f}, {float(T.max()):.1f}] K; launches over "
        f"the path {json.dumps(launches)}")
    for k in ("resort_rebin", "kappa_lookup", "rc_loop"):
        assert launches[k] > 0, f"the ETL path bypassed {k}: {launches}"
    lt = make_layer_tables(grid.opacities, p)
    k_layer, _ = kappa_from_layer_tables(lt, mmr, T, sig)
    t = grid.opacities.temps
    eps = 8 * torch.finfo(t.dtype).eps
    inside = (T >= t[0] - eps * t[0]) & (T <= t[-1] + eps * t[-1])
    assert torch.equal(k_kernel[~inside], sig.expand_as(k_kernel)[~inside])
    q_k = check_close("kappa kernel vs layer tables (inside the hull)",
                      k_kernel[inside], k_layer[inside], 1e-10, 0.0)
    log(f"[etl] kappa_from_stack (kernel) vs kappa_from_layer_tables at "
        f"the final temperatures: {int(inside.sum())} of {inside.numel()} "
        f"points inside the T hull, max rel "
        f"{rel_err(k_kernel[inside], k_layer[inside])[0]:.3e}, max "
        f"err/bound {q_k:.3f}; outside it sigma exactly")
    return {"walls": walls, "launches": launches, "solve_wall": wall}

def diff_grads(grid, T0):
    """Phase 4f's gradients: loss = sum(flux * w) / 1e12 (w rising from
    0.5 to 1.5 over the bins, so no cancellation) of the differentiable
    solve, 3 iterations with the convergence exits off, and its
    gradients with respect to g, alpha and the initial temperatures
    (`tests/test_grad.py:94-130`).  Returns (loss, point, gradients)."""
    from frei_tpu_torch.rt.physics import PhysicsParams
    from frei_tpu_torch.rt.solver import SolverConfig, solve_rc_batched
    p0 = grid.planet.physics_params()
    consts, kappa = grid._consts, grid._kappa_fn
    w = torch.linspace(0.5, 1.5, N_BINS, dtype=grid.dtype, device=grid.device)
    cfg = SolverConfig(n_timesteps=3, n_zero_crossings=10 ** 6,
                       convergence_dT=0.0, differentiable=True)

    def loss(g, alpha, T):
        par = PhysicsParams(g=g, m_bar=p0.m_bar, alpha=alpha, n_dof=p0.n_dof)
        return (solve_rc_batched(T, consts, par, kappa, cfg).flux
                * w).sum() / 1e12

    x = [torch.tensor(v, dtype=grid.dtype, device=grid.device)
         for v in (p0.g, p0.alpha)] + [T0.to(grid.device)]
    leaves = [v.clone().requires_grad_(True) for v in x]
    return loss, x, torch.autograd.grad(loss(*leaves), leaves)


def phase_differentiable(root):
    """Phase 4f: queue 1 items 11 and 13 on the card, float64 at the run's
    width (500 bins x 30 layers), each check raising on failure: the
    differentiable forward bit for bit the ordinary ``"eager"`` solve in
    every field (64 columns of the profile x U(0.8, 1.2), 4 iterations at a
    15 K threshold, so that columns stop after 1, 2, 3 and 4 iterations,
    where at 60 K all stop after one; remat chunks 0, 3, 1);
    d(loss)/d(g, alpha, T0[1, 11]) against central differences at rtol
    1e-5 (layer 11 is the photosphere's, where this gradient peaks; layer
    2, the JAX test's on 5 layers, lies below 100 bar here, at 2e-17) and
    against the port on the CPU at rtol 1e-8 (8 columns,
    :func:`diff_grads`); the associative scan against the sequential one
    (flux rtol 1e-10; temperatures 1e-12 on the grid's own profile, the
    JAX test's input); the standalone ``absorb`` / ``emit`` against sweeps by hand from the same
    self-seeds (rtol 1e-12); and 3 + 3 iterations resumed from a
    ``save_solution`` file bit for bit 6 continuous ones, on ``"cuda"``
    and ``"eager"``.  Returns its wall."""
    from frei_tpu_torch import absorb, emit
    from frei_tpu_torch.io.checkpoint import resume_state, save_solution
    from frei_tpu_torch.ops.planck import bb_flux
    from frei_tpu_torch.rt.solver import SolverConfig, solve_rc_batched
    from frei_tpu_torch.rt.sweeps import absorb_sweep, emit_sweep
    t_start = time.perf_counter()
    g64 = make_grid(torch.float64)
    args = solver_args(g64)

    # the forward: bit for bit, with columns converging early
    rng = np.random.RandomState(2)
    T0 = torch.as_tensor(np.asarray(g64.rt_grid.init_temperatures)[None, :]
                         * rng.uniform(0.8, 1.2, (DIFF_COLUMNS, 1)),
                         dtype=torch.float64, device=g64.device)
    kw = dict(n_timesteps=4, convergence_dT=15.0)
    ref = solve_rc_batched(T0, *args, SolverConfig(engine="eager", **kw))
    iters = torch.bincount(ref.n_iterations.long(), minlength=5).tolist()
    assert iters[4] < DIFF_COLUMNS and sum(x > 0 for x in iters) > 1, \
        f"the columns do not stop at different iterations: {iters}"
    for chunk in (0, 3, 1):
        got = solve_rc_batched(T0, *args, SolverConfig(
            differentiable=True, remat_chunk=chunk, **kw))
        bad = [f for f in ref._fields
               if not torch.equal(getattr(ref, f), getattr(got, f))]
        assert not bad, f"differentiable forward (chunk {chunk}): {bad}"
    log(f"[differentiable] forward, {DIFF_COLUMNS} columns x 4 iterations "
        f"(columns by iterations run 1-4: {iters[1:]}): every RTResult "
        f"field bit for bit the eager solve at remat_chunk 0, 3, 1")

    # gradients against central differences and against the CPU
    T8 = columns(g64, GRAD_COLUMNS, seed=3)
    loss, x, grads = diff_grads(g64, T8)
    e = torch.zeros_like(T8)
    e[1, 11] = 1.0
    fds = []
    with torch.no_grad():
        for i, (d, h) in enumerate(((1.0, float(x[0]) * 1e-6), (1.0, 1e-6),
                                    (e, 1e-3))):
            xp = [v + h * d if j == i else v for j, v in enumerate(x)]
            xm = [v - h * d if j == i else v for j, v in enumerate(x)]
            fds.append(float(loss(*xp) - loss(*xm)) / (2.0 * h))
    got = [float(grads[0]), float(grads[1]), float(grads[2][1, 11])]
    for name, a, b in zip(("g", "alpha", "T0[1, 11]"), got, fds):
        log(f"[differentiable] d(loss)/d {name}: autograd {a:.10e}, central "
            f"difference {b:.10e}")
        assert abs(a - b) <= 1e-5 * abs(b), (name, a, b)
    assert torch.isfinite(grads[2]).all()
    _, _, cpu = diff_grads(make_grid(torch.float64, "cpu"), T8.cpu())
    for name, a, b in zip(("g", "alpha", "T0"), grads, cpu):
        q = check_close(f"d(loss)/d {name} card vs CPU", a.cpu(), b, 1e-8,
                        1e-12 * float(b.abs().max()))
        log(f"[differentiable] d(loss)/d {name}, card vs the port on the "
            f"CPU: max rel {rel_err(a.cpu(), b)[0]:.3e}, err/bound {q:.3f}")

    # the associative scan (the eager engine's), 4 iterations: on the
    # grid's own profile (the JAX test's input) flux and temperatures; on
    # the 64 columns the flux (their thin top layer's update is a
    # difference of nearly equal sums, 1e-10 apart between the scans)
    T_grid = torch.as_tensor(g64.init_temperatures, dtype=torch.float64,
                             device=g64.device)
    for label, T in (("the grid's profile", T_grid[None]),
                     (f"{DIFF_COLUMNS} columns", T0)):
        ra = solve_rc_batched(T, *args, SolverConfig(4, engine="eager",
                                                     associative=True))
        rs = solve_rc_batched(T, *args, SolverConfig(4, engine="eager"))
        check_close(f"associative flux, {label}", ra.flux, rs.flux, 1e-10,
                    0.0)
        if T is T_grid[None]:
            check_close("associative temps", ra.final_temps,
                        rs.final_temps, 1e-12, 0.0)
        log(f"[associative] {label} x 4 iterations against the sequential "
            f"scan: flux max rel {rel_err(ra.flux, rs.flux)[0]:.3e}, temps "
            f"max rel {rel_err(ra.final_temps, rs.final_temps)[0]:.3e}")

    # the standalone drivers against sweeps by hand from the self-seeds
    consts, params, kappa = args
    T1 = torch.as_tensor(g64.init_temperatures, dtype=torch.float64,
                         device="cuda")
    sweep_kw = dict(sigma_scat=consts.sigma_scat, F_toa=consts.F_toa,
                    lam_cm=consts.lam_cm, trapz_w=consts.trapz_w,
                    pressures=consts.pressures, params=params)
    for name, drive, sweep, n in (("absorb", absorb, absorb_sweep, 4),
                                  ("emit", emit, emit_sweep, 3)):
        r = drive(T1, consts, params, kappa, n_timesteps=n,
                  convergence_thresh=0.0)
        Fu = torch.zeros((N_LAYERS, N_BINS), dtype=torch.float64,
                         device="cuda")
        Fd = torch.zeros_like(Fu)
        Fd[-1] = consts.F_toa
        if name == "absorb":
            Fu[0] = bb_flux(T1[0], consts.lam_cm)
        T, Fu, Fd = T1[None], Fu[None], Fd[None]
        for _ in range(n):
            s_ = sweep(T, Fu, Fd, kappa(T, consts.pressures), **sweep_kw)
            T, Fu, Fd = s_.temps, s_.F_up, s_.F_down
        assert int(r.n_history) == n + 1
        for label, a, b in (("temps", r.final_temps, T[0]),
                            ("F_up", r.F_up, Fu[0]),
                            ("F_down", r.F_down, Fd[0])):
            check_close(f"standalone {name} {label}", a, b, 1e-12, 0.0)
        log(f"[standalone] {name}, {n} timesteps of one column: temps, F_up "
            f"and F_down within rtol 1e-12 of sweeps by hand (max rel "
            f"{rel_err(r.final_temps, T[0])[0]:.3e})")

    # checkpoint resume: 3 + 3 iterations through a file, bit for bit
    data = root / "chip_smoke_data"
    data.mkdir(exist_ok=True)
    try:
        fixed = dict(n_zero_crossings=10 ** 6, convergence_dT=0.0)
        for engine in ("cuda", "eager"):
            full = solve_rc_batched(T0, *args, SolverConfig(
                6, engine=engine, **fixed))
            part = solve_rc_batched(T0, *args, SolverConfig(
                3, engine=engine, **fixed))
            path = save_solution(data / f"resume_{engine}.npz", part)
            temps, fluxes = resume_state(path, device="cuda")
            resumed = solve_rc_batched(temps, *args, SolverConfig(
                3, engine=engine, **fixed), init_fluxes=fluxes)
            bad = [f for f in ("flux", "final_temps", "F_up", "F_down")
                   if not torch.equal(getattr(full, f), getattr(resumed, f))]
            assert not bad, f"resume on {engine}: {bad} differ"
            log(f"[checkpoint] engine={engine}: 3 + 3 iterations resumed "
                f"from {path.name} equal 6 continuous ones bit for bit")
    finally:
        shutil.rmtree(data, ignore_errors=True)
    return time.perf_counter() - t_start


def phase_gradient_leg(sizes=GRAD_LEG_COLUMNS, runs=3):
    """Phase 5's gradient leg (`bench.py:194-232`): loss = sum(flux^2) /
    1e26 of the differentiable solve and its gradient with respect to the
    initial temperatures, float32, 500 x 30, 20 iterations with the exits
    off, at each size in ``sizes`` (the first columns of the headline's):
    one warm-up and ``runs`` timed runs, each timed by the host clock in
    two parts that end in a synchronize, the forward and the backward (the
    rematerialized forwards included); every kernel's launch count set to
    0 before and read after (the solve runs ``"eager"``: all must stay
    0); gradients finite."""
    from frei_tpu_torch.rt.solver import SolverConfig, solve_rc_batched
    wrappers = kernel_wrappers()
    grid = make_grid(torch.float32)
    consts, params, kappa = solver_args(grid)
    cfg = SolverConfig(n_timesteps=N_ITERS, n_zero_crossings=10 ** 6,
                       convergence_dT=0.0, differentiable=True)
    chunk = min(cfg.remat_chunk or max(1, round(N_ITERS ** 0.5)), N_ITERS)
    T_all = columns(grid, max(sizes))
    res = {}
    for n in sizes:
        T0 = T_all[:n].contiguous()
        for w in wrappers.values():
            w.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fwd, bwd = [], []
        for _ in range(runs + 1):
            T = T0.clone().requires_grad_(True)
            t0 = time.perf_counter()
            flux = solve_rc_batched(T, consts, params, kappa, cfg).flux
            loss = (flux ** 2).sum() / 1e26
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            (grad,) = torch.autograd.grad(loss, T)
            torch.cuda.synchronize()
            fwd.append(t1 - t0)
            bwd.append(time.perf_counter() - t1)
            del flux, loss
        fwd, bwd = fwd[1:], bwd[1:]           # the warm-up's left out
        walls = [a + b for a, b in zip(fwd, bwd)]
        launches = {k: w.launches for k, w in wrappers.items()}
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        assert not any(launches.values()), f"gradient leg ran {launches}"
        assert torch.isfinite(grad).all(), "non-finite gradients"
        assert grad.shape == (n, N_LAYERS)
        wall = min(walls)
        res[n] = dict(walls=walls, forward=fwd, backward=bwd,
                      rate=n * N_BINS / wall, peak_gb=peak_gb,
                      launches=launches, chunk=chunk)
        log(f"[gradient] {n} columns x {N_BINS} bins x {N_LAYERS} layers x "
            f"{N_ITERS} iterations float32, remat chunk {chunk}: walls "
            f"{', '.join(f'{w:.4f}' for w in walls)} s (forward "
            f"{', '.join(f'{w:.4f}' for w in fwd)}; backward "
            f"{', '.join(f'{w:.4f}' for w in bwd)}), "
            f"{res[n]['rate']:,.0f} columns*bins/s (best), peak memory "
            f"{peak_gb:.2f} GB, launches {json.dumps(launches)}, gradients "
            f"finite (max |dL/dT0| {float(grad.abs().max()):.4e})")
        del grad, T
    return res


def kernel_wrappers():
    """Each kernel's wrapper, by the kernel's name in the JSON record."""
    from frei_tpu_torch.ops import iteration_cuda as IC
    from frei_tpu_torch.ops import kappa_cuda as KC
    from frei_tpu_torch.ops import rebin_cuda as RC
    from frei_tpu_torch.ops import sweep_cuda as S
    return {"emit_sweep": S.emit_kernel, "absorb_sweep": S.absorb_kernel,
            "rc_iteration": IC.rc_iteration_kernel,
            "rc_loop": IC.rc_loop_kernel,
            "kappa_lookup": KC.kappa_kernel,
            "resort_rebin": RC.rebin_kernel}


# phase 4g, the parallel plane: the two-rank legs' float64 columns, their
# iterations (the CPU tests'), and the gradient leg's columns
PAR64_COLUMNS, PAR_ITERS, PAR_GRAD_COLUMNS = 64, 3, 8


def digest(t):
    """sha256 of a tensor's bytes."""
    return hashlib.sha256(
        t.detach().contiguous().cpu().numpy().tobytes()).hexdigest()


def counted(tally, fn):
    """``fn()`` with every kernel's launch count set to 0 just before and
    read just after (the device synchronized), added into ``tally``."""
    wrappers = kernel_wrappers()
    for w in wrappers.values():
        w.launches = 0
    out = fn()
    torch.cuda.synchronize()
    for k, w in wrappers.items():
        tally[k] += w.launches
    return out


def gather(dt):
    """A DTensor's global tensor, gathered with ``dist.all_gather_into_
    tensor`` over each sharded mesh dim.  (``DTensor.full_tensor()``
    crashes with a segmentation fault on a gloo world with CUDA tensors in
    torch 2.11, inside its functional collectives; the plain collective
    works.)"""
    import torch.distributed as dist
    from torch.distributed.tensor import Shard
    x = dt.to_local()
    for i, p in enumerate(dt.placements):
        if isinstance(p, Shard):
            group = dt.device_mesh.get_group(i)
            n = dist.get_world_size(group)
            parts = x.new_empty((n * x.shape[0],) + x.shape[1:])
            dist.all_gather_into_tensor(parts, x.contiguous(), group=group)
            x = torch.cat(parts.chunk(n), dim=p.dim)
    return x


def fixed(engine, n=N_ITERS, **kw):
    from frei_tpu_torch.rt.solver import SolverConfig
    return SolverConfig(n_timesteps=n, n_zero_crossings=10 ** 6,
                        convergence_dT=0.0, engine=engine, **kw)


def phase_parallel_one(tally):
    """Phase 4g on NCCL, a world of one: ``solve_ensemble`` on a (1, 1)
    mesh at the headline (8192 x 500 x 30, float32, 20 fixed iterations)
    on ``"loop"``, ``"iteration"`` and ``"cuda"``, its flux and final
    temperatures equal bit for bit to ``solve_rc_batched``'s (sha256);
    the walls of the two, in turns direct, plane, plane, direct after one
    warm-up each.  Returns {engine: walls}."""
    import torch.distributed as dist
    from frei_tpu_torch.parallel import make_mesh, solve_ensemble
    from frei_tpu_torch.parallel.launch import free_port
    from frei_tpu_torch.rt.solver import solve_rc_batched
    grid = make_grid(torch.float32)
    T0 = columns(grid, N_COLUMNS)
    consts, params, kappa = solver_args(grid)
    dist.init_process_group("nccl",
                            init_method=f"tcp://127.0.0.1:{free_port()}",
                            world_size=1, rank=0,
                            timeout=timedelta(seconds=300))
    out = {}
    try:
        mesh = make_mesh(1, 1)
        for engine in ("loop", "iteration", "cuda"):
            cfg = fixed(engine)
            run = {"direct": lambda: solve_rc_batched(T0, consts, params,
                                                      kappa, cfg),
                   "plane": lambda: counted(tally, lambda: solve_ensemble(
                       T0, consts, params, grid.opacities, grid.chemistry,
                       cfg, mesh=mesh))}
            res, walls = {}, {"direct": [], "plane": []}
            for kind in ("direct", "plane", "direct", "plane", "plane",
                         "direct"):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res[kind] = run[kind]()
                torch.cuda.synchronize()
                walls[kind].append(time.perf_counter() - t0)
            walls = {k: v[1:] for k, v in walls.items()}   # warm-ups out
            plane = res["plane"]
            assert type(plane.flux).__name__ == "DTensor"
            for f in ("final_temps", "flux"):
                a = digest(getattr(res["direct"], f))
                b = digest(getattr(plane, f).full_tensor())
                assert a == b, f"(1, 1) mesh, {engine}: {f} {a} != {b}"
            out[engine] = walls
            log(f"[parallel] NCCL world of one, (1, 1) mesh, engine="
                f"{engine:9s} {N_COLUMNS} x {N_BINS} x {N_LAYERS} x "
                f"{N_ITERS} float32: flux and final temps bit-equal to "
                f"solve_rc_batched (flux sha256 {b[:16]}); walls direct "
                + ", ".join(f"{w:.4f}" for w in walls["direct"])
                + " s, solve_ensemble "
                + ", ".join(f"{w:.4f}" for w in walls["plane"]) + " s")
    finally:
        dist.destroy_process_group()
    return out


def parallel_rank(out):
    """One rank of phase 4g's world of two: gloo, both ranks on cuda:0
    (NCCL refuses two ranks on one card).  Saves the gathered results
    (rank 0), its own launch counts, walls and the all-reduce's time
    under ``out``."""
    import torch.distributed as dist
    from frei_tpu_torch.parallel import (initialize_distributed, make_mesh,
                                         solve_ensemble)
    from frei_tpu_torch.rt import sweeps
    from frei_tpu_torch.rt.physics import PhysicsParams
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_num_threads(1)    # two ranks and their parent share the host
    rank = int(os.environ["RANK"])
    initialize_distributed(f"{os.environ['MASTER_ADDR']}:"
                           f"{os.environ['MASTER_PORT']}", 2, rank,
                           backend="gloo", timeout=timedelta(seconds=300))
    tally = dict.fromkeys(kernel_wrappers(), 0)
    info, saved = {"rank": rank, "backend": dist.get_backend()}, {}
    meshes = {s: make_mesh(*s) for s in ((2, 1), (1, 2))}

    def plane(grid, T0, cfg, shape, params=None):
        consts, p, _ = solver_args(grid)
        return counted(tally, lambda: solve_ensemble(
            T0, consts, params or p, grid.opacities, grid.chemistry, cfg,
            mesh=meshes[shape]))

    # float64, 64 columns: "cuda" on both meshes, "loop" and "iteration"
    # on the columns mesh, "iteration" refused on the bins mesh
    g64 = make_grid(torch.float64)
    T64 = columns(g64, PAR64_COLUMNS)
    for engine, shapes in (("cuda", ((2, 1), (1, 2))), ("loop", ((2, 1),)),
                           ("iteration", ((2, 1),))):
        for s in shapes:
            r = plane(g64, T64, fixed(engine, PAR_ITERS), s)
            for f in ("flux", "final_temps"):
                saved[f"{engine}/{s[0]}x{s[1]}/{f}"] = gather(getattr(r, f))
    try:
        plane(g64, T64, fixed("iteration", PAR_ITERS), (1, 2))
    except ValueError as e:
        info["iteration_bins_error"] = str(e)

    # gradients, float64: the differentiable "eager" solve on both meshes,
    # the loss this rank's part of sum(flux^2) / 1e26, the gradients
    # summed over the world
    p0 = g64.planet.physics_params()
    for s in ((2, 1), (1, 2)):
        T = T64[:PAR_GRAD_COLUMNS].clone().requires_grad_(True)
        g = torch.tensor(float(p0.g), dtype=torch.float64, device=T.device,
                         requires_grad=True)
        par = PhysicsParams(g=g, m_bar=p0.m_bar, alpha=p0.alpha,
                            n_dof=p0.n_dof)
        r = plane(g64, T, fixed("auto", 2, differentiable=True), s, par)
        loss = (r.flux.to_local() ** 2).sum() / 1e26
        loss.backward()
        grads = torch.cat([T.grad.reshape(-1), g.grad.reshape(1),
                           loss.detach().reshape(1)])
        dist.all_reduce(grads)
        saved[f"grad/{s[0]}x{s[1]}"] = grads
    del g64, T64

    # float32 at the headline on the bins mesh: 250 bins a rank through
    # the sweep kernels; one iteration (held), then 20 (finite, timed)
    g32 = make_grid(torch.float32)
    T32 = columns(g32, N_COLUMNS)
    r = plane(g32, T32, fixed("cuda", 1), (1, 2))
    saved["f32/1/flux"] = gather(r.flux)
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = plane(g32, T32, fixed("cuda"), (1, 2))
        walls.append(time.perf_counter() - t0)
    assert torch.isfinite(r.flux.to_local()).all(), "non-finite flux"
    saved["f32/20/flux"] = gather(r.flux)
    info["walls"] = walls[1:]
    # the same solve with each quadrature all-reduce timed (synchronized
    # before and after): its share of that run's wall
    plain, spent = sweeps._all_reduce, []

    def timed(x, group):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y = plain(x, group)
        torch.cuda.synchronize()
        spent.append(time.perf_counter() - t0)
        return y

    sweeps._all_reduce = timed
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plane(g32, T32, fixed("cuda"), (1, 2))
        info["timed_wall"] = time.perf_counter() - t0
    finally:
        sweeps._all_reduce = plain
    info["all_reduce_s"] = sum(spent)
    info["all_reduces"] = len(spent)
    info["launches"] = tally
    (out / f"rank{rank}.json").write_text(json.dumps(info))
    if rank == 0:
        torch.save({k: v.cpu() for k, v in saved.items()}, out / "saved.pt")
    dist.destroy_process_group()


def phase_parallel(root):
    """Phase 4g, the parallel plane (queue 1 item 14) on one card: NCCL on
    a world of one (:func:`phase_parallel_one`), then a world of two gloo
    ranks on cuda:0 (:func:`parallel_rank`, this file started twice by
    ``parallel.launch.run_ranks``, which kills both on a failure or after
    300 s), held against one-process solves here: float64 (2, 1) and
    (1, 2) meshes on ``"cuda"`` and (2, 1) on ``"loop"`` and
    ``"iteration"`` at 64 columns x 500 x 30, 3 iterations, flux and final
    temperatures at rtol 1e-10 (the top layer's at 1e-8); ``"iteration"``
    refused on (1, 2); the
    differentiable solve's gradients on both meshes, summed over the
    ranks, at rtol 1e-10 (8 columns, 2 iterations); float32 on (1, 2) at
    the headline after one iteration, flux at rtol 1e-4 plus 1e-5 of the
    largest (phase 3's float32 rtol; the update of the thin top layers is
    rounding noise), and after 20 (finite; the difference logged, as
    float32 trajectories diverge), its wall and the all-reduce's share.
    Returns the plane's launch counts and its numbers."""
    from frei_tpu_torch.parallel.launch import run_ranks
    from frei_tpu_torch.rt.physics import PhysicsParams
    from frei_tpu_torch.rt.solver import solve_rc_batched
    t_start = time.perf_counter()
    tally = dict.fromkeys(kernel_wrappers(), 0)
    one = phase_parallel_one(tally)

    # the one-process references
    ref = {}
    g64 = make_grid(torch.float64)
    T64 = columns(g64, PAR64_COLUMNS)
    args64 = solver_args(g64)
    for engine in ("cuda", "loop", "iteration"):
        r = solve_rc_batched(T64, *args64, fixed(engine, PAR_ITERS))
        ref[engine] = {f: getattr(r, f).cpu() for f in ("flux",
                                                        "final_temps")}
    p0 = g64.planet.physics_params()
    T = T64[:PAR_GRAD_COLUMNS].clone().requires_grad_(True)
    g = torch.tensor(float(p0.g), dtype=torch.float64, device=T.device,
                     requires_grad=True)
    par = PhysicsParams(g=g, m_bar=p0.m_bar, alpha=p0.alpha, n_dof=p0.n_dof)
    r = solve_rc_batched(T, args64[0], par, args64[2],
                         fixed("auto", 2, differentiable=True))
    loss = (r.flux ** 2).sum() / 1e26
    loss.backward()
    ref["grad"] = torch.cat([T.grad.reshape(-1), g.grad.reshape(1),
                             loss.detach().reshape(1)]).cpu()
    g32 = make_grid(torch.float32)
    T32 = columns(g32, N_COLUMNS)
    args32 = solver_args(g32)
    ref["f32/1"] = solve_rc_batched(T32, *args32, fixed("cuda", 1)).flux.cpu()
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = solve_rc_batched(T32, *args32, fixed("cuda"))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    ref["f32/20"] = r.flux.cpu()
    one_wall = walls[1:]
    del g64, T64, args64, T, g, par, r, loss, g32, T32, args32
    torch.cuda.empty_cache()

    out = root / "chip_smoke_data" / "parallel"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    try:
        t0 = time.perf_counter()
        run_ranks(2, [Path(__file__).resolve(), "--parallel-rank", out],
                  timeout=300, cwd=root)
        ranks_wall = time.perf_counter() - t0
        infos = [json.loads((out / f"rank{r}.json").read_text())
                 for r in range(2)]
        got = torch.load(out / "saved.pt")
    finally:
        shutil.rmtree(out, ignore_errors=True)
    assert [i["backend"] for i in infos] == ["gloo", "gloo"], infos
    for key, r in (("cuda/2x1", "cuda"), ("cuda/1x2", "cuda"),
                   ("loop/2x1", "loop"), ("iteration/2x1", "iteration")):
        # the top layer's temperature at 1e-8: its update is a nearly
        # cancelling difference of quadratures, which a bins split sums in
        # another order (1.6e-10 apart after 3 iterations; phase 4 holds
        # the kernels' temperatures to the eager engine's at 1e-8 for the
        # same reason)
        for label, a, b, rtol in (
                ("flux", got[f"{key}/flux"], ref[r]["flux"], 1e-10),
                ("final temps below the top layer",
                 got[f"{key}/final_temps"][:, :-1],
                 ref[r]["final_temps"][:, :-1], 1e-10),
                ("top layer's final temp", got[f"{key}/final_temps"][:, -1],
                 ref[r]["final_temps"][:, -1], 1e-8)):
            q = check_close(f"{key} {label}", a, b, rtol, 0.0)
            log(f"[parallel] gloo, two ranks on cuda:0, {key} float64 "
                f"{PAR64_COLUMNS} x {N_BINS} x {N_LAYERS} x {PAR_ITERS}: "
                f"{label} against the one-process solve max rel "
                f"{rel_err(a, b)[0]:.3e} (rtol {rtol:.0e}), err/bound "
                f"{q:.3f}")
    for i in infos:
        assert "engine 'iteration' does not support a bins-sharded mesh" \
            in i.get("iteration_bins_error", ""), i
    for s in ("2x1", "1x2"):
        q = check_close(f"gradient {s}", got[f"grad/{s}"], ref["grad"],
                        1e-10, 0.0)
        log(f"[parallel] gradients on {s}, summed over the ranks, against "
            f"the one-process ones (dL/dT0 of {PAR_GRAD_COLUMNS} columns, "
            f"dL/dg, the loss): max rel "
            f"{rel_err(got[f'grad/{s}'], ref['grad'])[0]:.3e}, err/bound "
            f"{q:.3f}")
    f1 = ref["f32/1"]
    q = check_close("float32 (1, 2) one iteration", got["f32/1/flux"], f1,
                    1e-4, 1e-5 * float(f1.abs().max()))
    d20 = float((got["f32/20/flux"] - ref["f32/20"]).abs().max()
                / ref["f32/20"].abs().max())
    walls = infos[0]["walls"]
    share = infos[0]["all_reduce_s"] / infos[0]["timed_wall"]
    log(f"[parallel] float32 (1, 2) mesh, {N_COLUMNS} x {N_BINS} x "
        f"{N_LAYERS}, 250 bins a rank: after one iteration flux max rel "
        f"{rel_err(got['f32/1/flux'], f1)[0]:.3e} (err/bound {q:.3f}); after "
        f"{N_ITERS} finite, max |dflux| / max flux {d20:.3e} (not asserted); "
        f"walls rank 0 {', '.join(f'{w:.4f}' for w in walls)} s, one "
        f"process {', '.join(f'{w:.4f}' for w in one_wall)} s; "
        f"{infos[0]['all_reduces']} quadrature all-reduces "
        f"{infos[0]['all_reduce_s']:.4f} s of a {infos[0]['timed_wall']:.4f} "
        f"s run ({share:.1%}); the two ranks' call {ranks_wall:.1f} s")
    for i in infos:
        for k, n in i["launches"].items():
            tally[k] += n
    wall = time.perf_counter() - t_start
    return dict(launches=tally, nccl_walls=one, f32_walls=walls,
                f32_one_process=one_wall, all_reduce_share=share,
                wall=wall)


def phase_headline(engines=("loop", "iteration", "cuda", "eager"), runs=3,
                   leg="headline", args=None):
    """Each engine's solve of the leg: one warm-up and ``runs`` timed
    solves, every launch count set to 0 just before and read just
    after.  ``args`` (consts, params, kappa_fn) default to the headline's
    grid (:func:`make_grid`); the population and chemistry legs pass
    theirs."""
    from frei_tpu_torch.rt.solver import SolverConfig, solve_rc_batched
    wrappers = kernel_wrappers()
    grid = make_grid(torch.float32)
    T0 = columns(grid, N_COLUMNS)
    if args is None:
        args = solver_args(grid)
    res = {}
    for engine in engines:
        cfg = SolverConfig(n_timesteps=N_ITERS, n_zero_crossings=10 ** 6,
                           convergence_dT=0.0, engine=engine)
        for w in wrappers.values():
            w.launches = 0
        out = None       # the last engine's result leaves the card first
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out = solve_rc_batched(T0, *args, cfg)      # warm-up
        torch.cuda.synchronize()
        walls = []
        for _ in range(runs):
            t0 = time.perf_counter()
            out = solve_rc_batched(T0, *args, cfg)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        launches = {k: w.launches for k, w in wrappers.items()}
        assert torch.isfinite(out.flux).all(), f"{engine}: non-finite flux"
        assert out.flux.shape == (N_COLUMNS, N_BINS)
        wall = min(walls)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        # a copy: the flux view would keep the whole F_up slab alive
        res[engine] = dict(wall=wall, walls=walls,
                           rate=N_COLUMNS * N_BINS / wall,
                           launches=launches, flux=out.flux.clone(),
                           peak_gb=peak_gb)
        log(f"[{leg}] engine={engine:9s} {N_COLUMNS} columns x "
            f"{N_BINS} bins x {N_LAYERS} layers x {N_ITERS} iterations "
            f"float32: walls {', '.join(f'{w:.4f}' for w in walls)} s, "
            f"{res[engine]['rate']:,.0f} columns*bins/s (best), peak "
            f"memory {peak_gb:.2f} GB, launches over {runs + 1} solves "
            f"{json.dumps(launches)}")
    main_path = {"cuda": ("emit_sweep", "absorb_sweep"),
                 "iteration": ("rc_iteration", "emit_sweep"),
                 "loop": ("rc_loop", "emit_sweep")}
    for engine, names in main_path.items():
        if engine not in res:
            continue
        got = res[engine]["launches"]
        assert all(got[k] > 0 for k in names), \
            f"{leg}: engine {engine} bypassed its kernels: {got}"
    if "eager" not in res:
        return res
    assert not any(res["eager"]["launches"].values()), \
        f"{leg}: eager engine ran a kernel"
    ref = res["eager"]["flux"]
    for engine in main_path:
        if engine not in res:
            continue
        d = (res[engine]["flux"] - ref).abs().max()
        log(f"[{leg}] {engine} vs eager after {N_ITERS} unconverged "
            f"float32 iterations: max |dflux| / max flux "
            f"{float(d / ref.abs().max()):.3e} (trajectories diverge "
            f"chaotically in float32; not asserted)")
    return res


def main(argv):
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; this "
                 "run needs an NVIDIA GPU")
    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root))
    if argv[:1] == ["--parallel-rank"]:
        # one rank of phase 4g's world of two, started by phase_parallel
        parallel_rank(Path(argv[1]))
        return
    from frei_tpu_torch import native
    from frei_tpu_torch.ops import iteration_cuda as IC
    from frei_tpu_torch.ops import kappa_cuda as KC
    from frei_tpu_torch.ops import rebin_cuda as RC
    from frei_tpu_torch.ops import sweep_cuda as S

    # phase 1: device
    torch.backends.cuda.matmul.allow_tf32 = False   # eager einsum in fp32
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"[device] {name} x{count}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}; TF32 off for matmul and cuDNN")
    log(smi)

    if argv in (["--ab-leg"], ["--ab-leg", "kappa"]):
        ab_leg(kappa_only=argv[1:] == ["kappa"])
        return
    if argv == ["--kappa"]:
        # the kappa kernel alone: build, every case, its plan, times and
        # variants
        log("\n".join(f"[build] {line}"
                      for line in ptxas_summary(KC.build())))
        phase_kappa()
        return
    if argv == ["--sweeps"]:
        # the sweep kernels alone: build, parity, times and variants
        log("\n".join(f"[build] {line}" for line in ptxas_summary(S.build())))
        phase_parity(torch.float64, PARITY64_COLUMNS, 1e-10, 1e-10, 1e-13,
                     timing=False)
        phase_parity(torch.float32, N_COLUMNS, 1e-4, 1e-5, 1e-7,
                     timing=True)
        phase_sweep_variants()
        phase_population_sweeps()
        return
    if argv == ["--iteration"]:
        # the whole-iteration kernels alone: build, parity, times and
        # variants
        log("\n".join(f"[build] {line}"
                      for line in ptxas_summary(IC.build())))
        phase_iteration_parity()
        phase_iteration_variants()
        phase_iteration_chemistry()
        return
    if argv == ["--differentiable"]:
        # the differentiable solve and item 13's paths: phase 4f (its
        # resume check runs the sweep kernels) and the gradient leg
        log("\n".join(f"[build] {line}" for line in ptxas_summary(S.build())))
        log(f"[differentiable] phase 4f passed in "
            f"{phase_differentiable(root):.1f} s")
        phase_gradient_leg()
        return
    if argv == ["--parallel"]:
        # the parallel plane alone: the sweep and whole-iteration kernels,
        # phase 4g
        with ThreadPoolExecutor(2) as pool:
            reports = list(pool.map(lambda m: m.build(), (S, IC)))
        log("\n".join(f"[build] {line}"
                      for line in ptxas_summary("".join(reports))))
        par = phase_parallel(root)
        log(f"[parallel] phase 4g passed in {par['wall']:.1f} s, launches "
            f"{json.dumps(par['launches'])}; {smi}")
        return
    if argv:
        sys.exit(f"chip_smoke: unknown arguments {argv}")

    # phase 2: build, one compiler per source, all started together
    t0 = time.perf_counter()
    with ThreadPoolExecutor(5) as pool:
        host = pool.submit(native.build_native)
        reports = list(pool.map(lambda m: m.build(), (S, IC, RC, KC)))
        host.result()
    log(f"[build] csrc/sweep.cu, iteration.cu, rebin.cu and kappa.cu (nvcc) "
        f"and rebin_host.cc (g++) -> csrc/build/ in "
        f"{time.perf_counter() - t0:.1f} s"
        + ("" if all(reports) else " (some already built)"))
    for line in ptxas_summary("".join(reports)):
        log(f"[build] {line}")

    # phase 3: kernel parity and kernel times
    phase_parity(torch.float64, PARITY64_COLUMNS, 1e-10, 1e-10, 1e-13,
                 timing=False)
    recs = phase_parity(torch.float32, N_COLUMNS, 1e-4, 1e-5, 1e-7,
                        timing=True)
    # phase 3d: where a sweep's time goes (the kernel's variants)
    phase_sweep_variants()
    # phase 3f: the sweep kernels with per-column constants (population)
    pop_ms = phase_population_sweeps()

    # phase 3b: the whole-iteration kernels against their twins, on the
    # mock chemistry's tables and on equilibrium tables (nTc = 64)
    whole = phase_iteration_parity()
    chem_build_3b, whole_chem = phase_iteration_chemistry()
    # phase 3e: where an RC step's time goes (the kernel's variants)
    phase_iteration_variants()
    # phase 3c: the opacity plane's kernels against their twins
    opac = phase_opacity_parity(make_grid(torch.float32).wl_bins)

    # phase 4: goldens through Grid(planet), which lands on the card
    phase_goldens()
    # phase 4b: the same goldens on the whole-iteration engines
    for engine in ("loop", "iteration"):
        phase_goldens_whole(engine)
    # phase 4c: the opacity plane end to end, on stores in the checkout
    data = root / "chip_smoke_data"
    shutil.rmtree(data, ignore_errors=True)
    try:
        etl = phase_etl(data)
    finally:
        shutil.rmtree(data, ignore_errors=True)
    log(f"[etl] on {smi}: load_opacities walls native "
        + ", ".join(f"{w:.4f}" for w in etl["walls"]["native"]) + " s, cuda "
        + ", ".join(f"{w:.4f}" for w in etl["walls"]["cuda"]) + " s")
    # phase 4d: a population of eight planets on the sweep kernels
    phase_population()
    # phase 4e: equilibrium chemistry through Grid(planet)
    chem, chem_build = phase_chemistry()
    log(f"[chemistry] on {smi}: default table builds on the card "
        f"{chem_build_3b:.2f} s (phase 3b), {chem_build:.2f} s (phase 4e)")
    # phase 4f: the differentiable solve, the associative scan, the
    # standalone drivers and checkpoint resume
    wall_4f = phase_differentiable(root)
    log(f"[differentiable] phase 4f passed in {wall_4f:.1f} s")

    # phase 5: the headline solve, then the population leg (bench.py's
    # draws) and the chemistry leg (the headline on equilibrium chemistry)
    head = phase_headline()
    log(f"[headline] on {smi}: " + ", ".join(
        f"{e} {head[e]['rate']:,.0f}" for e in head) + " columns*bins/s")
    grid = make_grid(torch.float32)
    pop = phase_headline(("cuda", "eager"), leg="population",
                         args=population_args(grid, N_COLUMNS))
    grid.load_opacities(opacities=grid.opacities, chemistry=chem)
    chem_leg = phase_headline(leg="chemistry", args=solver_args(grid))
    del grid
    for leg, r in (("population", pop), ("chemistry", chem_leg)):
        log(f"[{leg}] on {smi}: " + ", ".join(
            f"{e} {r[e]['rate']:,.0f} columns*bins/s, peak "
            f"{r[e]['peak_gb']:.2f} GB" for e in r))
    # the gradient leg: bench.py's size and the headline's
    grad_leg = phase_gradient_leg()
    log("[gradient] on " + smi + ": " + ", ".join(
        f"{n} columns {r['rate']:,.0f} columns*bins/s, best wall "
        f"{min(r['walls']):.4f} s, peak {r['peak_gb']:.2f} GB"
        for n, r in grad_leg.items()))

    # phase 4g: the parallel plane (NCCL on a world of one, then two gloo
    # ranks on this card)
    par = phase_parallel(root)
    log(f"[parallel] phase 4g passed in {par['wall']:.1f} s, launches "
        f"{json.dumps(par['launches'])}; {smi}")

    # each kernel: its time and its plain twin's at the main path's shapes,
    # the least time the card could take for the same work (bytes moved
    # over the HBM rate or float operations over the FP32 peak, whichever
    # is larger), one library call's time where one PyTorch call computes
    # the kernel's body, and the launches of the main path's run
    # (the kernels on the new legs also carry their launches there: the
    # population leg's "cuda" solves, the chemistry leg's solves on the
    # kernel's own engine)
    flops_sweep = SWEEP_FLOPS * N_COLUMNS * (N_LAYERS - 1) * N_BINS
    rows = []
    for k in ("emit", "absorb"):
        r = recs[k]
        name_ = f"{k}_sweep"
        rows.append((name_, "sweep.cu",
                     "frei_tpu/ops/sweep_pallas.py:"
                     + ("428" if k == "emit" else "484"),
                     head["cuda"]["launches"][name_],
                     dict(r, ms=r["ms_fused"], plain_ms=r["plain_ms_fused"],
                          bytes=r["bytes_fused"], flops=flops_sweep),
                     {"ms_materialized": r["ms_materialized"],
                      "plain_ms_materialized": r["plain_ms_materialized"],
                      "ms_population": pop_ms[k]["per-column"],
                      "launches_population":
                          pop["cuda"]["launches"][name_],
                      "launches_chemistry":
                          chem_leg["cuda"]["launches"][name_],
                      "launches_parallel": par["launches"][name_]}))
    for k, line in (("iteration", 163), ("loop", 297)):
        name_ = f"rc_{k}"
        rows.append((name_, "iteration.cu",
                     f"frei_tpu/ops/iteration_pallas.py:{line}",
                     head[k]["launches"][name_], whole[k],
                     {"launches_chemistry":
                          chem_leg[k]["launches"][name_],
                      "err_over_tol_chemistry":
                          whole_chem[k]["err_over_tol"],
                      "launches_parallel": par["launches"][name_]}))
    for k, name_, src, replaces in (
            ("kappa", "kappa_lookup", "kappa.cu",
             "frei_tpu/ops/kappa_pallas.py:48"),
            ("rebin", "resort_rebin", "rebin.cu",
             "frei_tpu/ops/rebin_pallas.py:47")):
        rows.append((name_, src, replaces, etl["launches"][name_], opac[k],
                     {x: opac[k][x] for x in ("ms_rounds", "variants")
                      if x in opac[k]}))
    kernels = []
    for name_, src, replaces, launches, r, extra in rows:
        bound_ms, bound_by = bound(r["bytes"], r["flops"])
        kernels.append({
            "name": name_, "route": "cuda",
            "source": f"frei_tpu_torch/csrc/{src}", "replaces": replaces,
            "launches": launches, "max_abs_err": r["max_abs_err"],
            "err_over_tol": r["err_over_tol"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": r.get("library_ms"), **extra})
        log(f"[kernels] {name_:12s} {r['ms']:.4f} ms, bound {bound_ms:.4f} "
            f"ms by {bound_by} ({bound_ms / r['ms']:.3f} of it), plain "
            f"{r['plain_ms']:.4f} ms, library "
            + (f"{r['library_ms']:.4f} ms" if "library_ms" in r else "none")
            + f", {launches} launches on the main path; {smi}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": name,
                                             "count": count}}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
