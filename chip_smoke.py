#!/usr/bin/env python3
"""Smoke run of frei_tpu_torch's main path on one NVIDIA GPU.

    python3 chip_smoke.py              # every phase (one card)
    python3 chip_smoke.py --sweeps     # build sweep.cu; phases 3 and 3d
    python3 chip_smoke.py --iteration  # build iteration.cu; phases 3b and 3e
    python3 chip_smoke.py --ab-leg     # one leg of a parent/change pair

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
3b. whole-iteration parity: the iteration kernel against its twin on
   one RC step (float64 at 64 columns, every third frozen, rtol 1e-10;
   float32 at 8192 columns), and the loop kernel against its twin
   (float64 at 64 columns over 3 iterations with some columns converging
   early; float32 at 8192 columns for 1 iteration); see
   :func:`hold_step` for how a step is held; each kernel's time against
   its twin's at the headline shape;
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
   lookup kernel in float64 at 64 columns (rtol 1e-10) and in float32
   at 8192 columns x 30 layers x 500 bins (rtol 1e-5 plus 1e-7 of the
   largest value), some points outside the hull; each kernel's time
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
   run and read after it).

The second-to-last line is a JSON record of the kernels (time, plain
twin, bound and what bounds it, library call, launches on the main
path); the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

N_COLUMNS, N_BINS, N_LAYERS, N_ITERS = 8192, 500, 30, 20
PARITY64_COLUMNS = 64
# the ETL's row chunk and a line-list store's wavelength axis (the
# H2O-sized store of docs/opacities.md has 2e6 samples)
ETL_ROWS, ETL_SAMPLES = 64, 2_000_000
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
    registers and spills, named as ``emit<float, NPT=2, mode 0>``."""
    out, kern, spill = [], None, ""
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '.*?"
                      r"(emit|absorb|iteration|loop|rebin|kappa)_kernelI"
                      r"([fd])(?:Li(\d+)E)?(?:Li(\d+)E)?", line)
        if m:
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


def make_grid(dtype):
    from frei_tpu_torch import Grid, Planet, load_example_opacity
    grid = Grid(Planet.from_hot_jupiter(), n_wl_bins=N_BINS,
                n_layers=N_LAYERS, T_ref=2400.0, dtype=dtype, device="cuda")
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


def ab_leg():
    """One leg of a parent/change comparison, on whatever checkout holds
    this file: each sweep kernel's time (phase 3's float32 timing) and a
    digest of its outputs, the whole-iteration kernels' times (one RC
    step, one 20-iteration loop) and the headline on the "loop",
    "iteration" and "cuda" engines.  Calls only wrappers every checkout
    of the port has.  Prints one JSON line."""
    from frei_tpu_torch.ops import iteration_cuda as IC
    from frei_tpu_torch.ops import sweep_cuda as S
    with ThreadPoolExecutor(2) as pool:
        list(pool.map(lambda m: m.build(), (S, IC)))
    recs = phase_parity(torch.float32, N_COLUMNS, 1e-4, 1e-5, 1e-7,
                        timing=True)
    whole = whole_times(plain=False)
    head = phase_headline(("loop", "iteration", "cuda"), runs=5)
    print(json.dumps({"ab_leg": {
        "root": str(Path(__file__).resolve().parent.name),
        "ms": {k: r["ms_fused"] for k, r in recs.items()},
        "ms_materialized": {k: r["ms_materialized"] for k, r in recs.items()},
        "sweep_sha256": sweep_digest(),
        "whole_ms": {k: r["ms"] for k, r in whole.items()},
        "walls": {e: h["walls"] for e, h in head.items()}}}), flush=True)


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
    from frei_tpu_torch.ops import kappa_cuda as KC
    from frei_tpu_torch.ops import rebin_cuda as RC
    dev = torch.device("cuda")
    rec = {"rebin": {"max_abs_err": 0.0, "err_over_tol": 0.0},
           "kappa": {"max_abs_err": 0.0, "err_over_tol": 0.0}}

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
    rec["rebin"]["ms"] = time_ms(lambda: RC.rebin_kernel(rows, plan), 20)
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
    log(f"[timing] rebin kernel {rec['rebin']['ms']:.4f} ms, plain twin "
        f"{rec['rebin']['plain_ms']:.4f} ms, one-hot torch.matmul "
        f"{rec['rebin']['library_ms']:.4f} ms ({ETL_ROWS} x {ETL_SAMPLES} "
        f"float32 samples -> {plan.n_bins} bins, device-resident)")
    del rows

    # kappa: float64 at 64 columns, float32 at the headline's width
    for dtype, n, rtol, atol_frac in (
            (torch.float64, PARITY64_COLUMNS, 1e-10, 0.0),
            (torch.float32, N_COLUMNS, 1e-5, 1e-7)):
        stack, mmr, T, P, sig = opacity_inputs(dtype, n)
        got, _ = KC.kappa_kernel(stack, mmr, T, P, sig)
        torch.cuda.synchronize()
        assert torch.equal(got, KC.kappa_kernel(stack, mmr, T, P, sig)[0]), \
            "repeated kappa launches differ"
        ref, _ = KC.kappa_plain(stack, mmr, T, P, sig)
        out = (ref == sig).all(-1)
        log(f"[parity] kappa {dtype} B={n}: {int(out.sum())} of "
            f"{out.numel()} lookup points outside the (T, P) hull")
        assert out.any() and not out.all()
        assert torch.equal(got[out], ref[out])
        hold("kappa", f"kappa {str(dtype):13s} B={n:5d} L={N_LAYERS} "
             f"W={N_BINS}", got, ref, rtol, atol_frac * float(ref.abs().max()))
        if dtype == torch.float32:
            del got, ref
            rec["kappa"]["ms"] = time_ms(
                lambda: KC.kappa_kernel(stack, mmr, T, P, sig), 20)
            rec["kappa"]["plain_ms"] = time_ms(
                lambda: KC.kappa_plain(stack, mmr, T, P, sig), 3)
            # the stack, the points and sigma in, (N, W) out; per output
            # value and species 4 corner multiply-adds and the mixing
            # ratio's (10 operations), plus sigma
            S_ = stack.values.shape[0]
            rec["kappa"]["bytes"] = (nbytes(stack.values, mmr, T, P, sig)
                                     + T.numel() * N_BINS * T.element_size())
            rec["kappa"]["flops"] = (10 * S_ + 1) * T.numel() * N_BINS
            rec["kappa"]["library_ms"] = kappa_library_ms(stack, T, P)
            log(f"[timing] kappa kernel {rec['kappa']['ms']:.4f} ms, plain "
                f"twin {rec['kappa']['plain_ms']:.4f} ms, one-hot "
                f"torch.matmul {rec['kappa']['library_ms']:.4f} ms ({n} x "
                f"{N_LAYERS} points x {N_BINS} bins, 2 species, float32)")
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


def phase_headline(engines=("loop", "iteration", "cuda", "eager"), runs=3):
    """Each engine's headline solve: one warm-up and ``runs`` timed
    solves, every launch count set to 0 just before and read just
    after."""
    from frei_tpu_torch.rt.solver import SolverConfig, solve_rc_batched
    wrappers = kernel_wrappers()
    grid = make_grid(torch.float32)
    T0 = columns(grid, N_COLUMNS)
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
        log(f"[headline] engine={engine:9s} {N_COLUMNS} columns x "
            f"{N_BINS} bins x {N_LAYERS} layers x {N_ITERS} iterations "
            f"float32: walls {', '.join(f'{w:.4f}' for w in walls)} s, "
            f"{res[engine]['rate']:,.0f} columns*bins/s (best), peak "
            f"memory {peak_gb:.2f} GB, launches over {runs + 1} solves "
            f"{json.dumps(launches)}")
    main_path = {"cuda": ("emit_sweep", "absorb_sweep"),
                 "iteration": ("rc_iteration", "emit_sweep"),
                 "loop": ("rc_loop", "emit_sweep")}
    for engine, names in main_path.items():
        got = res[engine]["launches"]
        assert all(got[k] > 0 for k in names), \
            f"engine {engine} bypassed its kernels: {got}"
    if "eager" not in res:
        return res
    assert not any(res["eager"]["launches"].values()), \
        "eager engine ran a kernel"
    ref = res["eager"]["flux"]
    for engine in ("loop", "iteration", "cuda"):
        d = (res[engine]["flux"] - ref).abs().max()
        log(f"[headline] {engine} vs eager after {N_ITERS} unconverged "
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

    if argv == ["--ab-leg"]:
        ab_leg()
        return
    if argv == ["--sweeps"]:
        # the sweep kernels alone: build, parity, times and variants
        log("\n".join(f"[build] {line}" for line in ptxas_summary(S.build())))
        phase_parity(torch.float64, PARITY64_COLUMNS, 1e-10, 1e-10, 1e-13,
                     timing=False)
        phase_parity(torch.float32, N_COLUMNS, 1e-4, 1e-5, 1e-7,
                     timing=True)
        phase_sweep_variants()
        return
    if argv == ["--iteration"]:
        # the whole-iteration kernels alone: build, parity, times and
        # variants
        log("\n".join(f"[build] {line}"
                      for line in ptxas_summary(IC.build())))
        phase_iteration_parity()
        phase_iteration_variants()
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

    # phase 3b: the whole-iteration kernels against their twins
    whole = phase_iteration_parity()
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

    # phase 5: the headline solve
    head = phase_headline()
    log(f"[headline] on {smi}: " + ", ".join(
        f"{e} {head[e]['rate']:,.0f}" for e in head) + " columns*bins/s")

    # each kernel: its time and its plain twin's at the main path's shapes,
    # the least time the card could take for the same work (bytes moved
    # over the HBM rate or float operations over the FP32 peak, whichever
    # is larger), one library call's time where one PyTorch call computes
    # the kernel's body, and the launches of the main path's run
    flops_sweep = SWEEP_FLOPS * N_COLUMNS * (N_LAYERS - 1) * N_BINS
    rows = []
    for k in ("emit", "absorb"):
        r = recs[k]
        rows.append((f"{k}_sweep", "sweep.cu",
                     "frei_tpu/ops/sweep_pallas.py:"
                     + ("428" if k == "emit" else "484"),
                     head["cuda"]["launches"][f"{k}_sweep"],
                     dict(r, ms=r["ms_fused"], plain_ms=r["plain_ms_fused"],
                          bytes=r["bytes_fused"], flops=flops_sweep),
                     {"ms_materialized": r["ms_materialized"],
                      "plain_ms_materialized": r["plain_ms_materialized"]}))
    for k, line in (("iteration", 163), ("loop", 297)):
        rows.append((f"rc_{k}", "iteration.cu",
                     f"frei_tpu/ops/iteration_pallas.py:{line}",
                     head[k]["launches"][f"rc_{k}"], whole[k], {}))
    for k, name_, src, replaces in (
            ("kappa", "kappa_lookup", "kappa.cu",
             "frei_tpu/ops/kappa_pallas.py:48"),
            ("rebin", "resort_rebin", "rebin.cu",
             "frei_tpu/ops/rebin_pallas.py:47")):
        rows.append((name_, src, replaces, etl["launches"][name_], opac[k],
                     {}))
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
