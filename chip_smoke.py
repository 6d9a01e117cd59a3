#!/usr/bin/env python3
"""Smoke run of frei_tpu_torch's main path on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one report line each, any failure raising (non-zero exit):

1. device: a CUDA device must be present (no CPU fallback); prints
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``;
2. build: compiles ``frei_tpu_torch/csrc/sweep.cu`` with nvcc and
   prints the build time and ptxas's register report;
3. kernel parity: each sweep kernel against its plain PyTorch twin on
   the card, fused and materialized opacity, some columns frozen:
   float64 at 64 columns (rtol 1e-10), float32 at 8192 columns (rtol
   1e-4 on slabs, sums and the emit's dtaus; 1e-5 on temperatures, plus
   the change the sums' own difference makes to the update, see
   :func:`phase_parity`), with each kernel's time against its twin's at
   the 8192-column shape;
4. goldens: ``Grid(..., device="cuda")`` + the synthetic fixture +
   ``emission_spectrum(n_timesteps=1)`` reproduce the published peak
   wavelength, peak flux and effective temperature through the kernels,
   and a float64 batched solve on the kernels agrees with the eager
   engine;
5. headline: the batched solve of 8192 columns x 500 bins x 30 layers,
   20 fixed iterations, float32, on the ``"cuda"`` and ``"eager"``
   engines: columns x bins per second, launch counts.

The second-to-last line is a JSON record of the kernels; the last line
is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

N_COLUMNS, N_BINS, N_LAYERS, N_ITERS = 8192, 500, 30, 20
PARITY64_COLUMNS = 64


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
    registers and spills, named as ``emit<float, NPT=2>``."""
    out, kern, spill = [], None, ""
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '.*?(emit|absorb)_kernel"
                      r"I([fd])Li(\d+)E", line)
        if m:
            kern = (f"{m[1]}<{'float' if m[2] == 'f' else 'double'}, "
                    f"NPT={m[3]}>")
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


def phase_parity(dtype, n, rtol, t_rtol, atol_frac, timing):
    """Each kernel against its twin; returns per-kernel records."""
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
        # emit also writes the solve's final dtaus diagnostic on request
        kw = {"with_dtaus": True} if name == "emit" else {}
        for form, kap in kaps.items():
            got = wrap(T, Fu, Fd, kap, sc, done, **kw)
            torch.cuda.synchronize()
            ref = plain(T, Fu, Fd, kap, sc, done, **kw)
            t_got, dT_got = epi(T, got[2], p, params)
            t_ref, dT_ref = epi(T, ref[2], p, params)
            # Slabs and sums: rtol, plus atol_frac of the largest value
            # for entries near zero.  Temperatures and dT come from the
            # sums through the same torch epilogue.  At fixed T and p the
            # update goes as sign(num) |num|^0.1, num the numerator of the
            # flux divergence: a difference of four quadratures that
            # nearly cancel in optically thin layers.  Numerators that
            # differ by r <= 0.1 move dT by at most 0.105 r |dT|, so dT is
            # held at rtol plus 0.2 r |dT|.  Where r > 0.1 (float32, the
            # optically thin top layers only) float32 quadratures cannot
            # resolve the update in any engine: those layers are counted
            # and must lie in the top three, and are not compared.
            top = name == "emit"
            num_ref = update_numerator(ref[2], T, p, params, top)
            num_got = update_numerator(got[2], T, p, params, top)
            r_num = (num_got - num_ref).abs() / num_ref.abs()
            resolved = r_num <= 0.1
            t_atol = torch.where(resolved, 0.2 * dT_ref.abs() * r_num,
                                 float("inf"))
            loose = sorted(set((~resolved).nonzero()[:, 1].tolist()))
            log(f"[parity] {name:6s} {form:12s} {str(dtype):13s} "
                f"B={n:5d} layers whose update float{dtype.itemsize * 8} "
                f"quadratures cannot resolve (r > 0.1): "
                f"{int((~resolved).sum())} of {resolved.numel()}, all in "
                f"layers {loose}")
            assert all(l >= N_LAYERS - 3 for l in loose), loose
            if dtype == torch.float64:
                assert not loose, loose
            checks = [("F_up", got[0], ref[0]), ("F_down", got[1], ref[1]),
                      ("sums", got[2], ref[2]), ("temps", t_got, t_ref)]
            if kw:
                checks.append(("dtaus", got[3], ref[3]))
            if dtype == torch.float64:
                checks.append(("dT", dT_got, dT_ref))
            for field, a, b in checks:
                if field in ("temps", "dT"):
                    q = check_close(f"{name} {form} {dtype} {field}", a, b,
                                    t_rtol, t_atol)
                    r, ab = rel_err(a[resolved], b[resolved])
                    field += " (resolved layers)"
                else:
                    q = check_close(f"{name} {form} {dtype} {field}", a, b,
                                    rtol, atol_frac * float(b.abs().max()))
                    r, ab = rel_err(a, b)
                    rec["max_abs_err"] = max(rec["max_abs_err"], ab)
                    rec["err_over_tol"] = max(rec["err_over_tol"], q)
                log(f"[parity] {name:6s} {form:12s} {str(dtype):13s} "
                    f"B={n:5d} {field:6s} max rel {r:.3e} max abs {ab:.3e} "
                    f"max err/bound {q:.3f}")
            if timing:
                ms = time_ms(lambda: wrap(T, Fu, Fd, kap, sc, done), 10)
                plain_ms = time_ms(lambda: plain(T, Fu, Fd, kap, sc, done),
                                   3)
                log(f"[timing] {name:6s} {form:12s} kernel {ms:.4f} ms, "
                    f"plain twin {plain_ms:.4f} ms (B={n}, L={N_LAYERS}, "
                    f"W={N_BINS}, {dtype})")
                rec[f"ms_{form}"] = ms
                rec[f"plain_ms_{form}"] = plain_ms
        out[name] = rec
    return out


def phase_goldens():
    from frei_tpu_torch import effective_temperature
    from frei_tpu_torch.ops import sweep_cuda as S
    from frei_tpu_torch.rt.solver import SolverConfig, solve_rc_batched
    grid = make_grid(torch.float32)
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


def phase_headline():
    from frei_tpu_torch.ops import sweep_cuda as S
    from frei_tpu_torch.rt.solver import SolverConfig, solve_rc_batched
    grid = make_grid(torch.float32)
    T0 = columns(grid, N_COLUMNS)
    args = solver_args(grid)
    res = {}
    for engine in ("cuda", "eager"):
        cfg = SolverConfig(n_timesteps=N_ITERS, n_zero_crossings=10 ** 6,
                           convergence_dT=0.0, engine=engine)
        if engine == "cuda":     # the main path's run: counts from zero
            S.emit_kernel.launches = S.absorb_kernel.launches = 0
        n0 = (S.emit_kernel.launches, S.absorb_kernel.launches)
        torch.cuda.reset_peak_memory_stats()
        out = solve_rc_batched(T0, *args, cfg)      # warm-up
        torch.cuda.synchronize()
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            out = solve_rc_batched(T0, *args, cfg)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        n1 = (S.emit_kernel.launches, S.absorb_kernel.launches)
        assert torch.isfinite(out.flux).all(), f"{engine}: non-finite flux"
        assert out.flux.shape == (N_COLUMNS, N_BINS)
        wall = min(walls)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        res[engine] = dict(wall=wall, rate=N_COLUMNS * N_BINS / wall,
                           launches=(n1[0] - n0[0], n1[1] - n0[1]),
                           flux=out.flux)
        log(f"[headline] engine={engine:5s} {N_COLUMNS} columns x "
            f"{N_BINS} bins x {N_LAYERS} layers x {N_ITERS} iterations "
            f"float32: walls {', '.join(f'{w:.4f}' for w in walls)} s, "
            f"{res[engine]['rate']:,.0f} columns*bins/s (best), peak "
            f"memory {peak_gb:.2f} GB, launches emit "
            f"{n1[0] - n0[0]} absorb {n1[1] - n0[1]}")
    assert min(res["cuda"]["launches"]) > 0, "main path bypassed the kernels"
    assert res["eager"]["launches"] == (0, 0), "eager engine ran a kernel"
    d = (res["cuda"]["flux"] - res["eager"]["flux"]).abs().max()
    log(f"[headline] cuda vs eager after {N_ITERS} unconverged float32 "
        f"iterations: max |dflux| / max flux "
        f"{float(d / res['eager']['flux'].abs().max()):.3e} (trajectories "
        f"diverge chaotically in float32; not asserted)")
    return res


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; this "
                 "run needs an NVIDIA GPU")
    sys.path.insert(0, str(Path(__file__).resolve().parent))
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

    # phase 2: build
    t0 = time.perf_counter()
    report = S.build()
    log(f"[build] csrc/sweep.cu -> csrc/build/libfrei_sweep.so in "
        f"{time.perf_counter() - t0:.1f} s"
        + ("" if report else " (already built)"))
    for line in ptxas_summary(report):
        log(f"[build] {line}")

    # phase 3: kernel parity and kernel times
    phase_parity(torch.float64, PARITY64_COLUMNS, 1e-10, 1e-10, 1e-13,
                 timing=False)
    recs = phase_parity(torch.float32, N_COLUMNS, 1e-4, 1e-5, 1e-7,
                        timing=True)

    # phase 4: goldens through Grid(device="cuda")
    phase_goldens()

    # phase 5: the headline solve
    head = phase_headline()
    log(f"[headline] on {smi}: cuda {head['cuda']['rate']:,.0f} vs eager "
        f"{head['eager']['rate']:,.0f} columns*bins/s")

    kernels = []
    for i, k in enumerate(("emit", "absorb")):
        r = recs[k]
        kernels.append({
            "name": f"{k}_sweep", "route": "cuda",
            "source": "frei_tpu_torch/csrc/sweep.cu",
            "replaces": ("frei_tpu/ops/sweep_pallas.py:428" if k == "emit"
                         else "frei_tpu/ops/sweep_pallas.py:484"),
            "launches": head["cuda"]["launches"][i],
            "max_abs_err": r["max_abs_err"],
            "err_over_tol": r["err_over_tol"],
            "ms": r["ms_fused"], "plain_ms": r["plain_ms_fused"],
            "ms_materialized": r["ms_materialized"],
            "plain_ms_materialized": r["plain_ms_materialized"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": name,
                                             "count": count}}), flush=True)


if __name__ == "__main__":
    main()
