// Whole radiative-convective iteration and whole RC loop for NVIDIA
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of frei_tpu/ops/iteration_pallas.py:
//   * iteration_kernel <- `_kernel` (launched by `rc_iteration_pallas`):
//     one RC step for every column;
//   * loop_kernel      <- `_loop_kernel` (launched by `rc_loop_pallas`):
//     the whole fixed-horizon loop, with the convergence counters, the
//     temperature history, max|dT| per iteration, n_iters and the
//     per-layer converged flags.
// The Python wrappers and their plain PyTorch twins live in
// frei_tpu_torch/ops/iteration_cuda.py.
//
// One RC step of one column, all of it inside the block:
//   1. the column's kappa T-interpolation weights for every layer (index
//      and two weights, zero-filled outside the table's T grid with the
//      8-ULP hull) and its chemistry: a clipped 1-D interpolation of each
//      species' ln MMR table in log10 T, then mmr = exp(ln_mmr);
//   2. the emit sweep (layers 1 .. L-1) with
//      kappa = sum_s mmr_s (w_lo tab[l,s,i] + w_hi tab[l,s,i+1]) + sigma,
//      masked writes under `done` and four quadratures per layer;
//   3. the dT epilogue of frei_tpu_torch/rt/physics.py (flux divergence,
//      adaptive timestep, temperature change) on the block's quadratures,
//      giving T1 = T - dT1;
//   4. weights at T1, the absorb sweep (layers L-2 .. 0), the epilogue
//      again, giving T2 = T1 - dT2.
// The loop kernel repeats that, records history rows 2 it and 2 it + 1,
// the incremental zero-crossing counters and the per-layer test
// (flips > n_zero_crossings or |dT2| < convergence_dT), and stops once
// every layer of its column has converged.
//
// What bounds it on an H100: the sweeps.  A sweep touches the two flux
// slabs once (B x L x W values each, 491.5 MB at 8192 columns x 30 layers
// x 500 bins in float32) and spends two expm1, one rsqrt and four IEEE
// divisions per element and layer, about 0.7 ms by instructions at that
// shape (the note in sweep.cu).  The two-kernel engine adds ~30 small
// torch launches per sweep for the epilogue and the weight rows, and one
// host sync per iteration; the iteration kernel removes those, and the
// loop kernel also moves the slabs through device memory once per solve
// instead of once per sweep (40 sweeps at the headline's 20 iterations),
// so it is bounded near 40 x 0.7 ms of compute.  The serial layer chain
// of each thread and the occupancy (registers; chip_smoke.py prints
// ptxas's report) decide where it lands, as for sweep.cu.
//
// What the design does about it:
//   * One block owns one column; each thread owns NPT wavelengths and
//     runs every layer loop in registers, as in sweep.cu.  A thread's
//     wavelengths exchange nothing with other wavelengths except through
//     the quadratures, so each thread updates its own entries of the
//     output slabs in place: the sweep orderings only read rows not yet
//     written in the same sweep.
//   * The weights and mixing ratios of all L layers are built once per
//     sweep into shared memory (the sweep's temperatures are fixed for
//     its duration).  A linear T interpolation leaves two non-zero
//     weights per species, so only two k_tab rows are read per species,
//     coalesced along W; the tables stay in L2.
//   * Quadratures: warp shuffles into per-layer shared slots, one barrier
//     after the layer loop, a sum over warps in warp order (twostream.cuh):
//     deterministic, no atomics.  Then threads 0 .. L-1 run the epilogue,
//     with the double selects and sequential divisions of rt/physics.py.
//   * Early exit: the TPU kernel runs a fixed trip count because one grid
//     instance holds 8 columns.  Here a block holds one column and leaves
//     its loop once that column has converged; frozen trips are masked
//     no-ops, so the outputs are identical.  History and max|dT| are
//     zero-initialized by the kernel.
//   * No padding of B; the scalars are kernel arguments.
//
// Bound to PyTorch through plain extern "C" launchers taking one argument
// struct (mirrored by a ctypes.Structure in iteration_cuda.py); each
// returns cudaGetLastError() after the launch, launches on the caller's
// stream and does not synchronize.

#include <cfloat>
#include <cuda_runtime.h>
#include <stdint.h>

#include "twostream.cuh"

namespace {

using namespace frei;

constexpr int kMaxThreads = 256;

struct IterArgs {
  // inputs
  const void* temps;       // (B, L)
  const void* F_up;        // (B, L, W)
  const void* F_down;      // (B, L, W)
  const uint8_t* done;     // (B,) freeze flags, or null (iteration only)
  const void* k_tgrid;     // (nT,) kappa table temperature grid [K]
  const void* k_tab;       // (L, S, nT, W) layer opacity tables
  const void* c_tgrid;     // (nTc,) chemistry log10 T grid
  const void* c_tab;       // (L, S, nTc) layer ln-MMR tables
  const void* c1;          // (W,) 2 h c^2 / lam^5
  const void* xrow;        // (W,) h c / (k lam)
  const void* sigma;       // (W,) scattering opacity
  const void* f_toa;       // (W,) top-of-atmosphere flux
  const void* tw;          // (W,) trapezoid weights
  const void* dtf_emit;    // (L-1,) dtau factors, emit ordering
  const void* dtf_absorb;  // (L-1,) dtau factors, absorb ordering
  const void* p1e;         // (L-1,) emit p1 = p[1:]
  const void* p2e;         // (L-1,) emit p2 = p[2:] + extrapolated top
  const void* p1a;         // (L-1,) absorb p1 = p[:-1]
  const void* p2a;         // (L-1,) absorb p2 = p[1:]
  // outputs
  void* F_up_out;          // (B, L, W)
  void* F_down_out;        // (B, L, W)
  void* T1;                // (B, L) iteration kernel
  void* T2;                // (B, L) iteration kernel
  void* dT2;               // (B, L) iteration kernel
  void* temps_out;         // (B, L) loop kernel
  void* hist;              // (B, 2 n_timesteps, L) loop kernel
  void* max_dT;            // (B, n_timesteps) loop kernel
  int32_t* n_iters;        // (B,) loop kernel
  uint8_t* conv;           // (B, L) loop kernel
  void* sums;              // (B, 2, 4, L-1) quadratures of the (last) step's
                           // emit and absorb sweeps, or null
  // scalars
  double g, m_bar, alpha, n_dof, k_B, sigma_sb, convergence_dT;
  int B, L, W, S, nT, nTc, n_timesteps, n_zero_crossings;
};

template <typename T> __device__ __forceinline__ T eps_t();
template <> __device__ __forceinline__ float eps_t<float>() { return FLT_EPSILON; }
template <> __device__ __forceinline__ double eps_t<double>() { return DBL_EPSILON; }

template <typename T> __device__ __forceinline__ T log_t(T x) { return log(x); }
template <> __device__ __forceinline__ float log_t<float>(float x) { return logf(x); }
template <typename T> __device__ __forceinline__ T exp_t(T x) { return exp(x); }
template <> __device__ __forceinline__ float exp_t<float>(float x) { return expf(x); }
template <typename T> __device__ __forceinline__ T sqrt_t(T x) { return sqrt(x); }
template <> __device__ __forceinline__ float sqrt_t<float>(float x) { return sqrtf(x); }
template <typename T> __device__ __forceinline__ T pow_t(T x, T y) { return pow(x, y); }
template <> __device__ __forceinline__ float pow_t<float>(float x, float y) {
  return powf(x, y);
}
template <typename T> __device__ __forceinline__ T abs_t(T x) { return fabs(x); }
template <> __device__ __forceinline__ float abs_t<float>(float x) { return fabsf(x); }

// Physical scalars in the working type.
template <typename T>
struct Phys {
  T g, m_bar, alpha, k_B, sigma_sb, c_p;
};

// The epilogue of rt/physics.py for one swept layer: div_bol_net_flux,
// radiative_timestep and delta_temperature, operation by operation.
template <typename T>
__device__ T delta_temperature(const Phys<T>& ph, T bu2, T bd2, T bu1, T bd1, T T1, T T2,
                               T p1, T p2) {
  const T dz = (ph.k_B * T1 / ph.m_bar) / ph.g * log_t<T>(p1 / p2);
  const T rho = ((p1 - p2) / ph.g) / dz;
  const T dg = (T1 - T2) / dz - ph.g / ph.c_p;
  const T dg_safe = dg > T(0) ? dg : T(1);
  const T ml = ph.alpha * (ph.k_B * T1 / ph.m_bar) / ph.g;
  const T flux = rho * ph.c_p * (ml * ml) * sqrt_t<T>(ph.g / T1) * pow_t<T>(dg_safe, T(1.5));
  const T f_conv = dg > T(0) ? flux : T(0);
  const T div = (((bu2 - bd2) - (bu1 - bd1)) + f_conv) / dz;
  const T dF = div * dz;
  const T dF_safe = dF != T(0) ? dF : T(1);
  const T f_pre = dF != T(0) ? T(1e5) / pow_t<T>(abs_t<T>(dF_safe), T(0.9)) : T(1);
  const T dt_rad = ph.c_p * p1 / (ph.sigma_sb * ph.g * (T1 * T1 * T1));
  const T dt_conv = sqrt_t<T>(T1 / (ph.g * dg_safe));
  const T dt = f_pre * (dg > T(0) ? (dt_conv < dt_rad ? dt_conv : dt_rad) : dt_rad);
  return div * dt / (rho * ph.c_p);
}

// Shared memory of one block: T arrays first, then int arrays.
template <typename T>
struct Smem {
  T* part;   // (3 (L-1) + 1) x nwarps quadrature partials
  T* sums;   // (4, L-1) block quadratures of the last sweep
  T* tc;     // (L,) temperatures at the start of the step
  T* t1;     // (L,) after the emit update
  T* t2;     // (L,) after the absorb update
  T* dt;     // (L,) the absorb's dT
  T* wlo;    // (L,) kappa T weights (zero outside the grid)
  T* whi;    // (L,)
  T* mmr;    // (L, S) mixing ratios
  T* prevT;  // (L,) loop: last history row
  T* prevS;  // (L,) loop: sign of the last history difference
  int* kidx;   // (L,) lower kappa T index
  int* flips;  // (L,) loop: sign flips
  int* conv;   // (L,) loop: converged flags
};

__host__ __device__ inline size_t smem_bytes(int L, int S, int nwarps, size_t elem) {
  const size_t nt = (size_t)(3 * (L - 1) + 1) * nwarps + 4 * (L - 1) + 9 * (size_t)L
                    + (size_t)L * S;
  return nt * elem + 3 * (size_t)L * sizeof(int);
}

template <typename T>
__device__ __forceinline__ Smem<T> smem_in(unsigned char* raw, int L, int S) {
  Smem<T> sm;
  T* p = reinterpret_cast<T*>(raw);
  sm.part = p;
  p += (3 * (L - 1) + 1) * (blockDim.x >> 5);
  sm.sums = p; p += 4 * (L - 1);
  sm.tc = p; p += L;
  sm.t1 = p; p += L;
  sm.t2 = p; p += L;
  sm.dt = p; p += L;
  sm.wlo = p; p += L;
  sm.whi = p; p += L;
  sm.prevT = p; p += L;
  sm.prevS = p; p += L;
  sm.mmr = p; p += (size_t)L * S;
  int* q = reinterpret_cast<int*>(p);
  sm.kidx = q; q += L;
  sm.flips = q; q += L;
  sm.conv = q;
  return sm;
}

// Lower index of a linear interpolation on an ascending grid c[0..n-1]:
// searchsorted(side='right') - 1, clipped to [0, n-2].
template <typename T>
__device__ __forceinline__ int lower_index(const T* c, int n, T x) {
  int i = -1;
  for (int t = 0; t < n; ++t) i += (x >= c[t]) ? 1 : 0;
  return i < 0 ? 0 : (i > n - 2 ? n - 2 : i);
}

// Weights and mixing ratios of every layer at the temperatures `temps`
// (shared); the caller's barrier publishes them.
template <typename T>
__device__ __forceinline__ void build_weights(const IterArgs& a, const Smem<T>& sm,
                                              const T* temps) {
  const T* ktg = static_cast<const T*>(a.k_tgrid);
  const T* ctg = static_cast<const T*>(a.c_tgrid);
  const T* ctab = static_cast<const T*>(a.c_tab);
  const int nT = a.nT, nTc = a.nTc, S = a.S;
  const T eps = T(8) * eps_t<T>();
  const T lo = ktg[0] - eps * abs_t<T>(ktg[0]);
  const T hi = ktg[nT - 1] + eps * abs_t<T>(ktg[nT - 1]);
  for (int l = threadIdx.x; l < a.L; l += blockDim.x) {
    const T x = temps[l];
    const int i = lower_index<T>(ktg, nT, x);
    const T f = (x - ktg[i]) / (ktg[i + 1] - ktg[i]);
    const T ok = (x >= lo && x <= hi) ? T(1) : T(0);
    sm.kidx[l] = i;
    sm.wlo[l] = (T(1) - f) * ok;
    sm.whi[l] = f * ok;
    // chemistry: jnp.clip, then the same interpolation without a hull
    T y = log_t<T>(x) * T(1.0 / 2.302585092994046);
    y = y < ctg[0] ? ctg[0] : y;
    y = y > ctg[nTc - 1] ? ctg[nTc - 1] : y;
    const int j = lower_index<T>(ctg, nTc, y);
    const T h = (y - ctg[j]) / (ctg[j + 1] - ctg[j]);
    const T* cl = ctab + (size_t)l * S * nTc + j;
    for (int s = 0; s < S; ++s)
      sm.mmr[l * S + s] = exp_t<T>((T(1) - h) * cl[s * nTc] + h * cl[s * nTc + 1]);
  }
}

// Total opacity of layer l at wavelength w from the shared weights.
template <typename T>
__device__ __forceinline__ T kappa_at(const IterArgs& a, const Smem<T>& sm, int l, int w,
                                      T sig) {
  const T* kt = static_cast<const T*>(a.k_tab) + ((size_t)l * a.S * a.nT + sm.kidx[l]) * a.W + w;
  const T wl = sm.wlo[l], wh = sm.whi[l];
  const T* m = sm.mmr + l * a.S;
  const size_t stride = (size_t)a.nT * a.W;
  T acc = T(0);
  for (int s = 0; s < a.S; ++s) {
    const T* r = kt + s * stride;
    acc += (wl * r[0] + wh * r[a.W]) * m[s];
  }
  return acc + sig;
}

// Per-thread wavelength rows, loaded once per kernel.
template <typename T, int NPT>
struct Rows {
  bool ok[NPT];
  int wi[NPT];
  T c1[NPT], xr[NPT], sg[NPT], tw[NPT];
};

template <typename T, int NPT>
__device__ __forceinline__ void load_rows(const IterArgs& a, Rows<T, NPT>& r) {
#pragma unroll
  for (int j = 0; j < NPT; ++j) {
    r.wi[j] = threadIdx.x + j * blockDim.x;
    r.ok[j] = r.wi[j] < a.W;
    const int w = r.ok[j] ? r.wi[j] : 0;
    r.c1[j] = static_cast<const T*>(a.c1)[w];
    r.xr[j] = static_cast<const T*>(a.xrow)[w];
    r.sg[j] = static_cast<const T*>(a.sigma)[w];
    r.tw[j] = r.ok[j] ? static_cast<const T*>(a.tw)[w] : T(0);
  }
}

// Emit sweep at the temperatures sm.tc.  Reads the stale state from
// (Fu, Fd), writes (Fuo, Fdo), which may alias them; a frozen column
// writes its old rows back.  Leaves the block quadratures in sm.sums.
template <typename T, int NPT>
__device__ __forceinline__ void emit_pass(const IterArgs& a, const Smem<T>& sm,
                                          const Rows<T, NPT>& r, const T* Fu, const T* Fd,
                                          T* Fuo, T* Fdo, bool frozen) {
  const int L = a.L, W = a.W, n = L - 1;
  const T* Tb = sm.tc;
  const T* dtf = static_cast<const T*>(a.dtf_emit);
  const T* ftoa = static_cast<const T*>(a.f_toa);
  T z[NPT], B1[NPT];
  const T inv1 = T(1) / Tb[1];
  T q0 = T(0);
#pragma unroll
  for (int j = 0; j < NPT; ++j) {
    z[j] = T(0);
    B1[j] = T(0);
    if (!r.ok[j]) continue;
    const int w = r.wi[j];
    if (Fuo != Fu) {         // rows the sweep copies through
      Fuo[w] = Fu[w];
      Fuo[W + w] = Fu[W + w];
      Fdo[w] = Fd[w];
    }
    z[j] = Fu[W + w];        // F_1_up carry
    B1[j] = r.c1[j] / expm1_t<T>(r.xr[j] * inv1);
    q0 += z[j] * r.tw[j];
  }
  warp_partial(q0, sm.part, 3 * n);   // incoming F_up of layer 1

  for (int i = 0; i < n; ++i) {
    const int l = i + 1;
    const bool top = (i == n - 1);
    const T dt = dtf[i];
    const T inv2 = top ? T(0) : T(1) / Tb[l + 1];
    T q1 = T(0), q2 = T(0);
    q0 = T(0);
#pragma unroll
    for (int j = 0; j < NPT; ++j) {
      if (!r.ok[j]) continue;
      const int w = r.wi[j];
      const T kk = kappa_at<T>(a, sm, l, w, r.sg[j]);
      const T dtau = kk * dt;
      const T om = r.sg[j] / (r.sg[j] + kk);
      T B2, F2d;
      if (!top) {
        B2 = r.c1[j] / expm1_t<T>(r.xr[j] * inv2);
        F2d = Fd[(size_t)(l + 1) * W + w];
      } else {  // T2 = T[-1] at the top: B2 = B1, incoming flux F_TOA
        B2 = B1[j];
        F2d = ftoa[w];
      }
      const Couplers<T> cp = couplers_g0<T>(dtau, om, B1[j], B2);
      const T u = z[j];
      z[j] = cp.a * u + (-cp.b * F2d + cp.s_up);
      const T F1d = cp.a * F2d - cp.b * u + cp.s_down;
      if (!top) {  // the top layer's outgoing flux is never stored
        const size_t o = (size_t)(l + 1) * W + w;
        Fuo[o] = frozen ? Fu[o] : z[j];
      }
      const size_t o = (size_t)l * W + w;
      Fdo[o] = frozen ? Fd[o] : F1d;
      q0 += z[j] * r.tw[j];
      q1 += F2d * r.tw[j];
      q2 += F1d * r.tw[j];
      B1[j] = B2;
    }
    warp_partial(q0, sm.part, i);           // outgoing F_up
    warp_partial(q1, sm.part, n + i);       // incoming F_down
    warp_partial(q2, sm.part, 2 * n + i);   // outgoing F_down
  }
  __syncthreads();
  for (int s = threadIdx.x; s < 3 * n + 1; s += blockDim.x) {
    const T t = slot_total(sm.part, s);
    const int q = s / n, i = s % n;
    if (q == 3) {
      sm.sums[2 * n] = t;                      // incoming F_up of layer 1
    } else if (q == 0) {
      sm.sums[i] = t;
      if (i + 1 < n) sm.sums[2 * n + i + 1] = t;  // next layer's incoming F_up
    } else {
      sm.sums[(q == 1 ? 1 : 3) * n + i] = t;
    }
  }
  __syncthreads();
}

// Absorb sweep at the temperatures sm.t1 on the state the emit sweep left
// in (Fuo, Fdo); a frozen column writes the rows of (Fu, Fd) back.
template <typename T, int NPT>
__device__ __forceinline__ void absorb_pass(const IterArgs& a, const Smem<T>& sm,
                                            const Rows<T, NPT>& r, const T* Fu, const T* Fd,
                                          T* Fuo, T* Fdo, bool frozen) {
  const int L = a.L, W = a.W, n = L - 1;
  const T* Tb = sm.t1;
  const T* dtf = static_cast<const T*>(a.dtf_absorb);
  T d[NPT], B2[NPT];
  const T invL = T(1) / Tb[L - 1];
  T q2 = T(0);
#pragma unroll
  for (int j = 0; j < NPT; ++j) {
    d[j] = T(0);
    B2[j] = T(0);
    if (!r.ok[j]) continue;
    d[j] = Fdo[(size_t)(L - 1) * W + r.wi[j]];   // F_2_down carry
    B2[j] = r.c1[j] / expm1_t<T>(r.xr[j] * invL);
    q2 += d[j] * r.tw[j];
  }
  warp_partial(q2, sm.part, 3 * n);   // incoming F_down of layer L-2

  for (int i = n - 1; i >= 0; --i) {
    const T dt = dtf[i];
    const T inv1 = T(1) / Tb[i];
    T q0 = T(0), q1 = T(0);
    q2 = T(0);
#pragma unroll
    for (int j = 0; j < NPT; ++j) {
      if (!r.ok[j]) continue;
      const int w = r.wi[j];
      const T kk = kappa_at<T>(a, sm, i, w, r.sg[j]);
      const T dtau = kk * dt;
      const T om = r.sg[j] / (r.sg[j] + kk);
      const T B1 = r.c1[j] / expm1_t<T>(r.xr[j] * inv1);
      const Couplers<T> cp = couplers_g0<T>(dtau, om, B1, B2[j]);
      const size_t o1 = (size_t)i * W + w;
      const size_t o2 = (size_t)(i + 1) * W + w;
      const T F1u = Fuo[o1];   // stale: the emit sweep's output
      const T dn = d[j];
      d[j] = cp.a * dn + (-cp.b * F1u + cp.s_down);
      const T F2u = cp.a * F1u - cp.b * dn + cp.s_up;
      Fdo[o1] = frozen ? Fd[o1] : d[j];
      Fuo[o2] = frozen ? Fu[o2] : F2u;
      q0 += F2u * r.tw[j];
      q1 += F1u * r.tw[j];
      q2 += d[j] * r.tw[j];
      B2[j] = B1;
    }
    warp_partial(q0, sm.part, i);           // outgoing F_up
    warp_partial(q1, sm.part, n + i);       // incoming F_up
    warp_partial(q2, sm.part, 2 * n + i);   // outgoing F_down
  }
  __syncthreads();
  for (int s = threadIdx.x; s < 3 * n + 1; s += blockDim.x) {
    const T t = slot_total(sm.part, s);
    const int q = s / n, i = s % n;
    if (q == 3) {
      sm.sums[n + n - 1] = t;                  // incoming F_down of layer L-2
    } else if (q == 2) {
      sm.sums[3 * n + i] = t;
      if (i > 0) sm.sums[n + i - 1] = t;       // next layer's incoming F_down
    } else {
      sm.sums[(q == 0 ? 0 : 2) * n + i] = t;
    }
  }
  __syncthreads();
}

// The block quadratures of the last sweep into the optional diagnostic
// output (already offset to this column and sweep), or nowhere.
template <typename T>
__device__ __forceinline__ void store_sums(const Smem<T>& sm, T* out, int n) {
  if (out == nullptr) return;
  for (int s = threadIdx.x; s < 4 * n; s += blockDim.x) out[s] = sm.sums[s];
}

// One RC step from sm.tc: T1 into sm.t1, T2 into sm.t2, dT2 into sm.dt;
// the quadratures of both sweeps into `sums_out` unless it is null.
template <typename T, int NPT>
__device__ __forceinline__ void rc_step(const IterArgs& a, const Smem<T>& sm,
                                        const Rows<T, NPT>& r, const Phys<T>& ph,
                                        const T* Fu, const T* Fd, T* Fuo, T* Fdo,
                                        bool frozen, T* sums_out) {
  const int L = a.L, n = L - 1;
  const T* p1e = static_cast<const T*>(a.p1e);
  const T* p2e = static_cast<const T*>(a.p2e);
  const T* p1a = static_cast<const T*>(a.p1a);
  const T* p2a = static_cast<const T*>(a.p2a);
  const T* S = sm.sums;

  build_weights<T>(a, sm, sm.tc);
  __syncthreads();
  emit_pass<T, NPT>(a, sm, r, Fu, Fd, Fuo, Fdo, frozen);
  store_sums<T>(sm, sums_out, n);
  for (int l = threadIdx.x; l < L; l += blockDim.x) {
    T dT = T(0);
    if (l > 0) {
      const int i = l - 1;
      const T T2 = l + 1 < L ? sm.tc[l + 1] : sm.tc[L - 1];
      dT = delta_temperature<T>(ph, S[i], S[n + i], S[2 * n + i], S[3 * n + i], sm.tc[l], T2,
                                p1e[i], p2e[i]);
    }
    sm.t1[l] = sm.tc[l] - dT;
  }
  __syncthreads();

  build_weights<T>(a, sm, sm.t1);
  __syncthreads();
  absorb_pass<T, NPT>(a, sm, r, Fu, Fd, Fuo, Fdo, frozen);
  store_sums<T>(sm, sums_out ? sums_out + 4 * n : nullptr, n);
  for (int l = threadIdx.x; l < L; l += blockDim.x) {
    T dT = T(0);
    if (l < n) {
      dT = delta_temperature<T>(ph, S[l], S[n + l], S[2 * n + l], S[3 * n + l], sm.t1[l],
                                sm.t1[l + 1], p1a[l], p2a[l]);
    }
    sm.dt[l] = dT;
    sm.t2[l] = sm.t1[l] - dT;
  }
  __syncthreads();
}

template <typename T>
__device__ __forceinline__ Phys<T> phys_of(const IterArgs& a) {
  Phys<T> ph;
  ph.g = T(a.g);
  ph.m_bar = T(a.m_bar);
  ph.alpha = T(a.alpha);
  ph.k_B = T(a.k_B);
  ph.sigma_sb = T(a.sigma_sb);
  ph.c_p = T(2.0 + a.n_dof) / (T(2) * ph.m_bar) * ph.k_B;
  return ph;
}

template <typename T>
__device__ __forceinline__ T* sums_of(const IterArgs& a, int b) {
  return a.sums ? static_cast<T*>(a.sums) + (size_t)b * 8 * (a.L - 1) : nullptr;
}

template <typename T, int NPT>
__global__ void __launch_bounds__(kMaxThreads) iteration_kernel(IterArgs a) {
  const int L = a.L, W = a.W, b = blockIdx.x;
  const size_t slab = (size_t)b * L * W;
  extern __shared__ __align__(16) unsigned char raw[];
  const Smem<T> sm = smem_in<T>(raw, L, a.S);
  Rows<T, NPT> r;
  load_rows<T, NPT>(a, r);
  const Phys<T> ph = phys_of<T>(a);
  const T* temps = static_cast<const T*>(a.temps) + (size_t)b * L;
  for (int l = threadIdx.x; l < L; l += blockDim.x) sm.tc[l] = temps[l];
  __syncthreads();
  const bool frozen = a.done != nullptr && a.done[b] != 0;
  rc_step<T, NPT>(a, sm, r, ph, static_cast<const T*>(a.F_up) + slab,
                  static_cast<const T*>(a.F_down) + slab, static_cast<T*>(a.F_up_out) + slab,
                  static_cast<T*>(a.F_down_out) + slab, frozen, sums_of<T>(a, b));
  T* T1 = static_cast<T*>(a.T1) + (size_t)b * L;
  T* T2 = static_cast<T*>(a.T2) + (size_t)b * L;
  T* dT2 = static_cast<T*>(a.dT2) + (size_t)b * L;
  for (int l = threadIdx.x; l < L; l += blockDim.x) {
    T1[l] = sm.t1[l];
    T2[l] = sm.t2[l];
    dT2[l] = sm.dt[l];
  }
}

template <typename T>
__device__ __forceinline__ T sign_t(T x) {
  return x > T(0) ? T(1) : (x < T(0) ? T(-1) : x);
}

template <typename T, int NPT>
__global__ void __launch_bounds__(kMaxThreads) loop_kernel(IterArgs a) {
  const int L = a.L, W = a.W, b = blockIdx.x, nt = a.n_timesteps;
  const size_t slab = (size_t)b * L * W;
  extern __shared__ __align__(16) unsigned char raw[];
  const Smem<T> sm = smem_in<T>(raw, L, a.S);
  Rows<T, NPT> r;
  load_rows<T, NPT>(a, r);
  const Phys<T> ph = phys_of<T>(a);
  const T cdT = T(a.convergence_dT);
  const T* Fu = static_cast<const T*>(a.F_up) + slab;
  const T* Fd = static_cast<const T*>(a.F_down) + slab;
  T* Fuo = static_cast<T*>(a.F_up_out) + slab;
  T* Fdo = static_cast<T*>(a.F_down_out) + slab;
  T* hist = static_cast<T*>(a.hist) + (size_t)b * 2 * nt * L;
  T* maxdt = static_cast<T*>(a.max_dT) + (size_t)b * nt;
  const T* temps = static_cast<const T*>(a.temps) + (size_t)b * L;

  // the state starts as the inputs; every later flux access is in place
  for (int l = 0; l < L; ++l) {
#pragma unroll
    for (int j = 0; j < NPT; ++j) {
      if (!r.ok[j]) continue;
      const size_t o = (size_t)l * W + r.wi[j];
      Fuo[o] = Fu[o];
      Fdo[o] = Fd[o];
    }
  }
  for (int k = threadIdx.x; k < 2 * nt * L; k += blockDim.x) hist[k] = T(0);
  for (int k = threadIdx.x; k < nt; k += blockDim.x) maxdt[k] = T(0);
  for (int l = threadIdx.x; l < L; l += blockDim.x) {
    sm.tc[l] = temps[l];
    sm.prevT[l] = temps[l];
    sm.prevS[l] = T(0);
    sm.flips[l] = 0;
    sm.conv[l] = 0;
  }
  __syncthreads();

  int it = 0, n_iters = 0, n_cols = 0;
  for (; it < nt; ++it) {
    rc_step<T, NPT>(a, sm, r, ph, Fuo, Fdo, Fuo, Fdo, false, sums_of<T>(a, b));
    // history rows, the incremental zero-crossing counters
    // (rt.solver._push_history) and the per-layer convergence test
    bool all_conv = true;
    for (int l = threadIdx.x; l < L; l += blockDim.x) {
      T pT = sm.prevT[l], pS = sm.prevS[l];
      int fl = sm.flips[l];
      const T rows[2] = {sm.t1[l], sm.t2[l]};
      for (int k = 0; k < 2; ++k) {
        const int nc = n_cols + k;
        const T s = sign_t<T>(rows[k] - pT);
        if (nc >= 2 && s != pS) ++fl;
        if (nc >= 1) pS = s;
        pT = rows[k];
        hist[(size_t)(2 * it + k) * L + l] = rows[k];
      }
      sm.prevT[l] = pT;
      sm.prevS[l] = pS;
      sm.flips[l] = fl;
      const bool c = fl > a.n_zero_crossings || abs_t<T>(sm.dt[l]) < cdT;
      sm.conv[l] = c ? 1 : 0;
      all_conv = all_conv && c;
      sm.tc[l] = sm.t2[l];
    }
    if (threadIdx.x == 0) {
      T m = abs_t<T>(sm.dt[0]);
      for (int l = 1; l < L; ++l) {
        const T v = abs_t<T>(sm.dt[l]);
        m = v > m ? v : m;
      }
      maxdt[it] = m;
    }
    n_cols += 2;
    n_iters = it + 1;
    // a barrier that also publishes sm.tc; the column stops once every
    // layer has converged (the same value in every thread)
    if (__syncthreads_and(all_conv)) break;
  }

  T* tout = static_cast<T*>(a.temps_out) + (size_t)b * L;
  for (int l = threadIdx.x; l < L; l += blockDim.x) {
    tout[l] = sm.tc[l];
    a.conv[(size_t)b * L + l] = (uint8_t)sm.conv[l];
  }
  if (threadIdx.x == 0) a.n_iters[b] = n_iters;
}

template <typename T, bool LOOP, int NPT>
int run(const IterArgs& a, int threads, cudaStream_t stream) {
  const size_t shmem = smem_bytes(a.L, a.S, threads / 32, sizeof(T));
  if (shmem > 227 * 1024) return (int)cudaErrorInvalidValue;
  void (*kern)(IterArgs) = LOOP ? loop_kernel<T, NPT> : iteration_kernel<T, NPT>;
  if (shmem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<a.B, threads, shmem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, bool LOOP>
int launch(const IterArgs* a, void* stream) {
  if (a->B <= 0) return 0;
  int npt, threads;
  if (!block_shape(a->W, &npt, &threads) || a->L < 3 || a->nT < 2 || a->nTc < 2 || a->S < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (npt) {
    case 1: return run<T, LOOP, 1>(*a, threads, s);
    case 2: return run<T, LOOP, 2>(*a, threads, s);
    case 4: return run<T, LOOP, 4>(*a, threads, s);
    default: return run<T, LOOP, 8>(*a, threads, s);
  }
}

}  // namespace

// The argument struct travels as `const void*`: a parameter of the
// anonymous namespace's type would give these functions internal linkage.
extern "C" int frei_rc_iteration_f32(const void* a, void* stream) {
  return launch<float, false>(static_cast<const IterArgs*>(a), stream);
}
extern "C" int frei_rc_iteration_f64(const void* a, void* stream) {
  return launch<double, false>(static_cast<const IterArgs*>(a), stream);
}
extern "C" int frei_rc_loop_f32(const void* a, void* stream) {
  return launch<float, true>(static_cast<const IterArgs*>(a), stream);
}
extern "C" int frei_rc_loop_f64(const void* a, void* stream) {
  return launch<double, true>(static_cast<const IterArgs*>(a), stream);
}
