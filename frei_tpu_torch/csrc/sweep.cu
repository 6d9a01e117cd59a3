// Batched emit / absorb two-stream sweeps for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels `_emit_kernel` and `_absorb_kernel`
// of frei_tpu/ops/sweep_pallas.py (launched there by `_run_sweep`).
// The Python wrappers, their plain PyTorch twins and the temperature
// epilogue live in frei_tpu_torch/ops/sweep_cuda.py.
//
// What one sweep computes, per column b and wavelength w, for each swept
// layer in the reference's Gauss-Seidel order (emit: layers 1 .. L-1,
// bottom up; absorb: layers L-2 .. 0, top down):
//   kappa  = ohs[b, l, :] . tab[l, :, w] + sigma[w]   (fused form), or
//            kappa[b, l, w]                             (materialized form)
//   dtau   = kappa * dtf[i];  omega0 = sigma / (sigma + kappa)
//   B      = c1[w] / expm1(xrow[w] / T[b, l])         (one per layer,
//            reused as the next layer's other interface)
//   the g0 two-stream couplers (a, b, s_up, s_down)
//   one step of the affine flux recurrence, carried in registers
//   masked stores under the per-column `done` freeze
//   three new bolometric quadratures per layer (the fourth is the
//   previous layer's, reused as in the TPU kernel), summed over W;
//   on request (emit only, the solve's final sweep) the (B, L, W) dtaus
//   diagnostic, so the opacity slab is never materialized for it.
//
// What bounds it on an H100: by bytes, memory traffic.  A sweep reads the
// stale flux slab it does not propagate (B x L x W) and writes both
// updated slabs, about 3 x 491.5 MB at 8192 columns x 30 layers x 500
// bins in float32, i.e. 0.44 ms at 3.35 TB/s.  By instructions, each
// element of each layer costs two expm1, one rsqrt and four IEEE
// divisions, about 0.7 ms at this shape.  Measured on an NVIDIA H100
// 80GB HBM3 at a 700 W limit, a float32 sweep at this shape takes
// 1.5-1.9 ms: neither bound is reached.  Each thread carries a serial
// chain through the layers, and at W = 500 (two wavelengths per thread,
// ~60 registers; chip_smoke.py prints ptxas's report) four 256-thread
// blocks fit on an SM, so latency hiding is the next thing to work on.
//
// What the design does about it:
//   * One block owns one column; each thread owns NPT wavelengths and
//     runs the whole layer loop in registers, so the recurrence carry,
//     the reused Planck row and the per-wavelength constants never leave
//     the SM.  Every slab element is read at most once and written once;
//     rows the TPU kernel copies through are copied here too (emit: F_up
//     rows 0-1 and F_down row 0; absorb: F_up row 0, F_down row L-1).
//   * The fused form stages the column's (L, K) interpolation weights in
//     shared memory and reads tab[l, k, w] coalesced along w; the 1.8 MB
//     layer table stays in L2.  Only the non-zero weights are staged,
//     compacted per layer in ascending k: a linear T interpolation has
//     two non-zero weights per species, so two of K table rows are read
//     instead of K.  The sum is unchanged (adding 0 * x adds 0 for
//     finite table entries) and keeps the contraction's order.
//   * The quadratures are the only coupling across W, and nothing inside
//     the sweep reads them.  Each warp reduces its partials per layer with
//     shuffles into a shared slot; one barrier after the layer loop, then
//     a sum over warps in warp order.  No atomics, so repeated runs give
//     identical bits, and no barrier inside the layer loop, so the warps
//     of a block overlap one another's loads.
//   * The ragged edge (w >= W) is masked; there is no padding of B.
//   * The `done` freeze is a masked store: a frozen column writes its old
//     rows back (read only when frozen) and still reports its sums.
//
// The couplers and the quadrature partials are in twostream.cuh, shared
// with the whole-iteration kernels of iteration.cu.
//
// Bound to PyTorch through plain extern "C" launchers loaded with ctypes.
// Each launcher returns cudaGetLastError() after the launch; it launches
// on the caller's stream and does not synchronize.

#include <cuda_runtime.h>
#include <stdint.h>

#include "twostream.cuh"

namespace {

using namespace frei;

constexpr int kMaxThreads = 256;

struct SweepArgs {
  const void* dtf;      // (L-1,) dtau factor per swept layer
  const uint8_t* done;  // (B,) freeze flags, or null
  const void* temps;    // (B, L)
  const void* ohs;      // (B, L, K) weight rows, or null (materialized form)
  const void* tab;      // (L, K, W) layer tables (fused form)
  const void* kappa;    // (B, L, W) total opacity (materialized form)
  const void* F_up;     // (B, L, W)
  const void* F_down;   // (B, L, W)
  const void* c1;       // (W,) 2 h c^2 / lam^5
  const void* xrow;     // (W,) h c / (k lam)
  const void* sigma;    // (W,) scattering opacity
  const void* f_toa;    // (W,) top-of-atmosphere flux (emit only)
  const void* tw;       // (W,) trapezoid weights
  void* F_up_out;       // (B, L, W)
  void* F_down_out;     // (B, L, W)
  void* sums;           // (B, 4, L-1)
  void* dtaus;          // (B, L, W) optical depths (emit only), or null
  int L, W, K;
};

// Shared-memory layout of the fused form: the column's non-zero weights
// per layer, compacted: values (L*K of T), table row indices (L*K ints),
// and counts (L ints).
template <typename T>
struct Weights {
  T* val;
  int* row;
  int* cnt;
};

// Dynamic shared memory: the compacted weights (fused form only), then
// the per-warp quadrature partials, 3 (L-1) + 1 slots of nwarps values.
__host__ __device__ inline size_t weights_bytes(bool fused, int L, int K, size_t elem) {
  const size_t b = fused ? (size_t)L * K * (elem + sizeof(int)) + (size_t)L * sizeof(int) : 0;
  return (b + 15) / 16 * 16;
}

__host__ __device__ inline size_t smem_bytes(bool fused, int L, int K, size_t elem,
                                             int threads) {
  return weights_bytes(fused, L, K, elem) + (size_t)(3 * (L - 1) + 1) * (threads / 32) * elem;
}

template <typename T>
__device__ __forceinline__ Weights<T> weights_in(unsigned char* smem, int L, int K) {
  Weights<T> ws;
  ws.val = reinterpret_cast<T*>(smem);
  ws.row = reinterpret_cast<int*>(ws.val + (size_t)L * K);
  ws.cnt = ws.row + (size_t)L * K;
  return ws;
}

// Total opacity of layer l at wavelength w for the current column.
template <typename T>
__device__ __forceinline__ T kappa_at(const SweepArgs& a, const Weights<T>& ws, const T* kap,
                                      int l, int w, T sig) {
  if (a.ohs == nullptr) return kap[(size_t)l * a.W + w];
  const T* tl = static_cast<const T*>(a.tab) + (size_t)l * a.K * a.W + w;
  const T* v = ws.val + (size_t)l * a.K;
  const int* r = ws.row + (size_t)l * a.K;
  T acc = T(0);
  for (int n = 0; n < ws.cnt[l]; ++n) acc += v[n] * tl[(size_t)r[n] * a.W];
  return acc + sig;
}

// Per-block set-up shared by both directions: compact the column's
// non-zero weights into shared memory (in ascending k, so the sum keeps
// the order of the full contraction), load the per-wavelength rows.  The
// caller's barrier publishes the compacted weights.
template <typename T, int NPT>
__device__ __forceinline__ void load_rows(const SweepArgs& a, const T* ohs_col,
                                          const Weights<T>& ws, bool ok[NPT],
                                          int wi[NPT], T c1[NPT], T xr[NPT], T sg[NPT],
                                          T tw[NPT]) {
  if (ohs_col != nullptr) {
    // one warp per layer: a ballot over K in chunks of 32 keeps the order
    const int lane = threadIdx.x & 31;
    for (int l = threadIdx.x >> 5; l < a.L; l += blockDim.x >> 5) {
      int n = 0;
      for (int k0 = 0; k0 < a.K; k0 += 32) {
        const int k = k0 + lane;
        const T v = k < a.K ? ohs_col[(size_t)l * a.K + k] : T(0);
        const unsigned nz = __ballot_sync(0xffffffffu, v != T(0));
        if (v != T(0)) {
          const int slot = n + __popc(nz & ((1u << lane) - 1u));
          ws.val[(size_t)l * a.K + slot] = v;
          ws.row[(size_t)l * a.K + slot] = k;
        }
        n += __popc(nz);
      }
      if (lane == 0) ws.cnt[l] = n;
    }
  }
#pragma unroll
  for (int j = 0; j < NPT; ++j) {
    wi[j] = threadIdx.x + j * blockDim.x;
    ok[j] = wi[j] < a.W;
    const int w = ok[j] ? wi[j] : 0;
    c1[j] = static_cast<const T*>(a.c1)[w];
    xr[j] = static_cast<const T*>(a.xrow)[w];
    sg[j] = static_cast<const T*>(a.sigma)[w];
    tw[j] = ok[j] ? static_cast<const T*>(a.tw)[w] : T(0);
  }
}

template <typename T, int NPT>
__global__ void __launch_bounds__(kMaxThreads) emit_kernel(SweepArgs a) {
  const int L = a.L, W = a.W, n = L - 1;
  const int b = blockIdx.x;
  const size_t slab = (size_t)b * L * W;
  const T* Fu = static_cast<const T*>(a.F_up) + slab;
  const T* Fd = static_cast<const T*>(a.F_down) + slab;
  const T* kap = a.ohs ? nullptr : static_cast<const T*>(a.kappa) + slab;
  T* Fuo = static_cast<T*>(a.F_up_out) + slab;
  T* Fdo = static_cast<T*>(a.F_down_out) + slab;
  T* S = static_cast<T*>(a.sums) + (size_t)b * 4 * n;
  T* tau = a.dtaus ? static_cast<T*>(a.dtaus) + slab : nullptr;
  const T* Tb = static_cast<const T*>(a.temps) + (size_t)b * L;
  const T* dtf = static_cast<const T*>(a.dtf);
  const T* ftoa = static_cast<const T*>(a.f_toa);
  const bool frozen = a.done != nullptr && a.done[b] != 0;

  extern __shared__ __align__(16) unsigned char smem[];
  const Weights<T> ws = weights_in<T>(smem, L, a.K);
  T* part = reinterpret_cast<T*>(smem + weights_bytes(a.ohs != nullptr, L, a.K, sizeof(T)));

  bool ok[NPT];
  int wi[NPT];
  T c1[NPT], xr[NPT], sg[NPT], tw[NPT], z[NPT], B1[NPT];
  load_rows<T, NPT>(a, a.ohs ? static_cast<const T*>(a.ohs) + (size_t)b * L * a.K : nullptr,
                    ws, ok, wi, c1, xr, sg, tw);

  const T inv1 = T(1) / Tb[1];
  T q0 = T(0);
#pragma unroll
  for (int j = 0; j < NPT; ++j) {
    z[j] = T(0);
    B1[j] = T(0);
    if (!ok[j]) continue;
    const int w = wi[j];
    Fuo[w] = Fu[w];            // rows the sweep copies through
    Fuo[W + w] = Fu[W + w];
    Fdo[w] = Fd[w];
    if (tau) tau[w] = T(1);    // the dtaus diagnostic's row of ones
    z[j] = Fu[W + w];          // F_1_up carry
    B1[j] = c1[j] / expm1_t<T>(xr[j] * inv1);
    q0 += z[j] * tw[j];
  }
  warp_partial(q0, part, 3 * n);   // incoming F_up of layer 1
  __syncthreads();                 // publishes the compacted weights

  for (int i = 0; i < n; ++i) {
    const int l = i + 1;
    const bool top = (i == n - 1);
    const T dt = dtf[i];
    const T inv2 = top ? T(0) : T(1) / Tb[l + 1];
    T q1 = T(0), q2 = T(0);
    q0 = T(0);
#pragma unroll
    for (int j = 0; j < NPT; ++j) {
      if (!ok[j]) continue;
      const int w = wi[j];
      const T kk = kappa_at<T>(a, ws, kap, l, w, sg[j]);
      const T dtau = kk * dt;
      if (tau) tau[(size_t)l * W + w] = dtau;
      const T om = sg[j] / (sg[j] + kk);
      T B2, F2d;
      if (!top) {
        B2 = c1[j] / expm1_t<T>(xr[j] * inv2);
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
      q0 += z[j] * tw[j];
      q1 += F2d * tw[j];
      q2 += F1d * tw[j];
      B1[j] = B2;
    }
    warp_partial(q0, part, i);           // outgoing F_up
    warp_partial(q1, part, n + i);       // incoming F_down
    warp_partial(q2, part, 2 * n + i);   // outgoing F_down
  }
  __syncthreads();
  for (int s = threadIdx.x; s < 3 * n + 1; s += blockDim.x) {
    const T t = slot_total(part, s);
    const int q = s / n, i = s % n;
    if (q == 3) {
      S[2 * n] = t;                      // incoming F_up of layer 1
    } else if (q == 0) {
      S[i] = t;
      if (i + 1 < n) S[2 * n + i + 1] = t;  // next layer's incoming F_up
    } else {
      S[(q == 1 ? 1 : 3) * n + i] = t;
    }
  }
}

template <typename T, int NPT>
__global__ void __launch_bounds__(kMaxThreads) absorb_kernel(SweepArgs a) {
  const int L = a.L, W = a.W, n = L - 1;
  const int b = blockIdx.x;
  const size_t slab = (size_t)b * L * W;
  const T* Fu = static_cast<const T*>(a.F_up) + slab;
  const T* Fd = static_cast<const T*>(a.F_down) + slab;
  const T* kap = a.ohs ? nullptr : static_cast<const T*>(a.kappa) + slab;
  T* Fuo = static_cast<T*>(a.F_up_out) + slab;
  T* Fdo = static_cast<T*>(a.F_down_out) + slab;
  T* S = static_cast<T*>(a.sums) + (size_t)b * 4 * n;
  const T* Tb = static_cast<const T*>(a.temps) + (size_t)b * L;
  const T* dtf = static_cast<const T*>(a.dtf);
  const bool frozen = a.done != nullptr && a.done[b] != 0;

  extern __shared__ __align__(16) unsigned char smem[];
  const Weights<T> ws = weights_in<T>(smem, L, a.K);
  T* part = reinterpret_cast<T*>(smem + weights_bytes(a.ohs != nullptr, L, a.K, sizeof(T)));

  bool ok[NPT];
  int wi[NPT];
  T c1[NPT], xr[NPT], sg[NPT], tw[NPT], d[NPT], B2[NPT];
  load_rows<T, NPT>(a, a.ohs ? static_cast<const T*>(a.ohs) + (size_t)b * L * a.K : nullptr,
                    ws, ok, wi, c1, xr, sg, tw);

  const T invL = T(1) / Tb[L - 1];
  T q2 = T(0);
#pragma unroll
  for (int j = 0; j < NPT; ++j) {
    d[j] = T(0);
    B2[j] = T(0);
    if (!ok[j]) continue;
    const int w = wi[j];
    const size_t top = (size_t)(L - 1) * W + w;
    Fuo[w] = Fu[w];            // rows the sweep copies through
    Fdo[top] = Fd[top];
    d[j] = Fd[top];            // F_2_down carry
    B2[j] = c1[j] / expm1_t<T>(xr[j] * invL);
    q2 += d[j] * tw[j];
  }
  warp_partial(q2, part, 3 * n);   // incoming F_down of layer L-2
  __syncthreads();                 // publishes the compacted weights

  for (int i = n - 1; i >= 0; --i) {
    const T dt = dtf[i];
    const T inv1 = T(1) / Tb[i];
    T q0 = T(0), q1 = T(0);
    q2 = T(0);
#pragma unroll
    for (int j = 0; j < NPT; ++j) {
      if (!ok[j]) continue;
      const int w = wi[j];
      const T kk = kappa_at<T>(a, ws, kap, i, w, sg[j]);
      const T dtau = kk * dt;
      const T om = sg[j] / (sg[j] + kk);
      const T B1 = c1[j] / expm1_t<T>(xr[j] * inv1);
      const Couplers<T> cp = couplers_g0<T>(dtau, om, B1, B2[j]);
      const size_t o1 = (size_t)i * W + w;
      const size_t o2 = (size_t)(i + 1) * W + w;
      const T F1u = Fu[o1];    // stale upward flux
      const T dn = d[j];
      d[j] = cp.a * dn + (-cp.b * F1u + cp.s_down);
      const T F2u = cp.a * F1u - cp.b * dn + cp.s_up;
      Fdo[o1] = frozen ? Fd[o1] : d[j];
      Fuo[o2] = frozen ? Fu[o2] : F2u;
      q0 += F2u * tw[j];
      q1 += F1u * tw[j];
      q2 += d[j] * tw[j];
      B2[j] = B1;
    }
    warp_partial(q0, part, i);           // outgoing F_up
    warp_partial(q1, part, n + i);       // incoming F_up
    warp_partial(q2, part, 2 * n + i);   // outgoing F_down
  }
  __syncthreads();
  for (int s = threadIdx.x; s < 3 * n + 1; s += blockDim.x) {
    const T t = slot_total(part, s);
    const int q = s / n, i = s % n;
    if (q == 3) {
      S[n + n - 1] = t;                  // incoming F_down of layer L-2
    } else if (q == 2) {
      S[3 * n + i] = t;
      if (i > 0) S[n + i - 1] = t;       // next layer's incoming F_down
    } else {
      S[(q == 0 ? 0 : 2) * n + i] = t;
    }
  }
}

template <typename T, bool EMIT, int NPT>
int run(const SweepArgs& a, int B, int threads, cudaStream_t stream) {
  const size_t shmem = smem_bytes(a.ohs != nullptr, a.L, a.K, sizeof(T), threads);
  if (shmem > 227 * 1024) return (int)cudaErrorInvalidValue;
  void (*kern)(SweepArgs) = EMIT ? emit_kernel<T, NPT> : absorb_kernel<T, NPT>;
  if (shmem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<B, threads, shmem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, bool EMIT>
int launch(const void* dtf, const void* done, const void* temps, const void* ohs,
           const void* tab, const void* kappa, const void* F_up, const void* F_down,
           const void* c1, const void* xrow, const void* sigma, const void* f_toa,
           const void* tw, void* F_up_out, void* F_down_out, void* sums, void* dtaus,
           int B, int L, int W, int K, void* stream) {
  if (B <= 0) return 0;
  int npt, threads;
  if (!block_shape(W, &npt, &threads) || L < 3 || (!EMIT && dtaus))
    return (int)cudaErrorInvalidValue;
  SweepArgs a;
  a.dtf = dtf;
  a.done = static_cast<const uint8_t*>(done);
  a.temps = temps;
  a.ohs = ohs;
  a.tab = tab;
  a.kappa = kappa;
  a.F_up = F_up;
  a.F_down = F_down;
  a.c1 = c1;
  a.xrow = xrow;
  a.sigma = sigma;
  a.f_toa = f_toa;
  a.tw = tw;
  a.F_up_out = F_up_out;
  a.F_down_out = F_down_out;
  a.sums = sums;
  a.dtaus = dtaus;
  a.L = L;
  a.W = W;
  a.K = K;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (npt) {
    case 1: return run<T, EMIT, 1>(a, B, threads, s);
    case 2: return run<T, EMIT, 2>(a, B, threads, s);
    case 4: return run<T, EMIT, 4>(a, B, threads, s);
    default: return run<T, EMIT, 8>(a, B, threads, s);
  }
}

}  // namespace

#define FREI_SWEEP_LAUNCHER(NAME, T, EMIT)                                              \
  extern "C" int NAME(const void* dtf, const void* done, const void* temps,           \
                      const void* ohs, const void* tab, const void* kappa,            \
                      const void* F_up, const void* F_down, const void* c1,           \
                      const void* xrow, const void* sigma, const void* f_toa,         \
                      const void* tw, void* F_up_out, void* F_down_out, void* sums,   \
                      void* dtaus, int B, int L, int W, int K, void* stream) {        \
    return launch<T, EMIT>(dtf, done, temps, ohs, tab, kappa, F_up, F_down, c1, xrow, \
                           sigma, f_toa, tw, F_up_out, F_down_out, sums, dtaus, B, L, \
                           W, K, stream);                                             \
  }

FREI_SWEEP_LAUNCHER(frei_emit_sweep_f32, float, true)
FREI_SWEEP_LAUNCHER(frei_emit_sweep_f64, double, true)
FREI_SWEEP_LAUNCHER(frei_absorb_sweep_f32, float, false)
FREI_SWEEP_LAUNCHER(frei_absorb_sweep_f64, double, false)
