// Batched bilinear (T, P) opacity lookup for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_kernel` of frei_tpu/ops/kappa_pallas.py
// (launched there by `kappa_pallas`).  The Python wrapper and its plain
// PyTorch twin (the 4-point gather of frei_tpu_torch/opacity/tables.py)
// are in frei_tpu_torch/ops/kappa_cuda.py.
//
// What it computes, for each lookup point n and wavelength bin w:
//   out[n, w] = sum_s mmr[n, s] * ((1 - tf) * ((1 - pf) * V[s, i, j, w] + pf * V[s, i, j1, w])
//                                  + tf * ((1 - pf) * V[s, i1, j, w] + pf * V[s, i1, j1, w]))
//               + sigma[w]                                   inside the (T, P) hull,
//   out[n, w] = sigma[w]                                     outside it,
// with (i, j) = divmod(idx[n], nP), i1 = min(i + 1, nT - 1) and
// j1 = min(j + 1, nP - 1).  The wrapper computes idx, the fractions
// (tf, pf) and the hull mask in torch with the port's `_axis_weights`
// (8-ULP hull tolerance), as the JAX wrapper does around its kernel; the
// blend is the twin's, written out factor by factor.  The clamps matter
// on a one-point P axis (nP = 1): there j + 1, and i + 1 at the last T
// interval, would point past the table.  Their weight is 0 (pf = 0), but
// a gather must not read out of bounds; the TPU kernel's one-hot compare
// simply never matched them.
//
// What bounds it on an H100: bytes, on the output.  8192 columns x 30
// layers of lookup points x 500 bins is a 491.5 MB float32 output,
// 0.15 ms at 3.35 TB/s.  The table (S x nT x nP x W, 1.8 MB a species on
// the run's 30 x 30 grid) is read four times per species and point, but
// from the 50 MB L2.
//
// What the design does about it:
//   * The TPU kernel kept the whole table resident in VMEM and contracted
//     a one-hot tile with it on the matrix unit, behind a 10 MB table
//     budget.  Here there is no budget: the table stays in device memory
//     and L2 serves the corner rows; nothing is staged in shared memory.
//   * Threads run along w, so the four corner loads of each species and
//     the output store are coalesced; a block walks kPoints points in
//     turn, and every thread of the block reads the same point data
//     (index, fractions, mask, mixing ratios) with broadcast loads.
//   * A point outside the hull writes sigma and reads no table row.
//   * The species sum runs in order s = 0 .. S-1 in the working type, as
//     the twin sums them; no atomics, so repeated launches give identical
//     bits.
//
// Bound to PyTorch through plain extern "C" launchers loaded with ctypes.
// Each launcher returns cudaGetLastError() after the launch; it launches
// on the caller's stream and does not synchronize.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kPoints = 8;      // lookup points per block

template <typename T>
__global__ void __launch_bounds__(kThreads)
    kappa_kernel(const int32_t* __restrict__ idx, const T* __restrict__ frac,
                 const uint8_t* __restrict__ mask, const T* __restrict__ mmr,
                 const T* __restrict__ tab, const T* __restrict__ sigma,
                 T* __restrict__ out, int64_t N, int S, int nT, int nP, int W) {
  const size_t plane = (size_t)nT * nP * W;   // one species' table
  const int64_t n0 = (int64_t)blockIdx.x * kPoints;
  for (int p = 0; p < kPoints; ++p) {
    const int64_t n = n0 + p;
    if (n >= N) return;
    T* o = out + (size_t)n * W;
    if (!mask[n]) {
      for (int w = threadIdx.x; w < W; w += kThreads) o[w] = T(0) + sigma[w];
      continue;
    }
    const int i = idx[n] / nP;
    const int j = idx[n] - i * nP;
    const int i1 = min(i + 1, nT - 1);
    const int j1 = min(j + 1, nP - 1);
    const size_t c00 = ((size_t)i * nP + j) * W, c01 = ((size_t)i * nP + j1) * W;
    const size_t c10 = ((size_t)i1 * nP + j) * W, c11 = ((size_t)i1 * nP + j1) * W;
    const T tf = frac[2 * n], pf = frac[2 * n + 1];
    const T* m = mmr + (size_t)n * S;
    for (int w = threadIdx.x; w < W; w += kThreads) {
      T acc = T(0);
      for (int s = 0; s < S; ++s) {
        const T* V = tab + s * plane + w;
        const T v = (T(1) - tf) * ((T(1) - pf) * V[c00] + pf * V[c01])
                    + tf * ((T(1) - pf) * V[c10] + pf * V[c11]);
        acc += m[s] * v;
      }
      o[w] = acc + sigma[w];
    }
  }
}

template <typename T>
int launch(const void* idx, const void* frac, const void* mask, const void* mmr,
           const void* tab, const void* sigma, void* out, int64_t N, int S, int nT, int nP,
           int W, void* stream) {
  if (N < 0 || S < 1 || nT < 1 || nP < 1 || W < 1) return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  const int64_t blocks = (N + kPoints - 1) / kPoints;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  kappa_kernel<T><<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(idx), static_cast<const T*>(frac),
      static_cast<const uint8_t*>(mask), static_cast<const T*>(mmr),
      static_cast<const T*>(tab), static_cast<const T*>(sigma), static_cast<T*>(out), N, S,
      nT, nP, W);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int frei_kappa_f32(const void* idx, const void* frac, const void* mask,
                              const void* mmr, const void* tab, const void* sigma, void* out,
                              int64_t N, int S, int nT, int nP, int W, void* stream) {
  return launch<float>(idx, frac, mask, mmr, tab, sigma, out, N, S, nT, nP, W, stream);
}

extern "C" int frei_kappa_f64(const void* idx, const void* frac, const void* mask,
                              const void* mmr, const void* tab, const void* sigma, void* out,
                              int64_t N, int S, int nT, int nP, int W, void* stream) {
  return launch<double>(idx, frac, mask, mmr, tab, sigma, out, N, S, nT, nP, W, stream);
}
