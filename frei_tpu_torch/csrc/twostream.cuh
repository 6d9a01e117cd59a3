// Device code shared by the sweep kernels (sweep.cu) and the
// whole-iteration kernels (iteration.cu): the g0 two-stream couplers and
// the deterministic per-warp quadrature partials.
#pragma once

#include <cuda_runtime.h>

namespace frei {

template <typename T> __device__ __forceinline__ T expm1_t(T x);
template <> __device__ __forceinline__ float expm1_t<float>(float x) {
  return expm1f(x);
}
template <> __device__ __forceinline__ double expm1_t<double>(double x) {
  return expm1(x);
}

template <typename T> __device__ __forceinline__ T rsqrt_t(T x);
template <> __device__ __forceinline__ float rsqrt_t<float>(float x) {
  return rsqrtf(x);
}
template <> __device__ __forceinline__ double rsqrt_t<double>(double x) {
  return rsqrt(x);
}

template <typename T>
struct Couplers {
  T a, b, s_up, s_down;
};

// two_stream_couplers_g0 of frei_tpu_torch/ops/twostream.py, term by term.
template <typename T>
__device__ __forceinline__ Couplers<T> couplers_g0(T dtau, T om, T B1, T B2) {
  const T E = om > T(0.1) ? (T(1.225) - T(0.1777) * om) - T(0.05582) * (om * om)
                          : T(1);
  const T d = E - om;
  const T s = rsqrt_t<T>(E * d);
  const T k_hat = E * d * s;
  const T ratio = d * s;
  const T zp = T(0.5) * (T(1) + ratio);
  const T zm = T(0.5) * (T(1) - ratio);
  const T em = expm1_t<T>(T(-2) * k_hat * dtau);  // transmission - 1
  const T tr = T(1) + em;
  const T zmT_zp = zm * tr + zp;
  const T chi = (zm * tr - zp) * zmT_zp;
  const T psi = (zm - zp) * tr;
  const T chi_p_xi = (zm - zp) * (zm * (tr * tr) + zp);
  const T grad = (B1 - B2) * (em / dtau) * zmT_zp * (T(0.5) * s * s * d);
  const T s_up_raw = B2 * chi_p_xi - psi * B1 + grad;
  const T s_down_raw = B1 * chi_p_xi - psi * B2 - grad;
  const T inv_dchi = T(1) / (d * chi);
  const T inv_chi = d * inv_dchi;
  const T pi_scale = (T(3.14159265358979323846) * (T(1) - om)) * inv_dchi;
  const T xi = chi_p_xi - chi;
  Couplers<T> c;
  c.a = psi * inv_chi;
  c.b = xi * inv_chi;
  c.s_up = s_up_raw * pi_scale;
  c.s_down = s_down_raw * pi_scale;
  return c;
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;  // lane 0 holds the warp's total
}

// Quadratures: each warp reduces its threads' partials for one slot and
// lane 0 stores the warp total at part[slot * nwarps + warp]; after the
// sweep's one closing barrier, the block total of a slot is the sum over
// warps in warp order.  The order is fixed, so repeated runs give
// identical bits, and no warp waits for another inside the layer loop.
template <typename T>
__device__ __forceinline__ void warp_partial(T v, T* part, int slot) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) part[slot * (blockDim.x >> 5) + (threadIdx.x >> 5)] = v;
}

template <typename T>
__device__ __forceinline__ T slot_total(const T* part, int slot) {
  const int nw = blockDim.x >> 5;
  T t = T(0);
  for (int w = 0; w < nw; ++w) t += part[slot * nw + w];
  return t;
}

// Threads per block and wavelengths per thread (NPT, a power of two up to
// 8) for a row of W wavelengths: at most 256 threads, a whole number of
// warps.  Returns false where W does not fit.
inline bool block_shape(int W, int* npt, int* threads) {
  int n = 1;
  while ((W + n - 1) / n > 256 && n < 8) n *= 2;
  const int per = (W + n - 1) / n;
  *npt = n;
  *threads = ((per + 31) / 32) * 32;
  return per <= 256;
}

}  // namespace frei
