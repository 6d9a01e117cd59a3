// Device code shared by the sweep kernels (sweep.cu) and the
// whole-iteration kernels (iteration.cu): the g0 two-stream couplers, the
// deterministic per-warp quadrature partials, and a thread's pieces of a
// wavelength row (global loads and stores, cp.async staging into shared
// memory).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <cstring>

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

// The three quadratures of one layer, reduced over the warp together: a
// transposed butterfly (the lower half-warp keeps q0 and q1, the upper q2,
// then each quarter one value), 6 shuffles instead of 3 x 5.  Lanes 0, 8
// and 16 then hold the warp totals of q0, q1 and q2 and store them at
// part[slot * nwarps + warp].  The order is fixed: identical bits on
// repeated runs.
template <typename T>
__device__ __forceinline__ void warp_partials3(T q0, T q1, T q2, T* part, int s0, int s1,
                                               int s2) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const bool up16 = (lane & 16) != 0, up8 = (lane & 8) != 0;
  T k0 = up16 ? q2 : q0;
  T k1 = up16 ? T(0) : q1;
  k0 += __shfl_xor_sync(full, up16 ? q0 : q2, 16);
  k1 += __shfl_xor_sync(full, up16 ? q1 : T(0), 16);
  T k = up8 ? k1 : k0;
  k += __shfl_xor_sync(full, up8 ? k0 : k1, 8);
  k += __shfl_xor_sync(full, k, 4);
  k += __shfl_xor_sync(full, k, 2);
  k += __shfl_xor_sync(full, k, 1);
  if ((lane & 7) == 0 && lane < 24) {
    const int slot = lane == 0 ? s0 : (lane == 8 ? s1 : s2);
    part[slot * (blockDim.x >> 5) + (threadIdx.x >> 5)] = k;
  }
}

template <typename T>
__device__ __forceinline__ T slot_total(const T* part, int slot) {
  const int nw = blockDim.x >> 5;
  T t = T(0);
  for (int w = 0; w < nw; ++w) t += part[slot * nw + w];
  return t;
}

// ---- a thread's wavelengths of one row --------------------------------

// A thread's NPT contiguous wavelengths move in pieces of `bytes` (16 at
// most: one cp.async, one shared or global vector access).
template <typename T, int NPT>
struct Piece {
  static constexpr int bytes = NPT * (int)sizeof(T) < 16 ? NPT * (int)sizeof(T) : 16;
  static constexpr int n = bytes / (int)sizeof(T);  // values per piece
};

template <int BYTES> struct Raw;
template <> struct Raw<4> { using type = unsigned; };
template <> struct Raw<8> { using type = uint2; };
template <> struct Raw<16> { using type = uint4; };

template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (N == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d), "l"(src), "n"(N)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until none of this thread's commit groups is in flight.
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Copy wavelengths w0 .. w0 + NPT - 1 (those below W) of a global row into
// a shared one: in pieces where rows are whole pieces, else one by one.
template <typename T, int NPT>
__device__ __forceinline__ void stage_row(T* dst, const T* src, int w0, int W, bool whole) {
  using P = Piece<T, NPT>;
  if (whole) {
#pragma unroll
    for (int o = 0; o < NPT; o += P::n)
      if (w0 + o < W) cp_async<P::bytes>(dst + w0 + o, src + w0 + o);
  } else {
#pragma unroll
    for (int j = 0; j < NPT; ++j)
      if (w0 + j < W) cp_async<sizeof(T)>(dst + w0 + j, src + w0 + j);
  }
}

// Read wavelengths w0 .. w0 + NPT - 1 of a shared row (always whole
// pieces: the ring's rows are padded to threads x NPT).
template <typename T, int NPT>
__device__ __forceinline__ void read_row(const T* row, int w0, T x[NPT]) {
  using P = Piece<T, NPT>;
  using R = typename Raw<P::bytes>::type;
#pragma unroll
  for (int o = 0; o < NPT; o += P::n) {
    const R r = *reinterpret_cast<const R*>(row + w0 + o);
    memcpy(x + o, &r, P::bytes);
  }
}

// Write wavelengths w0 .. w0 + NPT - 1 (those below W) of a global row.
template <typename T, int NPT>
__device__ __forceinline__ void write_row(T* row, int w0, int W, bool whole, const T x[NPT]) {
  using P = Piece<T, NPT>;
  using R = typename Raw<P::bytes>::type;
  if (whole) {
#pragma unroll
    for (int o = 0; o < NPT; o += P::n) {
      if (w0 + o >= W) continue;
      R r;
      memcpy(&r, x + o, P::bytes);
      *reinterpret_cast<R*>(row + w0 + o) = r;
    }
  } else {
#pragma unroll
    for (int j = 0; j < NPT; ++j)
      if (w0 + j < W) row[w0 + j] = x[j];
  }
}

// Read wavelengths w0 .. w0 + NPT - 1 (those below W) of a read-only
// global row one by one: a frozen column's old rows, or a kappa row the
// ring does not stage (both rare).
template <typename T, int NPT>
__device__ __forceinline__ void load_row(const T* row, int w0, int W, T x[NPT]) {
#pragma unroll
  for (int j = 0; j < NPT; ++j)
    if (w0 + j < W) x[j] = __ldg(row + w0 + j);
}

}  // namespace frei
