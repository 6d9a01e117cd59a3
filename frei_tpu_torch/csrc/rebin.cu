// Grouped trapezoid rebin of high-resolution opacity rows for NVIDIA
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_rebin_kernel` of
// frei_tpu/ops/rebin_pallas.py (launched there by `resort_rebin_pallas`).
// The Python wrapper, the per-store plan and the plain PyTorch twin
// (frei_tpu_torch/ops/rebin.py `resort_rebin`) are in
// frei_tpu_torch/ops/rebin_cuda.py.
//
// What it computes, for each row r of an (R, N) slab of samples v on an
// ascending wavelength grid and each right-closed bin b:
//   out[r, b] = sum over the pairs i with code[i] == code[i+1] == b of
//               0.5 * (v[r, i] + v[r, i+1]) * dx[i]
// A pair straddling a bin edge counts in neither bin; an empty bin, or a
// bin holding one sample, gives 0.  Because the samples are ascending, the
// samples of bin b are one contiguous range [start[b], stop[b]) and its
// pairs are i in [start[b], stop[b] - 1).  The host computes the ranges
// and dx = diff(x) once per store, in float64, from the same bin codes as
// the twin (float32 codes misassign samples within an ulp of an edge).
//
// The TPU kernel is a one-hot matrix product on the matrix unit; the JAX
// package records that it lost to the plain segment sum.  It is not
// carried over: this kernel reads each sample once and adds.
//
// What bounds it on an H100: bytes.  The slab is read once: 64 rows x
// 2e6 samples of float32 (the ETL's row chunk of a line-list store) is
// 512 MB, about 0.15 ms at 3.35 TB/s.  dx (8 bytes a sample, 16 MB at
// 2e6 samples) is read by every row but stays in the 50 MB L2.  The
// arithmetic (3 flops a sample in double) is far below the double rate.
//
// What the design does about it:
//   * One warp per (row, bin).  Its lanes stride over the bin's pairs,
//     so each load instruction of a warp reads 32 neighbouring samples
//     (128 bytes); v[i+1] is the next lane's v[i] and hits L1.  The
//     panels form inside the kernel and never touch device memory.
//   * Consecutive warps take consecutive bins of one row, so a block
//     streams one contiguous stretch of the row.
//   * Each lane accumulates in double, as the host engine does
//     (csrc/rebin_host.cc); the warp then reduces with a fixed xor
//     butterfly of shuffles.  No atomics and no shared memory: repeated
//     launches give identical bits.
//   * Bins are not equal: on a grid uniform in wavelength, a bin at 10 um
//     holds about 20x the samples of one at 0.5 um (bins widen with
//     wavelength at constant resolution).  Neighbouring bins, and so the
//     warps of one block, hold similar counts, and blocks are many (R x B
//     / 8), so the scheduler levels the imbalance across the SMs.
//
// Bound to PyTorch through plain extern "C" launchers loaded with ctypes.
// Each launcher returns cudaGetLastError() after the launch; it launches
// on the caller's stream and does not synchronize.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;             // 8 warps, 8 (row, bin) pairs
constexpr int kWarpsPerBlock = kThreads / 32;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    rebin_kernel(const T* __restrict__ values, const double* __restrict__ dx,
                 const int64_t* __restrict__ start, const int64_t* __restrict__ stop,
                 T* __restrict__ out, int R, int64_t N, int B) {
  const int64_t warp = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (warp >= (int64_t)R * B) return;     // the whole warp leaves together
  const int r = (int)(warp / B);
  const int b = (int)(warp - (int64_t)r * B);
  const T* row = values + (size_t)r * N;
  const int64_t last = stop[b] - 1;       // pairs i in [start[b], last)
  double acc = 0.0;
#pragma unroll 4
  for (int64_t i = start[b] + lane; i < last; i += 32)
    acc += 0.5 * ((double)row[i] + (double)row[i + 1]) * dx[i];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) out[(size_t)r * B + b] = (T)acc;
}

template <typename T>
int launch(const void* values, const void* dx, const void* start, const void* stop,
           void* out, int R, int64_t N, int B, void* stream) {
  if (R < 0 || B < 0 || N < 0) return (int)cudaErrorInvalidValue;
  const int64_t warps = (int64_t)R * B;
  if (warps == 0) return 0;
  const int64_t blocks = (warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  rebin_kernel<T><<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(values), static_cast<const double*>(dx),
      static_cast<const int64_t*>(start), static_cast<const int64_t*>(stop),
      static_cast<T*>(out), R, N, B);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int frei_rebin_f32(const void* values, const void* dx, const void* start,
                              const void* stop, void* out, int R, int64_t N, int B,
                              void* stream) {
  return launch<float>(values, dx, start, stop, out, R, N, B, stream);
}

extern "C" int frei_rebin_f64(const void* values, const void* dx, const void* start,
                              const void* stop, void* out, int R, int64_t N, int B,
                              void* stream) {
  return launch<double>(values, dx, start, stop, out, R, N, B, stream);
}
