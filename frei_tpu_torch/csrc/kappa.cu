// Batched bilinear (T, P) opacity lookup for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_kernel` of frei_tpu/ops/kappa_pallas.py
// (launched there by `kappa_pallas`).  The Python wrapper, its plain
// PyTorch twin (the 4-point gather of frei_tpu_torch/opacity/tables.py)
// and the plan's plain twin are in frei_tpu_torch/ops/kappa_cuda.py.
//
// What it computes, for each lookup point n and wavelength bin w:
//   out[n, w] = sum_s mmr[s, n] * ((1 - tf) * ((1 - pf) * V[s, i, j, w] + pf * V[s, i, j1, w])
//                                  + tf * ((1 - pf) * V[s, i1, j, w] + pf * V[s, i1, j1, w]))
//               + sigma[w]                                   inside the (T, P) hull,
//   out[n, w] = sigma[w]                                     outside it,
// with (i, tf) and (j, pf) the lower index and fraction of T and P on the
// table's axes exactly as the port's `_axis_weights` computes them
// (searchsorted(right=True) - 1 clamped to [0, n - 2], an IEEE
// (x - x0) / (x1 - x0), an 8-ULP hull), i1 = min(i + 1, nT - 1) and
// j1 = min(j + 1, nP - 1).  The clamps matter on a one-point P axis
// (nP = 1): there j + 1, and i + 1 at the last T interval, would point
// past the table.  Their weight is 0 (pf = 0), but a read must not go out
// of bounds; the TPU kernel's one-hot compare simply never matched them.
//
// What bounds it on an H100: bytes, on the output.  8192 columns x 30
// layers of lookup points x 500 bins is a 491.5 MB float32 output, 0.15 ms
// at 3.35 TB/s.  Read per point, the four corner rows of each species
// come to 32 bytes of L2 traffic for every 4 bytes written (3.9 GB a
// call), which is what held the first version of this kernel at a fifth
// of its bound.  Yet the points fall into at most nT x nP cells, a few
// hundred points a cell on the run's grid, and all points of a cell read
// the same corner rows.
//
// What the design does about it: a plan, then one lookup pass.
//   1. `kappa_prelude_kernel`, one thread per point: the axis weights
//      (both binary searches, the fractions, the hull test) and a bucket
//      key, the cell i * nP + j or M = nT * nP outside the hull; a
//      histogram of the keys (counted in shared memory block by block,
//      then one global atomic per bucket of a block).
//   2. `kappa_scan_kernel`, one block: the exclusive scans of the bucket
//      counts (where each bucket's points go) and of their work items, a
//      work item being one bucket and up to `p_max` of its points.
//   3. `kappa_scatter_kernel`: each point's id into its bucket (a counting
//      sort: ranks in shared memory, one global atomic per bucket of a
//      block; the order inside a bucket varies between launches, the
//      output does not: each output value is computed by one thread in a
//      fixed order).
//   4. `kappa_lookup_kernel`, one block per work item (an upper bound of
//      items is launched, the empty ones exit): the item's 4 S corner rows
//      staged into shared memory by 16-byte cp.async pieces, in tiles of W
//      that bound shared memory for any S; the item's point data (ids,
//      fractions, mixing ratios) staged once; then every point of the item
//      from shared memory, 16 bytes of contiguous wavelengths a thread,
//      written with 16-byte evict-first stores (st.global.cs: the output is
//      read by no later pass of this call, so it should not push the table
//      out of L2).  The outside bucket writes sigma rows and reads no table.
//      Each warp's stores start on a 32-byte sector (see the kernel).
// No host synchronisation anywhere: every size the device finds is read
// on the device.  The species sum runs in order s = 0 .. S-1 in the
// working type, as the twin sums them; no atomics touch an output value,
// so repeated launches give identical bits.  W not a multiple of 16 bytes,
// or a misaligned pointer, takes element-wise copies and stores.
//
// Measurement variants share the plan and the launcher (mode argument):
// write-only (sigma rows through the plan, no table), staging only (the
// lookup kernel without its arithmetic and stores), the plan alone, and
// the first version's gather of every corner from L2 per point (after the
// prelude, in point order, no plan).  The solver never reaches them.
//
// Bound to PyTorch through a plain extern "C" launcher loaded with ctypes.
// It returns the first CUDA error of its launches; it launches on the
// caller's stream and does not synchronize.

#include <cuda_runtime.h>
#include <stdint.h>

#include <cfloat>
#include <climits>

#include "twostream.cuh"

namespace {

using frei::cp_commit;
using frei::cp_wait_all;
using frei::read_row;
using frei::stage_row;

constexpr int kThreads = 128;        // lookup kernel, one work item a block
constexpr int kPlanThreads = 256;    // prelude and scatter, one point a thread
constexpr int kScanThreads = 1024;   // the scan's one block
constexpr int kGatherPoints = 8;     // the gather variant: points per block
constexpr int kCornerBytes = 96 * 1024;  // shared memory for a tile's corner rows
// buckets that the prelude and the scatter count in shared memory, block
// by block, before one global atomic per bucket; with more buckets, one
// global atomic a point
constexpr int kSharedBuckets = 4096;

enum Mode { kLookup = 0, kWrite = 1, kStage = 2, kPlan = 3, kGather = 4 };

template <typename T> struct Eps;
template <> struct Eps<float> { static constexpr float value = FLT_EPSILON; };
template <> struct Eps<double> { static constexpr double value = DBL_EPSILON; };

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }

// torch.searchsorted(c, x, right=True) as torch computes it: the first k
// with c[k] > x (n for a NaN x).
template <typename T>
__device__ __forceinline__ int upper_bound(const T* __restrict__ c, int n, T x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (!(__ldg(c + mid) > x)) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// The port's `_axis_weights` for one coordinate on the ascending axis c:
// lower index and fraction; returns whether x lies in the 8-ULP hull.
template <typename T>
__device__ __forceinline__ bool axis_weights(const T* __restrict__ c, int n, T x, int& idx,
                                             T& frac) {
  if (n == 1) {  // degenerate axis: constant along it
    idx = 0;
    frac = T(0);
    return true;
  }
  idx = min(max(upper_bound(c, n, x) - 1, 0), n - 2);
  const T x0 = __ldg(c + idx), x1 = __ldg(c + idx + 1);
  frac = (x - x0) / (x1 - x0);
  const T eps = T(8) * Eps<T>::value, c0 = __ldg(c), cl = __ldg(c + n - 1);
  // rounded products, as torch forms them (no contraction into an FMA)
  return x >= c0 - mul_rn(eps, fabs(c0)) && x <= cl + mul_rn(eps, fabs(cl));
}

template <typename T>
__global__ void __launch_bounds__(kPlanThreads)
    kappa_prelude_kernel(const T* __restrict__ t, const T* __restrict__ p,
                         const T* __restrict__ temps, const T* __restrict__ press,
                         T* __restrict__ frac, int* __restrict__ key, int* __restrict__ count,
                         int N, int nT, int nP) {
  extern __shared__ int hist[];  // [M1] where the buckets fit, else unused
  const int M1 = nT * nP + 1;
  const bool shared = M1 <= kSharedBuckets;
  if (shared) {
    for (int b = threadIdx.x; b < M1; b += kPlanThreads) hist[b] = 0;
    __syncthreads();
  }
  const int n = blockIdx.x * kPlanThreads + threadIdx.x;
  if (n < N) {
    int i, j;
    T tf, pf;
    const bool t_ok = axis_weights(temps, nT, t[n], i, tf);
    const bool p_ok = axis_weights(press, nP, p[n], j, pf);
    const int k = t_ok && p_ok ? i * nP + j : M1 - 1;
    frac[(size_t)2 * n] = tf;
    frac[(size_t)2 * n + 1] = pf;
    key[n] = k;
    atomicAdd((shared ? hist : count) + k, 1);
  }
  if (!shared) return;
  __syncthreads();
  for (int b = threadIdx.x; b < M1; b += kPlanThreads)
    if (hist[b]) atomicAdd(count + b, hist[b]);
}

// counts (M1 buckets) -> off (M1 + 1: each bucket's first position, then
// N) and item_off (M1 + 1: each bucket's first work item, then the item
// count); count[b] becomes off[b], the scatter's cursor.
__global__ void __launch_bounds__(kScanThreads)
    kappa_scan_kernel(int* __restrict__ count, int* __restrict__ off, int* __restrict__ item_off,
                      int M1, int p_max) {
  __shared__ int warp_c[kScanThreads / 32], warp_i[kScanThreads / 32];
  __shared__ int carry_c, carry_i;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) carry_c = carry_i = 0;
  __syncthreads();
  for (int b0 = 0; b0 < M1; b0 += kScanThreads) {
    const int b = b0 + threadIdx.x;
    const int c = b < M1 ? count[b] : 0;
    const int it = (c + p_max - 1) / p_max;
    int xc = c, xi = it;  // inclusive scans within the warp
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int yc = __shfl_up_sync(~0u, xc, d), yi = __shfl_up_sync(~0u, xi, d);
      if (lane >= d) {
        xc += yc;
        xi += yi;
      }
    }
    if (lane == 31) {
      warp_c[warp] = xc;
      warp_i[warp] = xi;
    }
    __syncthreads();
    if (warp == 0) {  // the warps' totals, scanned exclusively in place
      const int oc = warp_c[lane], oi = warp_i[lane];
      int sc = oc, si = oi;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int yc = __shfl_up_sync(~0u, sc, d), yi = __shfl_up_sync(~0u, si, d);
        if (lane >= d) {
          sc += yc;
          si += yi;
        }
      }
      warp_c[lane] = sc - oc;
      warp_i[lane] = si - oi;
    }
    __syncthreads();
    const int ec = carry_c + warp_c[warp] + xc - c;
    const int ei = carry_i + warp_i[warp] + xi - it;
    if (b < M1) {
      off[b] = ec;
      item_off[b] = ei;
      count[b] = ec;
    }
    __syncthreads();
    if (threadIdx.x == kScanThreads - 1) {
      carry_c = ec + c;
      carry_i = ei + it;
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    off[M1] = carry_c;
    item_off[M1] = carry_i;
  }
}

__global__ void __launch_bounds__(kPlanThreads)
    kappa_scatter_kernel(const int* __restrict__ key, int* __restrict__ cursor,
                         int* __restrict__ order, int N, int M1) {
  extern __shared__ int hist[];  // [M1] counts, then [M1] bases, where they fit
  int* base = hist + M1;
  const bool shared = M1 <= kSharedBuckets;
  if (shared) {
    for (int b = threadIdx.x; b < M1; b += kPlanThreads) hist[b] = 0;
    __syncthreads();
  }
  const int n = blockIdx.x * kPlanThreads + threadIdx.x;
  int k = 0, rank = 0;
  if (n < N) {
    k = key[n];
    if (shared) rank = atomicAdd(hist + k, 1);
    else order[atomicAdd(cursor + k, 1)] = n;
  }
  if (!shared) return;
  __syncthreads();
  // four buckets a thread at a time: their atomics in flight together
  for (int b0 = threadIdx.x; b0 < M1; b0 += 4 * kPlanThreads) {
    int got[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int b = b0 + r * kPlanThreads;
      got[r] = b < M1 && hist[b] ? atomicAdd(cursor + b, hist[b]) : 0;
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
      if (b0 + r * kPlanThreads < M1) base[b0 + r * kPlanThreads] = got[r];
  }
  __syncthreads();
  if (n < N) order[base[k] + rank] = n;
}

// 16 bytes of a row: vector loads and evict-first stores where rows are
// whole 16-byte pieces, else element by element.
template <typename T, int V, bool kVec>
__device__ __forceinline__ void load_piece(const T* __restrict__ src, int n, T (&x)[V]) {
  if constexpr (kVec) {
    if constexpr (sizeof(T) == 4) {
      const float4 r = __ldg(reinterpret_cast<const float4*>(src));
      x[0] = r.x; x[1] = r.y; x[2] = r.z; x[3] = r.w;
    } else {
      const double2 r = __ldg(reinterpret_cast<const double2*>(src));
      x[0] = r.x; x[1] = r.y;
    }
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) x[v] = v < n ? __ldg(src + v) : T(0);
  }
}

// An evict-first store (st.global.cs): no later pass of the call reads
// the output, so it should not push the table out of L2.
template <typename U>
__device__ __forceinline__ void store_out(U* dst, U x) {
  __stcs(dst, x);
}

template <typename T, int V, bool kVec>
__device__ __forceinline__ void store_piece(T* dst, int n, const T (&x)[V]) {
  if constexpr (kVec) {
    if constexpr (sizeof(T) == 4) {
      store_out(reinterpret_cast<float4*>(dst), make_float4(x[0], x[1], x[2], x[3]));
    } else {
      store_out(reinterpret_cast<double2*>(dst), make_double2(x[0], x[1]));
    }
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v)
      if (v < n) store_out(dst + v, x[v]);
  }
}

// The offsets of cell b's four corner rows in one species' table.
__device__ __forceinline__ void corner_rows(int b, int nT, int nP, int W, size_t (&rows)[4]) {
  const int i = b / nP, j = b - i * nP;
  const int i1 = min(i + 1, nT - 1), j1 = min(j + 1, nP - 1);
  rows[0] = ((size_t)i * nP + j) * W;
  rows[1] = ((size_t)i * nP + j1) * W;
  rows[2] = ((size_t)i1 * nP + j) * W;
  rows[3] = ((size_t)i1 * nP + j1) * W;
}

// acc += m * the bilinear blend of one species' corners, written factor by
// factor as the twin writes it.
template <typename T, int V>
__device__ __forceinline__ void blend(T tf, T pf, T m, const T (&v00)[V], const T (&v01)[V],
                                      const T (&v10)[V], const T (&v11)[V], T (&acc)[V]) {
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const T val = (T(1) - tf) * ((T(1) - pf) * v00[v] + pf * v01[v])
                  + tf * ((T(1) - pf) * v10[v] + pf * v11[v]);
    acc[v] += m * val;
  }
}

// One block per work item: bucket b and up to p_max of its points.
// Shared memory: the tile's corner rows [S][4][WT], then the points' data
// [p_max][2 + S] (tf, pf, mixing ratios) and the points' ids [p_max].
//
// Rows 16 bytes past a whole number of 32-byte sectors (`paired`: W = 500
// in float32) share a sector two by two, and each warp's 512 bytes of an
// odd row would start halfway into a sector.  So a thread computes piece
// threadIdx.x - h of the tile, h = 1 where the tile starts halfway into a
// sector (one thread of the block is spare for it), and each warp's
// stores start on a sector.
template <typename T, int kMode, bool kVec>
__global__ void __launch_bounds__(kThreads)
    kappa_lookup_kernel(const T* __restrict__ frac, const T* __restrict__ mmr,
                        const T* __restrict__ tab, const T* __restrict__ sigma,
                        const int* __restrict__ off, const int* __restrict__ item_off,
                        const int* __restrict__ order, T* __restrict__ out, int paired, int N,
                        int S, int nT, int nP, int W, int WT, int p_max) {
  constexpr int V = 16 / (int)sizeof(T);  // wavelengths a thread, per tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* corner = reinterpret_cast<T*>(smem_raw);
  T* pts = corner + (size_t)4 * S * WT;
  int* ids = reinterpret_cast<int*>(pts + (size_t)p_max * (2 + S));
  __shared__ int s_bucket, s_start, s_count;
  const int M = nT * nP;
  if (threadIdx.x == 0) {
    const int item = blockIdx.x;
    int b = -1;
    if (item < item_off[M + 1]) {  // the last bucket whose first item is <= item
      int lo = 0, hi = M + 1;
      while (hi - lo > 1) {
        const int mid = (lo + hi) >> 1;
        if (item_off[mid] <= item) lo = mid;
        else hi = mid;
      }
      b = lo;
      s_start = off[b] + (item - item_off[b]) * p_max;
      s_count = min(p_max, off[b + 1] - s_start);
    }
    s_bucket = b;
  }
  __syncthreads();
  const int b = s_bucket;
  if (b < 0) return;  // past the last item
  const int start = s_start, np = s_count;
  const bool inside = kMode != kWrite && b < M;
  const size_t plane = (size_t)M * W;  // one species' table
  for (int q = threadIdx.x; q < np; q += kThreads) {
    const int n = order[start + q];
    T* d = pts + (size_t)q * (2 + S);
    ids[q] = n;
    d[0] = frac[(size_t)2 * n];
    d[1] = frac[(size_t)2 * n + 1];
    for (int s = 0; s < S; ++s) d[2 + s] = mmr[(size_t)s * N + n];
  }
  size_t rows[4] = {0, 0, 0, 0};
  if (inside) corner_rows(b, nT, nP, W, rows);
  const int lw = threadIdx.x * V;  // this thread's staged wavelengths in a tile
  for (int w0 = 0; w0 < W; w0 += WT) {
    if (inside) {
      if (lw < WT) {
        for (int s = 0; s < S; ++s)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            stage_row<T, V>(corner + (size_t)(4 * s + c) * WT, tab + s * plane + rows[c] + w0,
                            lw, W - w0, kVec);
      }
      cp_commit();
      cp_wait_all();
    }
    __syncthreads();  // the tile's corners and the points' data are in
    if (kMode != kStage) {
      T sg[2][V];  // sigma at piece threadIdx.x - h of the tile, h = 0, 1
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int w = w0 + lw - h * V;
        if (w >= w0 && w < W) load_piece<T, V, kVec>(sigma + w, min(V, W - w), sg[h]);
      }
      for (int q = 0; q < np; ++q) {
        const int n = ids[q];
        const int h = paired ? (int)(((size_t)n * W + w0) * sizeof(T) / 16 & 1) : 0;
        const int lq = lw - h * V, w = w0 + lq;
        if (lq < 0 || lq >= WT || w >= W) continue;
        T o[V];
        if (inside) {
          const T* d = pts + (size_t)q * (2 + S);
          T acc[V];
#pragma unroll
          for (int v = 0; v < V; ++v) acc[v] = T(0);
          for (int s = 0; s < S; ++s) {
            T v00[V], v01[V], v10[V], v11[V];
            const T* cs = corner + (size_t)4 * s * WT;
            read_row<T, V>(cs, lq, v00);
            read_row<T, V>(cs + WT, lq, v01);
            read_row<T, V>(cs + 2 * WT, lq, v10);
            read_row<T, V>(cs + 3 * WT, lq, v11);
            blend<T, V>(d[0], d[1], d[2 + s], v00, v01, v10, v11, acc);
          }
#pragma unroll
          for (int v = 0; v < V; ++v) o[v] = acc[v] + (h ? sg[1][v] : sg[0][v]);
        } else {
#pragma unroll
          for (int v = 0; v < V; ++v) o[v] = T(0) + (h ? sg[1][v] : sg[0][v]);
        }
        store_piece<T, V, kVec>(out + (size_t)n * W + w, min(V, W - w), o);
      }
    }
    __syncthreads();  // before the next tile overwrites the corners
  }
}

// The first version's body, kept as a measurement variant: every corner
// of every point read from L2, kGatherPoints points a block in turn.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    kappa_gather_kernel(const int* __restrict__ key, const T* __restrict__ frac,
                        const T* __restrict__ mmr, const T* __restrict__ tab,
                        const T* __restrict__ sigma, T* __restrict__ out, int N, int S, int nT,
                        int nP, int W) {
  const int M = nT * nP;
  const size_t plane = (size_t)M * W;
  const int n0 = blockIdx.x * kGatherPoints;
  for (int p = 0; p < kGatherPoints; ++p) {
    const int n = n0 + p;
    if (n >= N) return;
    T* o = out + (size_t)n * W;
    const int k = key[n];
    if (k == M) {
      for (int w = threadIdx.x; w < W; w += kThreads) o[w] = T(0) + sigma[w];
      continue;
    }
    const int i = k / nP, j = k - i * nP;
    const int i1 = min(i + 1, nT - 1), j1 = min(j + 1, nP - 1);
    const size_t c00 = ((size_t)i * nP + j) * W, c01 = ((size_t)i * nP + j1) * W;
    const size_t c10 = ((size_t)i1 * nP + j) * W, c11 = ((size_t)i1 * nP + j1) * W;
    const T tf = frac[(size_t)2 * n], pf = frac[(size_t)2 * n + 1];
    for (int w = threadIdx.x; w < W; w += kThreads) {
      T acc = T(0);
      for (int s = 0; s < S; ++s) {
        const T* Vs = tab + s * plane + w;
        const T v = (T(1) - tf) * ((T(1) - pf) * Vs[c00] + pf * Vs[c01])
                    + tf * ((T(1) - pf) * Vs[c10] + pf * Vs[c11]);
        acc += mmr[(size_t)s * N + n] * v;
      }
      o[w] = acc + sigma[w];
    }
  }
}

template <typename T, int kMode, bool kVec>
int launch_lookup(unsigned items, size_t smem, const T* frac, const T* mmr, const T* tab,
                  const T* sigma, const int* off, const int* item_off, const int* order, T* out,
                  int paired, int N, int S, int nT, int nP, int W, int WT, int p_max,
                  cudaStream_t st) {
  auto kernel = kappa_lookup_kernel<T, kMode, kVec>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<items, kThreads, smem, st>>>(frac, mmr, tab, sigma, off, item_off, order, out, paired,
                                        N, S, nT, nP, W, WT, p_max);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(int mode, const void* t_, const void* p_, const void* mmr_, const void* temps_,
           const void* press_, const void* tab_, const void* sigma_, void* frac_, void* scratch,
           void* out_, int64_t N64, int S, int nT, int nP, int W, int p_max, void* stream) {
  constexpr int V = 16 / (int)sizeof(T);
  if (mode < kLookup || mode > kGather || N64 < 0 || N64 > INT_MAX - 1024 || S < 1 || nT < 2 ||
      nP < 1 || W < 1 || p_max < 1 || p_max > 1024 || (int64_t)nT * nP > INT_MAX / 4)
    return (int)cudaErrorInvalidValue;
  const int N = (int)N64, M = nT * nP;
  // 16-byte pieces where every row is whole pieces; rows 16 bytes past
  // whole 32-byte sectors are `paired` (one thread spare in a tile for the
  // warps' alignment)
  const bool vec = W % V == 0 && ((uintptr_t)tab_ | (uintptr_t)sigma_ | (uintptr_t)out_) % 16 == 0;
  const int paired = vec && (size_t)W * sizeof(T) % 32 == 16 && (uintptr_t)out_ % 32 == 0;
  int WT = min((kThreads - paired) * V, (W + V - 1) / V * V);
  WT = min(WT, kCornerBytes / (4 * S * (int)sizeof(T)) / V * V);
  const int64_t items = (N64 + p_max - 1) / p_max + M + 1;
  if (WT < V || items > INT_MAX) return (int)cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  const T* t = static_cast<const T*>(t_);
  const T* p = static_cast<const T*>(p_);
  const T* mmr = static_cast<const T*>(mmr_);
  const T* tab = static_cast<const T*>(tab_);
  const T* sigma = static_cast<const T*>(sigma_);
  T* frac = static_cast<T*>(frac_);
  T* out = static_cast<T*>(out_);
  // scratch: key [N], order [N], count [M + 1], off [M + 2], item_off [M + 2]
  int* key = static_cast<int*>(scratch);
  int* order = key + N;
  int* count = order + N;
  int* off = count + M + 1;
  int* item_off = off + M + 2;
  cudaError_t e = cudaMemsetAsync(count, 0, sizeof(int) * (M + 1), st);
  if (e != cudaSuccess) return (int)e;
  // with no point, the plan is empty bucket offsets and nothing launches
  // over points
  const unsigned point_blocks = (unsigned)((N + kPlanThreads - 1) / kPlanThreads);
  const size_t hist_bytes = M + 1 <= kSharedBuckets ? sizeof(int) * (M + 1) : 0;
  if (N > 0) {
    kappa_prelude_kernel<T><<<point_blocks, kPlanThreads, hist_bytes, st>>>(
        t, p, static_cast<const T*>(temps_), static_cast<const T*>(press_), frac, key, count, N,
        nT, nP);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  if (mode == kGather) {
    if (N == 0) return 0;
    kappa_gather_kernel<T><<<(unsigned)((N + kGatherPoints - 1) / kGatherPoints), kThreads, 0,
                             st>>>(key, frac, mmr, tab, sigma, out, N, S, nT, nP, W);
    return (int)cudaGetLastError();
  }
  kappa_scan_kernel<<<1, kScanThreads, 0, st>>>(count, off, item_off, M + 1, p_max);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  if (N == 0) return 0;
  kappa_scatter_kernel<<<point_blocks, kPlanThreads, 2 * hist_bytes, st>>>(key, count, order, N,
                                                                          M + 1);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  if (mode == kPlan) return 0;
  const size_t smem = sizeof(T) * ((size_t)4 * S * WT + (size_t)p_max * (2 + S))
                      + sizeof(int) * (size_t)p_max;
  const unsigned n_items = (unsigned)items;
#define FREI_LOOKUP(MODE, VEC)                                                                  \
  launch_lookup<T, MODE, VEC>(n_items, smem, frac, mmr, tab, sigma, off, item_off, order, out, \
                              paired, N, S, nT, nP, W, WT, p_max, st)
  if (mode == kLookup) return vec ? FREI_LOOKUP(kLookup, true) : FREI_LOOKUP(kLookup, false);
  if (mode == kWrite) return vec ? FREI_LOOKUP(kWrite, true) : FREI_LOOKUP(kWrite, false);
  return vec ? FREI_LOOKUP(kStage, true) : FREI_LOOKUP(kStage, false);
#undef FREI_LOOKUP
}

}  // namespace

// mode: 0 the lookup, 1 write-only, 2 staging only, 3 the plan alone, 4 the
// gather variant.  t, p: (N,) lookup points; mmr: (S, N); temps (nT,),
// press (nP,), tab (S, nT, nP, W), sigma (W,); frac: (N, 2) scratch of the
// working type; scratch: 2 N + 3 M + 5 int32; out: (N, W).
extern "C" int frei_kappa_f32(int mode, const void* t, const void* p, const void* mmr,
                              const void* temps, const void* press, const void* tab,
                              const void* sigma, void* frac, void* scratch, void* out, int64_t N,
                              int S, int nT, int nP, int W, int p_max, void* stream) {
  return launch<float>(mode, t, p, mmr, temps, press, tab, sigma, frac, scratch, out, N, S, nT,
                       nP, W, p_max, stream);
}

extern "C" int frei_kappa_f64(int mode, const void* t, const void* p, const void* mmr,
                              const void* temps, const void* press, const void* tab,
                              const void* sigma, void* frac, void* scratch, void* out, int64_t N,
                              int S, int nT, int nP, int W, int p_max, void* stream) {
  return launch<double>(mode, t, p, mmr, temps, press, tab, sigma, frac, scratch, out, N, S, nT,
                        nP, W, p_max, stream);
}
