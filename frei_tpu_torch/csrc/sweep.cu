// Batched emit / absorb two-stream sweeps for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels `_emit_kernel` and `_absorb_kernel`
// of frei_tpu/ops/sweep_pallas.py (launched there by `_run_sweep`).
// The Python wrappers, the launch plan, their plain PyTorch twins and the
// temperature epilogue live in frei_tpu_torch/ops/sweep_cuda.py.
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
// What bounds it on an H100.  By bytes: a float32 sweep at 8192 columns
// x 30 layers x 500 bins reads the stale flux slab it does not propagate
// and writes both updated slabs, ~1.5 GB, 0.456 ms at 3.35 TB/s.  By
// instructions it is close: each element of each layer costs two expm1,
// one rsqrt and four IEEE divisions with their slow-path guards, and the
// arithmetic alone (variant kArith) takes 0.73-0.74 ms, 1.6 times the
// bytes bound; the loads and stores alone (kCopy) take 0.67-0.70 ms.
// Each thread's layer chain is serial, so the independent chains in
// flight per SM set how far the two overlap.  Measured on an NVIDIA H100
// 80GB HBM3 at 700 W: 1.11-1.13 ms (emit) and 1.15-1.17 ms (absorb),
// 0.41 and 0.39 of the bytes bound.  PERF.md §5 has the split measured
// with this file's variants.
//
// What the design does about it:
//   * One block owns one column; each thread owns NPT contiguous
//     wavelengths and runs the whole layer loop in registers, so the
//     recurrence carry, the reused Planck row and the per-wavelength
//     constants never leave the SM.  NPT = 4 in 128-thread blocks with
//     registers capped for six (emit) or seven (absorb) blocks per SM
//     (24-28 warps, four independent layer chains per thread) measured
//     fastest.  A persistent grid (kPersist: as many blocks as fit, each
//     walking the columns) measured 10-11% slower.
//     Every slab element is read at most once and written once; rows the
//     TPU kernel copies through are copied here too (emit: F_up rows 0-1
//     and F_down row 0; absorb: F_up row 0, F_down row L-1).
//   * Memory latency is off the layer chain.  Nothing a layer loads
//     depends on the carry, so each thread stages its own wavelengths of
//     the next layer into the other slot of a two-slot shared-memory ring
//     with `cp.async` (one commit group per layer): the stale flux row and
//     the layer's opacity, that is the materialized kappa row or the
//     column's first `rows - 1` compacted table rows.  A thread reads back
//     only what it staged itself, so `cp.async.wait_group` is the only
//     wait: no barrier in the layer loop and the warps of a block run
//     free.  A ring filled by TMA bulk copies (kTma: one thread, a `full`
//     and an `empty` mbarrier per slot) saves the ~3 copy instructions per
//     thread and layer but ties the issuing warp to the block's slowest
//     one, and measured 6-11% slower.  Where rows are 16-byte multiples
//     (W = 500 in float32) each thread moves its wavelengths in 16-byte
//     pieces (staging, ring reads and stores); any other W goes element by
//     element.  1/T and dtf of the column are staged once per block.  The
//     launch plan (threads, NPT, ring depth 1, or 0 where shared memory is
//     short, staged rows, shared-memory bytes) is chosen in Python
//     (`plan_sweep`) and checked here against this file's layout.
//   * The fused form stages the column's (L, K) interpolation weights in
//     shared memory (one cp.async pass), compacted per layer in ascending
//     k: a linear T interpolation has two non-zero weights per species,
//     so two of K table rows are read instead of K (rows past the staged
//     ones come straight from L2).  The sum keeps the contraction's order.
//   * The quadratures are the only coupling across W, and nothing inside
//     the sweep reads them.  Each warp reduces a layer's three partials
//     together (a transposed butterfly, 6 shuffles) into a shared slot;
//     one barrier after the layer loop, then a sum over warps in warp
//     order.  No atomics, so repeated runs give identical bits.  Without
//     the quadratures at all (kNoSums) a sweep is 0.08-0.10 ms faster,
//     which bounds what any other arrangement of the sums could gain.
//   * The ragged edge (w >= W) is masked; there is no padding of B.
//   * The `done` freeze is a masked store: a frozen column writes its old
//     rows back (read only when frozen) and still reports its sums.
//   * Arithmetic is IEEE throughout (no fast-math intrinsics).
//
// The couplers, the quadrature reductions, cp.async and a thread's row
// pieces are in twostream.cuh, shared with the whole-iteration kernels of
// iteration.cu.
//
// Bound to PyTorch through plain extern "C" launchers loaded with ctypes.
// Each launcher returns cudaGetLastError() after the launch; it launches
// on the caller's stream and does not synchronize.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <cstring>
#include <initializer_list>
#include <type_traits>

#include "twostream.cuh"

namespace {

using namespace frei;

// Kernel variants.  The solver launches only kSweep; the others exist to
// measure where a sweep's time goes (chip_smoke.py phase 3d).
constexpr int kSweep = 0;    // the sweep
constexpr int kNoSums = 1;   // without the quadratures (sums left unwritten)
constexpr int kCopy = 3;     // also without the layer arithmetic: the same
                             // loads, stores and carry, a copy's floor
constexpr int kArith = 4;    // the arithmetic and the quadratures without the
                             // slabs: no ring, no stores (fixed opacity)
constexpr int kTma = 8;      // the sweep with its ring filled by TMA bulk
                             // copies (one thread, mbarriers; depth 1 only)
constexpr int kPersist = 16; // the sweep on a persistent grid: as many blocks
                             // as fit on the card, each walking the columns

template <int MODE> __host__ __device__ constexpr bool has_sums() { return (MODE & 1) == 0; }
template <int MODE> __host__ __device__ constexpr bool has_math() { return (MODE & 2) == 0; }
template <int MODE> __host__ __device__ constexpr bool has_memory() { return (MODE & 4) == 0; }
template <int MODE> __host__ __device__ constexpr bool has_tma() { return (MODE & kTma) != 0; }
template <int MODE> __host__ __device__ constexpr bool persistent() { return (MODE & kPersist) != 0; }

// Threads per block: at most 128 up to 4 wavelengths per thread (W <= 512),
// 256 at 8 (W <= 2048); `plan_sweep` in ops/sweep_cuda.py keeps to it.
template <int NPT>
__host__ __device__ constexpr int max_threads() { return NPT <= 4 ? 128 : 256; }

// Registers: warps in flight count.  The float32 sweep at up to 4
// wavelengths per thread is capped for six (emit: 85 registers) or seven
// (absorb: 73) 128-thread blocks per SM, the fastest of caps for 5 to 8
// blocks in trial builds; float64 and 8 wavelengths per thread are not
// capped.
template <typename T, int NPT, bool EMIT>
__host__ __device__ constexpr int min_blocks() {
  return sizeof(T) == 4 && NPT <= 4 ? (EMIT ? 6 : 7) : 1;
}

struct SweepArgs {
  const void* dtf;      // (L-1,) dtau factor per swept layer, or (B, L-1)
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
  const void* f_toa;    // (W,) or (B, W) top-of-atmosphere flux (emit only)
  const void* tw;       // (W,) trapezoid weights
  void* F_up_out;       // (B, L, W)
  void* F_down_out;     // (B, L, W)
  void* sums;           // (B, 4, L-1)
  void* dtaus;          // (B, L, W) optical depths (emit only), or null
  int B, L, W, K;
  // rows of dtf and f_toa a column moves on: 0 for one shared planet, L-1
  // and W for a population (one planet per column)
  int dtf_stride, ftoa_stride;
  int depth;  // layers the ring runs ahead of the layer being computed: 0
              // (one slot) or 1 (two slots)
  int rows;   // rows per ring slot: the stale flux row, then kappa rows
  int wpad;   // ring row length: threads x NPT
  int whole;  // rows of W values are whole pieces: move them piecewise
};

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) / 16 * 16; }

// Dynamic shared memory, in this order (byte offsets): the compacted
// weights (fused form: values L*K, table row indices L*K, counts L), 1/T
// (L), dtf (L-1), the per-warp quadrature partials (3 (L-1) + 1 slots of
// nwarps), and the ring of depth + 1 slots.  `sweep_smem_bytes` in
// ops/sweep_cuda.py mirrors `total`.
struct Layout {
  size_t row, cnt, inv_t, dtf, part, ring, total;
};

__host__ __device__ inline Layout layout(bool fused, int L, int K, size_t elem, int threads,
                                         int depth, int rows, int wpad) {
  const size_t lk = fused ? (size_t)L * K : 0;
  Layout s;
  s.row = align16(lk * elem);
  s.cnt = s.row + align16(lk * sizeof(int));
  s.inv_t = s.cnt + align16(fused ? (size_t)L * sizeof(int) : 0);
  s.dtf = s.inv_t + align16((size_t)L * elem);
  s.part = s.dtf + align16((size_t)(L - 1) * elem);
  s.ring = s.part + align16((size_t)(3 * (L - 1) + 1) * (threads / 32) * elem);
  s.total = s.ring + align16((size_t)(depth + 1) * rows * wpad * elem);
  return s;
}

template <typename T>
struct Smem {
  T* val;      // compacted non-zero weights, L x K
  int* row;    // their table rows, L x K
  int* cnt;    // non-zero weights per layer, L
  T* inv_t;    // 1 / T of the column, L
  T* dtf;      // L-1
  T* part;     // quadrature partials
  T* ring;     // depth + 1 slots of rows x wpad
};

template <typename T>
__device__ __forceinline__ Smem<T> smem_in(unsigned char* smem, const SweepArgs& a) {
  const Layout s = layout(a.ohs != nullptr, a.L, a.K, sizeof(T), blockDim.x, a.depth, a.rows,
                          a.wpad);
  Smem<T> m;
  m.val = reinterpret_cast<T*>(smem);
  m.row = reinterpret_cast<int*>(smem + s.row);
  m.cnt = reinterpret_cast<int*>(smem + s.cnt);
  m.inv_t = reinterpret_cast<T*>(smem + s.inv_t);
  m.dtf = reinterpret_cast<T*>(smem + s.dtf);
  m.part = reinterpret_cast<T*>(smem + s.part);
  m.ring = reinterpret_cast<T*>(smem + s.ring);
  return m;
}

// ---- asynchronous copies ----------------------------------------------

// cp.async and a thread's row pieces are in twostream.cuh; TMA bulk
// copies and mbarriers (the kTma variant's ring) here.
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// Arrive and announce `bytes` of bulk copies that complete on `bar`.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Wait for phase `parity` of `bar` to complete; trap rather than hang.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const unsigned addr = smem_addr(bar);
  for (unsigned spins = 0;; ++spins) {
    unsigned ready;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(ready)
        : "r"(addr), "r"(parity)
        : "memory");
    if (ready) return;
    if (spins > (1u << 24)) __trap();
  }
}

// One bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// from global into shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// The kTma variant's barriers: full[2] (a slot holds its rows), then
// empty[2] (every warp has read them).
__device__ __forceinline__ uint64_t* tma_bars() {
  __shared__ __align__(8) uint64_t bars[4];
  return bars;
}

// ---- per-block set-up -------------------------------------------------

// Compact the column's non-zero weights into shared memory (in ascending
// k, so the sum keeps the order of the full contraction), stage 1/T and
// dtf, and load the per-wavelength rows.  Ends with a barrier that
// publishes the shared part.
template <typename T, int NPT>
__device__ __forceinline__ void setup(const SweepArgs& a, int b, const Smem<T>& sm, int w0,
                                      bool ok[NPT], T c1[NPT], T xr[NPT], T sg[NPT],
                                      T tw[NPT]) {
  const T* Tb = static_cast<const T*>(a.temps) + (size_t)b * a.L;
  const T* dtf = static_cast<const T*>(a.dtf) + (size_t)b * a.dtf_stride;
  for (int l = threadIdx.x; l < a.L; l += blockDim.x) {
    sm.inv_t[l] = T(1) / Tb[l];
    if (l < a.L - 1) sm.dtf[l] = dtf[l];
  }
#pragma unroll
  for (int j = 0; j < NPT; ++j) {
    ok[j] = w0 + j < a.W;
    const int w = ok[j] ? w0 + j : 0;
    c1[j] = static_cast<const T*>(a.c1)[w];
    xr[j] = static_cast<const T*>(a.xrow)[w];
    sg[j] = static_cast<const T*>(a.sigma)[w];
    tw[j] = ok[j] ? static_cast<const T*>(a.tw)[w] : T(0);
  }
  if (a.ohs != nullptr) {
    // the column's (L, K) weights into sm.val in one pass, then compacted
    // in place, one warp per layer: a ballot over K in chunks of 32 moves
    // each chunk's non-zeros to lower indices only, after reading it
    const T* ohs_col = static_cast<const T*>(a.ohs) + (size_t)b * a.L * a.K;
    const int lk = a.L * a.K;
    for (int k = threadIdx.x; k < lk; k += blockDim.x) cp_async<sizeof(T)>(sm.val + k, ohs_col + k);
    cp_commit();
    cp_wait_all();
    __syncthreads();
    const int lane = threadIdx.x & 31;
    for (int l = threadIdx.x >> 5; l < a.L; l += blockDim.x >> 5) {
      int n = 0;
      for (int k0 = 0; k0 < a.K; k0 += 32) {
        const int k = k0 + lane;
        const T v = k < a.K ? sm.val[(size_t)l * a.K + k] : T(0);
        const unsigned nz = __ballot_sync(0xffffffffu, v != T(0));
        if (v != T(0)) {
          const int slot = n + __popc(nz & ((1u << lane) - 1u));
          sm.val[(size_t)l * a.K + slot] = v;
          sm.row[(size_t)l * a.K + slot] = k;
        }
        n += __popc(nz);
      }
      if (lane == 0) sm.cnt[l] = n;
    }
  }
  __syncthreads();
}

// ---- the ring ---------------------------------------------------------

// Kappa rows staged for layer l: the materialized row, or the first
// rows - 1 of the layer's compacted table rows.
template <typename T>
__device__ __forceinline__ int staged_kappa_rows(const SweepArgs& a, const Smem<T>& sm,
                                                 const T* kap_row, int l) {
  if (a.rows < 2) return 0;
  return kap_row != nullptr ? 1 : min(sm.cnt[l], a.rows - 1);
}

// Kappa row r of layer l's slot (see staged_kappa_rows).
template <typename T>
__device__ __forceinline__ const T* kappa_src(const SweepArgs& a, const Smem<T>& sm,
                                              const T* kap_row, int l, int r) {
  if (kap_row != nullptr) return kap_row;
  return static_cast<const T*>(a.tab) + ((size_t)l * a.K + sm.row[(size_t)l * a.K + r]) * a.W;
}

// Stage layer l's rows into `slot`: the stale flux row `flux`, then its
// staged kappa rows.  cp.async (`full` null): this thread's wavelengths,
// one commit group.  TMA (one thread): whole rows, completing on `full`.
template <typename T, int NPT>
__device__ __forceinline__ void stage(const SweepArgs& a, const Smem<T>& sm, T* slot,
                                      const T* flux, const T* kap_row, int l, int w0,
                                      uint64_t* full) {
  const int nk = staged_kappa_rows<T>(a, sm, kap_row, l);
  if (full != nullptr) {
    const unsigned row = (unsigned)a.W * sizeof(T);
    mbar_expect(full, (1 + nk) * row);
    bulk_copy(slot, flux, row, full);
    for (int r = 0; r < nk; ++r)
      bulk_copy(slot + (size_t)(r + 1) * a.wpad, kappa_src<T>(a, sm, kap_row, l, r), row, full);
    return;
  }
  const bool whole = a.whole != 0;
  stage_row<T, NPT>(slot, flux, w0, a.W, whole);
  for (int r = 0; r < nk; ++r)
    stage_row<T, NPT>(slot + (size_t)(r + 1) * a.wpad, kappa_src<T>(a, sm, kap_row, l, r), w0,
                      a.W, whole);
  cp_commit();
}

// The ring: step s of the layer loop reads slot s & 1 (depth 1: step
// s + 1 is staged while step s computes) or slot 0 (depth 0: each step
// stages its own rows).  cp.async: each thread stages and waits for its
// own wavelengths, so no barrier is needed.  TMA (depth 1 only): thread 0
// stages whole rows; full[k] completes when slot k holds them, and each
// warp arrives on empty[k] once it has read them, which thread 0 awaits
// before it refills the slot.  `stage_step(slot, full, s)` stages step s.
template <typename T, bool TMA>
struct Ring {
  T* base;
  size_t slot_len;
  int depth;
  uint64_t* bars;  // TMA: full[2], empty[2]

  __device__ T* slot(int s) const { return base + (depth ? (s & 1) : 0) * slot_len; }

  template <class F>
  __device__ void issue(int s, F&& stage_step) const {
    if constexpr (TMA) {
      if (threadIdx.x == 0) {
        if (s >= 2) mbar_wait(bars + 2 + (s & 1), ((s >> 1) - 1) & 1);
        stage_step(slot(s), bars + (s & 1), s);
      }
    } else {
      stage_step(slot(s), static_cast<uint64_t*>(nullptr), s);
    }
  }

  __device__ void wait(int s) const {
    if constexpr (TMA) {
      mbar_wait(bars + (s & 1), (s >> 1) & 1);
    } else {
      cp_wait_all();
    }
  }

  __device__ void release(int s) const {
    if constexpr (TMA) {
      __syncwarp();
      if ((threadIdx.x & 31) == 0) mbar_arrive(bars + 2 + (s & 1));
    }
  }
};

template <typename T, bool TMA>
__device__ __forceinline__ Ring<T, TMA> ring_in(const SweepArgs& a, const Smem<T>& sm) {
  Ring<T, TMA> r{sm.ring, (size_t)a.rows * a.wpad, a.depth, nullptr};
  if constexpr (TMA) {
    r.bars = tma_bars();
    if (threadIdx.x == 0) {
      for (int k = 0; k < 2; ++k) {
        mbar_init(r.bars + k, 1);
        mbar_init(r.bars + 2 + k, blockDim.x >> 5);
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    }
    __syncthreads();
  }
  return r;
}

// One step of the layer loop, around the rows it reads: stage them
// (depth 0), wait for them, read them with `read(slot)`, then (depth 1)
// release the slot and stage the next step into the other one.
template <typename T, bool TMA, class Stage, class Read>
__device__ __forceinline__ void ring_step(const Ring<T, TMA>& ring, int s, int n,
                                          Stage&& stage_step, Read&& read) {
  if (ring.depth == 0) ring.issue(s, stage_step);
  ring.wait(s);
  read(ring.slot(s));
  if (ring.depth != 0) {
    ring.release(s);
    if (s + 1 < n) ring.issue(s + 1, stage_step);
  }
}

// Total opacity of layer l at this thread's wavelengths, from the staged
// slot: kk[j] = sum_m val[m] tab[row[m], w] + sigma[w], summed in
// ascending m (rows past the staged ones, if any, straight from the
// table).  Two non-zero weights, both staged (one species), take a
// straight-line path with the weights read once per thread.
template <typename T, int NPT>
__device__ __forceinline__ void layer_kappa(const SweepArgs& a, const Smem<T>& sm, const T* slot,
                                            const T* kap, int l, int w0, const bool ok[NPT],
                                            const T sg[NPT], T kk[NPT]) {
  if (kap != nullptr) {
    if (a.rows > 1) {
      read_row<T, NPT>(slot + a.wpad, w0, kk);
    } else {
      load_row<T, NPT>(kap + (size_t)l * a.W, w0, a.W, kk);
    }
    return;
  }
  const T* v = sm.val + (size_t)l * a.K;
  const int cnt = sm.cnt[l];
  if (cnt == 2 && a.rows > 2) {
    T x0[NPT], x1[NPT];
    read_row<T, NPT>(slot + a.wpad, w0, x0);
    read_row<T, NPT>(slot + 2 * (size_t)a.wpad, w0, x1);
    const T v0 = v[0], v1 = v[1];
#pragma unroll
    for (int j = 0; j < NPT; ++j) {
      T acc = v0 * x0[j];
      acc += v1 * x1[j];
      kk[j] = acc + sg[j];
    }
  } else {
    const T* tl = static_cast<const T*>(a.tab) + (size_t)l * a.K * a.W;
    const int* r = sm.row + (size_t)l * a.K;
    const int nk = min(cnt, a.rows - 1);
#pragma unroll
    for (int j = 0; j < NPT; ++j) {
      if (!ok[j]) continue;
      const int w = w0 + j;
      T acc = T(0);
      for (int m = 0; m < cnt; ++m)
        acc += v[m] * (m < nk ? slot[(size_t)(m + 1) * a.wpad + w]
                              : __ldg(tl + (size_t)r[m] * a.W + w));
      kk[j] = acc + sg[j];
    }
  }
}

// ---- the sweeps -------------------------------------------------------

// One column of the emit sweep.  TAU: the launch writes the dtaus
// diagnostic (the solve's final emit); the flag is a template so that the
// other emits carry none of it.
template <typename T, int NPT, int MODE, bool TAU>
__device__ __forceinline__ void emit_column(const SweepArgs& a, int b) {
  constexpr bool kSums = has_sums<MODE>(), kMath = has_math<MODE>();
  constexpr bool kMem = has_memory<MODE>();
  const int L = a.L, W = a.W, n = L - 1;
  const int w0 = NPT * threadIdx.x;  // this thread's first wavelength
  const bool whole = a.whole != 0;
  const size_t slab = (size_t)b * L * W;
  const T* Fu = static_cast<const T*>(a.F_up) + slab;
  const T* Fd = static_cast<const T*>(a.F_down) + slab;
  const T* kap = a.ohs ? nullptr : static_cast<const T*>(a.kappa) + slab;
  T* Fuo = static_cast<T*>(a.F_up_out) + slab;
  T* Fdo = static_cast<T*>(a.F_down_out) + slab;
  T* S = static_cast<T*>(a.sums) + (size_t)b * 4 * n;
  T* tau = TAU ? static_cast<T*>(a.dtaus) + slab : nullptr;
  const T* ftoa = static_cast<const T*>(a.f_toa) + (size_t)b * a.ftoa_stride;
  const bool frozen = a.done != nullptr && a.done[b] != 0;

  extern __shared__ __align__(16) unsigned char smem[];
  const Smem<T> sm = smem_in<T>(smem, a);

  bool ok[NPT];
  T c1[NPT], xr[NPT], sg[NPT], tw[NPT], z[NPT], B1[NPT];
  setup<T, NPT>(a, b, sm, w0, ok, c1, xr, sg, tw);

  // step i sweeps layer l = i + 1 and reads the stale F_down row l + 1,
  // or F_TOA at the top
  const auto ring = ring_in<T, has_tma<MODE>()>(a, sm);
  auto stage_step = [&](T* slot, uint64_t* full, int i) {
    stage<T, NPT>(a, sm, slot, i + 1 < n ? Fd + (size_t)(i + 2) * W : ftoa,
                  kap ? kap + (size_t)(i + 1) * W : nullptr, i + 1, w0, full);
  };
  if (kMem && ring.depth != 0) ring.issue(0, stage_step);

  const T inv1 = sm.inv_t[1];
  T q1 = T(0);
#pragma unroll
  for (int j = 0; j < NPT; ++j) {
    z[j] = T(0);
    B1[j] = T(0);
    if (!ok[j]) continue;
    const int w = w0 + j;
    Fuo[w] = __ldg(Fu + w);            // rows the sweep copies through
    Fuo[W + w] = __ldg(Fu + W + w);
    Fdo[w] = __ldg(Fd + w);
    if (TAU) tau[w] = T(1);            // the dtaus diagnostic's row of ones
    z[j] = __ldg(Fu + W + w);          // F_1_up carry
    B1[j] = c1[j] / expm1_t<T>(xr[j] * inv1);
    q1 += z[j] * tw[j];
  }
  if (kSums) warp_partial(q1, sm.part, 3 * n);  // incoming F_up of layer 1

  // one swept layer; the top one (T2 = T[-1]: B2 = B1, incoming F_TOA,
  // outgoing F_up not stored) is a compile-time case, peeled off the loop
  auto layer = [&](int i, auto top_case) {
    constexpr bool top = decltype(top_case)::value;
    const int l = i + 1;
    T kk[NPT], f2[NPT];
    if (kMem) {
      ring_step(ring, i, n, stage_step, [&](const T* slot) {
        read_row<T, NPT>(slot, w0, f2);
        layer_kappa<T, NPT>(a, sm, slot, kap, l, w0, ok, sg, kk);
      });
    } else {
#pragma unroll
      for (int j = 0; j < NPT; ++j) {
        f2[j] = B1[j];
        kk[j] = T(2) * sg[j];
      }
    }
    const T dt = sm.dtf[i];
    const T inv2 = top ? T(0) : sm.inv_t[l + 1];
    const size_t r1 = (size_t)l * W, r2 = r1 + W;
    T dn[NPT];
    T q0 = T(0), q1 = T(0), q2 = T(0);
#pragma unroll
    for (int j = 0; j < NPT; ++j) {
      if (!ok[j]) continue;  // past W: nothing stored or summed
      const T F2d = f2[j];
      const T u = z[j];
      if (!kMath) {
        z[j] = kk[j] * dt + F2d;
        dn[j] = u + kk[j];
      } else {
        const T dtau = kk[j] * dt;
        // the final emit's diagnostic, one value at a time (rare)
        if (kMem && TAU) tau[r1 + w0 + j] = dtau;
        const T om = sg[j] / (sg[j] + kk[j]);
        // T2 = T[-1] at the top: B2 = B1, incoming flux F_TOA (staged)
        const T B2 = top ? B1[j] : c1[j] / expm1_t<T>(xr[j] * inv2);
        const Couplers<T> cp = couplers_g0<T>(dtau, om, B1[j], B2);
        z[j] = cp.a * u + (-cp.b * F2d + cp.s_up);
        dn[j] = cp.a * F2d - cp.b * u + cp.s_down;
        B1[j] = B2;
      }
      if (kSums) {
        q0 += z[j] * tw[j];
        q1 += F2d * tw[j];
        q2 += dn[j] * tw[j];
      }
    }
    if (kMem) {
      if (frozen) {  // a frozen column writes its old rows back
        T old[NPT];
        if (!top) {
          load_row<T, NPT>(Fu + r2, w0, W, old);
          write_row<T, NPT>(Fuo + r2, w0, W, whole, old);
        }
        load_row<T, NPT>(Fd + r1, w0, W, old);
        write_row<T, NPT>(Fdo + r1, w0, W, whole, old);
      } else {
        // the top layer's outgoing flux is never stored
        if (!top) write_row<T, NPT>(Fuo + r2, w0, W, whole, z);
        write_row<T, NPT>(Fdo + r1, w0, W, whole, dn);
      }
    }
    // outgoing F_up, incoming F_down, outgoing F_down
    if (kSums) warp_partials3(q0, q1, q2, sm.part, i, n + i, 2 * n + i);
  };
  for (int i = 0; i < n - 1; ++i) layer(i, std::false_type{});
  layer(n - 1, std::true_type{});
  if (!kSums) return;
  __syncthreads();
  for (int s = threadIdx.x; s < 3 * n + 1; s += blockDim.x) {
    const T t = slot_total(sm.part, s);
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

// One column of the absorb sweep.
template <typename T, int NPT, int MODE>
__device__ __forceinline__ void absorb_column(const SweepArgs& a, int b) {
  constexpr bool kSums = has_sums<MODE>(), kMath = has_math<MODE>();
  constexpr bool kMem = has_memory<MODE>();
  const int L = a.L, W = a.W, n = L - 1;
  const int w0 = NPT * threadIdx.x;  // this thread's first wavelength
  const bool whole = a.whole != 0;
  const size_t slab = (size_t)b * L * W;
  const T* Fu = static_cast<const T*>(a.F_up) + slab;
  const T* Fd = static_cast<const T*>(a.F_down) + slab;
  const T* kap = a.ohs ? nullptr : static_cast<const T*>(a.kappa) + slab;
  T* Fuo = static_cast<T*>(a.F_up_out) + slab;
  T* Fdo = static_cast<T*>(a.F_down_out) + slab;
  T* S = static_cast<T*>(a.sums) + (size_t)b * 4 * n;
  const bool frozen = a.done != nullptr && a.done[b] != 0;

  extern __shared__ __align__(16) unsigned char smem[];
  const Smem<T> sm = smem_in<T>(smem, a);

  bool ok[NPT];
  T c1[NPT], xr[NPT], sg[NPT], tw[NPT], d[NPT], B2[NPT];
  setup<T, NPT>(a, b, sm, w0, ok, c1, xr, sg, tw);

  // step k sweeps layer i = n - 1 - k and reads its stale F_up row
  const auto ring = ring_in<T, has_tma<MODE>()>(a, sm);
  auto stage_step = [&](T* slot, uint64_t* full, int k) {
    const int i = n - 1 - k;
    stage<T, NPT>(a, sm, slot, Fu + (size_t)i * W, kap ? kap + (size_t)i * W : nullptr, i, w0,
                  full);
  };
  if (kMem && ring.depth != 0) ring.issue(0, stage_step);

  const T invL = sm.inv_t[L - 1];
  T q2 = T(0);
#pragma unroll
  for (int j = 0; j < NPT; ++j) {
    d[j] = T(0);
    B2[j] = T(0);
    if (!ok[j]) continue;
    const int w = w0 + j;
    const size_t top = (size_t)(L - 1) * W + w;
    Fuo[w] = __ldg(Fu + w);            // rows the sweep copies through
    Fdo[top] = __ldg(Fd + top);
    d[j] = __ldg(Fd + top);            // F_2_down carry
    B2[j] = c1[j] / expm1_t<T>(xr[j] * invL);
    q2 += d[j] * tw[j];
  }
  if (kSums) warp_partial(q2, sm.part, 3 * n);  // incoming F_down of layer L-2

  for (int k = 0; k < n; ++k) {
    const int i = n - 1 - k;
    T kk[NPT], f1[NPT];
    if (kMem) {
      ring_step(ring, k, n, stage_step, [&](const T* slot) {
        read_row<T, NPT>(slot, w0, f1);
        layer_kappa<T, NPT>(a, sm, slot, kap, i, w0, ok, sg, kk);
      });
    } else {
#pragma unroll
      for (int j = 0; j < NPT; ++j) {
        f1[j] = B2[j];
        kk[j] = T(2) * sg[j];
      }
    }
    const T dt = sm.dtf[i];
    const T inv1 = sm.inv_t[i];
    T up[NPT];
    T q0 = T(0), q1 = T(0);
    q2 = T(0);
#pragma unroll
    for (int j = 0; j < NPT; ++j) {
      if (!ok[j]) continue;  // past W: nothing stored or summed
      const T F1u = f1[j];     // stale upward flux
      const T dold = d[j];
      if (!kMath) {
        d[j] = kk[j] * dt + F1u;
        up[j] = dold + kk[j];
      } else {
        const T dtau = kk[j] * dt;
        const T om = sg[j] / (sg[j] + kk[j]);
        const T B1 = c1[j] / expm1_t<T>(xr[j] * inv1);
        const Couplers<T> cp = couplers_g0<T>(dtau, om, B1, B2[j]);
        d[j] = cp.a * dold + (-cp.b * F1u + cp.s_down);
        up[j] = cp.a * F1u - cp.b * dold + cp.s_up;
        B2[j] = B1;
      }
      if (kSums) {
        q0 += up[j] * tw[j];
        q1 += F1u * tw[j];
        q2 += d[j] * tw[j];
      }
    }
    if (kMem) {
      const size_t r1 = (size_t)i * W, r2 = r1 + W;
      if (frozen) {  // a frozen column writes its old rows back
        T old[NPT];
        load_row<T, NPT>(Fd + r1, w0, W, old);
        write_row<T, NPT>(Fdo + r1, w0, W, whole, old);
        load_row<T, NPT>(Fu + r2, w0, W, old);
        write_row<T, NPT>(Fuo + r2, w0, W, whole, old);
      } else {
        write_row<T, NPT>(Fdo + r1, w0, W, whole, d);
        write_row<T, NPT>(Fuo + r2, w0, W, whole, up);
      }
    }
    // outgoing F_up, incoming F_up, outgoing F_down
    if (kSums) warp_partials3(q0, q1, q2, sm.part, i, n + i, 2 * n + i);
  }
  if (!kSums) return;
  __syncthreads();
  for (int s = threadIdx.x; s < 3 * n + 1; s += blockDim.x) {
    const T t = slot_total(sm.part, s);
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

// The kernels: one block per column (the grid is B), or on a persistent
// grid (kPersist) each block walks the columns, with a barrier before it
// reuses the shared memory.  The sweep keeps the loop too: without it
// the capped float32 kernels spilled more and ran slower.
template <typename T, int NPT, int MODE, bool TAU>
__global__ void __launch_bounds__(max_threads<NPT>(), min_blocks<T, NPT, true>())
    emit_kernel(SweepArgs a) {
  for (int b = blockIdx.x; b < a.B; b += gridDim.x) {
    emit_column<T, NPT, MODE, TAU>(a, b);
    if constexpr (persistent<MODE>()) __syncthreads();
  }
}

template <typename T, int NPT, int MODE>
__global__ void __launch_bounds__(max_threads<NPT>(), min_blocks<T, NPT, false>())
    absorb_kernel(SweepArgs a) {
  for (int b = blockIdx.x; b < a.B; b += gridDim.x) {
    absorb_column<T, NPT, MODE>(a, b);
    if constexpr (persistent<MODE>()) __syncthreads();
  }
}

// ---- launch -----------------------------------------------------------

// Rows move in whole pieces when every row of W values is a whole number
// of pieces and every row pointer is aligned to one.
template <typename T, int NPT>
bool whole_rows(const SweepArgs& a) {
  const size_t piece = Piece<T, NPT>::bytes;
  if (((size_t)a.W * sizeof(T)) % piece != 0) return false;
  for (const void* p : {a.F_up, a.F_down, a.kappa, a.tab, a.f_toa,
                        (const void*)a.F_up_out, (const void*)a.F_down_out,
                        (const void*)a.dtaus})
    if (reinterpret_cast<uintptr_t>(p) % piece != 0) return false;
  return true;
}

template <typename T, bool EMIT, int NPT, int MODE>
int run(const SweepArgs& a, int threads, size_t shmem, cudaStream_t stream) {
  void (*kern)(SweepArgs) = absorb_kernel<T, NPT, MODE>;
  if constexpr (EMIT) {
    if constexpr (MODE == kSweep) {
      kern = a.dtaus ? emit_kernel<T, NPT, MODE, true> : emit_kernel<T, NPT, MODE, false>;
    } else {
      if (a.dtaus) return (int)cudaErrorInvalidValue;  // variants write no dtaus
      kern = emit_kernel<T, NPT, MODE, false>;
    }
  }
  SweepArgs args = a;
  args.whole = whole_rows<T, NPT>(a) ? 1 : 0;
  // bulk copies move whole 16-byte rows into a two-slot ring
  if (has_tma<MODE>() && (a.depth != 1 || (size_t)a.W * sizeof(T) % 16 != 0 || !args.whole))
    return (int)cudaErrorInvalidValue;
  if (shmem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
    if (e != cudaSuccess) return (int)e;
  }
  int grid = a.B;
  if constexpr (persistent<MODE>()) {  // as many blocks as fit on the card
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads, shmem);
    if (e != cudaSuccess) return (int)e;
    grid = std::min(a.B, std::max(per_sm, 1) * sms);
  }
  kern<<<grid, threads, shmem, stream>>>(args);
  return (int)cudaGetLastError();
}

template <typename T, bool EMIT, int MODE>
int by_npt(const SweepArgs& a, int threads, int npt, size_t shmem, cudaStream_t s) {
  switch (npt) {
    case 1: return run<T, EMIT, 1, MODE>(a, threads, shmem, s);
    case 2: return run<T, EMIT, 2, MODE>(a, threads, shmem, s);
    case 4: return run<T, EMIT, 4, MODE>(a, threads, shmem, s);
    case 8: return run<T, EMIT, 8, MODE>(a, threads, shmem, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The measurement variants exist for float32 at NPT 4 only (the
// headline's W = 500 at 128 threads).
template <typename T, bool EMIT, int MODE>
int variant(const SweepArgs& a, int threads, int npt, size_t shmem, cudaStream_t s) {
  if constexpr (std::is_same<T, float>::value) {
    if (npt == 4) return run<T, EMIT, 4, MODE>(a, threads, shmem, s);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T, bool EMIT>
int launch(const void* dtf, const void* done, const void* temps, const void* ohs,
           const void* tab, const void* kappa, const void* F_up, const void* F_down,
           const void* c1, const void* xrow, const void* sigma, const void* f_toa,
           const void* tw, void* F_up_out, void* F_down_out, void* sums, void* dtaus,
           int B, int L, int W, int K, int dtf_stride, int ftoa_stride, int threads, int npt,
           int depth, int rows, int smem, int mode, void* stream) {
  if (B <= 0) return 0;
  if (L < 3 || W < 1 || (ohs && K < 1) || threads < 32 || threads % 32 ||
      (dtf_stride != 0 && dtf_stride != L - 1) || (ftoa_stride != 0 && ftoa_stride != W) ||
      threads > (npt <= 4 ? max_threads<4>() : max_threads<8>()) ||
      (long long)threads * npt < W || depth < 0 || depth > 1 || rows < 1 ||
      (!EMIT && dtaus))
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
  a.B = B;
  a.L = L;
  a.W = W;
  a.K = K;
  a.dtf_stride = dtf_stride;
  a.ftoa_stride = ftoa_stride;
  a.depth = depth;
  a.rows = rows;
  a.wpad = threads * npt;
  a.whole = 0;
  // the caller's plan must agree with this file's layout
  const size_t shmem =
      layout(ohs != nullptr, L, K, sizeof(T), threads, depth, rows, a.wpad).total;
  if (shmem != (size_t)smem || shmem > 227 * 1024) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kSweep: return by_npt<T, EMIT, kSweep>(a, threads, npt, shmem, s);
    case kNoSums: return variant<T, EMIT, kNoSums>(a, threads, npt, shmem, s);
    case kCopy: return variant<T, EMIT, kCopy>(a, threads, npt, shmem, s);
    case kArith: return variant<T, EMIT, kArith>(a, threads, npt, shmem, s);
    case kTma: return variant<T, EMIT, kTma>(a, threads, npt, shmem, s);
    case kPersist: return variant<T, EMIT, kPersist>(a, threads, npt, shmem, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

#define FREI_SWEEP_LAUNCHER(NAME, T, EMIT)                                               \
  extern "C" int NAME(const void* dtf, const void* done, const void* temps,            \
                      const void* ohs, const void* tab, const void* kappa,             \
                      const void* F_up, const void* F_down, const void* c1,            \
                      const void* xrow, const void* sigma, const void* f_toa,          \
                      const void* tw, void* F_up_out, void* F_down_out, void* sums,    \
                      void* dtaus, int B, int L, int W, int K, int dtf_stride,         \
                      int ftoa_stride, int threads, int npt, int depth, int rows,      \
                      int smem, int mode, void* stream) {                              \
    return launch<T, EMIT>(dtf, done, temps, ohs, tab, kappa, F_up, F_down, c1, xrow,  \
                           sigma, f_toa, tw, F_up_out, F_down_out, sums, dtaus, B, L,  \
                           W, K, dtf_stride, ftoa_stride, threads, npt, depth, rows,   \
                           smem, mode, stream);                                        \
  }

FREI_SWEEP_LAUNCHER(frei_emit_sweep_f32, float, true)
FREI_SWEEP_LAUNCHER(frei_emit_sweep_f64, double, true)
FREI_SWEEP_LAUNCHER(frei_absorb_sweep_f32, float, false)
FREI_SWEEP_LAUNCHER(frei_absorb_sweep_f64, double, false)
