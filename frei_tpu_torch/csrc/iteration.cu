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
// The Python wrappers, the launch plan (`plan_iteration`) and the plain
// PyTorch twins live in frei_tpu_torch/ops/iteration_cuda.py.
//
// One RC step of one column, all of it inside the block:
//   1. the column's kappa T-interpolation weights for every layer (index
//      and two weights, zero-filled outside the table's T grid with the
//      8-ULP hull), 1/T, and its chemistry: a clipped 1-D interpolation of
//      each species' ln MMR table in log10 T, then mmr = exp(ln_mmr);
//   2. the emit sweep (layers 1 .. L-1) with
//      kappa = sum_s mmr_s (w_lo tab[l,s,i] + w_hi tab[l,s,i+1]) + sigma
//      and three new quadratures per layer;
//   3. the dT epilogue of frei_tpu_torch/rt/physics.py (flux divergence,
//      adaptive timestep, temperature change) on the block's quadratures,
//      giving T1 = T - dT1;
//   4. weights at T1, the absorb sweep (layers L-2 .. 0), the epilogue
//      again, giving T2 = T1 - dT2; the per-column `done` freeze on the
//      slabs.
// The loop kernel repeats that, records history rows 2 it and 2 it + 1,
// the incremental zero-crossing counters and the per-layer test
// (flips > n_zero_crossings or |dT2| < convergence_dT), and stops once
// every layer of its column has converged.
//
// What bounds it on an H100: the two sweeps' instructions and how far
// the block's independent layer chains overlap them with its loads.  Each
// element of each swept layer costs two expm1, one rsqrt and four IEEE
// divisions (the couplers of twostream.cuh, shared with sweep.cu).  At
// 8192 columns x 30 layers x 500 bins in float32, measured on an NVIDIA
// H100 80GB HBM3 at 700 W: the arithmetic, quadratures and serial phases
// alone took 1.43 ms per step, the step's loads and stores alone
// 1.09-1.18 ms, the step 2.60-2.64 ms (0.17 of the 0.45 ms bytes bound);
// its serial phases cost 0.05 ms and loading one layer ahead 0.08-0.18
// ms.  The split was measured with variants of the iteration kernel that
// git keeps at commit 47e7c79.  The loop kernel runs the same step in
// 256-thread blocks of 2 wavelengths: 54.3-54.7 ms per 20 iterations.
//
// What the design does about it (the sweep kernels' layout, sweep.cu):
//   * One block owns one column; each thread owns NPT contiguous
//     wavelengths and runs both layer loops in registers: the iteration
//     kernel NPT = 4 in 128-thread blocks for W <= 512 with registers
//     capped for 7 blocks per SM, the loop kernel NPT = 2 in 256-thread
//     blocks for W <= 512 capped for 3 (float32; float64 and 8
//     wavelengths per thread are not capped).  Where rows are 16-byte
//     multiples (W = 500 in float32) rows move in 16-byte pieces.
//   * Memory latency is off the layer chain: each thread stages its own
//     wavelengths of the next layer's rows into the other slot of a
//     two-slot shared-memory ring with cp.async, one commit group per
//     layer: the stale flux row (emit: F_down row l + 1; absorb: the
//     emit's F_up row i) and the two k_tab rows of each staged species at
//     the indices the weights left in shared memory (species past the
//     staged ones are read from L2).  A thread reads back only what it
//     staged, so cp.async.wait_group is the only wait in the layer loop.
//     The plan (threads, NPT, ring depth 1, or 0 where shared memory is
//     short, staged rows, shared-memory bytes) is chosen in Python and
//     checked here against this file's layout: it stages the most species
//     that still leave the blocks per SM of the flux row alone, which
//     `frei_rc_blocks_per_sm` reads from the card's occupancy calculator.
//   * The three quadratures of a layer go through one transposed 6-shuffle
//     butterfly into per-warp shared slots; one barrier after the layer
//     loop, then a sum over warps in warp order: no atomics, identical
//     bits on repeated runs.  Threads 0 .. L-1 then run the epilogue, with
//     the double selects and sequential divisions of rt/physics.py.
//   * Only live stores: the absorb overwrites F_down rows 0 .. L-2 unread
//     and reads F_up rows 0 .. L-2 before it overwrites rows 1 .. L-1, so
//     the emit stores only the F_up rows the absorb reads from it (2 ..
//     L-2; rows 0-1 it reads from the step's source) and F_down row L-1,
//     whose value also stays in registers as the absorb's carry.  A frozen column stores nothing in
//     the emit; the absorb writes its old rows back, read only then.
//   * The loop's first step reads the inputs and writes the outputs, the
//     later ones update the outputs in place (the sweep orderings read
//     only rows not yet written in the same sweep), so the slabs are
//     never copied whole.  A column leaves its loop once it has
//     converged; frozen trips are masked no-ops in the TPU kernel, so the
//     outputs are identical.
//   * A population (one planet per column) and one shared planet take the
//     same code: each column reads its own F_TOA row, dtau-factor rows and
//     (g, m_bar, alpha) row at a stride of one row, which is 0 for a shared
//     planet (the sweep kernels' convention).  The rows are located once a
//     block, the dtau factors staged with the column's temperatures, and
//     the epilogue reads the column's physics row from L1; the layer loop
//     and the ring are unchanged.
//   * No padding of B; the remaining scalars are kernel arguments.  IEEE
//     arithmetic throughout.
//
// Bound to PyTorch through plain extern "C" launchers taking one argument
// struct (mirrored by a ctypes.Structure in iteration_cuda.py); each
// returns cudaGetLastError() after the launch, launches on the caller's
// stream and does not synchronize.  `frei_rc_blocks_per_sm` answers the
// plan's occupancy queries and launches nothing.

#include <cfloat>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cstring>
#include <initializer_list>
#include <type_traits>

#include "twostream.cuh"

// Blocks per SM the float32 register cap is set for (NPT <= 4), the
// fastest in trial builds (tools/torch_iteration_caps.py): the
// iteration kernel at 4 wavelengths x 128 threads fits 72 registers for 7
// blocks without spilling.  The loop kernel's build of the same step
// spilled at that shape under every cap that helped and ran slower than
// the parent's design; in 256-thread blocks of 2 wavelengths it fits 80
// registers for 3 blocks without spilling.
#ifndef FREI_ITERATION_MIN_BLOCKS
#define FREI_ITERATION_MIN_BLOCKS 7
#endif
#ifndef FREI_LOOP_MIN_BLOCKS
#define FREI_LOOP_MIN_BLOCKS 3
#endif

namespace {

using namespace frei;

// Threads per block.  The iteration kernel: at most 128 up to 4
// wavelengths per thread (W <= 512), 256 at 8 (W <= 2048), as the sweeps.
// The loop kernel: at most 256 (2 wavelengths per thread at W = 500).
template <int NPT, bool LOOP>
__host__ __device__ constexpr int max_threads() { return LOOP || NPT > 4 ? 256 : 128; }

template <typename T, int NPT, bool LOOP>
__host__ __device__ constexpr int min_blocks() {
  return sizeof(T) == 4 && NPT <= 4 ? (LOOP ? FREI_LOOP_MIN_BLOCKS : FREI_ITERATION_MIN_BLOCKS)
                                    : 1;
}

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
  const void* f_toa;       // (W,) or (B, W) top-of-atmosphere flux
  const void* tw;          // (W,) trapezoid weights
  const void* dtf_emit;    // (L-1,) or (B, L-1) dtau factors, emit ordering
  const void* dtf_absorb;  // (L-1,) or (B, L-1) dtau factors, absorb ordering
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
  // per column, placed after the parent layout's pointers: with `phys`
  // among the inputs and the strides after the ints, loop_kernel<double,
  // 2> ran 1.2% slower at S = 4 on an H100
  const void* phys;        // (3,) or (B, 3): g, m_bar, alpha
  // the elements of f_toa, dtf and phys a column moves on: W, L-1 and 3
  // for a population (one planet per column), 0 for one shared planet
  int ftoa_stride, dtf_stride, phys_stride;
  // scalars
  double n_dof, k_B, sigma_sb, convergence_dT;
  int B, L, W, S, nT, nTc, n_timesteps, n_zero_crossings;
  // the launch plan (ops/iteration_cuda.plan_iteration)
  int threads;  // threads per block
  int npt;      // wavelengths per thread
  int depth;    // ring depth: 0 (one slot) or 1 (two slots, one layer ahead)
  int rows;     // rows per ring slot: the flux row, then 2 per staged species
  int smem;     // dynamic shared-memory bytes
  // Unused.  The slot keeps the struct's layout: without it ptxas
  // allocated five of the kernels' instantiations differently, and
  // iteration_kernel<float, 4> spilled and ran 10% slower on an H100.
  int reserved;
  // set by the launcher
  int wpad;     // ring row length: threads x NPT
  int whole;    // rows of W values are whole pieces: move them piecewise
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

// ---- shared memory ----------------------------------------------------

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) / 16 * 16; }

// per-layer vectors of the working type: tc, t1, t2, dt, wlo, whi, inv,
// prevT, prevS
constexpr int kVecs = 9;

// Dynamic shared memory, in this order (byte offsets, each section
// 16-byte aligned): the per-warp quadrature partials (3 (L-1) + 1 slots of
// nwarps), the block quadratures (4, L-1), the per-layer vectors, dtf of
// both orderings (2 (L-1)), the mixing ratios (L, S), three int vectors
// (kidx, flips, conv) and the ring of depth + 1 slots of rows x wpad.
// `iteration_smem_bytes` in ops/iteration_cuda.py mirrors `total`.
struct Layout {
  size_t sums, vec, dtf, mmr, ints, ring, total;
};

__host__ __device__ inline Layout layout(int L, int S, size_t elem, int threads, int depth,
                                         int rows, int wpad) {
  const size_t n = (size_t)L - 1;
  Layout s;
  s.sums = align16((3 * n + 1) * (size_t)(threads / 32) * elem);
  s.vec = s.sums + align16(4 * n * elem);
  s.dtf = s.vec + align16((size_t)kVecs * L * elem);
  s.mmr = s.dtf + align16(2 * n * elem);
  s.ints = s.mmr + align16((size_t)L * S * elem);
  s.ring = s.ints + align16(3 * (size_t)L * sizeof(int));
  s.total = s.ring + align16((size_t)(depth + 1) * rows * wpad * elem);
  return s;
}

template <typename T>
struct Smem {
  T* part;    // quadrature partials
  T* sums;    // (4, L-1) block quadratures of the last sweep
  T* tc;      // (L,) temperatures at the start of the step
  T* t1;      // (L,) after the emit update
  T* t2;      // (L,) after the absorb update
  T* dt;      // (L,) the absorb's dT
  T* wlo;     // (L,) kappa T weights (zero outside the grid)
  T* whi;     // (L,)
  T* inv;     // (L,) 1 / T of the sweep's temperatures
  T* prevT;   // (L,) loop: last history row
  T* prevS;   // (L,) loop: sign of the last history difference
  T* dtfe;    // (L-1,) emit dtau factors
  T* dtfa;    // (L-1,) absorb dtau factors
  T* mmr;     // (L, S) mixing ratios
  int* kidx;  // (L,) lower kappa T index
  int* flips; // (L,) loop: sign flips
  int* conv;  // (L,) loop: converged flags
  T* ring;    // depth + 1 slots of rows x wpad
};

template <typename T>
__device__ __forceinline__ Smem<T> smem_in(unsigned char* raw, const IterArgs& a) {
  const Layout s = layout(a.L, a.S, sizeof(T), blockDim.x, a.depth, a.rows, a.wpad);
  const int L = a.L;
  Smem<T> m;
  m.part = reinterpret_cast<T*>(raw);
  m.sums = reinterpret_cast<T*>(raw + s.sums);
  T* v = reinterpret_cast<T*>(raw + s.vec);
  m.tc = v;
  m.t1 = v + L;
  m.t2 = v + 2 * L;
  m.dt = v + 3 * L;
  m.wlo = v + 4 * L;
  m.whi = v + 5 * L;
  m.inv = v + 6 * L;
  m.prevT = v + 7 * L;
  m.prevS = v + 8 * L;
  m.dtfe = reinterpret_cast<T*>(raw + s.dtf);
  m.dtfa = m.dtfe + (L - 1);
  m.mmr = reinterpret_cast<T*>(raw + s.mmr);
  int* q = reinterpret_cast<int*>(raw + s.ints);
  m.kidx = q;
  m.flips = q + L;
  m.conv = q + 2 * L;
  m.ring = reinterpret_cast<T*>(raw + s.ring);
  return m;
}

// ---- serial set-up ----------------------------------------------------

// Lower index of a linear interpolation on an ascending grid c[0..n-1]:
// searchsorted(side='right') - 1, clipped to [0, n-2].
template <typename T>
__device__ __forceinline__ int lower_index(const T* c, int n, T x) {
  int i = -1;
  for (int t = 0; t < n; ++t) i += (x >= c[t]) ? 1 : 0;
  return i < 0 ? 0 : (i > n - 2 ? n - 2 : i);
}

// Weights, mixing ratios and 1/T of every layer at the temperatures
// `temps` (shared); the caller's barrier publishes them.
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
    sm.inv[l] = T(1) / x;
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

// Per-thread wavelength rows, loaded once per kernel: this thread's first
// wavelength w0 and NPT contiguous ones from it.
template <typename T, int NPT>
struct Rows {
  int w0;
  bool ok[NPT];
  T c1[NPT], xr[NPT], sg[NPT], tw[NPT];
};

template <typename T, int NPT>
__device__ __forceinline__ void load_rows(const IterArgs& a, Rows<T, NPT>& r) {
  r.w0 = NPT * threadIdx.x;
#pragma unroll
  for (int j = 0; j < NPT; ++j) {
    r.ok[j] = r.w0 + j < a.W;
    const int w = r.ok[j] ? r.w0 + j : 0;
    r.c1[j] = __ldg(static_cast<const T*>(a.c1) + w);
    r.xr[j] = __ldg(static_cast<const T*>(a.xrow) + w);
    r.sg[j] = __ldg(static_cast<const T*>(a.sigma) + w);
    r.tw[j] = r.ok[j] ? __ldg(static_cast<const T*>(a.tw) + w) : T(0);
  }
}

// Read wavelengths w0 .. w0 + NPT - 1 (those below W) of a global row that
// this kernel may also write (plain loads, not the read-only path), in
// pieces where rows are whole pieces; the rest of x is zero.
template <typename T, int NPT>
__device__ __forceinline__ void ld_row(const T* row, int w0, int W, bool whole, T x[NPT]) {
  using P = Piece<T, NPT>;
  using R = typename Raw<P::bytes>::type;
#pragma unroll
  for (int j = 0; j < NPT; ++j) x[j] = T(0);
  if (whole) {
#pragma unroll
    for (int o = 0; o < NPT; o += P::n) {
      if (w0 + o >= W) continue;
      const R v = *reinterpret_cast<const R*>(row + w0 + o);
      memcpy(x + o, &v, P::bytes);
    }
  } else {
#pragma unroll
    for (int j = 0; j < NPT; ++j)
      if (w0 + j < W) x[j] = row[w0 + j];
  }
}

// ---- the ring ---------------------------------------------------------

// Step s of a layer loop reads slot s & 1 (depth 1: step s + 1 is staged
// while step s computes) or slot 0 (depth 0: each step stages its own).
template <typename T>
struct Ring {
  T* base;
  size_t slot_len;
  int depth;
  __device__ T* slot(int s) const { return base + (depth ? (s & 1) : 0) * slot_len; }
};

// Stage layer l's rows into `slot`: the stale flux row `flux`, then the
// two k_tab rows (the layer's lower and upper T index) of each staged
// species; this thread's wavelengths, one commit group.
template <typename T, int NPT>
__device__ __forceinline__ void stage_layer(const IterArgs& a, const Smem<T>& sm, T* slot,
                                            const T* flux, int l, int w0) {
  const bool whole = a.whole != 0;
  stage_row<T, NPT>(slot, flux, w0, a.W, whole);
  const int ss = (a.rows - 1) >> 1;
  const T* kt = static_cast<const T*>(a.k_tab) + ((size_t)l * a.S * a.nT + sm.kidx[l]) * a.W;
  const size_t stride = (size_t)a.nT * a.W;
  for (int s = 0; s < ss; ++s) {
    T* dst = slot + (size_t)(1 + 2 * s) * a.wpad;
    stage_row<T, NPT>(dst, kt + s * stride, w0, a.W, whole);
    stage_row<T, NPT>(dst + a.wpad, kt + s * stride + a.W, w0, a.W, whole);
  }
  cp_commit();
}

// One step of a layer loop around the rows it reads: stage them (depth
// 0), wait for this thread's copies, read them with `read(slot)`, then
// (depth 1) stage step s + 1 into the other slot.  A thread reads back
// only what it staged itself: no barrier.
template <typename T, class Stage, class Read>
__device__ __forceinline__ void ring_step(const Ring<T>& ring, int s, int n, Stage&& stage_step,
                                          Read&& read) {
  if (ring.depth == 0) stage_step(ring.slot(s), s);
  cp_wait_all();
  read(ring.slot(s));
  if (ring.depth != 0 && s + 1 < n) stage_step(ring.slot(s + 1), s + 1);
}

// Total opacity of layer l at this thread's wavelengths from the staged
// slot (species past the staged ones from L2):
// kk = sum_s (w_lo tab[l,s,i] + w_hi tab[l,s,i+1]) mmr_s + sigma, species
// ascending.
template <typename T, int NPT>
__device__ __forceinline__ void layer_kappa(const IterArgs& a, const Smem<T>& sm, const T* slot,
                                            int l, int w0, const bool ok[NPT], const T sg[NPT],
                                            T kk[NPT]) {
  const T wl = sm.wlo[l], wh = sm.whi[l];
  const T* m = sm.mmr + l * a.S;
  const int ss = (a.rows - 1) >> 1;
  T acc[NPT];
#pragma unroll
  for (int j = 0; j < NPT; ++j) acc[j] = T(0);
  for (int s = 0; s < ss; ++s) {
    T x0[NPT], x1[NPT];
    read_row<T, NPT>(slot + (size_t)(1 + 2 * s) * a.wpad, w0, x0);
    read_row<T, NPT>(slot + (size_t)(2 + 2 * s) * a.wpad, w0, x1);
    const T ms = m[s];
#pragma unroll
    for (int j = 0; j < NPT; ++j) acc[j] += (wl * x0[j] + wh * x1[j]) * ms;
  }
  if (ss < a.S) {
    const T* kt = static_cast<const T*>(a.k_tab) + ((size_t)l * a.S * a.nT + sm.kidx[l]) * a.W;
    const size_t stride = (size_t)a.nT * a.W;
    for (int s = ss; s < a.S; ++s) {
      const T* r = kt + s * stride + w0;
      const T ms = m[s];
#pragma unroll
      for (int j = 0; j < NPT; ++j)
        if (ok[j]) acc[j] += (wl * __ldg(r + j) + wh * __ldg(r + a.W + j)) * ms;
    }
  }
#pragma unroll
  for (int j = 0; j < NPT; ++j) kk[j] = acc[j] + sg[j];
}

// ---- the two passes of a step -----------------------------------------

// Emit sweep at the temperatures sm.tc (weights built).  Reads the stale
// state from (Fu, Fd), writes into (Fuo, Fdo), which may alias them: F_up
// row 0 copied through where they differ, the F_up rows 2 .. L-2 that the
// absorb reads, and F_down row L-1 (all of them only for a live column).
// `ftoa` is the column's F_TOA row.  Returns F_down row L-1 in `carry`
// and the block quadratures in sm.sums.
template <typename T, int NPT>
__device__ __forceinline__ void emit_pass(const IterArgs& a, const Smem<T>& sm,
                                          const Rows<T, NPT>& r, const T* ftoa, const T* Fu,
                                          const T* Fd, T* Fuo, T* Fdo, bool frozen,
                                          T carry[NPT]) {
  const int L = a.L, W = a.W, n = L - 1, w0 = r.w0;
  const bool whole = a.whole != 0;
  const Ring<T> ring{sm.ring, (size_t)a.rows * a.wpad, a.depth};
  // step i sweeps layer l = i + 1 and reads the stale F_down row l + 1, or
  // F_TOA at the top
  auto stage_step = [&](T* slot, int i) {
    stage_layer<T, NPT>(a, sm, slot, i + 1 < n ? Fd + (size_t)(i + 2) * W : ftoa, i + 1, w0);
  };
  if (ring.depth != 0) stage_step(ring.slot(0), 0);

  T z[NPT], B1[NPT];
  ld_row<T, NPT>(Fu + W, w0, W, whole, z);  // F_1_up carry
  if (Fuo != Fu) {                          // row 0 is copied through
    T row0[NPT];
    ld_row<T, NPT>(Fu, w0, W, whole, row0);
    write_row<T, NPT>(Fuo, w0, W, whole, row0);
  }
  const T inv1 = sm.inv[1];
  T q = T(0);
#pragma unroll
  for (int j = 0; j < NPT; ++j) {
    B1[j] = T(0);
    if (!r.ok[j]) continue;
    B1[j] = r.c1[j] / expm1_t<T>(r.xr[j] * inv1);
    q += z[j] * r.tw[j];
  }
  warp_partial(q, sm.part, 3 * n);  // incoming F_up of layer 1

  // one swept layer; the top one (T2 = T[-1]: B2 = B1, incoming F_TOA,
  // outgoing F_up not stored) is a compile-time case, peeled off the loop
  auto layer = [&](int i, auto top_case) {
    constexpr bool top = decltype(top_case)::value;
    const int l = i + 1;
    T kk[NPT], f2[NPT];
    ring_step(ring, i, n, stage_step, [&](const T* slot) {
      read_row<T, NPT>(slot, w0, f2);
      layer_kappa<T, NPT>(a, sm, slot, l, w0, r.ok, r.sg, kk);
    });
    const T dt = sm.dtfe[i];
    const T inv2 = top ? T(0) : sm.inv[l + 1];
    T dn[NPT];
    T q0 = T(0), q1 = T(0), q2 = T(0);
#pragma unroll
    for (int j = 0; j < NPT; ++j) {
      dn[j] = T(0);
      if (!r.ok[j]) continue;  // past W: nothing stored or summed
      const T F2d = f2[j];
      const T u = z[j];
      const T dtau = kk[j] * dt;
      const T om = r.sg[j] / (r.sg[j] + kk[j]);
      const T B2 = top ? B1[j] : r.c1[j] / expm1_t<T>(r.xr[j] * inv2);
      const Couplers<T> cp = couplers_g0<T>(dtau, om, B1[j], B2);
      z[j] = cp.a * u + (-cp.b * F2d + cp.s_up);
      dn[j] = cp.a * F2d - cp.b * u + cp.s_down;
      B1[j] = B2;
      q0 += z[j] * r.tw[j];
      q1 += F2d * r.tw[j];
      q2 += dn[j] * r.tw[j];
    }
    // the absorb overwrites F_down rows 0 .. L-2 and F_up rows 1 .. L-1
    // unread: store only the F_up rows it reads and F_down row L-1
    if (!frozen) {
      if (!top && l + 1 <= L - 2) write_row<T, NPT>(Fuo + (size_t)(l + 1) * W, w0, W, whole, z);
      if (top) write_row<T, NPT>(Fdo + (size_t)l * W, w0, W, whole, dn);
    }
    if (top) {
#pragma unroll
      for (int j = 0; j < NPT; ++j) carry[j] = dn[j];
    }
    // outgoing F_up, incoming F_down, outgoing F_down
    warp_partials3(q0, q1, q2, sm.part, i, n + i, 2 * n + i);
  };
  for (int i = 0; i < n - 1; ++i) layer(i, std::false_type{});
  layer(n - 1, std::true_type{});
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

// Absorb sweep at the temperatures sm.t1 (weights built) on the emit's
// state: F_up rows 2 .. L-2 from (Fuo), rows 0-1 (which the emit leaves)
// from the source Fu, the carry F_down row L-1 from the emit's registers.
// A frozen column reads the source's rows and writes them back.
template <typename T, int NPT>
__device__ __forceinline__ void absorb_pass(const IterArgs& a, const Smem<T>& sm,
                                            const Rows<T, NPT>& r, const T* Fu, const T* Fd,
                                            T* Fuo, T* Fdo, bool frozen, T d[NPT]) {
  const int L = a.L, W = a.W, n = L - 1, w0 = r.w0;
  const bool whole = a.whole != 0;
  const Ring<T> ring{sm.ring, (size_t)a.rows * a.wpad, a.depth};
  // step k sweeps layer i = n - 1 - k and reads its stale F_up row
  auto stage_step = [&](T* slot, int k) {
    const int i = n - 1 - k;
    stage_layer<T, NPT>(a, sm, slot, (frozen || i <= 1 ? Fu : Fuo) + (size_t)i * W, i, w0);
  };
  if (ring.depth != 0) stage_step(ring.slot(0), 0);
  if (frozen) {  // the carry is the old row L-1, written back
    ld_row<T, NPT>(Fd + (size_t)n * W, w0, W, whole, d);
    write_row<T, NPT>(Fdo + (size_t)n * W, w0, W, whole, d);
  }

  const T invL = sm.inv[L - 1];
  T B2[NPT];
  T q2 = T(0);
#pragma unroll
  for (int j = 0; j < NPT; ++j) {
    B2[j] = T(0);
    if (!r.ok[j]) continue;
    B2[j] = r.c1[j] / expm1_t<T>(r.xr[j] * invL);
    q2 += d[j] * r.tw[j];
  }
  warp_partial(q2, sm.part, 3 * n);  // incoming F_down of layer L-2

  for (int k = 0; k < n; ++k) {
    const int i = n - 1 - k;
    T kk[NPT], f1[NPT];
    ring_step(ring, k, n, stage_step, [&](const T* slot) {
      read_row<T, NPT>(slot, w0, f1);
      layer_kappa<T, NPT>(a, sm, slot, i, w0, r.ok, r.sg, kk);
    });
    const T dt = sm.dtfa[i];
    const T inv1 = sm.inv[i];
    T up[NPT];
    T q0 = T(0), q1 = T(0);
    q2 = T(0);
#pragma unroll
    for (int j = 0; j < NPT; ++j) {
      up[j] = T(0);
      if (!r.ok[j]) continue;  // past W: nothing stored or summed
      const T F1u = f1[j];     // stale upward flux
      const T dold = d[j];
      const T dtau = kk[j] * dt;
      const T om = r.sg[j] / (r.sg[j] + kk[j]);
      const T B1 = r.c1[j] / expm1_t<T>(r.xr[j] * inv1);
      const Couplers<T> cp = couplers_g0<T>(dtau, om, B1, B2[j]);
      d[j] = cp.a * dold + (-cp.b * F1u + cp.s_down);
      up[j] = cp.a * F1u - cp.b * dold + cp.s_up;
      B2[j] = B1;
      q0 += up[j] * r.tw[j];
      q1 += F1u * r.tw[j];
      q2 += d[j] * r.tw[j];
    }
    const size_t r1 = (size_t)i * W, r2 = r1 + W;
    if (frozen) {  // a frozen column writes its old rows back
      T old[NPT];
      ld_row<T, NPT>(Fd + r1, w0, W, whole, old);
      write_row<T, NPT>(Fdo + r1, w0, W, whole, old);
      ld_row<T, NPT>(Fu + r2, w0, W, whole, old);
      write_row<T, NPT>(Fuo + r2, w0, W, whole, old);
    } else {
      write_row<T, NPT>(Fdo + r1, w0, W, whole, d);
      write_row<T, NPT>(Fuo + r2, w0, W, whole, up);
    }
    // outgoing F_up, incoming F_up, outgoing F_down
    warp_partials3(q0, q1, q2, sm.part, i, n + i, 2 * n + i);
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

// The physics of column b: its row of `phys` (g, m_bar, alpha).
template <typename T>
__device__ __forceinline__ Phys<T> phys_of(const IterArgs& a, int b) {
  const T* p = static_cast<const T*>(a.phys) + (size_t)b * a.phys_stride;
  Phys<T> ph;
  ph.g = __ldg(p);
  ph.m_bar = __ldg(p + 1);
  ph.alpha = __ldg(p + 2);
  ph.k_B = T(a.k_B);
  ph.sigma_sb = T(a.sigma_sb);
  ph.c_p = T(2.0 + a.n_dof) / (T(2) * ph.m_bar) * ph.k_B;
  return ph;
}

// One RC step of column b from sm.tc: T1 into sm.t1, T2 into sm.t2, dT2
// into sm.dt; the quadratures of both sweeps into `sums_out` unless it is
// null.  `ftoa` is the column's F_TOA row.
template <typename T, int NPT>
__device__ __forceinline__ void rc_step(const IterArgs& a, const Smem<T>& sm,
                                        const Rows<T, NPT>& r, int b, const T* ftoa,
                                        const T* Fu, const T* Fd, T* Fuo, T* Fdo, bool frozen,
                                        T* sums_out) {
  const int L = a.L, n = L - 1;
  const T* p1e = static_cast<const T*>(a.p1e);
  const T* p2e = static_cast<const T*>(a.p2e);
  const T* p1a = static_cast<const T*>(a.p1a);
  const T* p2a = static_cast<const T*>(a.p2a);
  const T* S = sm.sums;
  T carry[NPT];

  build_weights<T>(a, sm, sm.tc);
  __syncthreads();
  emit_pass<T, NPT>(a, sm, r, ftoa, Fu, Fd, Fuo, Fdo, frozen, carry);
  store_sums<T>(sm, sums_out, n);
  for (int l = threadIdx.x; l < L; l += blockDim.x) {
    T dT = T(0);
    if (l > 0) {
      const Phys<T> ph = phys_of<T>(a, b);
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
  absorb_pass<T, NPT>(a, sm, r, Fu, Fd, Fuo, Fdo, frozen, carry);
  store_sums<T>(sm, sums_out ? sums_out + 4 * n : nullptr, n);
  for (int l = threadIdx.x; l < L; l += blockDim.x) {
    T dT = T(0);
    if (l < n) {
      const Phys<T> ph = phys_of<T>(a, b);
      dT = delta_temperature<T>(ph, S[l], S[n + l], S[2 * n + l], S[3 * n + l], sm.t1[l],
                                sm.t1[l + 1], p1a[l], p2a[l]);
    }
    sm.dt[l] = dT;
    sm.t2[l] = sm.t1[l] - dT;
  }
  __syncthreads();
}

template <typename T>
__device__ __forceinline__ T* sums_of(const IterArgs& a, int b) {
  return a.sums ? static_cast<T*>(a.sums) + (size_t)b * 8 * (a.L - 1) : nullptr;
}

// Column b's F_TOA row.
template <typename T>
__device__ __forceinline__ const T* ftoa_of(const IterArgs& a, int b) {
  return static_cast<const T*>(a.f_toa) + (size_t)b * a.ftoa_stride;
}

// Column b's temperatures into sm.tc and its rows of both dtf orderings
// into shared memory; the caller's barrier publishes them.
template <typename T>
__device__ __forceinline__ void setup_block(const IterArgs& a, const Smem<T>& sm, int b) {
  const T* temps = static_cast<const T*>(a.temps) + (size_t)b * a.L;
  const T* dte = static_cast<const T*>(a.dtf_emit) + (size_t)b * a.dtf_stride;
  const T* dta = static_cast<const T*>(a.dtf_absorb) + (size_t)b * a.dtf_stride;
  for (int l = threadIdx.x; l < a.L; l += blockDim.x) {
    sm.tc[l] = temps[l];
    if (l < a.L - 1) {
      sm.dtfe[l] = dte[l];
      sm.dtfa[l] = dta[l];
    }
  }
}

// ---- the kernels ------------------------------------------------------

template <typename T, int NPT>
__global__ void __launch_bounds__(max_threads<NPT, false>(), min_blocks<T, NPT, false>())
    iteration_kernel(IterArgs a) {
  const int L = a.L, W = a.W, b = blockIdx.x;
  const size_t slab = (size_t)b * L * W;
  extern __shared__ __align__(16) unsigned char raw[];
  const Smem<T> sm = smem_in<T>(raw, a);
  Rows<T, NPT> r;
  load_rows<T, NPT>(a, r);
  setup_block<T>(a, sm, b);
  __syncthreads();
  const bool frozen = a.done != nullptr && a.done[b] != 0;
  rc_step<T, NPT>(a, sm, r, b, ftoa_of<T>(a, b), static_cast<const T*>(a.F_up) + slab,
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

// After step `it` of the loop: history rows 2 it and 2 it + 1, the
// incremental zero-crossing counters (rt.solver._push_history), the
// per-layer convergence test, max|dT| and n_iters; T2 becomes the next
// step's temperatures.  Returns whether this thread's layers converged.
template <typename T>
__device__ __forceinline__ bool record_step(const IterArgs& a, const Smem<T>& sm, int it) {
  const int L = a.L, b = blockIdx.x;
  T* hist = static_cast<T*>(a.hist) + (size_t)b * 2 * a.n_timesteps * L;
  bool all_conv = true;
  for (int l = threadIdx.x; l < L; l += blockDim.x) {
    T pT = sm.prevT[l], pS = sm.prevS[l];
    int fl = sm.flips[l];
    const T rows[2] = {sm.t1[l], sm.t2[l]};
    for (int k = 0; k < 2; ++k) {
      const int nc = 2 * it + k;
      const T s = sign_t<T>(rows[k] - pT);
      if (nc >= 2 && s != pS) ++fl;
      if (nc >= 1) pS = s;
      pT = rows[k];
      hist[(size_t)(2 * it + k) * L + l] = rows[k];
    }
    sm.prevT[l] = pT;
    sm.prevS[l] = pS;
    sm.flips[l] = fl;
    const bool c = fl > a.n_zero_crossings || abs_t<T>(sm.dt[l]) < T(a.convergence_dT);
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
    static_cast<T*>(a.max_dT)[(size_t)b * a.n_timesteps + it] = m;
    a.n_iters[b] = it + 1;
  }
  return all_conv;
}

template <typename T, int NPT>
__global__ void __launch_bounds__(max_threads<NPT, true>(), min_blocks<T, NPT, true>())
    loop_kernel(IterArgs a) {
  const int L = a.L, W = a.W, b = blockIdx.x, nt = a.n_timesteps;
  extern __shared__ __align__(16) unsigned char raw[];
  const Smem<T> sm = smem_in<T>(raw, a);
  Rows<T, NPT> r;
  load_rows<T, NPT>(a, r);

  if (nt == 0) {  // no step: the state is the inputs
    const size_t slab = (size_t)b * L * W;
    const bool whole = a.whole != 0;
    for (int l = 0; l < L; ++l) {
      const size_t o = slab + (size_t)l * W;
      T x[NPT];
      ld_row<T, NPT>(static_cast<const T*>(a.F_up) + o, r.w0, W, whole, x);
      write_row<T, NPT>(static_cast<T*>(a.F_up_out) + o, r.w0, W, whole, x);
      ld_row<T, NPT>(static_cast<const T*>(a.F_down) + o, r.w0, W, whole, x);
      write_row<T, NPT>(static_cast<T*>(a.F_down_out) + o, r.w0, W, whole, x);
    }
    if (threadIdx.x == 0) a.n_iters[b] = 0;
  }
  T* hist = static_cast<T*>(a.hist) + (size_t)b * 2 * nt * L;
  T* maxdt = static_cast<T*>(a.max_dT) + (size_t)b * nt;
  for (int k = threadIdx.x; k < 2 * nt * L; k += blockDim.x) hist[k] = T(0);
  for (int k = threadIdx.x; k < nt; k += blockDim.x) maxdt[k] = T(0);
  setup_block<T>(a, sm, b);
  const T* ftoa = ftoa_of<T>(a, b);
  for (int l = threadIdx.x; l < L; l += blockDim.x) {
    sm.prevT[l] = sm.tc[l];
    sm.prevS[l] = T(0);
    sm.flips[l] = 0;
    sm.conv[l] = 0;
  }
  __syncthreads();

  for (int it = 0; it < nt; ++it) {
    // the first step reads the inputs, the later ones update in place
    const size_t slab = (size_t)b * L * W;
    T* Fuo = static_cast<T*>(a.F_up_out) + slab;
    T* Fdo = static_cast<T*>(a.F_down_out) + slab;
    rc_step<T, NPT>(a, sm, r, b, ftoa, it ? Fuo : static_cast<const T*>(a.F_up) + slab,
                    it ? Fdo : static_cast<const T*>(a.F_down) + slab, Fuo, Fdo, false,
                    sums_of<T>(a, b));
    // a barrier that also publishes sm.tc; the column stops once every
    // layer has converged (the same value in every thread)
    if (__syncthreads_and(record_step<T>(a, sm, it))) break;
  }

  T* tout = static_cast<T*>(a.temps_out) + (size_t)b * L;
  for (int l = threadIdx.x; l < L; l += blockDim.x) {
    tout[l] = sm.tc[l];
    a.conv[(size_t)b * L + l] = (uint8_t)sm.conv[l];
  }
}

// ---- launch -----------------------------------------------------------

// Rows move in whole pieces when every row of W values is a whole number
// of pieces and every row pointer is aligned to one.
template <typename T, int NPT>
bool whole_rows(const IterArgs& a) {
  const size_t piece = Piece<T, NPT>::bytes;
  if (((size_t)a.W * sizeof(T)) % piece != 0) return false;
  for (const void* p : {a.F_up, a.F_down, a.k_tab, a.f_toa, (const void*)a.F_up_out,
                        (const void*)a.F_down_out})
    if (reinterpret_cast<uintptr_t>(p) % piece != 0) return false;
  return true;
}

// The instantiation a launch takes, allowed `shmem` dynamic bytes.
template <typename T, bool LOOP, int NPT>
cudaError_t kernel_for(size_t shmem, void (**kern)(IterArgs)) {
  if constexpr (LOOP) {
    *kern = loop_kernel<T, NPT>;
  } else {
    *kern = iteration_kernel<T, NPT>;
  }
  if (shmem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(*kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
}

template <typename T, bool LOOP, int NPT>
int run(const IterArgs& a0, size_t shmem, cudaStream_t stream) {
  IterArgs a = a0;
  a.whole = whole_rows<T, NPT>(a) ? 1 : 0;
  void (*kern)(IterArgs);
  const cudaError_t e = kernel_for<T, LOOP, NPT>(shmem, &kern);
  if (e != cudaSuccess) return (int)e;
  kern<<<a.B, a.threads, shmem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, bool LOOP>
int by_npt(const IterArgs& a, size_t shmem, cudaStream_t s) {
  switch (a.npt) {
    case 1: return run<T, LOOP, 1>(a, shmem, s);
    case 2: return run<T, LOOP, 2>(a, shmem, s);
    case 4: return run<T, LOOP, 4>(a, shmem, s);
    case 8: return run<T, LOOP, 8>(a, shmem, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Blocks of one instantiation an SM holds at `threads` and `shmem`
// dynamic bytes, from the card's occupancy calculator; launches nothing.
template <typename T, bool LOOP, int NPT>
int occupancy(int threads, size_t shmem, int* blocks) {
  void (*kern)(IterArgs);
  cudaError_t e = kernel_for<T, LOOP, NPT>(shmem, &kern);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kern, threads, shmem);
  return (int)e;
}

template <typename T, bool LOOP>
int occupancy_by_npt(int npt, int threads, size_t shmem, int* blocks) {
  switch (npt) {
    case 1: return occupancy<T, LOOP, 1>(threads, shmem, blocks);
    case 2: return occupancy<T, LOOP, 2>(threads, shmem, blocks);
    case 4: return occupancy<T, LOOP, 4>(threads, shmem, blocks);
    case 8: return occupancy<T, LOOP, 8>(threads, shmem, blocks);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T, bool LOOP>
int launch(const void* args, void* stream) {
  IterArgs a = *static_cast<const IterArgs*>(args);
  if (a.B <= 0) return 0;
  if (a.L < 3 || a.W < 1 || a.nT < 2 || a.nTc < 2 || a.S < 1 || a.threads < 32 ||
      a.threads % 32 || a.threads > (a.npt <= 4 ? max_threads<4, LOOP>() : max_threads<8, LOOP>()) ||
      (long long)a.threads * a.npt < a.W || a.depth < 0 || a.depth > 1 || a.rows < 1 ||
      (a.rows - 1) % 2 != 0 || (a.rows - 1) / 2 > a.S ||
      (a.ftoa_stride != 0 && a.ftoa_stride != a.W) ||
      (a.dtf_stride != 0 && a.dtf_stride != a.L - 1) ||
      (a.phys_stride != 0 && a.phys_stride != 3))
    return (int)cudaErrorInvalidValue;
  a.wpad = a.threads * a.npt;
  // the caller's plan must agree with this file's layout
  const size_t shmem = layout(a.L, a.S, sizeof(T), a.threads, a.depth, a.rows, a.wpad).total;
  if (shmem != (size_t)a.smem || shmem > 227 * 1024) return (int)cudaErrorInvalidValue;
  return by_npt<T, LOOP>(a, shmem, static_cast<cudaStream_t>(stream));
}

}  // namespace

// The argument struct travels as `const void*`: a parameter of the
// anonymous namespace's type would give these functions internal linkage.
extern "C" int frei_rc_iteration_f32(const void* a, void* stream) {
  return launch<float, false>(a, stream);
}
extern "C" int frei_rc_iteration_f64(const void* a, void* stream) {
  return launch<double, false>(a, stream);
}
extern "C" int frei_rc_loop_f32(const void* a, void* stream) {
  return launch<float, true>(a, stream);
}
extern "C" int frei_rc_loop_f64(const void* a, void* stream) {
  return launch<double, true>(a, stream);
}

// Blocks per SM of the iteration (`loop` 0) or loop kernel in float32
// (`f64` 0) or float64 at `npt` wavelengths a thread, `threads` a block
// and `smem` dynamic bytes, written to `*blocks`; the launch plan sizes
// the shared-memory ring by it.
extern "C" int frei_rc_blocks_per_sm(int f64, int loop, int npt, int threads, int smem,
                                     int* blocks) {
  *blocks = 0;
  if (threads < 32 || threads % 32 || threads > 256 || smem < 0 || smem > 227 * 1024)
    return (int)cudaErrorInvalidValue;
  const size_t shmem = (size_t)smem;
  if (f64)
    return loop ? occupancy_by_npt<double, true>(npt, threads, shmem, blocks)
                : occupancy_by_npt<double, false>(npt, threads, shmem, blocks);
  return loop ? occupancy_by_npt<float, true>(npt, threads, shmem, blocks)
              : occupancy_by_npt<float, false>(npt, threads, shmem, blocks);
}
