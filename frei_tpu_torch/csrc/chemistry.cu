// Equilibrium chemistry table build for NVIDIA Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package builds its table with XLA
// (frei_tpu/chemistry/fastchem.py, no Pallas).  It replaces the eager
// PyTorch build of frei_tpu_torch/chemistry/fastchem.py on a CUDA device,
// whose Gauss-Seidel sweep (`_GaussSeidel.sweep`, the plain version, kept
// for the host build and exact mode) is a few thousand tiny tensor
// operations.  The Python wrapper and the stoichiometry lists it hands
// over live in frei_tpu_torch/ops/chemistry_cuda.py.
//
// What it computes: the (nT x nP) ln-partial-pressure table of
// `FastChemTorch._build_vmr_table`, with its control flow.  The hottest
// row starts from the atomic guess (the H/H2 quadratic solved
// analytically) and runs n_cold sweeps; every cooler row starts from the
// row above and runs n_warm.  A row whose final pressure-closure residual
// (the largest over its points) is over refinish_tol runs n_cold more.
// With `settle` (float64 grids) the row then runs blocks of settle_sweeps
// until no unknown of the row moves by more than settle_tol over a block,
// at most settle_blocks blocks; a row still moving stops the build and is
// reported (`fail`).  A sweep visits the elements in descending abundance
// and runs n_inner safeguarded Newton steps on each one's max-subtracted
// logsumexp (slope clamped at 0.5), then solves the electron's +-1
// quadratic exactly, then takes the secant step on m = ln M.  The host
// hands over ln K(T) of every row and ln P of every column as the plain
// build computes them, so the two builds differ only in summation order
// and in the rounding of exp and log.
//
// What bounds it on an H100: the algorithm's serial chain, not bytes or
// operations.  The default float64 64 x 32 table runs 6,128 sweeps in
// order (each row starts from the one above; each sweep from the last),
// and a sweep is 27 elements x 16 Newton steps, each a max, a sum of
// exponentials over the element's species, a log and two divisions in
// sequence: 2.65 M dependent steps.  Its operations (~3.6e9 float64 exp
// and their sums over the whole build, ~1e11 float64 operations) would
// take ~3 ms at the card's float64 rate; the tables it reads are a few
// tens of kB.  Measured on an H100 80GB HBM3 at 700 W: 0.93 us a Newton
// step (~1,800 cycles of latency at 1,980 MHz), 0.42 ms a sweep, 2.55 s
// for the table (PERF.md §6).
//
// What the design does about it:
//   * One launch, one thread-block cluster, for the whole table: the
//     row-to-row chain and the row decisions (refinish, settle) stay on
//     the card, taken at cluster barriers (each block's partial maxima
//     read through distributed shared memory), with no host round trip.
//   * One warp per (T, P) point, min(nP, 32) warps, 4 a block (the plan,
//     ops/chemistry_cuda.table_plan), so each warp has a scheduler of its
//     SM to itself: the sweep is a chain of dependent steps.  One block of
//     32 warps on one SM took 6.13 s for the default table (64 registers
//     a thread, spilling); 8 blocks of 4 warps 3.00 s, 4 of 8 3.16 s.  A
//     warp takes points g, g + G, ... of the G warps in turn, so any nP
//     works (a row wider than 32 points costs ceil(nP / 32) times a
//     sweep).  Each warp keeps its point's 495 species log pressures (y)
//     and its element state in shared memory; each block stages the
//     row's ln K once per row.
//   * An element's Newton sums run over the species that contain it
//     (CSR lists, 1 to 154 terms with the element's own term), spread
//     over the fewest lanes of a power-of-two width that hold them, so an
//     element of 8 terms sums in 3 shuffle levels, not 5; each lane keeps
//     its terms' bases and counts in registers for the 16 steps.  Sums
//     are xor butterflies: every lane gets the same bits, and repeated
//     builds give identical tables.  The logsumexp's max (the exact max,
//     so the same shift) is two redux.sync integer reductions of an
//     order-preserving key instead of five shuffle levels: with the
//     fixed-width sums, 3.00 -> 2.55 s, the table bit for bit the same.
//   * Products that feed a sum are rounded apart (__dmul_rn, __dadd_rn),
//     as the plain version's separate tensor operations round them.

// Bound to PyTorch through a plain extern "C" launcher loaded with ctypes.
// It returns cudaGetLastError() after the launch; it launches on the
// caller's stream and does not synchronize.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr double kNeg = -1e30;       // fastchem._NEG
constexpr int kMaxItems = 6;         // terms of one element a lane holds
constexpr int kMaxWarps = 32;       // warps of a row in all blocks
constexpr int kMaxBlockWarps = 8;    // warps of one block
constexpr int kMaxBlocks = 8;        // blocks of the cluster (portable)
constexpr unsigned kFull = 0xffffffffu;

struct ChemArgs {
  const double* lnK;       // (nT, S) ln K of each row's temperature
  const double* ln_P;      // (nP,) ln of each column's pressure [bar]
  const double* ln_eps;    // (E,) ln abundance, kNeg where it is zero
  const int* sp_off;       // (S + 1,) species i's (element, count) pairs
  const int* sp_el;        //   their elements
  const double* sp_nu;     //   their signed counts
  const int* el_j;         // (n_order,) the elements in sweep order
  const int* el_off;       // (n_order + 1,) each element's terms in aug_*
  const int* aug_sp;       //   the species (-1: the element's own term)
  const double* aug_nu;    //   its count (1 for the own term)
  const double* aug_lnnu;  //   ln of the count
  const int* cat_sp;       // (n_cat,) species with a negative e- count
  const double* cat_nu;
  const int* an_sp;        // (n_an,) species with a positive e- count
  const double* an_nu;
  const int* out_idx;      // (n_idx,) into [elements..., species...]
  double* state;           // (nP, E + 1) each point's lam and m
  double* out;             // (nT, nP, n_idx) ln p of the requested outputs
  double* row_res;         // (nT,) each row's final closure residual
  int* row_sweeps;         // (nT,) sweeps each row ran
  int* row_refin;          // (nT,) 1 where the row was refinished
  double* fail;            // (2,) the row that did not settle (or -1), its move
  double ln_eps_sum, eps_H, refinish_tol, settle_tol;
  int nT, nP, S, E, n_order, n_cat, n_an, n_idx, ie, iH, iH2;
  int n_cold, n_warm, n_inner, settle, settle_sweeps, settle_blocks;
  int warps, blocks;       // warps a block, blocks in the one cluster
};

// torch.amax's max: NaN wins.
__device__ __forceinline__ double nanmax(double a, double b) {
  return (a > b || a != a) ? a : b;
}

__device__ __forceinline__ double warp_nanmax(double v) {
  for (int off = 16; off > 0; off >>= 1) v = nanmax(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

// The warp's largest value, exactly, as the shift of a logsumexp: two
// integer reductions (redux.sync) of an order-preserving key of the
// double's bits, its high word then its low word, in place of five
// shuffle levels.  A NaN term makes the sum NaN whatever the shift.
__device__ __forceinline__ double warp_shift(double v) {
  const unsigned long long b = __double_as_longlong(v);
  const unsigned long long k = (b >> 63) ? ~b : (b | 0x8000000000000000ull);
  const unsigned hi = __reduce_max_sync(kFull, (unsigned)(k >> 32));
  const unsigned lo = __reduce_max_sync(kFull, (unsigned)(k >> 32) == hi ? (unsigned)k : 0u);
  const unsigned long long m = ((unsigned long long)hi << 32) | lo;
  return __longlong_as_double((m >> 63) ? (m & 0x7fffffffffffffffull) : ~m);
}

// Xor-butterfly sums over groups of W lanes: every lane of a group gets
// the same bits.
template <int W>
__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = W >> 1; off > 0; off >>= 1) v = __dadd_rn(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

template <int W>
__device__ __forceinline__ void warp_sum2(double& a, double& b) {
#pragma unroll
  for (int off = W >> 1; off > 0; off >>= 1) {
    const double a2 = __shfl_xor_sync(kFull, a, off);
    const double b2 = __shfl_xor_sync(kFull, b, off);
    a = __dadd_rn(a, a2);
    b = __dadd_rn(b, b2);
  }
}

// y = ln K + lam @ nu^T (the species' log pressures), lanes over species.
__device__ void species_pressures(const ChemArgs& a, const double* lnK, const double* lam,
                                  double* y, int lane) {
  for (int i = lane; i < a.S; i += 32) {
    double acc = 0.0;
    for (int q = a.sp_off[i]; q < a.sp_off[i + 1]; ++q) acc = fma(a.sp_nu[q], lam[a.sp_el[q]], acc);
    y[i] = __dadd_rn(lnK[i], acc);
  }
  __syncwarp();
}

// One element's 1-D solve: n_inner Newton steps of
// ln(sum_i exp(base_i + nu_i x)) = ln eps_j + m over its terms, K a lane
// on the first W lanes, then the species' log pressures moved by
// (x - lam_j) nu_i.
template <int K, int W>
__device__ void element(const ChemArgs& a, int e, double* y, double* lam, double m, int lane) {
  const int j = a.el_j[e];
  const int a0 = a.el_off[e];
  const int na = a.el_off[e + 1] - a0;
  const double lam_j = lam[j];
  const double target = __dadd_rn(a.ln_eps[j], m);
  double base[K], nu[K];
  int n_mine = 0;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int t = lane + W * k;
    base[k] = 0.0;
    nu[k] = 0.0;
    if (lane < W && t < na) {
      const int sp = a.aug_sp[a0 + t];
      nu[k] = a.aug_nu[a0 + t];
      if (sp >= 0)
        base[k] = __dadd_rn(__dsub_rn(y[sp], __dmul_rn(nu[k], lam_j)), a.aug_lnnu[a0 + t]);
      n_mine = k + 1;
    }
  }
  double x = lam_j;
#pragma unroll 1
  for (int it = 0; it < a.n_inner; ++it) {
    double mx = -INFINITY;
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (k < n_mine) mx = fmax(mx, __dadd_rn(base[k], __dmul_rn(nu[k], x)));
    mx = warp_shift(mx);                        // lanes past W hold -inf
    double s = 0.0, s_nu = 0.0;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (k < n_mine) {
        const double ea = exp(__dsub_rn(__dadd_rn(base[k], __dmul_rn(nu[k], x)), mx));
        s = __dadd_rn(s, ea);
        s_nu = __dadd_rn(s_nu, __dmul_rn(ea, nu[k]));
      }
    }
    warp_sum2<W>(s, s_nu);
    const double t = __dadd_rn(mx, log(s));
    double slope = s_nu / s;
    slope = slope < 0.5 ? 0.5 : slope;          // torch.clamp(min=0.5): NaN stays
    x = __dsub_rn(x, __dsub_rn(t, target) / slope);
  }
  const double d = __dsub_rn(x, lam_j);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (k < n_mine) {
      const int sp = a.aug_sp[a0 + lane + W * k];
      if (sp >= 0) y[sp] = __dadd_rn(y[sp], __dmul_rn(d, nu[k]));
    }
  }
  __syncwarp();
  if (lane == 0) lam[j] = x;
  __syncwarp();
}

// The element's terms on the fewest lanes of a power-of-two width that
// hold them (one a lane up to 32 terms), else K a lane on all 32.
__device__ void element_any(const ChemArgs& a, int e, double* y, double* lam, double m, int lane) {
  const int na = a.el_off[e + 1] - a.el_off[e];
  if (na <= 1) return element<1, 1>(a, e, y, lam, m, lane);
  if (na <= 2) return element<1, 2>(a, e, y, lam, m, lane);
  if (na <= 4) return element<1, 4>(a, e, y, lam, m, lane);
  if (na <= 8) return element<1, 8>(a, e, y, lam, m, lane);
  if (na <= 16) return element<1, 16>(a, e, y, lam, m, lane);
  switch ((na + 31) / 32) {
    case 1: return element<1, 32>(a, e, y, lam, m, lane);
    case 2: return element<2, 32>(a, e, y, lam, m, lane);
    case 3: return element<3, 32>(a, e, y, lam, m, lane);
    case 4: return element<4, 32>(a, e, y, lam, m, lane);
    case 5: return element<5, 32>(a, e, y, lam, m, lane);
    default: return element<kMaxItems, 32>(a, e, y, lam, m, lane);
  }
}

// fastchem._lse's max and its clamps: max(amax, kNeg), ln(max(s, 1e-300)).
__device__ __forceinline__ double lse_max(double mx) { return mx < kNeg ? kNeg : mx; }
__device__ __forceinline__ double lse_of(double mx, double s) {
  return __dadd_rn(mx, log(s < 1e-300 ? 1e-300 : s));
}

// The electron: lam_e = (lse_cations - lse([0, anions])) / 2.
__device__ void electron(const ChemArgs& a, const double* y, double* lam, int lane) {
  const double lam_e = lam[a.ie];
  double mc = -INFINITY, ma = lane == 0 ? 0.0 : -INFINITY;
  for (int c = lane; c < a.n_cat; c += 32)
    mc = fmax(mc, __dsub_rn(y[a.cat_sp[c]], __dmul_rn(lam_e, a.cat_nu[c])));
  for (int c = lane; c < a.n_an; c += 32)
    ma = fmax(ma, __dsub_rn(y[a.an_sp[c]], __dmul_rn(lam_e, a.an_nu[c])));
  mc = lse_max(warp_shift(mc));
  ma = lse_max(warp_shift(ma));
  double sc = 0.0, sa = lane == 0 ? exp(-ma) : 0.0;
  for (int c = lane; c < a.n_cat; c += 32)
    sc = __dadd_rn(sc, exp(__dsub_rn(__dsub_rn(y[a.cat_sp[c]], __dmul_rn(lam_e, a.cat_nu[c])), mc)));
  for (int c = lane; c < a.n_an; c += 32)
    sa = __dadd_rn(sa, exp(__dsub_rn(__dsub_rn(y[a.an_sp[c]], __dmul_rn(lam_e, a.an_nu[c])), ma)));
  warp_sum2<32>(sc, sa);
  const double lam_new = 0.5 * __dsub_rn(lse_of(mc, sc), lse_of(ma, sa));
  __syncwarp();
  if (lane == 0) lam[a.ie] = lam_new;
  __syncwarp();
}

// The pressure closure's residual lse([lam, y]) - ln P.
__device__ double closure(const ChemArgs& a, const double* y, const double* lam, double ln_P,
                          int lane) {
  double mx = -INFINITY;
  for (int q = lane; q < a.E; q += 32) mx = fmax(mx, lam[q]);
  for (int i = lane; i < a.S; i += 32) mx = fmax(mx, y[i]);
  mx = lse_max(warp_shift(mx));
  double s = 0.0;
  for (int q = lane; q < a.E; q += 32) s = __dadd_rn(s, exp(__dsub_rn(lam[q], mx)));
  for (int i = lane; i < a.S; i += 32) s = __dadd_rn(s, exp(__dsub_rn(y[i], mx)));
  s = warp_sum<32>(s);
  __syncwarp();                                 // y is read before the next sweep writes it
  return __dsub_rn(lse_of(mx, s), ln_P);
}

// One Gauss-Seidel sweep of one point, from y = species_pressures(lam);
// leaves y so again and returns the closure residual.
__device__ double sweep(const ChemArgs& a, const double* lnK, double* y, double* lam, double& m,
                        double ln_P, int lane) {
  for (int e = 0; e < a.n_order; ++e) element_any(a, e, y, lam, m, lane);
  species_pressures(a, lnK, lam, y, lane);
  electron(a, y, lam, lane);
  species_pressures(a, lnK, lam, y, lane);
  const double r = closure(a, y, lam, ln_P, lane);
  m = __dsub_rn(m, r);
  return r;
}

// The atomic start of fastchem._solve_batch: lam_j = ln eps_j + m0 with
// m0 = ln P - ln sum(eps), the electron at ln P - 40, hydrogen from the
// H/H2 quadratic.
__device__ void atomic_start(const ChemArgs& a, const double* lnK, double* lam, double ln_P,
                             int lane) {
  const double m0 = __dsub_rn(ln_P, a.ln_eps_sum);
  for (int q = lane; q < a.E; q += 32) lam[q] = __dadd_rn(a.ln_eps[q], m0);
  __syncwarp();
  if (lane == 0) {
    lam[a.ie] = __dsub_rn(ln_P, 40.0);
    if (a.iH2 >= 0) {
      const double lnK2 = lnK[a.iH2];
      const double K2 = exp(lnK2 > 600.0 ? 600.0 : lnK2);
      const double u = __dmul_rn(__dmul_rn(__dmul_rn(8.0, K2), a.eps_H), exp(m0));
      const double pH = __dadd_rn(-1.0, sqrt(__dadd_rn(1.0, u))) / __dmul_rn(4.0, K2);
      lam[a.iH] = log(pH < 1e-300 ? 1e-300 : pH);
    }
    lam[a.E] = m0;
  }
  __syncwarp();
}

struct Group {
  double r;      // the row's largest |closure residual| of the last sweep
  double moved;  // the row's largest move of an unknown over the group
};

// n sweeps of every point of the row (a warp's points in turn, warp g of
// the cluster's G taking points g, g + G, ...); the row's residual and
// move, read by every thread of the cluster after a cluster barrier.
__device__ Group run_group(const ChemArgs& a, const double* lnK, double* y, double* lam,
                           double* z0, double* part, int g, int warp, int lane, int n,
                           bool start) {
  cg::cluster_group cluster = cg::this_cluster();
  const int E1 = a.E + 1;
  double r_max = -INFINITY, moved = -INFINITY;
  for (int p = g; p < a.nP; p += a.warps * a.blocks) {
    double* st = a.state + (size_t)p * E1;
    const double ln_P = a.ln_P[p];
    if (start) {
      atomic_start(a, lnK, lam, ln_P, lane);
    } else {
      for (int q = lane; q < E1; q += 32) lam[q] = st[q];
      __syncwarp();
    }
    for (int q = lane; q < E1; q += 32) z0[q] = lam[q];
    double m = lam[a.E];
    species_pressures(a, lnK, lam, y, lane);
    double r = 0.0;
#pragma unroll 1
    for (int s = 0; s < n; ++s) r = sweep(a, lnK, y, lam, m, ln_P, lane);
    __syncwarp();
    if (lane == 0) lam[a.E] = m;
    __syncwarp();
    double d = -INFINITY;
    for (int q = lane; q < E1; q += 32) {
      st[q] = lam[q];
      d = nanmax(d, fabs(__dsub_rn(lam[q], z0[q])));
    }
    moved = nanmax(moved, warp_nanmax(d));
    r_max = nanmax(r_max, fabs(r));
    __syncwarp();
  }
  if (lane == 0) {
    part[warp] = r_max;
    part[kMaxWarps + warp] = moved;
  }
  cluster.sync();
  Group row{-INFINITY, -INFINITY};
  for (int b = 0; b < a.blocks; ++b) {        // the same order in every thread
    const double* pb = cluster.map_shared_rank(part, b);
    for (int w = 0; w < a.warps; ++w) {
      row.r = nanmax(row.r, pb[w]);
      row.moved = nanmax(row.moved, pb[kMaxWarps + w]);
    }
  }
  cluster.sync();                             // before the next group writes part
  return row;
}

size_t smem_doubles(int S, int E, int warps) {
  return (size_t)S + (size_t)warps * S + 2 * (size_t)warps * (E + 1) + 2 * kMaxWarps;
}

__global__ void __launch_bounds__(kMaxBlockWarps * 32, 1) table_kernel(ChemArgs a) {
  extern __shared__ double smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = blockIdx.x * a.warps + warp;  // the warp's rank in the cluster
  const bool lead = blockIdx.x == 0 && threadIdx.x == 0;
  const int E1 = a.E + 1;
  double* lnK = smem;
  double* y = lnK + a.S + (size_t)warp * a.S;
  double* lam = lnK + a.S + (size_t)a.warps * a.S + (size_t)warp * E1;
  double* z0 = lnK + a.S + (size_t)a.warps * (a.S + E1) + (size_t)warp * E1;
  double* part = lnK + a.S + (size_t)a.warps * (a.S + 2 * E1);
  for (int k = a.nT - 1; k >= 0; --k) {
    for (int i = threadIdx.x; i < a.S; i += blockDim.x) lnK[i] = a.lnK[(size_t)k * a.S + i];
    __syncthreads();
    const bool cold = k == a.nT - 1;
    int sweeps = cold ? a.n_cold : a.n_warm;
    Group row = run_group(a, lnK, y, lam, z0, part, g, warp, lane, sweeps, cold);
    int refin = 0;
    if (row.r > a.refinish_tol) {   // false for NaN, as in the plain build
      refin = 1;
      row = run_group(a, lnK, y, lam, z0, part, g, warp, lane, a.n_cold, false);
      sweeps += a.n_cold;
    }
    if (a.settle) {
      bool settled = false;
      for (int b = 0; b < a.settle_blocks && !settled; ++b) {
        row = run_group(a, lnK, y, lam, z0, part, g, warp, lane, a.settle_sweeps, false);
        sweeps += a.settle_sweeps;
        settled = row.moved <= a.settle_tol;
      }
      if (!settled) {               // every thread of the cluster leaves here
        if (lead) {
          a.fail[0] = k;
          a.fail[1] = row.moved;
          a.row_sweeps[k] = sweeps;
          a.row_refin[k] = refin;
        }
        return;
      }
    }
    for (int p = g; p < a.nP; p += a.warps * a.blocks) {
      const double* st = a.state + (size_t)p * E1;
      for (int q = lane; q < E1; q += 32) lam[q] = st[q];
      __syncwarp();
      species_pressures(a, lnK, lam, y, lane);
      double* o = a.out + ((size_t)k * a.nP + p) * a.n_idx;
      for (int q = lane; q < a.n_idx; q += 32) {
        const int idx = a.out_idx[q];
        o[q] = idx < a.E ? lam[idx] : y[idx - a.E];
      }
      __syncwarp();
    }
    if (lead) {
      a.row_res[k] = row.r;
      a.row_sweeps[k] = sweeps;
      a.row_refin[k] = refin;
    }
    __syncthreads();
  }
}

int launch(const void* args, void* stream) {
  ChemArgs a = *static_cast<const ChemArgs*>(args);
  if (a.nT < 1 || a.nP < 1 || a.S < 1 || a.E < 1 || a.n_order < 0 || a.n_cat < 1 ||
      a.n_an < 0 || a.n_idx < 0 || a.ie < 0 || a.ie >= a.E || a.iH < 0 || a.iH >= a.E ||
      a.iH2 >= a.S || a.n_cold < 1 || a.n_warm < 1 || a.n_inner < 0 ||
      (a.settle && (a.settle_sweeps < 1 || a.settle_blocks < 1)) || a.warps < 1 ||
      a.warps > kMaxBlockWarps || a.blocks < 1 || a.blocks > kMaxBlocks ||
      a.warps * a.blocks > kMaxWarps)
    return (int)cudaErrorInvalidValue;
  const size_t shmem = smem_doubles(a.S, a.E, a.warps) * sizeof(double);
  if (shmem > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (shmem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(table_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.blocks, 1, 1);
  cfg.blockDim = dim3(a.warps * 32, 1, 1);
  cfg.dynamicSmemBytes = shmem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = a.blocks;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, table_kernel, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// The argument struct travels as `const void*`: a parameter of the
// anonymous namespace's type would give this function internal linkage.
extern "C" int frei_chem_table(const void* args, void* stream) { return launch(args, stream); }
