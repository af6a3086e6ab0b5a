// K2: fused cell-blocked WCSPH right-hand side over the RCLL cell tables.
//
// Replaces the Pallas kernel repro/kernels/rcll_force.py::rcll_force
// (_force_kernel). For every slot of every cell it sums, over the 3^d
// neighbor cells: the Eq. (7) decode with the stale-cell shift re-anchor
// (tiling.cuh), the B-spline dW/dr / r, p/rho^2 from the streamed 1/rho
// through the scheme's EOS (linear or Tait), the grad-W channel (pressure +
// Monaghan artificial viscosity), the Morris dv channel and the delta-SPH
// continuity term, in fp32. Empty slots carry m = 0 and 1/rho0, so their
// pair terms are exact zeros; compact support zeroes out-of-range and self
// pairs, exactly as in the Pallas kernel. The shift stream is int16.
// Occupancy comes from the binning: row c's occupied slots are 0 ..
// min(counts[c], cap) - 1 (K1 packs them first), whatever their masses; a
// massless particle is occupied and is walked like any other.
//
// Bound on the H100: the pair terms cost ~60 fp32 operations (one sqrt,
// two to four IEEE divisions) against ~16 bytes per slot, but only pairs
// inside the support need them; the others need the decode and a test. At
// taylor_green that prices the operations under the ~115 MB of inputs and
// outputs, so the least time is set by bytes. The TPU kernel evaluates every cap x cap slot pair of every tile; at
// taylor_green (N = 1,048,576, cap 20, ~5.8 particles a cell) that is
// (C+1) * 9 * cap^2 ~ 6.5e8 pairs, ~12x the ~5.4e7 occupied ones. This
// kernel visits only pairs whose neighbor slot is occupied, in two passes
// on the caller's stream:
//
//  1. stage (one warp per row): reads the row's occupied count and writes
//     one fp32 record per slot up to and including the first empty one: the
//     re-anchored rel, v, m, 1/rho and p/rho^2. The Tait powf and the
//     decode run once per slot instead of once per tile it appears in.
//  2. force (32 consecutive cells per 256-thread block): the work rows of
//     a cell are its occupied slots plus, when it has an empty slot, one
//     representative empty slot. A block scans its cells' work counts in
//     shared memory and gives one work row to each thread, so warps are
//     full whatever the occupancy (one cell per block left 12 of 32 lanes
//     idle at cap 20, and ~14 of the 20 others on empty slots). Each thread
//     runs a cursor over k in cells.neighbor_cell_offsets order and, within
//     a tile, the neighbor's occupied slots j ascending, read through the
//     read-only path (consecutive threads share neighbor cells, so records
//     hit L1). Only ~1/3 of the visited pairs lie inside the support r < 2h
//     (3x3 cells of edge 2h around a disc of radius 2h); the cursor skips
//     the others in a cheap inner loop, and the pair terms (sqrt, IEEE
//     divisions) run once per pair inside the support with every thread of
//     the warp that found one. A skipped pair has dW = 0 and adds exact
//     zeros. Each tile's sum is added to fp32 register accumulators: the
//     Pallas kernel's order, no atomics, no barrier per tile. Every empty
//     slot of a row has the same inputs (K1 masks them), hence the same
//     outputs: the representative's are written to all of them at the end.
//
// Skipping an empty neighbor slot or a pair outside the support removes a
// +-0 term, so the sums are those of the all-pairs design up to nvcc's
// multiply-add contraction. Arithmetic follows the plain version
// (repro_torch/kernels/rcll_force.py) expression by expression; nvcc's
// default --fmad=true contracts fp32 multiply-adds in the pair terms, so the
// kernel differs from the plain version by a few ulps per term, within
// rcll_force.rounding_bound. The per-slot p/rho^2 is the exception (see
// por2_inv). powf, sqrtf and '/' are the IEEE-rounded CUDA versions.
//
// Left on the table: divergence across the ~5 cells a warp spans (the
// pair terms run as often as the warp's busiest thread needs), the IEEE
// divisions and sqrt (a reciprocal or rsqrt form changes the rounding model
// behind rounding_bound), Newton's-third-law pair sharing (it changes the
// summation order), and staging the block's neighborhood in shared memory.
// Gathering each thread's pairs inside the support into a shared-memory
// list before evaluating them, to take the cursor's inner loop out of the
// pair terms' way, did not pay on the H100.
#include <cuda_runtime.h>

#include "tiling.cuh"

namespace {

using repro_torch::cell_offset;
using repro_torch::dw_over_r;
using repro_torch::pair_disp;
using repro_torch::reanchor;
using repro_torch::to_f32;

constexpr int kCellsPerBlock = 32;  // one warp scans the block's cells
constexpr int kForceThreads = 256;
// 5 blocks (40 warps) an SM hold the force pass to 51 registers a thread
// (unbounded it takes 54 in 2-D, 61 in 3-D, and 4 blocks fit): the pair
// terms are long dependent chains, and the extra warps hide their latency.
constexpr int kForceMinBlocks = 5;
constexpr int kStageThreads = 256;  // 8 rows per block, one warp each

struct ForceParams {
  float hc[3];    // physical cell edges
  float h;        // smoothing length (R = r / h)
  float a_dw;     // alpha_d(dim, h) / h
  float eos_k;    // linear: c0*c0; tait: B = c0*c0*rho0/gamma
  float rho0;
  float neg_gamma;
  float reg;      // 0.01 * h * h
  float avc;      // -alpha * c0 * h
  float two_mu;   // 2 * mu
  float dk;       // 2 * delta * h * c0
  int eos_tait, has_av, has_dv, has_delta;
  int skip_last_nb;  // 0; 1 plants a fault: each tile's last occupied slot is skipped
};

// p/rho^2 of one slot. The linear form c0^2 (1/rho - rho0/rho^2) cancels
// to ~1e-3 of its parts near rho0, so a contracted multiply-add here would
// change it by ~1e-4 relative; it is evaluated with explicitly rounded
// operations in the plain version's order.
__device__ __forceinline__ float por2_inv(float inv, const ForceParams& p) {
  if (p.eos_tait) {
    const float ratio = __fmul_rn(p.rho0, inv);
    return __fmul_rn(__fmul_rn(__fmul_rn(p.eos_k, __fsub_rn(powf(ratio, p.neg_gamma), 1.0f)),
                               inv),
                     inv);
  }
  return __fmul_rn(p.eos_k, __fsub_rn(inv, __fmul_rn(__fmul_rn(p.rho0, inv), inv)));
}

// One staged slot: 2-D {rx, ry, vx, vy}, {m, inv, por2, -}; 3-D {rx, ry, rz,
// m}, {vx, vy, vz, inv}, {por2, -, -, -}. rx.. are re-anchored.
template <int DIM>
struct Slot {
  static constexpr int kQuads = DIM == 2 ? 2 : 3;
  float r[DIM], v[DIM], m, inv, por2;
};

template <int DIM>
__device__ __forceinline__ void store_slot(float4* rec, size_t idx, const Slot<DIM>& s) {
  float4* q = rec + idx * Slot<DIM>::kQuads;
  if constexpr (DIM == 2) {
    q[0] = make_float4(s.r[0], s.r[1], s.v[0], s.v[1]);
    q[1] = make_float4(s.m, s.inv, s.por2, 0.0f);
  } else {
    q[0] = make_float4(s.r[0], s.r[1], s.r[2], s.m);
    q[1] = make_float4(s.v[0], s.v[1], s.v[2], s.inv);
    q[2] = make_float4(s.por2, 0.0f, 0.0f, 0.0f);
  }
}

template <int DIM>
__device__ __forceinline__ Slot<DIM> load_slot(const float4* __restrict__ rec, size_t idx) {
  const float4* q = rec + idx * Slot<DIM>::kQuads;
  Slot<DIM> s;
  const float4 a = __ldg(q);
  const float4 b = __ldg(q + 1);
  if constexpr (DIM == 2) {
    s.r[0] = a.x; s.r[1] = a.y; s.v[0] = a.z; s.v[1] = a.w;
    s.m = b.x; s.inv = b.y; s.por2 = b.z;
  } else {
    const float4 c = __ldg(q + 2);
    s.r[0] = a.x; s.r[1] = a.y; s.r[2] = a.z; s.m = a.w;
    s.v[0] = b.x; s.v[1] = b.y; s.v[2] = b.z; s.inv = b.w;
    s.por2 = c.x;
  }
  return s;
}

// Row c's occupied count: the binning's count, read as at most cap.
__device__ __forceinline__ int occupied(const int* __restrict__ counts, int c, int cap) {
  return min(max(__ldg(counts + c), 0), cap);
}

// Pass 1: per row, the staged records of slots 0 .. min(count, cap - 1).
template <int DIM, typename RelT, typename RecT>
__global__ void __launch_bounds__(kStageThreads)
    stage_kernel(const RelT* __restrict__ rel, const int16_t* __restrict__ shift,
                 const RecT* __restrict__ v, const RecT* __restrict__ m,
                 const float* __restrict__ inv_rho, const int* __restrict__ counts,
                 float4* __restrict__ rec, int c_rows, int cap, ForceParams p) {
  const int c = (blockIdx.x * kStageThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (c >= c_rows) return;  // uniform over the warp
  const int count = occupied(counts, c, cap);
  const int staged = count < cap ? count + 1 : cap;
  for (int s = lane; s < staged; s += 32) {
    Slot<DIM> q;
#pragma unroll
    for (int a = 0; a < DIM; ++a) {
      const size_t e = (static_cast<size_t>(c) * DIM + a) * cap + s;
      q.r[a] = reanchor(rel[e], shift[e]);
      q.v[a] = to_f32(v[e]);
    }
    const size_t e = static_cast<size_t>(c) * cap + s;
    q.m = to_f32(m[e]);
    q.inv = inv_rho[e];
    q.por2 = por2_inv(q.inv, p);
    store_slot<DIM>(rec, e, q);
  }
}

// The pair terms of self slot i = me and neighbor slot j = o, added to the
// tile sums: Scheme.gradw_pair_coef, dv_pair_coef and drho_pair_term.
template <int DIM>
__device__ __forceinline__ void pair_terms(const Slot<DIM>& me, const Slot<DIM>& o,
                                           const float (&disp)[DIM], float r2,
                                           const ForceParams& p, float& t_drho,
                                           float (&t_acc)[DIM]) {
  const float coef = dw_over_r(sqrtf(r2), p.h, p.a_dw);
  const float mj = o.m;
  const float inv_i = me.inv;
  const float inv_j = o.inv;
  float dv[DIM];
  float dv_dot_disp = 0.0f;
#pragma unroll
  for (int a = 0; a < DIM; ++a) {
    dv[a] = me.v[a] - o.v[a];
    dv_dot_disp += dv[a] * disp[a];
  }
  float gc = mj * (me.por2 + o.por2);
  if (p.has_av) {
    const float mu_ij = dv_dot_disp / (r2 + p.reg);
    const float rho_bar_inv = 2.0f * inv_i * inv_j / (inv_i + inv_j);
    const float pi_ij = p.avc * mu_ij * rho_bar_inv;
    gc = gc + mj * (dv_dot_disp < 0.0f ? pi_ij : 0.0f);
  }
  gc = gc * coef;
  const float x_dot_gw = coef * r2;
  float vc = 0.0f;
  if (p.has_dv) vc = mj * p.two_mu * x_dot_gw * inv_i * inv_j / (r2 + p.reg);
#pragma unroll
  for (int a = 0; a < DIM; ++a) {
    float contrib = -gc * disp[a];
    if (p.has_dv) contrib = contrib + vc * dv[a];
    t_acc[a] += contrib;
  }
  float dterm = mj * coef * dv_dot_disp;
  if (p.has_delta) {
    const float rho_diff = (inv_i - inv_j) / (inv_i * inv_j);
    dterm = dterm + p.dk * mj * inv_j * rho_diff * (-x_dot_gw) / (r2 + p.reg);
  }
  t_drho += dterm;
}

// Pass 2: one thread per work row (occupied slot or representative empty
// slot) of kCellsPerBlock consecutive cells.
template <int DIM>
__global__ void __launch_bounds__(kForceThreads, kForceMinBlocks)
    force_kernel(const float4* __restrict__ rec, const int* __restrict__ counts,
                 const int* __restrict__ nb_ids, float* __restrict__ drho,
                 float* __restrict__ acc, int c_rows, int cap, ForceParams p) {
  constexpr int kNb = DIM == 2 ? 9 : 27;
  __shared__ int s_start[kCellsPerBlock + 1];  // exclusive scan of work rows
  __shared__ int s_occ[kCellsPerBlock];
  __shared__ float s_rep[kCellsPerBlock][DIM + 1];  // the representative's drho, acc

  const int c0 = blockIdx.x * kCellsPerBlock;
  const int n_cells = min(kCellsPerBlock, c_rows - c0);
  if (threadIdx.x < 32) {
    const int i = threadIdx.x;
    const int occ = i < n_cells ? occupied(counts, c0 + i, cap) : 0;
    const int work = i < n_cells ? occ + (occ < cap ? 1 : 0) : 0;
    int incl = work;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, d);
      if (i >= d) incl += y;
    }
    s_start[i] = incl - work;
    if (i == 31) s_start[kCellsPerBlock] = incl;
    s_occ[i] = occ;
  }
  __syncthreads();

  float hc[DIM];
#pragma unroll
  for (int a = 0; a < DIM; ++a) hc[a] = p.hc[a];
  // Beyond r = 2h, dw_over_r is exactly 0; the margin covers the rounding
  // of r^2, sqrt and r / h, so every pair this cut skips has dW = 0.
  const float r2_cut = 4.0f * p.h * p.h * 1.00001f;

  const int total = s_start[kCellsPerBlock];
  for (int w = threadIdx.x; w < total; w += kForceThreads) {
    // The cell of work row w: the last i with s_start[i] <= w (every cell
    // of the block has at least one work row, so the starts increase).
    int lo = 0, hi = n_cells - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (s_start[mid] <= w) lo = mid; else hi = mid - 1;
    }
    const int i = lo;
    const int s = w - s_start[i];
    const int c = c0 + i;
    const Slot<DIM> me = load_slot<DIM>(rec, static_cast<size_t>(c) * cap + s);

    // A cursor over (k, j): k in cells.neighbor_cell_offsets order, j over
    // the neighbor's occupied slots ascending. The inner loop moves it to
    // the next pair inside the support (r^2 <= r2_cut), closing each
    // finished tile's sums into the accumulators; the pair terms then run
    // with every thread of the warp that found one. A pair outside the
    // support has dW = 0 and adds exact zeros, so skipping it leaves every
    // sum as it is.
    float drho_acc = 0.0f, t_drho = 0.0f;
    float acc_acc[DIM], t_acc[DIM], off[DIM];
#pragma unroll
    for (int a = 0; a < DIM; ++a) acc_acc[a] = t_acc[a] = off[a] = 0.0f;
    int k = -1, j = 0, count = 0;
    size_t base = 0;
    while (true) {
      bool found = false;
      Slot<DIM> o;
      float disp[DIM];
      float r2 = 0.0f;
      while (true) {
        if (j < count) {
          o = load_slot<DIM>(rec, base + j);
          ++j;
          r2 = pair_disp<DIM>(me.r, o.r, off, hc, disp);
          if (r2 <= r2_cut) {
            found = true;
            break;
          }
        } else {
          drho_acc += t_drho;
          t_drho = 0.0f;
#pragma unroll
          for (int a = 0; a < DIM; ++a) {
            acc_acc[a] += t_acc[a];
            t_acc[a] = 0.0f;
          }
          if (++k == kNb) break;
          const int nc = __ldg(nb_ids + static_cast<size_t>(c) * kNb + k);
          count = occupied(counts, nc, cap) - p.skip_last_nb;
          base = static_cast<size_t>(nc) * cap;
          j = 0;
#pragma unroll
          for (int a = 0; a < DIM; ++a) off[a] = cell_offset<DIM>(k, a);
        }
      }
      if (!found) break;
      pair_terms<DIM>(me, o, disp, r2, p, t_drho, t_acc);
    }
    if (s < s_occ[i]) {
      drho[static_cast<size_t>(c) * cap + s] = drho_acc;
#pragma unroll
      for (int a = 0; a < DIM; ++a) {
        acc[(static_cast<size_t>(c) * DIM + a) * cap + s] = acc_acc[a];
      }
    } else {
      s_rep[i][0] = drho_acc;
#pragma unroll
      for (int a = 0; a < DIM; ++a) s_rep[i][1 + a] = acc_acc[a];
    }
  }
  __syncthreads();

  // Every empty slot of a row takes its representative's outputs.
  for (int e = threadIdx.x; e < n_cells * cap; e += kForceThreads) {
    const int i = e / cap;
    const int s = e - i * cap;
    if (s < s_occ[i]) continue;
    const size_t c = static_cast<size_t>(c0 + i);
    drho[c * cap + s] = s_rep[i][0];
#pragma unroll
    for (int a = 0; a < DIM; ++a) acc[(c * DIM + a) * cap + s] = s_rep[i][1 + a];
  }
}

struct Launch {
  const void *rel, *shift, *v, *m, *inv_rho, *nb_ids, *counts;
  void *drho, *acc, *staged;
  int c_rows, cap;
  ForceParams p;
  cudaStream_t stream;

  template <int DIM, typename RelT, typename RecT>
  int run() const {
    const int stage_blocks = (c_rows + kStageThreads / 32 - 1) / (kStageThreads / 32);
    stage_kernel<DIM, RelT, RecT><<<stage_blocks, kStageThreads, 0, stream>>>(
        static_cast<const RelT*>(rel), static_cast<const int16_t*>(shift),
        static_cast<const RecT*>(v), static_cast<const RecT*>(m),
        static_cast<const float*>(inv_rho), static_cast<const int*>(counts),
        static_cast<float4*>(staged), c_rows, cap, p);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const int force_blocks = (c_rows + kCellsPerBlock - 1) / kCellsPerBlock;
    force_kernel<DIM><<<force_blocks, kForceThreads, 0, stream>>>(
        static_cast<const float4*>(staged), static_cast<const int*>(counts),
        static_cast<const int*>(nb_ids), static_cast<float*>(drho), static_cast<float*>(acc),
        c_rows, cap, p);
    return static_cast<int>(cudaGetLastError());
  }
};

template <int DIM, typename RelT>
int dispatch_rec(int rec_kind, const Launch& l) {
  switch (rec_kind) {
    case 0: return l.run<DIM, RelT, __half>();
    case 1: return l.run<DIM, RelT, __nv_bfloat16>();
    case 2: return l.run<DIM, RelT, float>();
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int DIM>
int dispatch_rel(int rel_kind, int rec_kind, const Launch& l) {
  if (rel_kind == 0) return dispatch_rec<DIM, __half>(rec_kind, l);
  if (rel_kind == 1) return dispatch_rec<DIM, float>(rec_kind, l);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// rel_kind: 0 = fp16, 1 = fp32. rec_kind: 0 = fp16, 1 = bf16, 2 = fp32.
// counts: (c_rows,) int32, each row's occupied count (read as at most cap;
// the sentinel row's is 0). staged: (c_rows * cap * (dim == 2 ? 2 : 3))
// float4 scratch, 16-byte aligned. n_nb must be 3^dim.
// fparams: hc[0..2], h, a_dw, eos_k, rho0, neg_gamma, reg, avc, two_mu, dk.
// iparams: eos_tait, has_av, has_dv, has_delta, skip_last_nb.
extern "C" int repro_rcll_force(int dim, int rel_kind, int rec_kind, const void* rel,
                                const void* shift, const void* v, const void* m,
                                const void* inv_rho, const void* nb_ids, const void* counts,
                                void* drho, void* acc, void* staged, int c_rows, int cap,
                                int n_nb,
                                const float* fparams, const int* iparams, void* stream) {
  if (cap < 1 || c_rows < 1 || (dim != 2 && dim != 3) || n_nb != (dim == 2 ? 9 : 27))
    return static_cast<int>(cudaErrorInvalidValue);
  Launch l{rel, shift, v, m, inv_rho, nb_ids, counts, drho, acc, staged, c_rows, cap, {},
           static_cast<cudaStream_t>(stream)};
  ForceParams& p = l.p;
  for (int a = 0; a < 3; ++a) p.hc[a] = fparams[a];
  p.h = fparams[3];
  p.a_dw = fparams[4];
  p.eos_k = fparams[5];
  p.rho0 = fparams[6];
  p.neg_gamma = fparams[7];
  p.reg = fparams[8];
  p.avc = fparams[9];
  p.two_mu = fparams[10];
  p.dk = fparams[11];
  p.eos_tait = iparams[0];
  p.has_av = iparams[1];
  p.has_dv = iparams[2];
  p.has_delta = iparams[3];
  p.skip_last_nb = iparams[4];
  if (dim == 2) return dispatch_rel<2>(rel_kind, rec_kind, l);
  return dispatch_rel<3>(rel_kind, rec_kind, l);
}
