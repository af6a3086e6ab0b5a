// K3: fused RCLL neighbor search and A5 normalized-gradient sums.
//
// Replaces the Pallas kernel repro/kernels/sph_gradient.py::rcll_gradient
// (_gradient_kernel). Per (self cell, neighbor cell) tile of cap x cap
// pairs, the NNPS tier decides each pair as K4/K5 do (tiling.cuh
// tile_r2_cell in the NNPS type, fp16 by default, every operation
// rounded, under the occupancy mask with the self pair removed), and each
// accepted pair feeds the physics tier in fp32 at once: the Eq. (7)
// displacement x_i - x_j, the B-spline dW/dr / r (shared with K2), and
//   num_a += (f_j - f_i) dW/dx_a,   den_a += -disp_a dW/dx_a,
// so the adjacency never reaches device memory (the paper's Table 6
// fusion). A rejected pair, and any pair with an empty slot, adds exactly
// 0 in the plain version (repro_torch/kernels/sph_gradient.py), so it is
// skipped here.
//
// Bound on the H100: bytes and operations nearly tie (~13 operations per
// decided pair, ~40 per accepted pair, against ~0.6 KB per cell of tables
// in and sums out). The TPU kernel decides every cap x cap pair of every
// tile; at the paper's 1M-particle case (cap 20, ~5.75 particles a cell)
// only ~1/12 of them have two occupied slots. This kernel visits only
// those, in two passes on the caller's stream:
//
//  1. staging (tiling.cuh launch_stage_slots, one warp a row): the row's
//     occupancy mask as bits, one 32-bit word per 32 slots, by ballots over
//     occ (the mask may have holes anywhere; no prefix is assumed), and
//     each occupied slot's coordinates and f packed for one load.
//  2. gradient (32 consecutive cells per 256-thread block): the work rows
//     of a cell are its occupied slots, found from occ with ballots and
//     popcounts and scanned in shared memory, one work row a thread, so
//     warps are full whatever the occupancy; the cells' neighbor ids and
//     words are staged in shared memory. Each thread walks the tiles k in
//     cells.neighbor_cell_offsets order, the same k for the whole warp.
//     Within a tile it first decides the neighbor's occupied slots j in
//     the NNPS type (their records through the read-only path) into a bit
//     mask, then runs the physics tier over the accepted j ascending,
//     all the warp's threads together, into the tile's sums; each tile's
//     sum is added to fp32 register accumulators in k order (the Pallas
//     kernel's order), with no atomics. An empty self slot's num and den
//     are exact zeros: the block writes them and evaluates nothing.
//
// Skipped pairs add +-0 terms, so the sums are those of the all-pairs
// design up to nvcc's multiply-add contraction in the physics tier: num
// and den differ from the plain version's by a few ulps per term, within
// sph_gradient.rounding_bound.
//
// A first design of this pass ran K2's cursor (each thread moving to its
// own next accepted pair across tiles): the ~5 cells a warp spans put its
// threads at different tiles, so nearly every step paid some thread's
// dependent loads of the next tile, and it read 0.72 ms at the main path.
// Left on the table: the staging pass (one warp a row) and each block's
// setup wait on their loads; the warp runs a tile's decisions and physics
// as often as its busiest thread needs; and the IEEE division and sqrt of
// dw_over_r.
#include <cuda_runtime.h>

#include <type_traits>

#include "tiling.cuh"

namespace {

using repro_torch::cell_offset;
using repro_torch::dw_over_r;
using repro_torch::load_record;
using repro_torch::NnpsArith;
using repro_torch::SlotRecord;
using repro_torch::pair_disp;
using repro_torch::tile_r2_cell;
using repro_torch::to_compute;
using repro_torch::to_f32;

using repro_torch::block_work_rows;
using repro_torch::stage_neighborhood;
using repro_torch::work_row;

constexpr int kCellsPerBlock = 32;  // one warp scans the block's cells
constexpr int kGradThreads = 256;
// 6 blocks (48 warps) an SM hold the gradient pass to 40 registers a thread
// (unbounded it takes 59 in 2-D, and 4 blocks fit; a few bytes spill): the
// walk waits on its loads, and the extra warps hide their latency.
constexpr int kGradMinBlocks = 6;

struct GradParams {
  float w[3];    // anisotropy weights, rounded to the NNPS type on the host
  float r2;      // r_cell^2, rounded to the NNPS type on the host
  float hc[3];   // physical cell edges
  float h;       // smoothing length
  float a_dw;    // alpha_d(dim, h) / h
  float f_sign;  // +1: f_j - f_i (a check plants -1 to show it catches it)
};

// A stored coordinate in the NNPS type; no round trip when they agree.
template <typename CT, typename RelT>
__device__ __forceinline__ CT nnps_coord(RelT x) {
  if constexpr (std::is_same_v<CT, RelT>) {
    return x;
  } else {
    return to_compute<CT>(x);
  }
}

// Pass 2: one thread per occupied self slot of kCellsPerBlock consecutive
// cells.
template <int DIM, typename RelT, typename CT>
__global__ void __launch_bounds__(kGradThreads, kGradMinBlocks)
    gradient_kernel(const typename SlotRecord<DIM, RelT>::Raw* __restrict__ recs,
                    const float* __restrict__ occ, const unsigned* __restrict__ occ_words,
                    const int* __restrict__ nb_ids, float* __restrict__ num,
                    float* __restrict__ den, int c_rows, int cap, int words, GradParams p) {
  constexpr int M = DIM == 2 ? 9 : 27;
  using A = NnpsArith<CT>;
  __shared__ unsigned s_self[kCellsPerBlock * 32];  // the block's own occupancy words
  __shared__ int s_count[kCellsPerBlock];
  __shared__ int s_start[kCellsPerBlock + 1];  // exclusive scan of work rows
  __shared__ int s_nb[kCellsPerBlock * M];
  __shared__ unsigned s_nbw[kCellsPerBlock * M];

  const int c0 = blockIdx.x * kCellsPerBlock;
  const int n_cells = min(kCellsPerBlock, c_rows - c0);
  block_work_rows(occ, c0, n_cells, cap, words, s_self, s_count, s_start);
  stage_neighborhood<M>(nb_ids, occ_words, c0, n_cells, words, s_nb, s_nbw);

  CT w[DIM];
  float hc[DIM];
#pragma unroll
  for (int a = 0; a < DIM; ++a) {
    w[a] = A::from_f32(p.w[a]);
    hc[a] = p.hc[a];
  }
  const float r2_cell = A::f32(A::from_f32(p.r2));

  const int total = s_start[kCellsPerBlock];
  for (int wr = threadIdx.x; wr < total; wr += kGradThreads) {
    const int2 cs = work_row(wr, s_self, s_start, words);
    const int ci = cs.x, s = cs.y, c = c0 + ci;
    const SlotRecord<DIM, RelT> me =
        load_record<DIM, RelT>(recs, static_cast<size_t>(c) * cap + s);
    float ri[DIM];
    CT ri_c[DIM];
#pragma unroll
    for (int a = 0; a < DIM; ++a) {
      ri[a] = to_f32(me.r[a]);
      ri_c[a] = nnps_coord<CT>(me.r[a]);
    }
    const float f_i = __uint_as_float(me.payload());

    // Tile by tile in cells.neighbor_cell_offsets order, the same k for the
    // whole warp: decide the neighbor's occupied slots in the NNPS tier
    // (the self pair removed), then run the physics tier over the accepted
    // ones, j ascending, into the tile's sums.
    float num_acc[DIM], den_acc[DIM];
#pragma unroll
    for (int a = 0; a < DIM; ++a) num_acc[a] = den_acc[a] = 0.0f;
    for (int k = 0; k < M; ++k) {
      const int nc = s_nb[ci * M + k];
      const size_t nbase = static_cast<size_t>(nc) * cap;
      float off[DIM], t_num[DIM], t_den[DIM];
      CT off_c[DIM];
#pragma unroll
      for (int a = 0; a < DIM; ++a) {
        off[a] = cell_offset<DIM>(k, a);
        off_c[a] = A::from_f32(off[a]);
        t_num[a] = t_den[a] = 0.0f;
      }
      for (int wd = 0; wd < words; ++wd) {
        unsigned todo = words == 1 ? s_nbw[ci * M + k]
                                   : __ldg(occ_words + static_cast<size_t>(nc) * words + wd);
        if (nc == c && wd == (s >> 5)) todo &= ~(1u << (s & 31));
        unsigned accepted = 0;
        while (todo) {
          const int jl = __ffs(todo) - 1;
          todo &= todo - 1;
          const int j = wd * 32 + jl;
          const SlotRecord<DIM, RelT> rec = load_record<DIM, RelT>(recs, nbase + j);
          CT rj[DIM];
#pragma unroll
          for (int a = 0; a < DIM; ++a) rj[a] = nnps_coord<CT>(rec.r[a]);
          if (A::f32(tile_r2_cell<DIM>(ri_c, rj, 1, off_c, w)) <= r2_cell) accepted |= 1u << jl;
        }
        while (accepted) {
          const int j = wd * 32 + __ffs(accepted) - 1;
          accepted &= accepted - 1;
          const SlotRecord<DIM, RelT> rec = load_record<DIM, RelT>(recs, nbase + j);
          float rj[DIM], disp[DIM];
#pragma unroll
          for (int a = 0; a < DIM; ++a) rj[a] = to_f32(rec.r[a]);
          const float r2 = pair_disp<DIM>(ri, rj, off, hc, disp);
          const float coef = dw_over_r(sqrtf(r2), p.h, p.a_dw);
          const float df = p.f_sign * (__uint_as_float(rec.payload()) - f_i);
#pragma unroll
          for (int a = 0; a < DIM; ++a) {
            const float gw = coef * disp[a];
            t_num[a] += df * gw;
            t_den[a] += -disp[a] * gw;
          }
        }
      }
#pragma unroll
      for (int a = 0; a < DIM; ++a) {
        num_acc[a] += t_num[a];
        den_acc[a] += t_den[a];
      }
    }
#pragma unroll
    for (int a = 0; a < DIM; ++a) {
      const size_t e = (static_cast<size_t>(c) * DIM + a) * cap + s;
      num[e] = num_acc[a];
      den[e] = den_acc[a];
    }
  }

  // Every empty slot's sums are exact zeros.
  for (int e = threadIdx.x; e < n_cells * cap; e += kGradThreads) {
    const int ci = e / cap;
    const int s = e - ci * cap;
    if ((s_self[ci * words + (s >> 5)] >> (s & 31)) & 1u) continue;
    const size_t c = static_cast<size_t>(c0 + ci);
#pragma unroll
    for (int a = 0; a < DIM; ++a) {
      num[(c * DIM + a) * cap + s] = 0.0f;
      den[(c * DIM + a) * cap + s] = 0.0f;
    }
  }
}

struct GradientLaunch {
  const void *rel, *f, *occ, *nb_ids;
  void *num, *den, *words_buf, *recs_buf;
  int c_rows, cap, n_nb, skip_last, hole_as_end;
  GradParams p;
  cudaStream_t stream;

  template <int DIM, typename RelT, typename CT>
  int run() const {
    if (n_nb != (DIM == 2 ? 9 : 27)) return static_cast<int>(cudaErrorInvalidValue);
    const int words = (cap + 31) / 32;
    auto* wbuf = static_cast<unsigned*>(words_buf);
    const int err = repro_torch::launch_stage_slots<DIM, RelT, true>(
        static_cast<const RelT*>(rel), static_cast<const float*>(occ), f, wbuf, recs_buf,
        c_rows, cap, skip_last, hole_as_end, stream);
    if (err != 0) return err;
    const int blocks = (c_rows + kCellsPerBlock - 1) / kCellsPerBlock;
    gradient_kernel<DIM, RelT, CT><<<blocks, kGradThreads, 0, stream>>>(
        static_cast<const typename SlotRecord<DIM, RelT>::Raw*>(recs_buf),
        static_cast<const float*>(occ), wbuf, static_cast<const int*>(nb_ids),
        static_cast<float*>(num), static_cast<float*>(den), c_rows, cap, words, p);
    return static_cast<int>(cudaGetLastError());
  }
};

}  // namespace

// rel_kind: 0 = fp16, 1 = bf16, 2 = fp32 storage. compute_kind (the NNPS
// type): 0 = fp16, 1 = fp32. words_buf: (c_rows * ceil(cap / 32)) int32 and
// recs_buf: (c_rows * cap) x 16 bytes of scratch for the staging pass.
// n_nb must be 3^dim. fparams: w[0..2], r2_cell, hc[0..2], h, a_dw, f_sign.
// iparams (faults a check plants; 0 from the wrapper): skip_last_occupied,
// hole_as_end.
extern "C" int repro_rcll_gradient(int dim, int rel_kind, int compute_kind, const void* rel,
                                   const void* f, const void* occ, const void* nb_ids,
                                   void* num, void* den, void* words_buf, void* recs_buf,
                                   int c_rows, int cap, int n_nb, const float* fparams,
                                   const int* iparams, void* stream) {
  if (cap < 1 || cap > 1024 || c_rows < 1) return static_cast<int>(cudaErrorInvalidValue);
  GradParams p;
  for (int a = 0; a < 3; ++a) {
    p.w[a] = fparams[a];
    p.hc[a] = fparams[4 + a];
  }
  p.r2 = fparams[3];
  p.h = fparams[7];
  p.a_dw = fparams[8];
  p.f_sign = fparams[9];
  const GradientLaunch l{rel,      f,      occ,        nb_ids,     num, den,
                         words_buf, recs_buf, c_rows, cap, n_nb, iparams[0], iparams[1],
                         p,        static_cast<cudaStream_t>(stream)};
  return repro_torch::dispatch(dim, rel_kind, compute_kind, l);
}
