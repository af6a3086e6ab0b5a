// Cell-pair tile math shared by the RCLL CUDA kernels.
//
// Device counterpart of repro_torch/kernels/tiling.py and
// repro_torch/core/bspline.py:
//  - the physics tier (fp32, contraction allowed): the stale-binning
//    re-anchor rel' = rel + 2 * shift, the Eq. (7) decode
//    x_i - x_j = ((rel'_i - rel'_j) / 2 - off) * hc per axis, and the
//    B-spline dW/dr / r;
//  - the NNPS tier (tile_r2_cell): the Eq. (7) squared distance in
//    reference-cell units in the compute type (fp16 or fp32), every
//    operation explicitly rounded (__h*_rn / __f*_rn, never contracted
//    into an FMA) in the plain version's order, so the neighbor decisions
//    of the kernels and of their plain versions are identical bit for bit;
//  - the occupied-slot walk of K3 and K4: a staging pass (each row's
//    occupancy mask as bit words, one 32-bit word per 32 slots, and each
//    occupied slot's coordinates and payload packed for one load), a
//    block's work rows (its cells' occupied slots, scanned in shared
//    memory) and its cells' neighbor ids and words staged in shared memory;
//  - the host-side dispatch over (dim, storage type, compute type).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace repro_torch {

__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(float x) { return x; }

// Re-anchored relative coordinate of one slot on one axis.
template <typename RelT>
__device__ __forceinline__ float reanchor(RelT rel, int16_t shift) {
  return to_f32(rel) + 2.0f * static_cast<float>(shift);
}

// Neighborhood offset of the k-th neighbor cell on axis a, in the order of
// cells.neighbor_cell_offsets (meshgrid over {-1,0,1}^DIM, 'ij').
template <int DIM>
__device__ __forceinline__ float cell_offset(int k, int a) {
  int div = 1;
  for (int b = DIM - 1; b > a; --b) div *= 3;
  return static_cast<float>((k / div) % 3 - 1);
}

// Physical displacement x_i - x_j per axis and r^2 for one pair.
template <int DIM>
__device__ __forceinline__ float pair_disp(const float (&ri)[DIM], const float* rj,
                                           const float (&off)[DIM],
                                           const float (&hc)[DIM], float (&disp)[DIM]) {
  float r2 = 0.0f;
#pragma unroll
  for (int a = 0; a < DIM; ++a) {
    const float du = (ri[a] - rj[a]) * 0.5f - off[a];
    const float dx = du * hc[a];
    disp[a] = dx;
    r2 = (a == 0) ? dx * dx : r2 + dx * dx;
  }
  return r2;
}

// bspline.dw_over_r: (dW/dr) / r with the r -> 0 guard; a_dw = alpha_d / h.
__device__ __forceinline__ float dw_over_r(float r, float h, float a_dw) {
  const float R = r / h;
  const float d1 = -2.0f * R + 1.5f * R * R;
  const float t = 2.0f - R;
  const float d2 = -0.5f * (t * t);
  const float dwdr = a_dw * (R < 1.0f ? d1 : (R < 2.0f ? d2 : 0.0f));
  return dwdr / (r > 1e-12f ? r : 1.0f);
}

// Arithmetic of the NNPS tier, rounded after every operation.
template <typename CT>
struct NnpsArith;

template <>
struct NnpsArith<float> {
  static __device__ __forceinline__ float from_f32(float x) { return x; }
  static __device__ __forceinline__ float f32(float x) { return x; }
  static __device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
  static __device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
};

template <>
struct NnpsArith<__half> {
  static __device__ __forceinline__ __half from_f32(float x) { return __float2half_rn(x); }
  static __device__ __forceinline__ float f32(__half x) { return __half2float(x); }
  static __device__ __forceinline__ __half sub(__half a, __half b) { return __hsub_rn(a, b); }
  static __device__ __forceinline__ __half mul(__half a, __half b) { return __hmul_rn(a, b); }
  static __device__ __forceinline__ __half add(__half a, __half b) { return __hadd_rn(a, b); }
};

// A stored coordinate in the compute type (one rounding from storage, as
// torch's .to(dtype) does; widening to fp32 is exact).
template <typename CT, typename RelT>
__device__ __forceinline__ CT to_compute(RelT x) {
  return NnpsArith<CT>::from_f32(to_f32(x));
}

// tiling.tile_r2_cell for one pair: du = (r_i - r_j) * 0.5,
// du = (du - off) * w, d2 += du * du, axis by axis; rj[a * stride].
template <int DIM, typename CT>
__device__ __forceinline__ CT tile_r2_cell(const CT (&ri)[DIM], const CT* rj, int stride,
                                           const CT (&off)[DIM], const CT (&w)[DIM]) {
  using A = NnpsArith<CT>;
  const CT half = A::from_f32(0.5f);
  CT d2 = A::from_f32(0.0f);
#pragma unroll
  for (int a = 0; a < DIM; ++a) {
    CT du = A::mul(A::sub(ri[a], rj[a * stride]), half);
    du = A::mul(A::sub(du, off[a]), w[a]);
    d2 = A::add(d2, A::mul(du, du));
  }
  return d2;
}

constexpr unsigned kFullMask = 0xffffffffu;

// A slot's inputs to the walk packed for one load: its coordinates in the
// storage type and a 32-bit payload (K4: its particle id; K3: its f), in 8
// or 16 bytes.
template <int DIM, typename RelT>
struct SlotRecord {
  static constexpr int kBytes = DIM * static_cast<int>(sizeof(RelT)) + 4 <= 8 ? 8 : 16;
  using Raw = std::conditional_t<kBytes == 8, uint2, uint4>;
  union {
    Raw raw;
    RelT r[DIM];
    unsigned w[kBytes / 4];
  };
  __device__ __forceinline__ unsigned payload() const { return w[kBytes / 4 - 1]; }
};

template <int DIM, typename RelT>
__device__ __forceinline__ SlotRecord<DIM, RelT> load_record(
    const typename SlotRecord<DIM, RelT>::Raw* __restrict__ recs, size_t slot) {
  SlotRecord<DIM, RelT> rec;
  rec.raw = __ldg(recs + slot);
  return rec;
}

// Rows a warp of the staging pass: 8 without records (their loads in
// flight together), 1 with them (8 rows of records took 79 registers a
// thread and ran slower).
template <bool RECORDS>
constexpr int kStageRows = RECORDS ? 1 : 8;

// The staging pass of K3 and K4, a warp a kStageRows<RECORDS> rows:
// words[c * ceil(cap / 32) + q] bit s is slot 32 q + s of row c occupied
// (occ > 0; the mask may have holes anywhere), and with RECORDS each
// occupied slot's record (coordinates and payload) goes to recs[c * cap +
// slot]. skip_last and hole_as_end (0 from the wrappers) plant faults in
// the words that the walk reads: each row's last occupied slot cleared, or
// every slot from its first empty one on.

template <int DIM, typename RelT, bool RECORDS>
static __global__ void __launch_bounds__(256)
    stage_slots_kernel(const RelT* __restrict__ rel, const float* __restrict__ occ,
                       const unsigned* __restrict__ payload, unsigned* __restrict__ words_out,
                       typename SlotRecord<DIM, RelT>::Raw* __restrict__ recs, int c_rows,
                       int cap, int words, int skip_last, int hole_as_end) {
  constexpr int kRows = kStageRows<RECORDS>;
  const long long c0 = (static_cast<long long>(blockIdx.x) * 256 + threadIdx.x) / 32 * kRows;
  const int lane = threadIdx.x & 31;
  if (c0 >= c_rows) return;  // uniform over the warp
  unsigned mine[kRows] = {};  // lane q keeps word q of each row
  for (int q = 0; q < words; ++q) {
    const int s = q * 32 + lane;
    bool o[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const long long c = c0 + r;
      o[r] = c < c_rows && s < cap && occ[c * cap + s] > 0.0f;
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const unsigned b = __ballot_sync(kFullMask, o[r]);
      if (lane == q) mine[r] = b;
    }
    if constexpr (RECORDS) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (!o[r]) continue;
        const long long c = c0 + r;
        SlotRecord<DIM, RelT> rec;
        rec.raw = {};
#pragma unroll
        for (int a = 0; a < DIM; ++a) rec.r[a] = rel[(c * DIM + a) * cap + s];
        rec.w[SlotRecord<DIM, RelT>::kBytes / 4 - 1] = payload[c * cap + s];
        recs[c * cap + s] = rec.raw;
      }
    }
  }
  const int valid = cap - lane * 32;  // slots of word `lane` inside a row
  const unsigned all = valid >= 32 ? kFullMask : (valid > 0 ? (1u << valid) - 1u : 0u);
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (hole_as_end) {
      const unsigned holed = __ballot_sync(kFullMask, lane < words && mine[r] != all);
      if (holed) {
        const int first = __ffs(holed) - 1;
        if (lane == first) mine[r] &= ~(mine[r] + 1u);  // the run of ones from bit 0
        if (lane > first) mine[r] = 0;
      }
    }
    if (skip_last) {
      const unsigned nonzero = __ballot_sync(kFullMask, mine[r] != 0);
      if (nonzero && lane == 31 - __clz(nonzero)) mine[r] &= ~(0x80000000u >> __clz(mine[r]));
    }
    if (lane < words && c0 + r < c_rows) words_out[(c0 + r) * words + lane] = mine[r];
  }
}

// Launch the staging pass on the stream; with RECORDS, recs_buf holds 16
// bytes a slot (else it is not read). Returns cudaGetLastError().
template <int DIM, typename RelT, bool RECORDS>
static inline int launch_stage_slots(const RelT* rel, const float* occ, const void* payload,
                                     unsigned* words, void* recs_buf, int c_rows, int cap,
                                     int skip_last, int hole_as_end, cudaStream_t stream) {
  constexpr int kRowsPerBlock = 256 / 32 * kStageRows<RECORDS>;
  const int blocks = (c_rows + kRowsPerBlock - 1) / kRowsPerBlock;
  stage_slots_kernel<DIM, RelT, RECORDS><<<blocks, 256, 0, stream>>>(
      rel, occ, static_cast<const unsigned*>(payload), words,
      static_cast<typename SlotRecord<DIM, RelT>::Raw*>(recs_buf), c_rows, cap,
      (cap + 31) / 32, skip_last, hole_as_end);
  return static_cast<int>(cudaGetLastError());
}

// A block's work rows: the occupied slots of its n_cells (<= 32)
// consecutive cells from c0, found by ballots over occ. On return (after a
// __syncthreads) s_self[ci * words + q] holds cell ci's occupancy words and
// s_start[0 .. 32] the exclusive scan of their popcounts (cells past
// n_cells count 0). Every thread of the block calls it.
__device__ __forceinline__ void block_work_rows(const float* __restrict__ occ, int c0,
                                                int n_cells, int cap, int words,
                                                unsigned* s_self, int* s_count, int* s_start) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int ci = warp; ci < 32; ci += blockDim.x >> 5) {
    int n = 0;
    for (int q = 0; q < words; ++q) {
      const int s = q * 32 + lane;
      const unsigned b = __ballot_sync(
          kFullMask,
          ci < n_cells && s < cap && occ[static_cast<size_t>(c0 + ci) * cap + s] > 0.0f);
      if (lane == 0 && ci < n_cells) s_self[ci * words + q] = b;
      n += __popc(b);
    }
    if (lane == 0) s_count[ci] = n;
  }
  __syncthreads();
  if (warp == 0) {
    const int n = s_count[lane];
    int incl = n;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFullMask, incl, d);
      if (lane >= d) incl += y;
    }
    s_start[lane] = incl - n;
    if (lane == 31) s_start[32] = incl;
  }
  __syncthreads();
}

// The cell (x) and slot (y) of work row wr < s_start[32]: the last cell
// whose start is <= wr (it has a work row, since the next start is > wr),
// and its rank-th occupied slot.
__device__ __forceinline__ int2 work_row(int wr, const unsigned* s_self, const int* s_start,
                                         int words) {
  int lo = 0, hi = 31;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (s_start[mid] <= wr) lo = mid; else hi = mid - 1;
  }
  int rank = wr - s_start[lo];
  int q = 0;
  unsigned word = s_self[lo * words];
  while (rank >= __popc(word)) {
    rank -= __popc(word);
    word = s_self[lo * words + ++q];
  }
  for (; rank > 0; --rank) word &= word - 1;
  return make_int2(lo, q * 32 + __ffs(word) - 1);
}

// Stage the block's cells' neighbor ids (s_nb[ci * M + k]) and, at one word
// a row, the neighbors' occupancy words (s_nbw, same index); ends with a
// __syncthreads.
template <int M>
__device__ __forceinline__ void stage_neighborhood(const int* __restrict__ nb_ids,
                                                   const unsigned* __restrict__ occ_words,
                                                   int c0, int n_cells, int words, int* s_nb,
                                                   unsigned* s_nbw) {
  for (int e = threadIdx.x; e < n_cells * M; e += blockDim.x) {
    const int nc = __ldg(nb_ids + static_cast<size_t>(c0) * M + e);
    s_nb[e] = nc;
    if (words == 1) s_nbw[e] = __ldg(occ_words + nc);
  }
  __syncthreads();
}

// Host-side dispatch: f.template run<DIM, RelT, CT>() for dim in {2, 3},
// rel_kind 0/1/2 = fp16/bf16/fp32 storage, compute_kind 0/1 = fp16/fp32.
template <int DIM, typename RelT, typename F>
int dispatch_compute(int compute_kind, const F& f) {
  if (compute_kind == 0) return f.template run<DIM, RelT, __half>();
  if (compute_kind == 1) return f.template run<DIM, RelT, float>();
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int DIM, typename F>
int dispatch_rel(int rel_kind, int compute_kind, const F& f) {
  switch (rel_kind) {
    case 0: return dispatch_compute<DIM, __half>(compute_kind, f);
    case 1: return dispatch_compute<DIM, __nv_bfloat16>(compute_kind, f);
    case 2: return dispatch_compute<DIM, float>(compute_kind, f);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename F>
int dispatch(int dim, int rel_kind, int compute_kind, const F& f) {
  if (dim == 2) return dispatch_rel<2>(rel_kind, compute_kind, f);
  if (dim == 3) return dispatch_rel<3>(rel_kind, compute_kind, f);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace repro_torch
