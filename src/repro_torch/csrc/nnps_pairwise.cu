// K4 and K5: cell-blocked RCLL neighbor search over the cell tables.
//
// Replace the Pallas kernels repro/kernels/nnps_pairwise.py::
// rcll_neighbor_list_tables (K4, _neighbor_list_kernel) and
// rcll_adjacency (K5, _adjacency_kernel). For a self cell c and each of
// its M = 3^d neighbor cells k (nb_ids, in cells.neighbor_cell_offsets
// order, the offset being the exact Eq. (7) anchor), a pair (i, j) of the
// cap x cap tile is a neighbor when both slots are occupied, it is not
// the self pair (same cell, same slot), and the
// Eq. (7) squared distance in reference-cell units, computed in the
// compute type with every operation rounded (tiling.cuh tile_r2_cell),
// is <= r_cell^2 in that type. The decisions equal the plain versions'
// (repro_torch/kernels/nnps_pairwise.py) bit for bit.
//
// K4 design: one block per self cell (C+1 blocks, the last the sentinel),
// one thread per self slot i (blockDim = cap rounded up to 32). The block
// stages each neighbor tile (coordinates in the compute type, occupancy,
// particle ids) in shared memory; thread i walks j in order and appends
// each hit's id at its running count while the count is below K, so the
// list is in (k, j) order, the order of the Pallas kernel and of
// nnps.rcll_neighbors, and the count is the true count. The Pallas
// kernel's one-hot scatter existed only because a TPU lane cannot scatter.
//
// K5 design: one block per self cell; for each k the block writes the
// whole cap x cap {0,1} tile, its threads striding over the flattened
// tile so that consecutive threads write consecutive floats (the tile is
// contiguous in adj), and counts hits per slot with integer shared-memory
// atomics (exact and order-free).
//
// Bound on the H100: bytes. K5 writes 4 M cap^2 bytes per cell (2.6 GB at
// N = 1,048,576 in 2-D) against ~10 operations per pair; K4 writes
// 4 cap K bytes per cell. Left on the table: K4's per-thread row writes
// are strided (a shared-memory staging of the cap x K tile would make
// them coalesced), empty and sentinel neighbor tiles are not skipped, and
// one cell per block leaves lanes idle at small cap.
#include <cuda_runtime.h>

#include "tiling.cuh"

namespace {

using repro_torch::cell_offset;
using repro_torch::NnpsArith;
using repro_torch::tile_r2_cell;
using repro_torch::to_compute;

struct NnpsParams {
  float w[3];        // anisotropy weights, rounded to the compute type on the host
  float r2;          // r_cell^2, rounded to the compute type on the host
  int keep_self;     // 0 from the wrapper: the self pair is no neighbor (a check plants 1)
};

template <int DIM, typename RelT, typename CT>
__global__ void neighbor_lists_kernel(const RelT* __restrict__ rel, const float* __restrict__ occ,
                                      const int* __restrict__ ids,
                                      const int* __restrict__ nb_ids, int* __restrict__ out,
                                      float* __restrict__ counts, int cap, int n_nb,
                                      int k_slots, NnpsParams p) {
  using A = NnpsArith<CT>;
  extern __shared__ int smem_i[];
  int* s_id = smem_i;                               // [cap] particle ids of the neighbor cell
  int* s_occ = s_id + cap;                          // [cap]
  CT* s_r = reinterpret_cast<CT*>(s_occ + cap);     // [DIM][cap] in the compute type

  const int c = blockIdx.x;
  const int i = threadIdx.x;
  const bool active = i < cap;
  CT w[DIM], ri[DIM];
#pragma unroll
  for (int a = 0; a < DIM; ++a) w[a] = A::from_f32(p.w[a]);
  const float r2 = A::f32(A::from_f32(p.r2));
  bool occ_i = false;
  if (active) {
    occ_i = occ[static_cast<size_t>(c) * cap + i] > 0.0f;
#pragma unroll
    for (int a = 0; a < DIM; ++a) {
      ri[a] = to_compute<CT>(rel[(static_cast<size_t>(c) * DIM + a) * cap + i]);
    }
  }
  int cnt = 0;
  int* row = out + (static_cast<size_t>(c) * cap + i) * k_slots;

  for (int k = 0; k < n_nb; ++k) {
    const int nc = nb_ids[static_cast<size_t>(c) * n_nb + k];
    __syncthreads();  // the previous tile is consumed
    for (int s = threadIdx.x; s < cap; s += blockDim.x) {
      const size_t e = static_cast<size_t>(nc) * cap + s;
      s_id[s] = ids[e];
      s_occ[s] = occ[e] > 0.0f;
#pragma unroll
      for (int a = 0; a < DIM; ++a) {
        s_r[a * cap + s] = to_compute<CT>(rel[(static_cast<size_t>(nc) * DIM + a) * cap + s]);
      }
    }
    __syncthreads();
    if (!active || !occ_i) continue;
    CT off[DIM];
#pragma unroll
    for (int a = 0; a < DIM; ++a) off[a] = A::from_f32(cell_offset<DIM>(k, a));
    const bool self_cell = nc == c;
    for (int j = 0; j < cap; ++j) {
      if (!s_occ[j] || (!p.keep_self && self_cell && j == i)) continue;
      if (A::f32(tile_r2_cell<DIM>(ri, s_r + j, cap, off, w)) <= r2) {
        if (cnt < k_slots) row[cnt] = s_id[j];
        ++cnt;
      }
    }
  }
  if (active) {
    for (int t = cnt < k_slots ? cnt : k_slots; t < k_slots; ++t) row[t] = -1;
    counts[static_cast<size_t>(c) * cap + i] = static_cast<float>(cnt);
  }
}

template <int DIM, typename RelT, typename CT>
__global__ void adjacency_kernel(const RelT* __restrict__ rel, const float* __restrict__ occ,
                                 const int* __restrict__ nb_ids, float* __restrict__ adj,
                                 float* __restrict__ counts, int cap, int n_nb, NnpsParams p) {
  using A = NnpsArith<CT>;
  extern __shared__ int smem_i[];
  int* s_cnt = smem_i;                                // [cap] hits per self slot
  int* s_occ_i = s_cnt + cap;                         // [cap]
  int* s_occ_j = s_occ_i + cap;                       // [cap]
  CT* s_ri = reinterpret_cast<CT*>(s_occ_j + cap);    // [DIM][cap] self cell
  CT* s_rj = s_ri + DIM * cap;                        // [DIM][cap] neighbor cell

  const int c = blockIdx.x;
  CT w[DIM];
#pragma unroll
  for (int a = 0; a < DIM; ++a) w[a] = A::from_f32(p.w[a]);
  const float r2 = A::f32(A::from_f32(p.r2));
  for (int s = threadIdx.x; s < cap; s += blockDim.x) {
    s_cnt[s] = 0;
    s_occ_i[s] = occ[static_cast<size_t>(c) * cap + s] > 0.0f;
#pragma unroll
    for (int a = 0; a < DIM; ++a) {
      s_ri[a * cap + s] = to_compute<CT>(rel[(static_cast<size_t>(c) * DIM + a) * cap + s]);
    }
  }
  const int tile = cap * cap;
  for (int k = 0; k < n_nb; ++k) {
    const int nc = nb_ids[static_cast<size_t>(c) * n_nb + k];
    __syncthreads();  // the previous tile is consumed (and the self cell staged)
    for (int s = threadIdx.x; s < cap; s += blockDim.x) {
      s_occ_j[s] = occ[static_cast<size_t>(nc) * cap + s] > 0.0f;
#pragma unroll
      for (int a = 0; a < DIM; ++a) {
        s_rj[a * cap + s] = to_compute<CT>(rel[(static_cast<size_t>(nc) * DIM + a) * cap + s]);
      }
    }
    __syncthreads();
    CT off[DIM];
#pragma unroll
    for (int a = 0; a < DIM; ++a) off[a] = A::from_f32(cell_offset<DIM>(k, a));
    const bool self_cell = nc == c;
    float* out = adj + (static_cast<size_t>(c) * n_nb + k) * tile;
    for (int e = threadIdx.x; e < tile; e += blockDim.x) {
      const int i = e / cap;
      const int j = e - i * cap;
      bool ok = s_occ_i[i] && s_occ_j[j] && (p.keep_self || !(self_cell && i == j));
      if (ok) {
        CT ri[DIM];
#pragma unroll
        for (int a = 0; a < DIM; ++a) ri[a] = s_ri[a * cap + i];
        ok = A::f32(tile_r2_cell<DIM>(ri, s_rj + j, cap, off, w)) <= r2;
      }
      out[e] = ok ? 1.0f : 0.0f;
      if (ok) atomicAdd(&s_cnt[i], 1);
    }
  }
  __syncthreads();
  for (int s = threadIdx.x; s < cap; s += blockDim.x) {
    counts[static_cast<size_t>(c) * cap + s] = static_cast<float>(s_cnt[s]);
  }
}

NnpsParams make_params(const float* fparams, const int* iparams) {
  NnpsParams p;
  for (int a = 0; a < 3; ++a) p.w[a] = fparams[a];
  p.r2 = fparams[3];
  p.keep_self = iparams[0];
  return p;
}

struct ListsLaunch {
  const void *rel, *occ, *ids, *nb_ids;
  void *out, *counts;
  int c_rows, cap, n_nb, k_slots;
  NnpsParams p;
  cudaStream_t stream;

  template <int DIM, typename RelT, typename CT>
  int run() const {
    const int threads = ((cap + 31) / 32) * 32;
    const size_t smem = (2 * sizeof(int) + DIM * sizeof(CT)) * static_cast<size_t>(cap);
    neighbor_lists_kernel<DIM, RelT, CT><<<c_rows, threads, smem, stream>>>(
        static_cast<const RelT*>(rel), static_cast<const float*>(occ),
        static_cast<const int*>(ids), static_cast<const int*>(nb_ids), static_cast<int*>(out),
        static_cast<float*>(counts), cap, n_nb, k_slots, p);
    return static_cast<int>(cudaGetLastError());
  }
};

struct AdjacencyLaunch {
  const void *rel, *occ, *nb_ids;
  void *adj, *counts;
  int c_rows, cap, n_nb;
  NnpsParams p;
  cudaStream_t stream;

  template <int DIM, typename RelT, typename CT>
  int run() const {
    const int tile = cap * cap;
    const int threads = tile >= 256 ? 256 : ((tile + 31) / 32) * 32;
    const size_t smem = (3 * sizeof(int) + 2 * DIM * sizeof(CT)) * static_cast<size_t>(cap);
    adjacency_kernel<DIM, RelT, CT><<<c_rows, threads, smem, stream>>>(
        static_cast<const RelT*>(rel), static_cast<const float*>(occ),
        static_cast<const int*>(nb_ids), static_cast<float*>(adj), static_cast<float*>(counts),
        cap, n_nb, p);
    return static_cast<int>(cudaGetLastError());
  }
};

}  // namespace

// rel_kind: 0 = fp16, 1 = bf16, 2 = fp32 storage. compute_kind: 0 = fp16,
// 1 = fp32. fparams: w[0..2], r2_cell. iparams: keep_self.
extern "C" int repro_rcll_neighbor_lists(int dim, int rel_kind, int compute_kind,
                                         const void* rel, const void* occ, const void* ids,
                                         const void* nb_ids, void* out, void* counts,
                                         int c_rows, int cap, int n_nb, int k_slots,
                                         const float* fparams, const int* iparams,
                                         void* stream) {
  if (cap < 1 || cap > 1024 || k_slots < 1) return static_cast<int>(cudaErrorInvalidValue);
  const ListsLaunch l{rel, occ, ids, nb_ids, out, counts, c_rows, cap, n_nb, k_slots,
                      make_params(fparams, iparams), static_cast<cudaStream_t>(stream)};
  return repro_torch::dispatch(dim, rel_kind, compute_kind, l);
}

extern "C" int repro_rcll_adjacency(int dim, int rel_kind, int compute_kind, const void* rel,
                                    const void* occ, const void* nb_ids, void* adj,
                                    void* counts, int c_rows, int cap, int n_nb,
                                    const float* fparams, const int* iparams, void* stream) {
  if (cap < 1 || cap > 1024) return static_cast<int>(cudaErrorInvalidValue);
  const AdjacencyLaunch l{rel, occ, nb_ids, adj, counts, c_rows, cap, n_nb,
                          make_params(fparams, iparams), static_cast<cudaStream_t>(stream)};
  return repro_torch::dispatch(dim, rel_kind, compute_kind, l);
}
