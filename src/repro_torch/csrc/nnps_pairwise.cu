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
// K5 design: the output is one flat array of (C+1)*M*cap^2 floats, ~92 % of
// them zeros at the main path, so the kernel streams it with 16-byte
// streaming stores (st.global.cs: the 2.6 GB do not evict rel and occ from
// L2) and decides only pairs of occupied slots. A warp owns a self cell and
// a group of 32 self slots (lane = slot); per neighbor tile it loads the
// neighbor cell's 32-slot chunks (lane = slot), ballots their occupancy and
// walks only the occupied j, each lane deciding its own row i, the neighbor
// coordinates broadcast by shuffles. Each row's hits are a bit mask in
// shared memory (one 32-bit word per 32 columns); a count is the popcount of
// its row's masks, exact with no atomics. Each lane then writes 16-byte
// chunks of the region from the masks: at cap <= 32 (one group) after all M
// tiles, the cell's whole contiguous M*cap^2 region at once; at larger caps
// the group's rows of each tile. Chunks are aligned to 16 bytes; the
// elements before the first and after the last chunk of a region are stored
// one by one. The neighbor ids are loaded once per warp and each tile's
// inputs one tile ahead; no __syncthreads anywhere.
//
// Bound on the H100: bytes. K5 writes 4 M cap^2 bytes per cell (2.6 GB at
// N = 1,048,576 in 2-D) against ~10 operations per occupied pair; K4 writes
// 4 cap K bytes per cell. Left on the table in K4: its per-thread row
// writes are strided (a shared-memory staging of the cap x K tile would
// make them coalesced), empty and sentinel neighbor tiles are not skipped,
// and one cell per block leaves lanes idle at small cap.
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

constexpr unsigned kFull = 0xffffffffu;
constexpr int kAdjWarps = 8;  // warps of a K5 block (ADJ_WARPS in kernels/nnps_pairwise.py)

// Write elements [0, len) of the region of adj that starts at element e0:
// element o is row o / cap, column o % cap, and row r's bits are
// s_mask[r * words ..]. adj is 16-byte aligned (the wrapper's torch.empty).
__device__ __forceinline__ void stream_rows(float* __restrict__ adj, size_t e0, int len, int cap,
                                            int words, const unsigned* s_mask, int lane) {
  auto bit = [&](int r, int j) {
    return (s_mask[r * words + (j >> 5)] >> (j & 31)) & 1u ? 1.0f : 0.0f;
  };
  int head = static_cast<int>((4 - (e0 & 3)) & 3);
  if (head > len) head = len;
  const int chunks = (len - head) >> 2;
  const int tail0 = head + 4 * chunks;
  if (lane < head + (len - tail0)) {  // at most 6 single elements
    const int o = lane < head ? lane : tail0 + (lane - head);
    const int r = o / cap;
    __stcs(adj + e0 + o, bit(r, o - r * cap));
  }
  // a lane's chunks are 128 elements apart: (r, j) advance by (dr, dj)
  const int dr = 128 / cap;
  const int dj = 128 - dr * cap;
  int o = head + 4 * lane;
  int r = o / cap;
  int j = o - r * cap;
  for (int q = lane; q < chunks; q += 32) {
    float4 v;
    if (j + 4 <= cap && (j & 31) <= 28) {  // four bits of one word
      const unsigned m = s_mask[r * words + (j >> 5)] >> (j & 31);
      v = make_float4(m & 1u ? 1.0f : 0.0f, m & 2u ? 1.0f : 0.0f, m & 4u ? 1.0f : 0.0f,
                      m & 8u ? 1.0f : 0.0f);
    } else {  // the chunk crosses a word, a row or a tile
      float t[4];
      int rr = r, jj = j;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        t[u] = bit(rr, jj);
        if (++jj == cap) {
          jj = 0;
          ++rr;
        }
      }
      v = make_float4(t[0], t[1], t[2], t[3]);
    }
    __stcs(reinterpret_cast<float4*>(adj + e0 + o), v);
    o += 128;
    j += dj;
    r += dr;
    if (j >= cap) {
      j -= cap;
      ++r;
    }
  }
}

// One neighbor chunk as a lane holds it: slot j = 32 * chunk + lane.
template <int DIM, typename CT>
struct NbSlot {
  bool occ;
  CT r[DIM];
};

template <int DIM, typename RelT, typename CT>
__device__ __forceinline__ NbSlot<DIM, CT> load_slot(const RelT* __restrict__ rel,
                                                     const float* __restrict__ occ, int nc, int j,
                                                     int cap) {
  NbSlot<DIM, CT> s;
  s.occ = false;
#pragma unroll
  for (int a = 0; a < DIM; ++a) s.r[a] = NnpsArith<CT>::from_f32(0.0f);
  if (j < cap) {
    s.occ = occ[static_cast<size_t>(nc) * cap + j] > 0.0f;
#pragma unroll
    for (int a = 0; a < DIM; ++a) {
      s.r[a] = to_compute<CT>(rel[(static_cast<size_t>(nc) * DIM + a) * cap + j]);
    }
  }
  return s;
}

// SMALL: cap <= 32, one group of slots a cell, one mask word a row.
template <int DIM, typename RelT, typename CT, bool SMALL>
__global__ void __launch_bounds__(kAdjWarps * 32)
adjacency_kernel(const RelT* __restrict__ rel, const float* __restrict__ occ,
                 const int* __restrict__ nb_ids, float* __restrict__ adj,
                 float* __restrict__ counts, int c_rows, int cap, int groups, NnpsParams p) {
  constexpr int M = DIM == 2 ? 9 : 27;
  using A = NnpsArith<CT>;
  extern __shared__ unsigned s_bits[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int words = SMALL ? 1 : (cap + 31) >> 5;
  unsigned* s_mask = s_bits + warp * (SMALL ? M * cap : 32 * words);
  const int item = blockIdx.x * kAdjWarps + warp;
  if (item >= c_rows * groups) return;  // whole warps only; no block barrier follows
  const int c = item / groups;
  const int i0 = (item - c * groups) * 32;
  const int i = i0 + lane;
  const bool row_ok = i < cap;

  CT w[DIM];
#pragma unroll
  for (int a = 0; a < DIM; ++a) w[a] = A::from_f32(p.w[a]);
  const float r2 = A::f32(A::from_f32(p.r2));
  const NbSlot<DIM, CT> self = load_slot<DIM, RelT, CT>(rel, occ, c, i, cap);
  const bool any_i = __any_sync(kFull, self.occ);
  const int nb_lane = lane < M ? nb_ids[static_cast<size_t>(c) * M + lane] : 0;

  int cnt = 0;
  const int steps = M * words;  // (tile k, neighbor chunk) pairs, chunk fastest
  NbSlot<DIM, CT> next{};
  if (any_i) next = load_slot<DIM, RelT, CT>(rel, occ, __shfl_sync(kFull, nb_lane, 0), lane, cap);
  for (int t = 0; t < steps; ++t) {
    const int k = SMALL ? t : t / words;
    const int wd = SMALL ? 0 : t - k * words;
    const int nc = __shfl_sync(kFull, nb_lane, k % 32);
    const NbSlot<DIM, CT> cur = next;
    if (any_i && t + 1 < steps) {  // the next chunk's inputs, one step ahead
      const int k1 = SMALL ? t + 1 : (t + 1) / words;
      const int nc1 = __shfl_sync(kFull, nb_lane, k1 % 32);
      next = load_slot<DIM, RelT, CT>(rel, occ, nc1, (t + 1 - k1 * words) * 32 + lane, cap);
    }
    unsigned hits = 0;
    if (any_i) {
      CT off[DIM];
#pragma unroll
      for (int a = 0; a < DIM; ++a) off[a] = A::from_f32(cell_offset<DIM>(k, a));
      const bool self_cell = nc == c;
      unsigned todo = __ballot_sync(kFull, cur.occ);
      while (todo) {  // the occupied neighbor slots, the same for the whole warp
        const int jl = __ffs(todo) - 1;
        todo &= todo - 1;
        CT rj[DIM];
#pragma unroll
        for (int a = 0; a < DIM; ++a) rj[a] = A::from_f32(__shfl_sync(kFull, A::f32(cur.r[a]), jl));
        const int j = wd * 32 + jl;
        if (self.occ && (p.keep_self || !(self_cell && j == i)) &&
            A::f32(tile_r2_cell<DIM>(self.r, rj, 1, off, w)) <= r2) {
          hits |= 1u << jl;
        }
      }
    }
    cnt += __popc(hits);
    if (row_ok) s_mask[SMALL ? k * cap + lane : lane * words + wd] = hits;
    if (!SMALL && wd == words - 1) {  // this tile's rows of the group are decided
      __syncwarp();
      const int rows = min(32, cap - i0);
      stream_rows(adj, ((static_cast<size_t>(c) * M + k) * cap + i0) * cap, rows * cap, cap,
                  words, s_mask, lane);
      __syncwarp();
    }
  }
  if (SMALL) {
    __syncwarp();
    stream_rows(adj, static_cast<size_t>(c) * M * cap * cap, M * cap * cap, cap, 1, s_mask, lane);
  }
  if (row_ok) counts[static_cast<size_t>(c) * cap + i] = static_cast<float>(cnt);
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
  int c_rows, cap, n_nb, groups;
  NnpsParams p;
  cudaStream_t stream;

  template <int DIM, typename RelT, typename CT>
  int run() const {
    constexpr int M = DIM == 2 ? 9 : 27;
    if (n_nb != M || groups != (cap + 31) / 32) return static_cast<int>(cudaErrorInvalidValue);
    const bool small = cap <= 32;
    const int words = (cap + 31) / 32;
    const size_t smem = sizeof(unsigned) * kAdjWarps * (small ? M * cap : 32 * words);
    const long long items = static_cast<long long>(c_rows) * groups;
    const int blocks = static_cast<int>((items + kAdjWarps - 1) / kAdjWarps);
    const auto* r = static_cast<const RelT*>(rel);
    const auto* o = static_cast<const float*>(occ);
    const auto* nb = static_cast<const int*>(nb_ids);
    auto* a = static_cast<float*>(adj);
    auto* cn = static_cast<float*>(counts);
    if (small) {
      adjacency_kernel<DIM, RelT, CT, true><<<blocks, kAdjWarps * 32, smem, stream>>>(
          r, o, nb, a, cn, c_rows, cap, groups, p);
    } else {
      adjacency_kernel<DIM, RelT, CT, false><<<blocks, kAdjWarps * 32, smem, stream>>>(
          r, o, nb, a, cn, c_rows, cap, groups, p);
    }
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

// groups: ceil(cap / 32) warps a self cell (kernels/nnps_pairwise.py::adjacency_geometry).
extern "C" int repro_rcll_adjacency(int dim, int rel_kind, int compute_kind, const void* rel,
                                    const void* occ, const void* nb_ids, void* adj,
                                    void* counts, int c_rows, int cap, int n_nb, int groups,
                                    const float* fparams, const int* iparams, void* stream) {
  if (cap < 1 || cap > 1024 || (reinterpret_cast<uintptr_t>(adj) & 15) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const AdjacencyLaunch l{rel, occ, nb_ids, adj, counts, c_rows, cap, n_nb, groups,
                          make_params(fparams, iparams), static_cast<cudaStream_t>(stream)};
  return repro_torch::dispatch(dim, rel_kind, compute_kind, l);
}
