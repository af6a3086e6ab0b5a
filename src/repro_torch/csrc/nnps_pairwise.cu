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
// K4 design: the output is (C+1) x cap rows of K ids, ~89 % of them -1
// padding at the main path (4 cap K bytes a cell against ~2 hits a slot a
// tile), so, as K5, it is written with 16-byte streaming stores and
// decides only pairs of occupied slots. A first pass turns each row's
// occupancy mask (holes anywhere) into bit words (tiling.cuh
// launch_stage_slots). A block of 128 threads owns 16 consecutive cells:
// their occupied slots are its work rows (ballots and a scan in shared
// memory, one a thread), and their neighbor ids and words are staged in
// shared memory. The block first writes the rows of its empty slots, all
// -1, so their stores drain while it walks. Each thread then walks the
// tiles k in order, the same k for the whole warp, and within a tile the
// neighbor's occupied slots j ascending, loading their coordinates through
// the read-only path; each hit is appended to the thread's row of a
// shared-memory stage at its running count while that is below K, as
// (k << 10) | j in 16 bits, and the count runs on past K, so it is the
// true count. Hits land in (k, j) order, the order of the Pallas kernel
// and of nnps.rcll_neighbors. The block then writes its staged rows,
// gathering each hit's id (ids of the neighbor cell s_nb[k], slot j) and
// padding with -1. A batch of 128 work rows at a time keeps the stage
// bounded; a K whose stage does not fit (kernels/nnps_pairwise.py
// list_stride) takes the unstaged path: each thread writes its own row.
// The Pallas kernel's one-hot scatter existed only because a TPU lane
// cannot scatter.
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
// N = 1,048,576 in 2-D) against ~10 operations per occupied pair; K4
// writes 4 cap K bytes per cell (0.70 GB at K = 48). K4's walk, not its
// stores, sets most of its time: it waits on its loads, so what helped
// was warps (a 16-bit stage: 18 KB a block and 40 registers a thread, 12
// blocks an SM). Designs that read slower at the main path: a warp a self
// cell walking its neighbors in step (K5's walk; ~6 useful lanes of 32),
// four neighbor slots loaded before deciding them, packed slot records,
// and each thread storing its own row from registers.
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
  int pad;           // K4's padding id: -1 from the wrapper (a check plants 0)
  int count_at_k;    // 0: K4's counts are the true counts (a check plants 1: saturated at K)
};

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

constexpr int kListCells = 16;     // cells of a K4 block (LIST_CELLS in kernels/nnps_pairwise.py)
constexpr int kListThreads = 128;  // a block's work rows a batch, one a thread (LIST_THREADS)
constexpr long long kListStageBytes = 24 * 1024;  // its stage at most (LIST_STAGE_BYTES)

// Whether row slot s of the block's cell ci is empty (so all padding).
__device__ __forceinline__ bool empty_row(const unsigned* s_self, int ci, int s, int words) {
  return !((s_self[ci * words + (s >> 5)] >> (s & 31)) & 1u);
}

// The rows of the block's empty slots, all padding, before its walk (their
// stores drain while it runs): elements [0, len) of its region of out from
// e0, row gr = o / k (cell gr / cap, slot gr % cap). e0 is a multiple of 4
// (16 cells of cap * k ids) and out is 16-byte aligned, so a thread's
// chunks of 4 ids are 16-byte streaming stores; a chunk that also holds an
// occupied row's ids, and the elements past the last whole chunk, are
// stored one by one.
__device__ __forceinline__ void write_empty_rows(int* __restrict__ out, size_t e0, int len,
                                                 int k, int cap, int words,
                                                 const unsigned* s_self, int pad) {
  const int chunks = len >> 2;
  int o = 4 * threadIdx.x;
  int gr = o / k, t = o - gr * k;
  int ci = gr / cap, s = gr - ci * cap;
  // a thread's chunks are 4 * kListThreads elements apart: rows advance by dr
  const int dr = 4 * kListThreads / k;
  const int dt = 4 * kListThreads - dr * k;
  for (int q = threadIdx.x; q < chunks; q += kListThreads) {
    if ((k & 3) == 0) {  // t % 4 = 0: four ids of one row
      if (empty_row(s_self, ci, s, words)) {
        __stcs(reinterpret_cast<int4*>(out + e0 + o), make_int4(pad, pad, pad, pad));
      }
    } else {  // the chunk may cross rows
      bool e[4];
      int cc = ci, ss = s, tt = t;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        e[u] = empty_row(s_self, cc, ss, words);
        if (++tt == k) {
          tt = 0;
          if (++ss == cap) {
            ss = 0;
            ++cc;
          }
        }
      }
      if (e[0] && e[1] && e[2] && e[3]) {
        __stcs(reinterpret_cast<int4*>(out + e0 + o), make_int4(pad, pad, pad, pad));
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (e[u]) __stcs(out + e0 + o + u, pad);
        }
      }
    }
    o += 4 * kListThreads;
    t += dt;
    int adv = dr;
    if (t >= k) {
      t -= k;
      ++adv;
    }
    for (s += adv; s >= cap; s -= cap) ++ci;
  }
  const int o_tail = 4 * chunks + threadIdx.x;  // at most 3 single elements
  if (o_tail < len) {
    const int g = o_tail / k;
    if (empty_row(s_self, g / cap, g % cap, words)) __stcs(out + e0 + o_tail, pad);
  }
}

// A batch's n staged rows: stage row r holds s_n[r] hits as (k << 10) | j,
// neighbor tile k (s_nb[s_nbase[r] + k] its cell) and slot j, and is row
// s_row[r] of out: each hit's id is gathered from ids, the rest is padding.
// V = 4 when k_slots % 4 = 0 (rows 16-byte aligned: 4 ids a 16-byte store),
// else 1; a warp's stores cover a few rows' contiguous bytes.
template <int V>
__device__ __forceinline__ void write_staged_rows(int* __restrict__ out,
                                                  const int* __restrict__ ids, int n,
                                                  int k_slots, int cap, int stride,
                                                  const unsigned short* s_stage, const int* s_n,
                                                  const int* s_row, const int* s_nbase,
                                                  const int* s_nb, int pad) {
  const int per_row = k_slots / V;
  int r = threadIdx.x / per_row;
  int t = (threadIdx.x - r * per_row) * V;
  // a thread's stores are kListThreads apart: rows advance by dr
  const int dr = kListThreads / per_row;
  const int dt = (kListThreads - dr * per_row) * V;
  while (r < n) {
    int* dst = out + static_cast<size_t>(s_row[r]) * k_slots + t;
    const int m = s_n[r];
    const unsigned short* hit = s_stage + r * stride + t;
    const int* nb = s_nb + s_nbase[r];
    auto id = [&](int u) {
      if (t + u >= m) return pad;
      const unsigned x = hit[u];
      return __ldg(ids + static_cast<size_t>(nb[x >> 10]) * cap + (x & 1023u));
    };
    if constexpr (V == 4) {
      __stcs(reinterpret_cast<int4*>(dst), make_int4(id(0), id(1), id(2), id(3)));
    } else {
      __stcs(dst, id(0));
    }
    t += dt;
    r += dr;
    if (t >= k_slots) {
      t -= k_slots;
      ++r;
    }
  }
}

// The block writes the rows of its empty slots first. STAGED: each work
// row's hits go through its thread's row of the shared-memory stage (stride
// 16-bit entries a row), which the block writes out after each batch;
// otherwise each thread writes its own row.
template <int DIM, typename RelT, typename CT, bool STAGED>
__global__ void __launch_bounds__(kListThreads)
    neighbor_lists_kernel(const RelT* __restrict__ rel, const float* __restrict__ occ,
                          const int* __restrict__ ids, const unsigned* __restrict__ occ_words,
                          const int* __restrict__ nb_ids, int* __restrict__ out,
                          float* __restrict__ counts, int c_rows, int cap, int words,
                          int k_slots, int stride, NnpsParams p) {
  constexpr int M = DIM == 2 ? 9 : 27;
  using A = NnpsArith<CT>;
  extern __shared__ __align__(16) unsigned short s_stage[];  // [kListThreads][stride]
  __shared__ unsigned s_self[kListCells * 32];
  __shared__ int s_count[32];
  __shared__ int s_start[33];
  __shared__ int s_nb[kListCells * M];
  __shared__ unsigned s_nbw[kListCells * M];
  __shared__ int s_n[kListThreads];      // hits kept in each stage row,
  __shared__ int s_row[kListThreads];    // its row of out,
  __shared__ int s_nbase[kListThreads];  // and its cell's neighbor ids in s_nb

  const int c0 = blockIdx.x * kListCells;
  const int n_cells = min(kListCells, c_rows - c0);
  repro_torch::block_work_rows(occ, c0, n_cells, cap, words, s_self, s_count, s_start);
  repro_torch::stage_neighborhood<M>(nb_ids, occ_words, c0, n_cells, words, s_nb, s_nbw);

  CT w[DIM];
#pragma unroll
  for (int a = 0; a < DIM; ++a) w[a] = A::from_f32(p.w[a]);
  const float r2 = A::f32(A::from_f32(p.r2));
  const int total = s_start[32];
  write_empty_rows(out, static_cast<size_t>(c0) * cap * k_slots, n_cells * cap * k_slots,
                   k_slots, cap, words, s_self, p.pad);
  for (int base = 0; base < total; base += kListThreads) {
    const int wr = base + static_cast<int>(threadIdx.x);
    if (wr < total) {
      const int2 cs = repro_torch::work_row(wr, s_self, s_start, words);
      const int ci = cs.x, s = cs.y, c = c0 + ci;
      CT ri[DIM];
#pragma unroll
      for (int a = 0; a < DIM; ++a) {
        ri[a] = to_compute<CT>(rel[(static_cast<size_t>(c) * DIM + a) * cap + s]);
      }
      unsigned short* srow = s_stage + threadIdx.x * stride;
      int* row = out + (static_cast<size_t>(c) * cap + s) * k_slots;
      int cnt = 0;
      // Tile by tile in cells.neighbor_cell_offsets order, the same k for
      // the whole warp; within a tile the neighbor's occupied slots j
      // ascending: (k, j) order.
      for (int k = 0; k < M; ++k) {
        const int nc = s_nb[ci * M + k];
        const RelT* rj_base = rel + static_cast<size_t>(nc) * DIM * cap;
        const int* id_base = ids + static_cast<size_t>(nc) * cap;
        CT off[DIM];
#pragma unroll
        for (int a = 0; a < DIM; ++a) off[a] = A::from_f32(cell_offset<DIM>(k, a));
        for (int wd = 0; wd < words; ++wd) {
          unsigned todo = words == 1 ? s_nbw[ci * M + k]
                                     : __ldg(occ_words + static_cast<size_t>(nc) * words + wd);
          if (!p.keep_self && nc == c && wd == (s >> 5)) todo &= ~(1u << (s & 31));
          while (todo) {
            const int j = wd * 32 + __ffs(todo) - 1;
            todo &= todo - 1;
            CT rj[DIM];
#pragma unroll
            for (int a = 0; a < DIM; ++a) rj[a] = to_compute<CT>(__ldg(rj_base + a * cap + j));
            if (A::f32(tile_r2_cell<DIM>(ri, rj, 1, off, w)) <= r2) {
              if (cnt < k_slots) {
                if constexpr (STAGED) {
                  srow[cnt] = static_cast<unsigned short>((k << 10) | j);
                } else {
                  row[cnt] = __ldg(id_base + j);
                }
              }
              ++cnt;
            }
          }
        }
      }
      const int written = cnt < k_slots ? cnt : k_slots;
      counts[static_cast<size_t>(c) * cap + s] =
          static_cast<float>(p.count_at_k ? written : cnt);
      if constexpr (STAGED) {
        s_n[threadIdx.x] = written;
        s_row[threadIdx.x] = c * cap + s;
        s_nbase[threadIdx.x] = ci * M;
      } else {
        for (int t = written; t < k_slots; ++t) row[t] = p.pad;
      }
    }
    if constexpr (STAGED) {
      __syncthreads();  // the batch's stage rows are complete
      const int n = min(kListThreads, total - base);
      if ((k_slots & 3) == 0) {
        write_staged_rows<4>(out, ids, n, k_slots, cap, stride, s_stage, s_n, s_row, s_nbase,
                             s_nb, p.pad);
      } else {
        write_staged_rows<1>(out, ids, n, k_slots, cap, stride, s_stage, s_n, s_row, s_nbase,
                             s_nb, p.pad);
      }
      __syncthreads();  // and written: the next batch may refill the stage
    }
  }
  // empty slots count 0
  for (int e = threadIdx.x; e < n_cells * cap; e += kListThreads) {
    const int ci = e / cap;
    const int s = e - ci * cap;
    if (empty_row(s_self, ci, s, words)) counts[static_cast<size_t>(c0 + ci) * cap + s] = 0.0f;
  }
}

NnpsParams make_params(const float* fparams, const int* iparams) {
  NnpsParams p;
  for (int a = 0; a < 3; ++a) p.w[a] = fparams[a];
  p.r2 = fparams[3];
  p.keep_self = iparams[0];
  p.pad = iparams[1];
  p.count_at_k = iparams[2];
  return p;
}

struct ListsLaunch {
  const void *rel, *occ, *ids, *nb_ids;
  void *out, *counts, *words_buf;
  int c_rows, cap, n_nb, k_slots, stride;
  NnpsParams p;
  cudaStream_t stream;

  template <int DIM, typename RelT, typename CT, bool STAGED>
  int launch() const {
    const int words = (cap + 31) / 32;
    auto* wbuf = static_cast<unsigned*>(words_buf);
    const int err = repro_torch::launch_stage_slots<DIM, RelT, false>(
        static_cast<const RelT*>(rel), static_cast<const float*>(occ), nullptr, wbuf, nullptr,
        c_rows, cap, 0, 0, stream);
    if (err != 0) return err;
    const size_t smem =
        STAGED ? sizeof(unsigned short) * kListThreads * static_cast<size_t>(stride) : 0;
    const int blocks = (c_rows + kListCells - 1) / kListCells;
    neighbor_lists_kernel<DIM, RelT, CT, STAGED><<<blocks, kListThreads, smem, stream>>>(
        static_cast<const RelT*>(rel), static_cast<const float*>(occ),
        static_cast<const int*>(ids), wbuf, static_cast<const int*>(nb_ids),
        static_cast<int*>(out), static_cast<float*>(counts), c_rows, cap, words, k_slots,
        stride, p);
    return static_cast<int>(cudaGetLastError());
  }

  template <int DIM, typename RelT, typename CT>
  int run() const {
    constexpr int M = DIM == 2 ? 9 : 27;
    if (n_nb != M || (stride != 0 && (stride < k_slots || stride % 4 != 0 ||
                                      2LL * kListThreads * stride > kListStageBytes))) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    return stride ? launch<DIM, RelT, CT, true>() : launch<DIM, RelT, CT, false>();
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
// 1 = fp32. fparams: w[0..2], r2_cell. iparams: keep_self, pad, count_at_k.
// words_buf: (c_rows * ceil(cap / 32)) int32 scratch. stride: ids a stage
// row, a multiple of 4, >= k_slots and at most kListStageBytes a block, or
// 0 for the unstaged path (kernels/nnps_pairwise.py list_stride).
extern "C" int repro_rcll_neighbor_lists(int dim, int rel_kind, int compute_kind,
                                         const void* rel, const void* occ, const void* ids,
                                         const void* nb_ids, void* out, void* counts,
                                         void* words_buf, int c_rows, int cap, int n_nb,
                                         int k_slots, int stride, const float* fparams,
                                         const int* iparams, void* stream) {
  if (cap < 1 || cap > 1024 || k_slots < 1 || c_rows < 1 ||
      static_cast<long long>(kListCells) * cap * k_slots > (1LL << 31) - 1 ||
      (reinterpret_cast<uintptr_t>(out) & 15) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const ListsLaunch l{rel,    occ,     ids,    nb_ids, out,
                      counts, words_buf, c_rows, cap,  n_nb,
                      k_slots, stride, make_params(fparams, iparams),
                      static_cast<cudaStream_t>(stream)};
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
