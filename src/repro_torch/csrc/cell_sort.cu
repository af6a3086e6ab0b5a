// The rebuild's counting-sort pack: a stable re-sort of cell-sorted particles
// by their new flat cell id, as five kernels bound by bytes.
//
// Replaces no Pallas kernel: the JAX package's counting sort
// (repro/core/cells.py::_counting_sort_positions) is plain jnp, which the port
// carried over as about 60 small PyTorch ops a rebuild (kernels/cell_sort.py
// keeps that path as the plain version). The outputs are those of the plain
// path bit for bit: order (the permutation of argsort(cell_id, stable=True)),
// inverse, the new counts, the (C, cap) table of packed ids, the overflow
// count, the packed cell ids, cell coordinates and rel rows, and the packed
// binning's own order (the identity).
//
// Precondition, checked by codes_kernel: the particles are in the order of
// the previous pack, so previous cell g's particles are the run
// run_start[g] .. run_start[g] + run_count[g] - 1, and each moved at most one
// cell per axis (minimum image) since. Then new cell c's particles come from
// at most 3^d source cells (c's neighbors, each through one offset), and the
// stable sort puts them in the flat-id order of their sources (per axis in
// increasing source coordinate; across a periodic seam the wrapped source is
// out of offset order), each source's in index order. A particle that moved
// further gets code kFar and raises far_flag, which the wrapper reads on the
// host before it launches the rest (the pack's one host read); with the flag
// set it takes the argsort oracle.
//
// Kernels: codes_kernel, a thread a particle (its offset code as a byte, the
// flag, the first index of each previous run); count_kernel, a thread a new
// cell walking its sources' runs in that order (the count, `before`: the
// particles of its earlier sources, per-block sums of counts and overflow);
// scan_kernel, one block (an exclusive scan of the block sums, the overflow
// total); table_kernel, a block of cells (each cell's start from a block scan
// plus the block's base, then the block's table rows with 16-byte stores);
// scatter_kernel, a thread a particle: position = start of its new cell +
// before[its source][the cell] + its rank among the earlier particles of its
// run with its code, then order, inverse, cell id, coordinates and rel at it.
// The permutation is close to the identity (most particles keep their cell),
// so a warp's stores at the positions land in a few lines.
//
// Bound on the H100: bytes. Each input is read once and each output written
// once from device memory (about 282 MB at 4.19M particles and 727,609 cells
// of 20 slots: 0.084 ms at 3.35 TB/s), besides the scratch (before, 3^d ints
// an occupied cell, written once and gathered once); the walks read the codes
// (a byte a particle) again from L2. There are no atomics: every output is a
// function of the inputs alone (the flag is a plain store of 1).
// A run-time `fault` (0 from the wrapper) lets a check plant a wrong kernel
// without touching this source: 1 ranks each particle among the later
// particles of its run (the run's order reversed), 2 leaves the sources in
// offset order across a periodic seam.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;       // particles or cells a block
constexpr int kScanThreads = 1024;  // scan_kernel's one block
constexpr int kFar = 0xFF;          // the code of a particle that moved past its neighbors
constexpr int kFaultRunReversed = 1;
constexpr int kFaultSeamOrder = 2;

struct Grid {
  int n[3];         // cells per axis (1 past the dimension)
  int periodic[3];  // 1 where the axis wraps
  int c_total;
};

template <int DIM>
__host__ __device__ constexpr int pow3() {
  return DIM == 2 ? 9 : 27;
}

template <int DIM>
__device__ __forceinline__ void coords_of(const Grid& grid, int c, int* xc) {
#pragma unroll
  for (int a = DIM - 1; a > 0; --a) {
    xc[a] = c % grid.n[a];
    c /= grid.n[a];
  }
  xc[0] = c;
}

// The three cells a particle now in coordinate x of one axis can have come
// from: src[k] with delta[k] = x - src[k] (before wrapping), ok[k] false where
// a wall axis has no such cell, sorted by source coordinate.
struct Axis {
  int src[3], delta[3];
  bool ok[3];
};

__device__ __forceinline__ void order_pair(Axis& ax, int i, int j) {
  if (ax.src[i] > ax.src[j]) {
    const int s = ax.src[i], d = ax.delta[i];
    ax.src[i] = ax.src[j];
    ax.delta[i] = ax.delta[j];
    ax.src[j] = s;
    ax.delta[j] = d;
  }
}

__device__ __forceinline__ Axis axis_sources(int x, int n, bool periodic, int fault) {
  Axis ax;
#pragma unroll
  for (int k = 0; k < 3; ++k) {  // delta +1, 0, -1: increasing source coordinate
    const int d = 1 - k;
    int s = x - d;
    ax.ok[k] = periodic || (s >= 0 && s < n);
    if (periodic) s = s < 0 ? s + n : (s >= n ? s - n : s);
    ax.src[k] = s;
    ax.delta[k] = d;
  }
  if (periodic && fault != kFaultSeamOrder) {  // n >= 3: three distinct sources
    order_pair(ax, 0, 1);
    order_pair(ax, 1, 2);
    order_pair(ax, 0, 1);
  }
  return ax;
}

// Inclusive sum of v over the block's threads, in thread order; *total gets
// the block's sum. Every thread of the block calls it.
template <int THREADS>
__device__ __forceinline__ int block_scan(int v, int* warp_sums, int* total) {
  constexpr int kWarps = THREADS / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += y;
  }
  if (lane == 31) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kWarps ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < kWarps; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    if (lane < kWarps) warp_sums[lane] = w;
  }
  __syncthreads();
  const int out = v + (warp > 0 ? warp_sums[warp - 1] : 0);
  *total = warp_sums[kWarps - 1];
  __syncthreads();  // warp_sums is free again
  return out;
}

template <int DIM>
__global__ void __launch_bounds__(kThreads)
codes_kernel(const int* __restrict__ cell_xy, const int* __restrict__ prev_xy,
             const int* __restrict__ prev_cell_id, uint8_t* __restrict__ code,
             int* __restrict__ run_start, int* __restrict__ far_flag, int n, Grid grid) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  int o = 0;
  bool far = false;
#pragma unroll
  for (int a = 0; a < DIM; ++a) {
    int d = __ldg(cell_xy + i * DIM + a) - __ldg(prev_xy + i * DIM + a);
    if (grid.periodic[a]) {  // minimum image with floor-mod, as Domain.wrap_cell_delta
      const int half = grid.n[a] / 2;
      int t = (d + half) % grid.n[a];
      if (t < 0) t += grid.n[a];
      d = t - half;
    }
    far = far || d < -1 || d > 1;
    o = o * 3 + d + 1;
  }
  code[i] = static_cast<uint8_t>(far ? kFar : o);
  if (far) *far_flag = 1;
  const int g = __ldg(prev_cell_id + i);
  if ((i == 0 || __ldg(prev_cell_id + i - 1) != g) && g >= 0 && g < grid.c_total) {
    run_start[g] = i;
  }
}

// A thread a new cell c: for its sources k in order (digit a of k the sorted
// position on axis a), before[k * C + c] = the particles from sources before
// k, then k's run is walked for the particles whose code leads to c. The k-th
// entries of a warp's cells are one 128-byte store.
template <int DIM>
__global__ void __launch_bounds__(kThreads)
count_kernel(Grid grid, const uint8_t* __restrict__ code, const int* __restrict__ run_start,
             const int* __restrict__ run_count, int* __restrict__ counts,
             int* __restrict__ before, int* __restrict__ block_sum, int* __restrict__ block_over,
             int cap, int fault) {
  constexpr int kSources = pow3<DIM>();
  __shared__ int warp_sums[kThreads / 32];
  const int c = blockIdx.x * kThreads + threadIdx.x;
  int cnt = 0;
  if (c < grid.c_total) {
    int xc[DIM];
    coords_of<DIM>(grid, c, xc);
    Axis ax[DIM];
#pragma unroll
    for (int a = 0; a < DIM; ++a) ax[a] = axis_sources(xc[a], grid.n[a], grid.periodic[a], fault);
    int earlier[kSources];
#pragma unroll
    for (int k = 0; k < kSources; ++k) {
      earlier[k] = cnt;
      int dig[DIM];
      int rem = k;
#pragma unroll
      for (int a = DIM - 1; a >= 0; --a) {
        dig[a] = rem % 3;
        rem /= 3;
      }
      bool ok = true;
      int g = 0, o = 0;
#pragma unroll
      for (int a = 0; a < DIM; ++a) {
        ok = ok && ax[a].ok[dig[a]];
        g = g * grid.n[a] + ax[a].src[dig[a]];
        o = o * 3 + ax[a].delta[dig[a]] + 1;
      }
      if (!ok) continue;
      const int len = __ldg(run_count + g);
      if (len <= 0) continue;
      const int s = __ldg(run_start + g);
      for (int j = s; j < s + len; ++j) cnt += __ldg(code + j) == o;
    }
    counts[c] = cnt;
    if (cnt > 0) {  // no particle reads an empty cell's entries
#pragma unroll
      for (int k = 0; k < kSources; ++k) {
        before[static_cast<size_t>(k) * grid.c_total + c] = earlier[k];
      }
    }
  }
  int total, over;
  block_scan<kThreads>(cnt, warp_sums, &total);
  block_scan<kThreads>(max(cnt - cap, 0), warp_sums, &over);
  if (threadIdx.x == 0) {
    block_sum[blockIdx.x] = total;
    block_over[blockIdx.x] = over;
  }
}

// One block: block_sum becomes its exclusive scan (each count block's first
// packed position); *overflow the sum of block_over.
__global__ void __launch_bounds__(kScanThreads)
scan_kernel(int* __restrict__ block_sum, const int* __restrict__ block_over, int blocks,
            int* __restrict__ overflow) {
  __shared__ int warp_sums[kScanThreads / 32];
  int carry = 0, over = 0;
  for (int base = 0; base < blocks; base += kScanThreads) {
    const int i = base + threadIdx.x;
    const int v = i < blocks ? block_sum[i] : 0;
    int total, over_part;
    const int inc = block_scan<kScanThreads>(v, warp_sums, &total);
    if (i < blocks) block_sum[i] = carry + inc - v;
    carry += total;
    block_scan<kScanThreads>(i < blocks ? block_over[i] : 0, warp_sums, &over_part);
    over += over_part;
  }
  if (threadIdx.x == 0) *overflow = over;
}

// A block of cells: starts, then the block's table rows, one stretch of
// (c1 - c0) * cap ints that begins on a 16-byte boundary (c0 * cap is a
// multiple of kThreads): slot s of cell c holds start + s while
// s < min(count, cap), else -1.
__global__ void __launch_bounds__(kThreads)
table_kernel(int c_total, const int* __restrict__ counts, const int* __restrict__ block_base,
             int* __restrict__ starts, int* __restrict__ table, int cap) {
  __shared__ int warp_sums[kThreads / 32];
  __shared__ int start_s[kThreads], occ_s[kThreads];
  const int c0 = blockIdx.x * kThreads;
  const int c = c0 + threadIdx.x;
  const int cnt = c < c_total ? __ldg(counts + c) : 0;
  int total;
  const int start =
      __ldg(block_base + blockIdx.x) + block_scan<kThreads>(cnt, warp_sums, &total) - cnt;
  if (c < c_total) starts[c] = start;
  start_s[threadIdx.x] = start;
  occ_s[threadIdx.x] = min(cnt, cap);
  __syncthreads();
  const int len = (min(c0 + kThreads, c_total) - c0) * cap;
  int* out = table + static_cast<size_t>(c0) * cap;
  const int chunks = len / 4;
  for (int q = threadIdx.x; q < chunks; q += kThreads) {
    int cl = (q * 4) / cap;
    int s = q * 4 - cl * cap;
    int v[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      v[t] = s < occ_s[cl] ? start_s[cl] + s : -1;
      if (++s == cap) {
        s = 0;
        ++cl;
      }
    }
    reinterpret_cast<int4*>(out)[q] = make_int4(v[0], v[1], v[2], v[3]);
  }
  for (int e = chunks * 4 + threadIdx.x; e < len; e += kThreads) {
    const int cl = e / cap, s = e - cl * cap;
    out[e] = s < occ_s[cl] ? start_s[cl] + s : -1;
  }
}

__device__ __forceinline__ void copy_row(const void* src, void* dst, int i, int pos, int words,
                                         bool wide) {
  if (wide) {
    const uint32_t* s = static_cast<const uint32_t*>(src) + static_cast<size_t>(i) * words;
    uint32_t* d = static_cast<uint32_t*>(dst) + static_cast<size_t>(pos) * words;
    for (int w = 0; w < words; ++w) d[w] = __ldg(s + w);
  } else {
    const uint16_t* s = static_cast<const uint16_t*>(src) + static_cast<size_t>(i) * words;
    uint16_t* d = static_cast<uint16_t*>(dst) + static_cast<size_t>(pos) * words;
    for (int w = 0; w < words; ++w) d[w] = __ldg(s + w);
  }
}

// A thread a particle i, now in cell c, from source cell g (its previous
// cell) with code o: its position is starts[c] + before[k][c] (k: g's place
// among c's sources) + the particles of g's run before i with code o.
template <int DIM>
__global__ void __launch_bounds__(kThreads)
scatter_kernel(Grid grid, const uint8_t* __restrict__ code, const int* __restrict__ run_start,
               const int* __restrict__ run_count, const int* __restrict__ prev_cell_id,
               const int* __restrict__ cell_xy, const int* __restrict__ starts,
               const int* __restrict__ before, const void* __restrict__ rel, int rel_words,
               int rel_wide, int* __restrict__ order, int* __restrict__ inverse,
               int* __restrict__ cell_id, int* __restrict__ cell_xy_out,
               void* __restrict__ rel_out, int* __restrict__ identity, int n, int fault) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const int o = __ldg(code + i);
  const int g = __ldg(prev_cell_id + i);
  const int s = __ldg(run_start + g);
  int rank = 0;
  if (fault == kFaultRunReversed) {
    const int end = s + __ldg(run_count + g);
    for (int j = i + 1; j < end; ++j) rank += __ldg(code + j) == o;
  } else {
    for (int j = s; j < i; ++j) rank += __ldg(code + j) == o;
  }
  int xc[DIM];
  int c = 0, k = 0;
#pragma unroll
  for (int a = 0; a < DIM; ++a) {
    xc[a] = __ldg(cell_xy + i * DIM + a);
    c = c * grid.n[a] + xc[a];
  }
  int digits = o, weight = 1;
#pragma unroll
  for (int a = DIM - 1; a >= 0; --a) {  // axis a's delta: base-3 digit DIM-1-a of o, less 1
    const int d = digits % 3 - 1;
    digits /= 3;
    const Axis ax = axis_sources(xc[a], grid.n[a], grid.periodic[a], fault);
    k += weight * (ax.delta[0] == d ? 0 : (ax.delta[1] == d ? 1 : 2));
    weight *= 3;
  }
  const int pos =
      __ldg(starts + c) + __ldg(before + static_cast<size_t>(k) * grid.c_total + c) + rank;
  order[pos] = i;
  inverse[i] = pos;
  cell_id[pos] = c;
#pragma unroll
  for (int a = 0; a < DIM; ++a) cell_xy_out[pos * DIM + a] = xc[a];
  copy_row(rel, rel_out, i, pos, rel_words, rel_wide);
  identity[i] = i;
}

Grid make_grid(int c_total, int n0, int n1, int n2, int per0, int per1, int per2) {
  Grid g;
  g.n[0] = n0;
  g.n[1] = n1;
  g.n[2] = n2;
  g.periodic[0] = per0;
  g.periodic[1] = per1;
  g.periodic[2] = per2;
  g.c_total = c_total;
  return g;
}

template <int DIM>
int launch_codes(const void* cell_xy, const void* prev_xy, const void* prev_cell_id, void* code,
                 void* run_start, void* far_flag, int n, Grid grid, cudaStream_t stream) {
  codes_kernel<DIM><<<(n + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      static_cast<const int*>(cell_xy), static_cast<const int*>(prev_xy),
      static_cast<const int*>(prev_cell_id), static_cast<uint8_t*>(code),
      static_cast<int*>(run_start), static_cast<int*>(far_flag), n, grid);
  return static_cast<int>(cudaGetLastError());
}

struct PackArgs {
  const void *code, *run_start, *run_count, *prev_cell_id, *cell_xy, *rel;
  void *counts, *before, *starts, *block_sum, *block_over, *overflow;
  void *order, *inverse, *cell_id, *cell_xy_out, *rel_out, *table, *identity;
};

template <int DIM>
int launch_pack(const PackArgs& p, Grid grid, int n, int cap, int rel_bytes, int fault,
                cudaStream_t stream) {
  const int blocks = (grid.c_total + kThreads - 1) / kThreads;
  const auto* code = static_cast<const uint8_t*>(p.code);
  const auto* run_start = static_cast<const int*>(p.run_start);
  const auto* run_count = static_cast<const int*>(p.run_count);
  count_kernel<DIM><<<blocks, kThreads, 0, stream>>>(
      grid, code, run_start, run_count, static_cast<int*>(p.counts), static_cast<int*>(p.before),
      static_cast<int*>(p.block_sum), static_cast<int*>(p.block_over), cap, fault);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  scan_kernel<<<1, kScanThreads, 0, stream>>>(static_cast<int*>(p.block_sum),
                                               static_cast<const int*>(p.block_over), blocks,
                                               static_cast<int*>(p.overflow));
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  table_kernel<<<blocks, kThreads, 0, stream>>>(
      grid.c_total, static_cast<const int*>(p.counts), static_cast<const int*>(p.block_sum),
      static_cast<int*>(p.starts), static_cast<int*>(p.table), cap);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0 || n == 0) return rc;
  const bool wide = rel_bytes % 4 == 0 && reinterpret_cast<uintptr_t>(p.rel) % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(p.rel_out) % 4 == 0;
  scatter_kernel<DIM><<<(n + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      grid, code, run_start, run_count, static_cast<const int*>(p.prev_cell_id),
      static_cast<const int*>(p.cell_xy), static_cast<const int*>(p.starts),
      static_cast<const int*>(p.before), p.rel, wide ? rel_bytes / 4 : rel_bytes / 2, wide,
      static_cast<int*>(p.order), static_cast<int*>(p.inverse), static_cast<int*>(p.cell_id),
      static_cast<int*>(p.cell_xy_out), p.rel_out, static_cast<int*>(p.identity), n, fault);
  return static_cast<int>(cudaGetLastError());
}

bool grid_ok(int dim, int c_total, int n0, int n1, int n2) {
  return (dim == 2 || dim == 3) && c_total >= 1 && n0 >= 1 && n1 >= 1 && n2 >= 1 &&
         static_cast<long long>(n0) * n1 * n2 == c_total;
}

}  // namespace

// Codes, the far flag (which the caller zeroes first) and each previous run's
// first index. dim: 2 or 3; n0..n2, per0..per2: cells and periodic flags per
// axis (1 and 0 past dim).
extern "C" int repro_cell_sort_codes(const void* cell_xy, const void* prev_xy,
                                     const void* prev_cell_id, void* code, void* run_start,
                                     void* far_flag, int n, int c_total, int dim, int n0, int n1,
                                     int n2, int per0, int per1, int per2, void* stream) {
  if (n < 0 || !grid_ok(dim, c_total, n0, n1, n2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  const Grid grid = make_grid(c_total, n0, n1, n2, per0, per1, per2);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto launch = dim == 2 ? &launch_codes<2> : &launch_codes<3>;
  return launch(cell_xy, prev_xy, prev_cell_id, code, run_start, far_flag, n, grid, s);
}

// The pack, after codes with the far flag clear. before: 3^dim * c_total ints,
// starts: c_total ints, block_sum and block_over: ceil(c_total / 256) ints each,
// all scratch. rel_bytes: bytes of a rel row (even). fault: 0 (see the note
// above).
extern "C" int repro_cell_sort_pack(const void* code, const void* run_start, const void* run_count,
                                    const void* prev_cell_id, const void* cell_xy, const void* rel,
                                    void* counts, void* before, void* starts, void* block_sum,
                                    void* block_over, void* overflow, void* order, void* inverse,
                                    void* cell_id, void* cell_xy_out, void* rel_out, void* table,
                                    void* identity, int n, int c_total, int dim, int n0, int n1,
                                    int n2, int per0, int per1, int per2, int cap, int rel_bytes,
                                    int fault, void* stream) {
  if (n < 0 || cap < 1 || rel_bytes < 2 || rel_bytes % 2 != 0 ||
      !grid_ok(dim, c_total, n0, n1, n2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Grid grid = make_grid(c_total, n0, n1, n2, per0, per1, per2);
  const PackArgs p{code,    run_start,   run_count, prev_cell_id, cell_xy,  rel,
                   counts,  before,      starts,    block_sum,    block_over, overflow,
                   order,   inverse,     cell_id,   cell_xy_out,  rel_out,  table,
                   identity};
  const auto launch = dim == 2 ? &launch_pack<2> : &launch_pack<3>;
  return launch(p, grid, n, cap, rel_bytes, fault, static_cast<cudaStream_t>(stream));
}
