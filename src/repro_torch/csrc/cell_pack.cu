// K1: cell-major packing of cell-sorted record rows, as a store-bound kernel.
//
// Replaces the Pallas kernel repro/kernels/cell_pack.py::cell_tables
// (_pack_kernel). The persistent pipeline's arrays are cell-sorted, so cell
// c's particles are the rows starts[c] .. starts[c]+counts[c]-1. The outputs
// are t16 (C+1, F16, cap) int16, t32 (C+1, F32, cap) f32 and ids (C+1, cap)
// int32: slot s of column f of cell c holds row starts[c]+s's column f while
// s < counts[c], else 0 in t16, fill32[f] in t32 and -1 in ids; cell C is the
// sentinel (start N, count 0). Output is bit-identical to the plain version
// (pure copies and selects; a row index is clamped to [0, N) as the plain
// version clamps it).
//
// Bound on the H100: bytes. It reads N*(2*F16 + 4*F32) bytes of rows and
// writes (C+1)*cap*(2*F16 + 4*F32 + 4) bytes of tables (17 MB read, 73 MB
// written at the main path, ~72 % of it empty-slot fill). Design: one thread
// for each 16-byte chunk of an output (8 int16 or 4 32-bit elements), the
// three tables' chunks one after the other in the grid, so a warp writes 512
// contiguous bytes with one 16-byte store a thread. A thread finds its
// chunk's (cell, column, slot) with two divisions by invariants (multiply-
// high, no integer division), loads its cell's start and count (and the next
// cell's when the chunk crosses into it), and gathers its occupied slots'
// values from the rows (L1/L2 hits: a warp's chunks cover two or three
// cells). At cap >= 8 a chunk is at most two runs of consecutive slots (the
// rest of one column, the start of the next), so each element costs a
// compare against its run's occupied limit and one predicated load at
// base + t * F. There is no shared memory and no barrier: every thread's
// loads are independent of every other's, which keeps enough of them in
// flight. Instructions and the dependent loads, not the store bytes, set
// what is left (PERF.md). A block-run design (stage a run of cells'
// rows in shared memory, transpose into shared-memory tiles, copy out) was
// slower: its transposition and barriers set its time.
// A run-time `fault` (0 from the wrapper) lets a check plant a wrong kernel
// without touching this source: 1 leaves the last occupied slot of each cell
// empty, 2 fills empty fp32 slots with 0 instead of fill32.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // PACK_THREADS in kernels/cell_pack.py
constexpr int kFaultLastSlot = 1;
constexpr int kFaultFillZero = 2;

// Unsigned 32-bit division by an invariant d >= 1 as a multiply-high and
// shifts (the round-up method of Granlund and Montgomery; exact for every
// 32-bit numerator).
struct FastDiv {
  unsigned d, m;
  int s1, s2;
  explicit FastDiv(unsigned divisor) : d(divisor) {
    int l = 0;
    while ((1ull << l) < divisor) ++l;
    m = static_cast<unsigned>(((1ull << 32) * ((1ull << l) - divisor)) / divisor + 1);
    s1 = l < 1 ? l : 1;
    s2 = l > 1 ? l - 1 : 0;
  }
  __device__ __forceinline__ unsigned div(unsigned x) const {
    const unsigned t = __umulhi(m, x);
    return (t + ((x - t) >> s1)) >> s2;
  }
};

struct Cell {
  int start, cnt;
};

struct Inputs {
  const int* starts;
  const int* counts;
  const float* fill32;
  int n, c_total, cap, fault;

  // The cell's occupied rows lie in [0, n): no row index needs the clamp.
  __device__ __forceinline__ bool in_range(Cell m) const {
    return m.start >= 0 && m.start <= n - m.cnt;
  }

  __device__ __forceinline__ Cell cell(unsigned c) const {
    Cell m{n, 0};  // the sentinel cell
    if (c < static_cast<unsigned>(c_total)) {
      m.start = __ldg(starts + c);
      m.cnt = min(max(__ldg(counts + c), 0), cap);
      if (fault == kFaultLastSlot && m.cnt > 0) --m.cnt;
    }
    return m;
  }
};

// One table: KIND 0 is t16 (rows16, empty 0), 1 is t32 (rows32, empty
// fill32[f]), 2 is ids (start + s, empty -1).
template <typename T, int KIND>
struct Table {
  T* out;
  const T* rows;
  unsigned total;  // (C+1) * F * cap elements
  int f_cols;
  FastDiv per_cell, per_col;  // F * cap and cap

  __device__ __forceinline__ T slot(const Inputs& in, int f, int s, Cell m) const {
    const bool occ = s < m.cnt;
    if constexpr (KIND == 2) {
      return occ ? m.start + s : -1;
    } else {
      T v;
      if (occ) {
        const int r = min(max(m.start + s, 0), in.n - 1);
        v = __ldg(rows + r * f_cols + f);
      } else if constexpr (KIND == 1) {
        v = in.fault == kFaultFillZero ? 0.0f : __ldg(in.fill32 + f);
      } else {
        v = 0;
      }
      return v;
    }
  }

  // Element e as (cell, column, slot), from scratch.
  __device__ __forceinline__ T element(const Inputs& in, unsigned e) const {
    const unsigned c = per_cell.div(e);
    const unsigned rem = e - c * per_cell.d;
    const unsigned f = per_col.div(rem);
    return slot(in, static_cast<int>(f), static_cast<int>(rem - f * per_col.d), in.cell(c));
  }

  // Write chunk q: elements [q * V, q * V + V) of the table.
  __device__ __forceinline__ void chunk(const Inputs& in, unsigned q) const {
    constexpr int V = 16 / sizeof(T);
    const unsigned e0 = q * V;
    if (e0 + V > total) {  // the table's last, partial chunk
      for (unsigned e = e0; e < total; ++e) out[e] = element(in, e);
      return;
    }
    union {
      uint4 u;
      T v[V];
    } pack;
    if (in.cap < V) {  // a chunk may cross several slots' rows and cells
#pragma unroll
      for (int t = 0; t < V; ++t) pack.v[t] = element(in, e0 + t);
    } else {  // two runs of slots: s.. of column f, then 0.. of the next column
      const unsigned c = per_cell.div(e0);
      const int rem = static_cast<int>(e0 - c * per_cell.d);
      const int f = static_cast<int>(per_col.div(rem));
      const int s = rem - f * in.cap;
      const int k = min(V, in.cap - s);    // elements in the first run
      const bool cross = f + 1 == f_cols;  // the second run is in the next cell
      const Cell m0 = in.cell(c);
      const Cell m1 = k < V && cross ? in.cell(c + 1) : m0;
      const int f1 = cross ? 0 : f + 1;
      if (!in.in_range(m0) || !in.in_range(m1)) {  // rows to clamp: element by element
#pragma unroll
        for (int t = 0; t < V; ++t) {
          pack.v[t] = t < k ? slot(in, f, s + t, m0) : slot(in, f1, t - k, m1);
        }
      } else {
        // element t is occupied while t < lim (lim_a in the first run, lim_b in
        // the second) and lies at offset base + t * F of the rows
        const int lim_a = min(k, max(m0.cnt - s, 0));
        const int lim_b = min(V, k + m1.cnt);
        const int base_a = (m0.start + s) * f_cols + f;
        const int base_b = (m1.start - k) * f_cols + f1;
        T empty_a = 0, empty_b = 0;
        if constexpr (KIND == 1) {
          empty_a = in.fault == kFaultFillZero ? 0.0f : __ldg(in.fill32 + f);
          empty_b = in.fault == kFaultFillZero ? 0.0f : __ldg(in.fill32 + f1);
        }
#pragma unroll
        for (int t = 0; t < V; ++t) {
          const bool first = t < k;
          const bool occ = t < (first ? lim_a : lim_b);
          if constexpr (KIND == 2) {
            pack.v[t] = occ ? (first ? m0.start + s : m1.start - k) + t : -1;
          } else {
            T v = first ? empty_a : empty_b;
            if (occ) v = __ldg(rows + (first ? base_a : base_b) + t * f_cols);
            pack.v[t] = v;
          }
        }
      }
    }
    *reinterpret_cast<uint4*>(out + e0) = pack.u;
  }
};

// Blocks [0, b16) take t16's chunks, [b16, b16 + b32) t32's, the rest ids'.
__global__ void __launch_bounds__(kThreads)
cell_tables_kernel(Inputs in, Table<int16_t, 0> t16, Table<float, 1> t32, Table<int, 2> ids,
                   unsigned b16, unsigned b32) {
  const unsigned b = blockIdx.x;
  if (b < b16) {
    const unsigned q = b * kThreads + threadIdx.x;
    if (q * 8 < t16.total) t16.chunk(in, q);
  } else if (b < b16 + b32) {
    const unsigned q = (b - b16) * kThreads + threadIdx.x;
    if (q * 4 < t32.total) t32.chunk(in, q);
  } else {
    const unsigned q = (b - b16 - b32) * kThreads + threadIdx.x;
    if (q * 4 < ids.total) ids.chunk(in, q);
  }
}

}  // namespace

// blocks16, blocks32, blocks_id: blocks of each table
// (kernels/cell_pack.py::pack_geometry); the wrapper keeps every table and
// slab below 2^31 elements. fault: 0 (see the note above).
extern "C" int repro_cell_tables(const void* rows16, const void* rows32, const void* starts,
                                 const void* counts, const void* fill32, void* t16, void* t32,
                                 void* ids, int n, int c_total, int f16, int f32, int cap,
                                 int blocks16, int blocks32, int blocks_id, int fault,
                                 void* stream) {
  if (cap < 1 || f16 < 1 || f32 < 1 || c_total < 0 || n < 1 || blocks16 < 0 || blocks32 < 0 ||
      blocks_id < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned cells = static_cast<unsigned>(c_total) + 1;
  const unsigned ucap = static_cast<unsigned>(cap);
  const Inputs in{static_cast<const int*>(starts), static_cast<const int*>(counts),
                  static_cast<const float*>(fill32), n, c_total, cap, fault};
  const Table<int16_t, 0> a{static_cast<int16_t*>(t16), static_cast<const int16_t*>(rows16),
                            cells * f16 * ucap, f16, FastDiv(f16 * ucap), FastDiv(ucap)};
  const Table<float, 1> b{static_cast<float*>(t32), static_cast<const float*>(rows32),
                          cells * f32 * ucap, f32, FastDiv(f32 * ucap), FastDiv(ucap)};
  const Table<int, 2> c{static_cast<int*>(ids), nullptr, cells * ucap, 1, FastDiv(ucap),
                        FastDiv(ucap)};
  const int blocks = blocks16 + blocks32 + blocks_id;
  if (blocks == 0) return 0;
  cell_tables_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      in, a, b, c, blocks16, blocks32);
  return static_cast<int>(cudaGetLastError());
}
