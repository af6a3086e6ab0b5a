// K1: one-sweep cell-major packing of cell-sorted record rows.
//
// Replaces the Pallas kernel repro/kernels/cell_pack.py::cell_tables
// (_pack_kernel). The persistent pipeline's arrays are cell-sorted, so cell
// c's particles are the contiguous rows starts[c] .. starts[c]+counts[c]-1.
// One block per cell (C+1 blocks; block C is the sentinel empty cell) copies
// those rows from a 16-bit slab and an fp32 slab, masks slots past the
// occupancy (0 in the 16-bit slab, fill32[f] per fp32 column), transposes to
// the (F, cap) layout and emits ids = start + slot, or -1 past the count.
// Output is bit-identical to the plain version (pure copies and selects).
//
// Bound on the H100: bytes. It reads N*(2*F16 + 4*F32) bytes of rows and
// writes (C+1)*cap*(2*F16 + 4*F32 + 4) bytes of tables, with no arithmetic
// to speak of. Threads stride over (column, slot) with the slot fastest, so
// the table writes are coalesced; the row reads are strided by the row width
// (F16 * 2 or F32 * 4 bytes) and lean on L1/L2 to merge. Left on the table:
// staging each cell's rows through shared memory with 16-byte vector loads,
// and processing several small cells per block (cap * F is ~120 elements,
// so most threads of a 128-thread block do one element).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void cell_tables_kernel(const int16_t* __restrict__ rows16,
                                   const float* __restrict__ rows32,
                                   const int* __restrict__ starts,
                                   const int* __restrict__ counts,
                                   const float* __restrict__ fill32,
                                   int16_t* __restrict__ t16, float* __restrict__ t32,
                                   int* __restrict__ ids, int n, int c_total, int f16,
                                   int f32, int cap) {
  const int c = blockIdx.x;
  int start = n, count = 0;  // sentinel cell
  if (c < c_total) {
    start = starts[c];
    count = counts[c];
  }
  for (int s = threadIdx.x; s < cap; s += blockDim.x) {
    ids[static_cast<size_t>(c) * cap + s] = s < count ? start + s : -1;
  }
  const int n16 = f16 * cap;
  int16_t* out16 = t16 + static_cast<size_t>(c) * n16;
  for (int e = threadIdx.x; e < n16; e += blockDim.x) {
    const int f = e / cap;
    const int s = e - f * cap;
    out16[e] = s < count ? rows16[static_cast<size_t>(start + s) * f16 + f]
                         : static_cast<int16_t>(0);
  }
  const int n32 = f32 * cap;
  float* out32 = t32 + static_cast<size_t>(c) * n32;
  for (int e = threadIdx.x; e < n32; e += blockDim.x) {
    const int f = e / cap;
    const int s = e - f * cap;
    out32[e] = s < count ? rows32[static_cast<size_t>(start + s) * f32 + f] : fill32[f];
  }
}

}  // namespace

extern "C" int repro_cell_tables(const void* rows16, const void* rows32, const void* starts,
                                 const void* counts, const void* fill32, void* t16, void* t32,
                                 void* ids, int n, int c_total, int f16, int f32, int cap,
                                 void* stream) {
  int width = (f16 > f32 ? f16 : f32) * cap;
  int threads = ((width + 31) / 32) * 32;
  if (threads < 32) threads = 32;
  if (threads > 256) threads = 256;
  cell_tables_kernel<<<c_total + 1, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(rows16), static_cast<const float*>(rows32),
      static_cast<const int*>(starts), static_cast<const int*>(counts),
      static_cast<const float*>(fill32), static_cast<int16_t*>(t16), static_cast<float*>(t32),
      static_cast<int*>(ids), n, c_total, f16, f32, cap);
  return static_cast<int>(cudaGetLastError());
}
