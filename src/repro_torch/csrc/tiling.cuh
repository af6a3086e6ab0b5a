// Cell-pair tile math shared by the RCLL CUDA kernels.
//
// Device counterpart of repro_torch/kernels/tiling.py
// (tile_phys_disp_shifted): the stale-binning re-anchor
// rel' = rel + 2 * shift in fp32, then the Eq. (7) decode
// x_i - x_j = ((rel'_i - rel'_j) / 2 - off) * hc per axis.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

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

}  // namespace repro_torch
