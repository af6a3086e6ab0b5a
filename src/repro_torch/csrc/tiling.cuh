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
//  - the host-side dispatch over (dim, storage type, compute type).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
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
