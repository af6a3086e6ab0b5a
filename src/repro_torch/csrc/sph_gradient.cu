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
// fusion). A rejected pair adds exactly 0 in the plain version
// (repro_torch/kernels/sph_gradient.py), so it is skipped here.
//
// Design: one block per self cell (C+1 blocks, the last the sentinel),
// one thread per self slot (blockDim = cap rounded up to 32), neighbor
// tiles staged in shared memory in both tiers' types; each tile's sum
// over j is added to fp32 register accumulators (k, then j: the Pallas
// kernel's order), written once: no atomics, and a fixed order. nvcc
// contracts the physics tier's multiply-adds, so num and den differ from
// the plain version's by a few ulps per term; the check's tolerance is
// derived from that (sph_gradient.rounding_bound).
//
// Bound on the H100: bytes and operations nearly tie (~13 operations per
// decided pair, ~40 per accepted pair, against ~0.6 KB per cell of tables
// in and sums out). Left on the table: empty self slots idle their lanes
// for the whole tile walk, sentinel neighbor tiles are not skipped, and
// one cell per block leaves 12 of 32 lanes idle at cap = 20.
#include <cuda_runtime.h>

#include "tiling.cuh"

namespace {

using repro_torch::cell_offset;
using repro_torch::dw_over_r;
using repro_torch::NnpsArith;
using repro_torch::pair_disp;
using repro_torch::tile_r2_cell;
using repro_torch::to_compute;
using repro_torch::to_f32;

struct GradParams {
  float w[3];    // anisotropy weights, rounded to the NNPS type on the host
  float r2;      // r_cell^2, rounded to the NNPS type on the host
  float hc[3];   // physical cell edges
  float h;       // smoothing length
  float a_dw;    // alpha_d(dim, h) / h
  float f_sign;  // +1: f_j - f_i (a check plants -1 to show it catches it)
};

template <int DIM, typename RelT, typename CT>
__global__ void gradient_kernel(const RelT* __restrict__ rel, const float* __restrict__ f,
                                const float* __restrict__ occ, const int* __restrict__ nb_ids,
                                float* __restrict__ num, float* __restrict__ den, int cap,
                                int n_nb, GradParams p) {
  using A = NnpsArith<CT>;
  extern __shared__ float smem_f[];
  float* s_r32 = smem_f;                               // [DIM][cap] fp32 physics tier
  float* s_f = s_r32 + DIM * cap;                      // [cap]
  int* s_occ = reinterpret_cast<int*>(s_f + cap);      // [cap]
  CT* s_rc = reinterpret_cast<CT*>(s_occ + cap);       // [DIM][cap] NNPS tier

  const int c = blockIdx.x;
  const int i = threadIdx.x;
  const bool active = i < cap;
  CT w[DIM], ri_c[DIM];
  float hc[DIM], ri[DIM];
#pragma unroll
  for (int a = 0; a < DIM; ++a) {
    w[a] = A::from_f32(p.w[a]);
    hc[a] = p.hc[a];
  }
  const float r2_cell = A::f32(A::from_f32(p.r2));
  bool occ_i = false;
  float f_i = 0.0f;
  if (active) {
    occ_i = occ[static_cast<size_t>(c) * cap + i] > 0.0f;
    f_i = f[static_cast<size_t>(c) * cap + i];
#pragma unroll
    for (int a = 0; a < DIM; ++a) {
      const RelT x = rel[(static_cast<size_t>(c) * DIM + a) * cap + i];
      ri[a] = to_f32(x);
      ri_c[a] = to_compute<CT>(x);
    }
  }
  float num_acc[DIM], den_acc[DIM];
#pragma unroll
  for (int a = 0; a < DIM; ++a) num_acc[a] = den_acc[a] = 0.0f;

  for (int k = 0; k < n_nb; ++k) {
    const int nc = nb_ids[static_cast<size_t>(c) * n_nb + k];
    __syncthreads();  // the previous tile is consumed
    for (int s = threadIdx.x; s < cap; s += blockDim.x) {
      const size_t e = static_cast<size_t>(nc) * cap + s;
      s_f[s] = f[e];
      s_occ[s] = occ[e] > 0.0f;
#pragma unroll
      for (int a = 0; a < DIM; ++a) {
        const RelT x = rel[(static_cast<size_t>(nc) * DIM + a) * cap + s];
        s_r32[a * cap + s] = to_f32(x);
        s_rc[a * cap + s] = to_compute<CT>(x);
      }
    }
    __syncthreads();
    if (!active || !occ_i) continue;
    CT off_c[DIM];
    float off[DIM];
#pragma unroll
    for (int a = 0; a < DIM; ++a) {
      off[a] = cell_offset<DIM>(k, a);
      off_c[a] = A::from_f32(off[a]);
    }
    const bool self_cell = nc == c;
    float t_num[DIM], t_den[DIM];
#pragma unroll
    for (int a = 0; a < DIM; ++a) t_num[a] = t_den[a] = 0.0f;
    for (int j = 0; j < cap; ++j) {
      if (!s_occ[j] || (self_cell && j == i)) continue;
      if (!(A::f32(tile_r2_cell<DIM>(ri_c, s_rc + j, cap, off_c, w)) <= r2_cell)) continue;
      float rj[DIM];
#pragma unroll
      for (int a = 0; a < DIM; ++a) rj[a] = s_r32[a * cap + j];
      float disp[DIM];
      const float r2 = pair_disp<DIM>(ri, rj, off, hc, disp);
      const float coef = dw_over_r(sqrtf(r2), p.h, p.a_dw);
      const float df = p.f_sign * (s_f[j] - f_i);
#pragma unroll
      for (int a = 0; a < DIM; ++a) {
        const float gw = coef * disp[a];
        t_num[a] += df * gw;
        t_den[a] += -disp[a] * gw;
      }
    }
#pragma unroll
    for (int a = 0; a < DIM; ++a) {
      num_acc[a] += t_num[a];
      den_acc[a] += t_den[a];
    }
  }
  if (active) {
#pragma unroll
    for (int a = 0; a < DIM; ++a) {
      const size_t e = (static_cast<size_t>(c) * DIM + a) * cap + i;
      num[e] = num_acc[a];
      den[e] = den_acc[a];
    }
  }
}

struct GradientLaunch {
  const void *rel, *f, *occ, *nb_ids;
  void *num, *den;
  int c_rows, cap, n_nb;
  GradParams p;
  cudaStream_t stream;

  template <int DIM, typename RelT, typename CT>
  int run() const {
    const int threads = ((cap + 31) / 32) * 32;
    const size_t smem =
        ((DIM + 1) * sizeof(float) + sizeof(int) + DIM * sizeof(CT)) * static_cast<size_t>(cap);
    gradient_kernel<DIM, RelT, CT><<<c_rows, threads, smem, stream>>>(
        static_cast<const RelT*>(rel), static_cast<const float*>(f),
        static_cast<const float*>(occ), static_cast<const int*>(nb_ids),
        static_cast<float*>(num), static_cast<float*>(den), cap, n_nb, p);
    return static_cast<int>(cudaGetLastError());
  }
};

}  // namespace

// rel_kind: 0 = fp16, 1 = bf16, 2 = fp32 storage. compute_kind (the NNPS
// type): 0 = fp16, 1 = fp32. fparams: w[0..2], r2_cell, hc[0..2], h,
// a_dw, f_sign.
extern "C" int repro_rcll_gradient(int dim, int rel_kind, int compute_kind, const void* rel,
                                   const void* f, const void* occ, const void* nb_ids,
                                   void* num, void* den, int c_rows, int cap, int n_nb,
                                   const float* fparams, void* stream) {
  if (cap < 1 || cap > 1024) return static_cast<int>(cudaErrorInvalidValue);
  GradParams p;
  for (int a = 0; a < 3; ++a) {
    p.w[a] = fparams[a];
    p.hc[a] = fparams[4 + a];
  }
  p.r2 = fparams[3];
  p.h = fparams[7];
  p.a_dw = fparams[8];
  p.f_sign = fparams[9];
  const GradientLaunch l{rel, f, occ, nb_ids, num, den, c_rows, cap, n_nb, p,
                         static_cast<cudaStream_t>(stream)};
  return repro_torch::dispatch(dim, rel_kind, compute_kind, l);
}
