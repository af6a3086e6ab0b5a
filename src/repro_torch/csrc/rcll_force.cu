// K2: fused cell-blocked WCSPH right-hand side over the RCLL cell tables.
//
// Replaces the Pallas kernel repro/kernels/rcll_force.py::rcll_force
// (_force_kernel). Per (self cell, neighbor cell) tile of cap x cap pairs:
// the Eq. (7) decode with the stale-cell shift re-anchor (tiling.cuh), the
// B-spline dW/dr / r, p/rho^2 from the streamed 1/rho through the scheme's
// EOS (linear or Tait), the grad-W channel (pressure + Monaghan artificial
// viscosity), the Morris dv channel and the delta-SPH continuity term, summed
// in fp32 over the 3^d neighborhood. No occupancy mask is streamed: empty
// slots carry m = 0 and 1/rho0, and compact support zeroes out-of-range and
// self pairs, exactly as in the Pallas kernel. The shift stream is int16.
//
// Design: one block per self cell (C+1 blocks, the last is the sentinel
// cell), one thread per self slot (blockDim = cap rounded up to 32). The
// block walks the M = 3^d neighbor cells in the order of
// cells.neighbor_cell_offsets, stages each neighbor tile (re-anchored rel,
// v, m, 1/rho and its p/rho^2) in shared memory, and every thread loops over
// j. Each tile's sum over j is added to fp32 register accumulators (k, then
// j: the Pallas kernel's order), written once at the end: no atomics, and
// the summation order is fixed.
//
// Arithmetic follows the plain version (repro_torch/kernels/rcll_force.py)
// expression by expression. nvcc's default --fmad=true contracts fp32
// multiply-adds in the pair loop (r^2, dv.disp, the channel sums), so the
// kernel differs from the plain version by a few ulps per term; the
// comparison tolerance is derived from fp32 sums of 9*cap (2-D) or 27*cap
// (3-D) terms with that contraction. The per-slot p/rho^2 is the exception
// (see por2_inv). powf, sqrtf and '/' are the IEEE-rounded CUDA versions.
//
// Bound on the H100: operations. Every tile evaluates cap^2 pairs of ~60
// fp32 operations (one division-guarded sqrt, two to four divisions, the
// Tait powf) against ~16 bytes per slot of input, far above the fp32
// non-tensor ridge point. Left on the table: skipping sentinel (out-of-
// domain) neighbor tiles, skipping empty self slots, several cells per block
// when cap is small (cap = 20 leaves 12 of 32 lanes idle), register tiling of
// several i per thread, and the reciprocal/rsqrt forms of the divisions.
#include <cuda_runtime.h>

#include "tiling.cuh"

namespace {

using repro_torch::cell_offset;
using repro_torch::pair_disp;
using repro_torch::reanchor;
using repro_torch::to_f32;

struct ForceParams {
  float hc[3];    // physical cell edges
  float h;        // smoothing length (R = r / h)
  float a_dw;     // alpha_d(dim, h) / h
  float eos_k;    // linear: c0*c0; tait: B = c0*c0*rho0/gamma
  float rho0;
  float neg_gamma;
  float reg;      // 0.01 * h * h
  float avc;      // -alpha * c0 * h
  float two_mu;   // 2 * mu
  float dk;       // 2 * delta * h * c0
  int eos_tait, has_av, has_dv, has_delta;
};

// p/rho^2 of one slot. The linear form c0^2 (1/rho - rho0/rho^2) cancels
// to ~1e-3 of its parts near rho0, so a contracted multiply-add here would
// change it by ~1e-4 relative; it is evaluated with explicitly rounded
// operations in the plain version's order (it runs once per slot, not per
// pair, so this costs nothing).
__device__ __forceinline__ float por2_inv(float inv, const ForceParams& p) {
  if (p.eos_tait) {
    const float ratio = __fmul_rn(p.rho0, inv);
    return __fmul_rn(__fmul_rn(__fmul_rn(p.eos_k, __fsub_rn(powf(ratio, p.neg_gamma), 1.0f)),
                               inv),
                     inv);
  }
  return __fmul_rn(p.eos_k, __fsub_rn(inv, __fmul_rn(__fmul_rn(p.rho0, inv), inv)));
}

template <int DIM, typename RelT, typename RecT>
__global__ void rcll_force_kernel(const RelT* __restrict__ rel,
                                  const int16_t* __restrict__ shift,
                                  const RecT* __restrict__ v, const RecT* __restrict__ m,
                                  const float* __restrict__ inv_rho,
                                  const int* __restrict__ nb_ids, float* __restrict__ drho,
                                  float* __restrict__ acc, int cap, int n_nb, ForceParams p) {
  extern __shared__ float smem[];
  float* s_r = smem;               // [DIM][cap] re-anchored rel of the neighbor cell
  float* s_v = s_r + DIM * cap;    // [DIM][cap]
  float* s_m = s_v + DIM * cap;    // [cap]
  float* s_inv = s_m + cap;        // [cap]
  float* s_por2 = s_inv + cap;     // [cap]

  const int c = blockIdx.x;
  const int i = threadIdx.x;
  const bool active = i < cap;
  float hc[DIM];
#pragma unroll
  for (int a = 0; a < DIM; ++a) hc[a] = p.hc[a];

  float ri[DIM], vi[DIM];
  float inv_i = 0.0f, por2_i = 0.0f;
  if (active) {
#pragma unroll
    for (int a = 0; a < DIM; ++a) {
      const size_t e = (static_cast<size_t>(c) * DIM + a) * cap + i;
      ri[a] = reanchor(rel[e], shift[e]);
      vi[a] = to_f32(v[e]);
    }
    inv_i = inv_rho[static_cast<size_t>(c) * cap + i];
    por2_i = por2_inv(inv_i, p);
  }

  float drho_acc = 0.0f;
  float acc_acc[DIM];
#pragma unroll
  for (int a = 0; a < DIM; ++a) acc_acc[a] = 0.0f;

  for (int k = 0; k < n_nb; ++k) {
    const int nc = nb_ids[static_cast<size_t>(c) * n_nb + k];
    __syncthreads();  // the previous tile is consumed
    for (int s = threadIdx.x; s < cap; s += blockDim.x) {
#pragma unroll
      for (int a = 0; a < DIM; ++a) {
        const size_t e = (static_cast<size_t>(nc) * DIM + a) * cap + s;
        s_r[a * cap + s] = reanchor(rel[e], shift[e]);
        s_v[a * cap + s] = to_f32(v[e]);
      }
      const size_t e = static_cast<size_t>(nc) * cap + s;
      s_m[s] = to_f32(m[e]);
      const float inv = inv_rho[e];
      s_inv[s] = inv;
      s_por2[s] = por2_inv(inv, p);
    }
    __syncthreads();
    if (!active) continue;

    float off[DIM];
#pragma unroll
    for (int a = 0; a < DIM; ++a) off[a] = cell_offset<DIM>(k, a);

    float t_drho = 0.0f;
    float t_acc[DIM];
#pragma unroll
    for (int a = 0; a < DIM; ++a) t_acc[a] = 0.0f;

    for (int j = 0; j < cap; ++j) {
      float rj[DIM];
#pragma unroll
      for (int a = 0; a < DIM; ++a) rj[a] = s_r[a * cap + j];
      float disp[DIM];
      const float r2 = pair_disp<DIM>(ri, rj, off, hc, disp);
      const float r = sqrtf(r2);
      // bspline.dw_over_r
      const float R = r / p.h;
      const float d1 = -2.0f * R + 1.5f * R * R;
      const float t = 2.0f - R;
      const float d2 = -0.5f * (t * t);
      const float dwdr = p.a_dw * (R < 1.0f ? d1 : (R < 2.0f ? d2 : 0.0f));
      const float coef = dwdr / (r > 1e-12f ? r : 1.0f);

      const float mj = s_m[j];
      const float inv_j = s_inv[j];
      float dv[DIM];
      float dv_dot_disp = 0.0f;
#pragma unroll
      for (int a = 0; a < DIM; ++a) {
        dv[a] = vi[a] - s_v[a * cap + j];
        dv_dot_disp += dv[a] * disp[a];
      }
      // Scheme.gradw_pair_coef
      float gc = mj * (por2_i + s_por2[j]);
      if (p.has_av) {
        const float mu_ij = dv_dot_disp / (r2 + p.reg);
        const float rho_bar_inv = 2.0f * inv_i * inv_j / (inv_i + inv_j);
        const float pi_ij = p.avc * mu_ij * rho_bar_inv;
        gc = gc + mj * (dv_dot_disp < 0.0f ? pi_ij : 0.0f);
      }
      gc = gc * coef;
      const float x_dot_gw = coef * r2;
      float vc = 0.0f;
      if (p.has_dv) {  // Scheme.dv_pair_coef
        vc = mj * p.two_mu * x_dot_gw * inv_i * inv_j / (r2 + p.reg);
      }
#pragma unroll
      for (int a = 0; a < DIM; ++a) {
        float contrib = -gc * disp[a];
        if (p.has_dv) contrib = contrib + vc * dv[a];
        t_acc[a] += contrib;
      }
      float dterm = mj * coef * dv_dot_disp;
      if (p.has_delta) {  // Scheme.drho_pair_term
        const float rho_diff = (inv_i - inv_j) / (inv_i * inv_j);
        dterm = dterm + p.dk * mj * inv_j * rho_diff * (-x_dot_gw) / (r2 + p.reg);
      }
      t_drho += dterm;
    }
    drho_acc += t_drho;
#pragma unroll
    for (int a = 0; a < DIM; ++a) acc_acc[a] += t_acc[a];
  }

  if (active) {
    drho[static_cast<size_t>(c) * cap + i] = drho_acc;
#pragma unroll
    for (int a = 0; a < DIM; ++a) {
      acc[(static_cast<size_t>(c) * DIM + a) * cap + i] = acc_acc[a];
    }
  }
}

template <int DIM, typename RelT, typename RecT>
int launch(const void* rel, const void* shift, const void* v, const void* m,
           const void* inv_rho, const void* nb_ids, void* drho, void* acc, int c_rows,
           int cap, int n_nb, const ForceParams& p, cudaStream_t stream) {
  const int threads = ((cap + 31) / 32) * 32;
  const size_t smem = sizeof(float) * static_cast<size_t>(2 * DIM + 3) * cap;
  rcll_force_kernel<DIM, RelT, RecT><<<c_rows, threads, smem, stream>>>(
      static_cast<const RelT*>(rel), static_cast<const int16_t*>(shift),
      static_cast<const RecT*>(v), static_cast<const RecT*>(m),
      static_cast<const float*>(inv_rho), static_cast<const int*>(nb_ids),
      static_cast<float*>(drho), static_cast<float*>(acc), cap, n_nb, p);
  return static_cast<int>(cudaGetLastError());
}

template <int DIM, typename RelT>
int dispatch_rec(int rec_kind, const void* rel, const void* shift, const void* v,
                 const void* m, const void* inv_rho, const void* nb_ids, void* drho, void* acc,
                 int c_rows, int cap, int n_nb, const ForceParams& p, cudaStream_t s) {
  switch (rec_kind) {
    case 0:
      return launch<DIM, RelT, __half>(rel, shift, v, m, inv_rho, nb_ids, drho, acc, c_rows,
                                       cap, n_nb, p, s);
    case 1:
      return launch<DIM, RelT, __nv_bfloat16>(rel, shift, v, m, inv_rho, nb_ids, drho, acc,
                                              c_rows, cap, n_nb, p, s);
    case 2:
      return launch<DIM, RelT, float>(rel, shift, v, m, inv_rho, nb_ids, drho, acc, c_rows,
                                      cap, n_nb, p, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int DIM>
int dispatch_rel(int rel_kind, int rec_kind, const void* rel, const void* shift,
                 const void* v, const void* m, const void* inv_rho, const void* nb_ids,
                 void* drho, void* acc, int c_rows, int cap, int n_nb, const ForceParams& p,
                 cudaStream_t s) {
  if (rel_kind == 0)
    return dispatch_rec<DIM, __half>(rec_kind, rel, shift, v, m, inv_rho, nb_ids, drho, acc,
                                     c_rows, cap, n_nb, p, s);
  if (rel_kind == 1)
    return dispatch_rec<DIM, float>(rec_kind, rel, shift, v, m, inv_rho, nb_ids, drho, acc,
                                    c_rows, cap, n_nb, p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// rel_kind: 0 = fp16, 1 = fp32. rec_kind: 0 = fp16, 1 = bf16, 2 = fp32.
// fparams: hc[0..2], h, a_dw, eos_k, rho0, neg_gamma, reg, avc, two_mu, dk.
// iparams: eos_tait, has_av, has_dv, has_delta.
extern "C" int repro_rcll_force(int dim, int rel_kind, int rec_kind, const void* rel,
                                const void* shift, const void* v, const void* m,
                                const void* inv_rho, const void* nb_ids, void* drho, void* acc,
                                int c_rows, int cap, int n_nb, const float* fparams,
                                const int* iparams, void* stream) {
  if (cap < 1 || cap > 1024) return static_cast<int>(cudaErrorInvalidValue);
  ForceParams p;
  for (int a = 0; a < 3; ++a) p.hc[a] = fparams[a];
  p.h = fparams[3];
  p.a_dw = fparams[4];
  p.eos_k = fparams[5];
  p.rho0 = fparams[6];
  p.neg_gamma = fparams[7];
  p.reg = fparams[8];
  p.avc = fparams[9];
  p.two_mu = fparams[10];
  p.dk = fparams[11];
  p.eos_tait = iparams[0];
  p.has_av = iparams[1];
  p.has_dv = iparams[2];
  p.has_delta = iparams[3];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dim == 2)
    return dispatch_rel<2>(rel_kind, rec_kind, rel, shift, v, m, inv_rho, nb_ids, drho, acc,
                           c_rows, cap, n_nb, p, s);
  if (dim == 3)
    return dispatch_rel<3>(rel_kind, rec_kind, rel, shift, v, m, inv_rho, nb_ids, drho, acc,
                           c_rows, cap, n_nb, p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
