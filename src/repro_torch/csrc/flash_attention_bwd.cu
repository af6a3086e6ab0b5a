// K7b: the gradient of K7 (flash attention) for training.
//
// The JAX package trains through XLA's autodiff of its plain attention
// (sdpa_chunked); no Pallas kernel computes this. Given K7's inputs q (B, H,
// Lq, Dh) and k, v (B, Hkv, Lk, Dh) (fp32 or bf16, strided views with a unit
// Dh stride), its fp32 output O, each row's logsumexp lse = m + log l that
// K7's forward wrote (+inf for a row that sees no key) and the gradient dO of
// O (fp32, contiguous), it computes in fp32
//   D_i   = sum_d dO_id O_id
//   P_ij  = exp(scale q_i . k_j - lse_i)               (0 for a masked pair)
//   dV_j  = sum_i P_ij dO_i
//   dS_ij = P_ij (dO_i . v_j - D_i)
//   dQ_i  = scale sum_j dS_ij k_j
//   dK_j  = scale sum_i dS_ij q_i
// with K7's mask: key j is seen by query i when j <= i + (Lk - Lq) (causal),
// rows and columns past Lq / Lk masked. dK and dV of a kv head sum over the
// rep = H / Hkv query heads of its group. Outputs are contiguous fp32.
//
// Two launches, CUDA cores, fp32 FMA, no atomics, every sum in one fixed
// order (the same bits on every launch):
//   dq_kernel:   one block per (32-row query tile, b*H + h), 4 threads a row;
//                D_i first (written out for the second kernel), then the key
//                tiles of 32 staged in shared memory, up to the causal edge.
//   dkdv_kernel: one block per (32-key tile, b*Hkv + g), 4 threads a key; it
//                walks the group's query heads in order and, for each, the
//                query tiles of 32 (q, dO, lse and D staged) from the first
//                row that sees a key of the tile.
// Each pair's q.k and dO.v are computed in both kernels (14 Dh operations a
// visible pair against the 10 Dh of the function): a first design, right and
// simple; tensor cores (wgmma) and TMA come later.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

struct BwdParams {
  float scale;
  int causal;
  int causal_shift;     // 0; a check plants 1 to let one future key in
  int first_head_only;  // 0; a check plants 1: dK/dV take only the group's first head
  int d_from_do;        // 0; a check plants 1: D_i = sum_d dO_id, O left out
};

struct Strides {  // element strides of a (B, heads, L, Dh) view; Dh stride 1
  long long b, h, l;
};

constexpr int LANES = 4;              // threads per query row / key
constexpr int ROWS = 32;              // rows (queries or keys) per block
constexpr int TILE = 32;              // staged rows of the other operand
constexpr int THREADS = ROWS * LANES;  // 128

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// This thread's Dh / 4 elements of row ``r`` (columns 16 c + 4 lane + e).
template <typename T, int DH>
__device__ __forceinline__ void load_row(float (&dst)[DH / 16][4], const T* r, int lane, bool ok) {
#pragma unroll
  for (int c = 0; c < DH / 16; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) dst[c][e] = ok ? to_f(r[16 * c + 4 * lane + e]) : 0.0f;
}

// This thread's part of a . s_row (a row staged in shared memory).
template <int DH>
__device__ __forceinline__ float dot_part(const float (&a)[DH / 16][4], const float* s_row,
                                          int lane) {
  float part = 0.0f;
#pragma unroll
  for (int c = 0; c < DH / 16; ++c) {
    const float4 x = *reinterpret_cast<const float4*>(s_row + 16 * c + 4 * lane);
    part += a[c][0] * x.x + a[c][1] * x.y + a[c][2] * x.z + a[c][3] * x.w;
  }
  return part;
}

// acc += w * s_row on this thread's elements.
template <int DH>
__device__ __forceinline__ void axpy(float (&acc)[DH / 16][4], float w, const float* s_row,
                                     int lane) {
#pragma unroll
  for (int c = 0; c < DH / 16; ++c) {
    const float4 x = *reinterpret_cast<const float4*>(s_row + 16 * c + 4 * lane);
    acc[c][0] += w * x.x;
    acc[c][1] += w * x.y;
    acc[c][2] += w * x.z;
    acc[c][3] += w * x.w;
  }
}

template <int DH>
__device__ __forceinline__ void store_row(float* dst, const float (&acc)[DH / 16][4], float mul,
                                          int lane) {
#pragma unroll
  for (int c = 0; c < DH / 16; ++c) {
    float4 r;
    r.x = acc[c][0] * mul;
    r.y = acc[c][1] * mul;
    r.z = acc[c][2] * mul;
    r.w = acc[c][3] * mul;
    *reinterpret_cast<float4*>(dst + 16 * c + 4 * lane) = r;
  }
}

// dQ and D: one block per (query tile, b*H + h).
template <typename T, int DH>
__global__ void __launch_bounds__(THREADS)
    dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const float* __restrict__ o, const float* __restrict__ dout,
              const float* __restrict__ lse, float* __restrict__ dsum, float* __restrict__ dq,
              int H, int rep, int Lq, int Lk, Strides qs, Strides ks, Strides vs, BwdParams p) {
  static_assert(DH % 16 == 0, "Dh must be a multiple of 16");
  __shared__ __align__(16) float s_k[TILE][DH];
  __shared__ __align__(16) float s_v[TILE][DH];

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H, g = h / rep;
  const int q0 = blockIdx.x * ROWS;
  const int tid = threadIdx.x;
  const int i = q0 + tid / LANES;  // this thread's query row
  const int lane = tid % LANES;
  const bool row_ok = i < Lq;
  const int offset = Lk - Lq + p.causal_shift;  // key j is seen when j <= i + offset
  const long long row = static_cast<long long>(bh) * Lq + i;

  float qv[DH / 16][4], dov[DH / 16][4], acc[DH / 16][4];
  load_row<T, DH>(qv, q + b * qs.b + h * qs.h + static_cast<long long>(i) * qs.l, lane, row_ok);
  load_row<float, DH>(dov, dout + row * DH, lane, row_ok);
  load_row<float, DH>(acc, o + row * DH, lane, row_ok);  // O, for D; acc is zeroed below
  float d_part = 0.0f;
#pragma unroll
  for (int c = 0; c < DH / 16; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      d_part += p.d_from_do ? dov[c][e] : dov[c][e] * acc[c][e];
      acc[c][e] = 0.0f;
    }
  const float d_i = quad_sum(d_part);
  const float lse_i = row_ok ? lse[row] : 0.0f;
  if (row_ok && lane == 0) dsum[row] = d_i;

  int last_key = Lk - 1;
  if (p.causal) last_key = min(last_key, q0 + ROWS - 1 + offset);
  const int n_tiles = last_key < 0 ? 0 : last_key / TILE + 1;
  const T* kb = k + b * ks.b + g * ks.h;
  const T* vb = v + b * vs.b + g * vs.h;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * TILE;
    __syncthreads();  // the previous tile is consumed
    for (int e = tid; e < TILE * DH; e += THREADS) {
      const int j = e / DH, d = e % DH;
      const bool ok = k0 + j < Lk;
      s_k[j][d] = ok ? to_f(kb[static_cast<long long>(k0 + j) * ks.l + d]) : 0.0f;
      s_v[j][d] = ok ? to_f(vb[static_cast<long long>(k0 + j) * vs.l + d]) : 0.0f;
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < TILE; ++j) {
      const float s = quad_sum(dot_part<DH>(qv, s_k[j], lane));
      const float dp = quad_sum(dot_part<DH>(dov, s_v[j], lane));
      const int col = k0 + j;
      const bool keep = row_ok && col < Lk && (!p.causal || col <= i + offset);
      const float pij = keep ? expf(s * p.scale - lse_i) : 0.0f;
      axpy<DH>(acc, pij * (dp - d_i), s_k[j], lane);
    }
  }
  if (row_ok) store_row<DH>(dq + row * DH, acc, p.scale, lane);
}

// dK and dV: one block per (key tile, b*Hkv + g).
template <typename T, int DH>
__global__ void __launch_bounds__(THREADS)
    dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const float* __restrict__ dout, const float* __restrict__ lse,
                const float* __restrict__ dsum, float* __restrict__ dk, float* __restrict__ dv,
                int H, int Hkv, int Lq, int Lk, Strides qs, Strides ks, Strides vs,
                BwdParams p) {
  __shared__ __align__(16) float s_q[TILE][DH];
  __shared__ __align__(16) float s_do[TILE][DH];
  __shared__ float s_lse[TILE], s_d[TILE];

  const int rep = H / Hkv;
  const int bg = blockIdx.y;
  const int b = bg / Hkv, g = bg % Hkv;
  const int k0 = blockIdx.x * ROWS;
  const int tid = threadIdx.x;
  const int j = k0 + tid / LANES;  // this thread's key
  const int lane = tid % LANES;
  const bool col_ok = j < Lk;
  const int offset = Lk - Lq + p.causal_shift;

  float kv[DH / 16][4], vv[DH / 16][4], dk_acc[DH / 16][4], dv_acc[DH / 16][4];
  load_row<T, DH>(kv, k + b * ks.b + g * ks.h + static_cast<long long>(j) * ks.l, lane, col_ok);
  load_row<T, DH>(vv, v + b * vs.b + g * vs.h + static_cast<long long>(j) * vs.l, lane, col_ok);
#pragma unroll
  for (int c = 0; c < DH / 16; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[c][e] = dv_acc[c][e] = 0.0f;

  // the first query row that sees a key of this tile
  const int first_row = p.causal ? max(0, k0 - offset) : 0;
  const int heads = p.first_head_only ? 1 : rep;
  for (int r = 0; r < heads; ++r) {
    const int h = g * rep + r;
    const long long bh = static_cast<long long>(b) * H + h;
    const T* qb = q + b * qs.b + h * qs.h;
    for (int t0 = (first_row / TILE) * TILE; t0 < Lq; t0 += TILE) {
      __syncthreads();  // the previous tile is consumed
      for (int e = tid; e < TILE * DH; e += THREADS) {
        const int ii = e / DH, d = e % DH;
        const bool ok = t0 + ii < Lq;
        s_q[ii][d] = ok ? to_f(qb[static_cast<long long>(t0 + ii) * qs.l + d]) : 0.0f;
        s_do[ii][d] = ok ? dout[(bh * Lq + t0 + ii) * DH + d] : 0.0f;
      }
      if (tid < TILE) {
        const bool ok = t0 + tid < Lq;
        s_lse[tid] = ok ? lse[bh * Lq + t0 + tid] : 0.0f;
        s_d[tid] = ok ? dsum[bh * Lq + t0 + tid] : 0.0f;
      }
      __syncthreads();
#pragma unroll 4
      for (int ii = 0; ii < TILE; ++ii) {
        const int i = t0 + ii;
        const float s = quad_sum(dot_part<DH>(kv, s_q[ii], lane));
        const float dp = quad_sum(dot_part<DH>(vv, s_do[ii], lane));
        const bool keep = col_ok && i < Lq && (!p.causal || j <= i + offset);
        const float pij = keep ? expf(s * p.scale - s_lse[ii]) : 0.0f;
        axpy<DH>(dv_acc, pij, s_do[ii], lane);
        axpy<DH>(dk_acc, pij * (dp - s_d[ii]), s_q[ii], lane);
      }
    }
  }
  if (!col_ok) return;
  const long long row = static_cast<long long>(bg) * Lk + j;
  store_row<DH>(dk + row * DH, dk_acc, p.scale, lane);
  store_row<DH>(dv + row * DH, dv_acc, 1.0f, lane);
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* k, const void* v, const float* o,
                   const float* dout, const float* lse, float* dsum, float* dq, float* dk,
                   float* dv, int B, int H, int Hkv, int Lq, int Lk, const long long* st,
                   BwdParams p, cudaStream_t stream) {
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]}, vs{st[6], st[7], st[8]};
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  dq_kernel<T, DH><<<dim3((Lq + ROWS - 1) / ROWS, B * H), THREADS, 0, stream>>>(
      qt, kt, vt, o, dout, lse, dsum, dq, H, H / Hkv, Lq, Lk, qs, ks, vs, p);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dkdv_kernel<T, DH><<<dim3((Lk + ROWS - 1) / ROWS, B * Hkv), THREADS, 0, stream>>>(
      qt, kt, vt, dout, lse, dsum, dk, dv, H, Hkv, Lq, Lk, qs, ks, vs, p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dh(int dh, const void* q, const void* k, const void* v, const float* o,
                        const float* dout, const float* lse, float* dsum, float* dq, float* dk,
                        float* dv, int B, int H, int Hkv, int Lq, int Lk, const long long* st,
                        BwdParams p, cudaStream_t s) {
  switch (dh) {
    case 16: return launch<T, 16>(q, k, v, o, dout, lse, dsum, dq, dk, dv, B, H, Hkv, Lq, Lk, st, p, s);
    case 32: return launch<T, 32>(q, k, v, o, dout, lse, dsum, dq, dk, dv, B, H, Hkv, Lq, Lk, st, p, s);
    case 64: return launch<T, 64>(q, k, v, o, dout, lse, dsum, dq, dk, dv, B, H, Hkv, Lq, Lk, st, p, s);
    case 128: return launch<T, 128>(q, k, v, o, dout, lse, dsum, dq, dk, dv, B, H, Hkv, Lq, Lk, st, p, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 fp32, 1 bf16 (q, k and v alike); strides: q, k, v (b, head, l)
// each, in elements. o, dout: contiguous (B, H, Lq, Dh) fp32; lse and dsum
// (D, written here): contiguous (B, H, Lq) fp32; dq: contiguous (B, H, Lq, Dh)
// fp32; dk, dv: contiguous (B, Hkv, Lk, Dh) fp32. Lq, Lk >= 1. Returns
// cudaGetLastError() after the launches (or the refusal's error).
extern "C" int repro_flash_attention_bwd(int dtype, int dh, const void* q, const void* k,
                                         const void* v, const void* o, const void* dout,
                                         const void* lse, void* dsum, void* dq, void* dk,
                                         void* dv, int B, int H, int Hkv, int Lq, int Lk,
                                         const long long* strides, const void* params,
                                         void* stream) {
  const BwdParams p = *static_cast<const BwdParams*>(params);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto of = static_cast<const float*>(o);
  const auto df = static_cast<const float*>(dout);
  const auto lf = static_cast<const float*>(lse);
  const auto sf = static_cast<float*>(dsum);
  const auto qf = static_cast<float*>(dq);
  const auto kf = static_cast<float*>(dk);
  const auto vf = static_cast<float*>(dv);
  if (dtype == 0)
    return dispatch_dh<float>(dh, q, k, v, of, df, lf, sf, qf, kf, vf, B, H, Hkv, Lq, Lk,
                              strides, p, s);
  if (dtype == 1)
    return dispatch_dh<__nv_bfloat16>(dh, q, k, v, of, df, lf, sf, qf, kf, vf, B, H, Hkv, Lq, Lk,
                                      strides, p, s);
  return cudaErrorInvalidValue;
}
