// K6: one-token GQA decode attention over the RCLL-KV cache.
//
// Replaces the Pallas kernel repro/kernels/rcll_kv_attention.py::rcll_kv_decode
// (_decode_kernel). The cache holds each 128-token block of K and V as
//   kv = anchor (fp32, per block and dim) + scale (fp32) * residual,
// the residual int8 (levels times 1/127), fp16 or bf16. For each kv head the
// `rep` query heads that share it attend over the blocks below length[b]:
// keys are dequantized in registers (never written back), scores scaled, the
// ragged last block masked, and the softmax carried online in fp32 across
// blocks (m, l and the accumulator rescaled by exp(m_old - m_new)). Besides
// out = acc / l it writes each row's final m and l, which the TPU kernel
// keeps in scratch, so the caller can merge another part of the keys (the
// open fp32 tail block) exactly. A row with length 0 gives m = -1e30, l = 0
// and out = 0.
//
// Design: one block per (b, kv head), 128 threads. Per cache block: the K
// residual tile is dequantized by all threads at once into shared memory as
// fp32 (rows padded by one float, so a thread per key reads them without bank
// conflicts) and the V residual tile is staged raw (16-byte loads where the
// layout allows); then one thread per key computes its rep scores against the
// query rows (broadcast from shared memory), one warp per query row takes the
// block's max, weights and sum, and one thread per dim runs P.V. All loads of
// a tile are in flight together; no warp waits on one dependent load per key.
// Dequantization rounds the product and the sum separately (no FMA
// contraction), so keys and values equal the plain version's bit for bit.
// Every tensor comes with element strides, so the model passes permuted views
// of its (B, nblk, blk, Hkv, Dh) cache, no copy.
//
// Bound on the H100: bytes. One decode step of llama3.2-3b (B 4, 8 kv heads,
// 9 closed blocks of 128 x 128, int8) streams ~9.4 MB of residuals and
// ~0.15 MB of anchors and scales: ~3 us at 3.35 TB/s. At B * Hkv = 32 blocks
// on 132 SMs a block per (b, kv head) cannot reach it; splitting the keys
// across blocks (a second pass merging (m, l)) is later work.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_REP = 8;
constexpr int MAX_DH = 128;

struct KvParams {
  float scale;
  float inv_levels;  // 1/127: int8 residual levels (a check can plant 1/128)
  int len_shift_blocks;  // 0; a check plants -1 (a length mask one block short)
};

struct KvStrides {  // element strides (b, head, block, row, dim) of
  long long s[6][5];  // k_resid, k_anchor, k_scale, v_resid, v_anchor, v_scale
};

__device__ __forceinline__ float resid_f32(int8_t r, float inv) {
  return __fmul_rn(static_cast<float>(r), inv);
}
__device__ __forceinline__ float resid_f32(__half r, float) { return __half2float(r); }
__device__ __forceinline__ float resid_f32(__nv_bfloat16 r, float) {
  return __bfloat162float(r);
}

__device__ __forceinline__ long long off(const long long* s, int b, int g, int n, int t, int d) {
  return b * s[0] + g * s[1] + n * s[2] + t * s[3] + d * s[4];
}

// Shared-memory layout of one launch, in bytes from the base (16-aligned).
struct Smem {
  size_t k, v, q, anchor, p, total;
};

__host__ __device__ __forceinline__ size_t up16(size_t x) { return (x + 15) / 16 * 16; }

template <typename R>
__host__ __device__ __forceinline__ Smem smem_layout(int rep, int blk, int dh) {
  Smem m;
  m.k = 0;                                                   // fp32 [blk][dh + 1]
  m.v = up16(m.k + sizeof(float) * blk * (dh + 1));            // R [blk][dh]
  m.q = up16(m.v + sizeof(R) * blk * dh);                      // fp32 [rep][dh]
  m.anchor = up16(m.q + sizeof(float) * rep * dh);             // fp32 [2][dh]
  m.p = up16(m.anchor + sizeof(float) * 2 * dh);               // fp32 [rep][blk] + 3 [rep]
  m.total = up16(m.p + sizeof(float) * (rep * blk + 3 * rep));
  return m;
}

template <typename R>
__global__ void __launch_bounds__(THREADS)
    kv_decode_kernel(const float* __restrict__ q, const R* __restrict__ kr,
                     const float* __restrict__ ka, const float* __restrict__ ks,
                     const R* __restrict__ vr, const float* __restrict__ va,
                     const float* __restrict__ vs, const int* __restrict__ length,
                     float* __restrict__ out, float* __restrict__ m_out,
                     float* __restrict__ l_out, int hkv, int rep, int nblk, int blk, int dh,
                     KvStrides st, KvParams p, int vec_k, int vec_v) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem lay = smem_layout<R>(rep, blk, dh);
  float* s_k = reinterpret_cast<float*>(smem_raw + lay.k);   // dequantized keys
  R* s_vr = reinterpret_cast<R*>(smem_raw + lay.v);          // raw V residuals
  float* s_q = reinterpret_cast<float*>(smem_raw + lay.q);
  float* s_kan = reinterpret_cast<float*>(smem_raw + lay.anchor);
  float* s_ksc = s_kan + dh;
  float* s_p = reinterpret_cast<float*>(smem_raw + lay.p);   // scores, then weights
  float* s_corr = s_p + rep * blk;
  float* s_m = s_corr + rep;
  float* s_l = s_m + rep;
  const int kstride = dh + 1;

  const int b = blockIdx.x / hkv, g = blockIdx.x % hkv;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int H = hkv * rep;
  const int len = min(max(length[b] + p.len_shift_blocks * blk, 0), nblk * blk);
  const int n_used = (len + blk - 1) / blk;
  const long long row0 = static_cast<long long>(b) * H + g * rep;

  for (int e = tid; e < rep * dh; e += THREADS) s_q[e] = q[row0 * dh + e];
  if (tid < rep) {
    s_m[tid] = NEG_INF;
    s_l[tid] = 0.0f;
  }
  float acc[MAX_REP];
#pragma unroll
  for (int r = 0; r < MAX_REP; ++r) acc[r] = 0.0f;

  for (int ib = 0; ib < n_used; ++ib) {
    float van = 0.0f, vsc = 0.0f;
    if (tid < dh) {
      s_kan[tid] = ka[off(st.s[1], b, g, ib, 0, tid)];
      s_ksc[tid] = ks[off(st.s[2], b, g, ib, 0, tid)];
      van = va[off(st.s[4], b, g, ib, 0, tid)];
      vsc = vs[off(st.s[5], b, g, ib, 0, tid)];
    }
    // raw V rows, whole 16-byte chunks where the layout allows
    if (vec_v) {
      const int per_row = dh * static_cast<int>(sizeof(R)) / 16;
      for (int c = tid; c < blk * per_row; c += THREADS) {
        const int t = c / per_row, w = c % per_row;
        reinterpret_cast<uint4*>(s_vr + t * dh)[w] =
            reinterpret_cast<const uint4*>(vr + off(st.s[3], b, g, ib, t, 0))[w];
      }
    } else {
      for (int e = tid; e < blk * dh; e += THREADS)
        s_vr[e] = vr[off(st.s[3], b, g, ib, e / dh, e % dh)];
    }
    __syncthreads();  // the anchors and scales are in place

    // dequantized keys, 16 bytes of residuals a thread at a time where allowed
    if (vec_k) {
      constexpr int N = 16 / sizeof(R);
      const int per_row = dh / N;
      for (int c = tid; c < blk * per_row; c += THREADS) {
        const int t = c / per_row, d0 = (c % per_row) * N;
        const uint4 raw =
            reinterpret_cast<const uint4*>(kr + off(st.s[0], b, g, ib, t, 0))[c % per_row];
        const R* rr = reinterpret_cast<const R*>(&raw);
#pragma unroll
        for (int j = 0; j < N; ++j)
          s_k[t * kstride + d0 + j] = __fadd_rn(
              s_kan[d0 + j], __fmul_rn(s_ksc[d0 + j], resid_f32(rr[j], p.inv_levels)));
      }
    } else {
      for (int e = tid; e < blk * dh; e += THREADS) {
        const int t = e / dh, d = e % dh;
        s_k[t * kstride + d] = __fadd_rn(
            s_kan[d], __fmul_rn(s_ksc[d], resid_f32(kr[off(st.s[0], b, g, ib, t, d)],
                                                    p.inv_levels)));
      }
    }
    __syncthreads();

    // scores: one thread per key
    for (int t = tid; t < blk; t += THREADS) {
      float part[MAX_REP];
#pragma unroll
      for (int r = 0; r < MAX_REP; ++r) part[r] = 0.0f;
      const float* krow = s_k + t * kstride;
#pragma unroll 4
      for (int d = 0; d < dh; ++d) {
        const float kval = krow[d];
#pragma unroll
        for (int r = 0; r < MAX_REP; ++r)
          if (r < rep) part[r] += s_q[r * dh + d] * kval;
      }
      const bool keep = ib * blk + t < len;
#pragma unroll
      for (int r = 0; r < MAX_REP; ++r)
        if (r < rep) s_p[r * blk + t] = keep ? part[r] * p.scale : NEG_INF;
    }
    __syncthreads();

    // the block's max, weights and sum: one warp per query row
    for (int r = warp; r < rep; r += WARPS) {
      float mx = NEG_INF;
      for (int t = lane; t < blk; t += 32) mx = fmaxf(mx, s_p[r * blk + t]);
#pragma unroll
      for (int o = 16; o > 0; o /= 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = s_m[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.0f;
      for (int t = lane; t < blk; t += 32) {
        const float sc = s_p[r * blk + t];
        const float w = sc > NEG_INF / 2 ? expf(sc - m_new) : 0.0f;
        s_p[r * blk + t] = w;
        sum += w;
      }
#pragma unroll
      for (int o = 16; o > 0; o /= 2) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        s_corr[r] = corr;
        s_l[r] = s_l[r] * corr + sum;
        s_m[r] = m_new;
      }
    }
    __syncthreads();

    // P.V: one thread per dim
    if (tid < dh) {
#pragma unroll
      for (int r = 0; r < MAX_REP; ++r)
        if (r < rep) acc[r] *= s_corr[r];
#pragma unroll 4
      for (int t = 0; t < blk; ++t) {
        const float vval =
            __fadd_rn(van, __fmul_rn(vsc, resid_f32(s_vr[t * dh + tid], p.inv_levels)));
#pragma unroll
        for (int r = 0; r < MAX_REP; ++r)
          if (r < rep) acc[r] += s_p[r * blk + t] * vval;
      }
    }
    __syncthreads();  // the tiles and s_p are rewritten for the next block
  }

  __syncthreads();  // s_m and s_l are final (also when no block was used)
  if (tid < dh) {
#pragma unroll
    for (int r = 0; r < MAX_REP; ++r) {
      if (r < rep) {
        const float l = s_l[r];
        out[(row0 + r) * dh + tid] = acc[r] / (l > 0.0f ? l : 1.0f);
      }
    }
  }
  if (tid < rep) {
    m_out[row0 + tid] = s_m[tid];
    l_out[row0 + tid] = s_l[tid];
  }
}

template <typename R>
bool rows_vectorizable(const void* base, const long long* s, int dh) {
  const long long w = 16 / static_cast<long long>(sizeof(R));  // elements per 16 bytes
  return reinterpret_cast<uintptr_t>(base) % 16 == 0 && s[4] == 1 && dh % w == 0 &&
         s[0] % w == 0 && s[1] % w == 0 && s[2] % w == 0 && s[3] % w == 0;
}

template <typename R>
cudaError_t launch(const void* q, const void* kr, const void* ka, const void* ks, const void* vr,
                   const void* va, const void* vs, const int* length, float* out, float* m,
                   float* l, int B, int hkv, int rep, int nblk, int blk, int dh,
                   const KvStrides& st, KvParams p, cudaStream_t stream) {
  const size_t smem = smem_layout<R>(rep, blk, dh).total;
  cudaError_t err = cudaFuncSetAttribute(kv_decode_kernel<R>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kv_decode_kernel<R><<<B * hkv, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const R*>(kr), static_cast<const float*>(ka),
      static_cast<const float*>(ks), static_cast<const R*>(vr), static_cast<const float*>(va),
      static_cast<const float*>(vs), length, out, m, l, hkv, rep, nblk, blk, dh, st, p,
      rows_vectorizable<R>(kr, st.s[0], dh), rows_vectorizable<R>(vr, st.s[3], dh));
  return cudaGetLastError();
}

}  // namespace

// resid_kind: 0 int8, 1 fp16, 2 bf16. q (B, H, Dh) fp32 contiguous; out
// (B, H, Dh), m and l (B, H) fp32 contiguous; strides: 6 x 5 element strides
// of k_resid, k_anchor, k_scale, v_resid, v_anchor, v_scale, each viewed as
// (B, Hkv, nblk, rows, Dh). Returns cudaGetLastError().
extern "C" int repro_rcll_kv_decode(int resid_kind, const void* q, const void* kr,
                                    const void* ka, const void* ks, const void* vr,
                                    const void* va, const void* vs, const void* length,
                                    void* out, void* m, void* l, int B, int hkv, int rep,
                                    int nblk, int blk, int dh, const long long* strides,
                                    const void* params, void* stream) {
  // the parameters travel as a pointer to their C struct (a ctypes.Structure):
  // a type of this file's unnamed namespace must not appear in a C signature
  const KvParams p = *static_cast<const KvParams*>(params);
  if (rep > MAX_REP || dh > MAX_DH) return cudaErrorInvalidValue;
  KvStrides st;
  for (int i = 0; i < 6; ++i)
    for (int j = 0; j < 5; ++j) st.s[i][j] = strides[5 * i + j];
  const auto s = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(length);
  float* o = static_cast<float*>(out);
  float* mo = static_cast<float*>(m);
  float* lo = static_cast<float*>(l);
  switch (resid_kind) {
    case 0:
      return launch<int8_t>(q, kr, ka, ks, vr, va, vs, len, o, mo, lo, B, hkv, rep, nblk, blk,
                            dh, st, p, s);
    case 1:
      return launch<__half>(q, kr, ka, ks, vr, va, vs, len, o, mo, lo, B, hkv, rep, nblk, blk,
                            dh, st, p, s);
    case 2:
      return launch<__nv_bfloat16>(q, kr, ka, ks, vr, va, vs, len, o, mo, lo, B, hkv, rep,
                                   nblk, blk, dh, st, p, s);
    default:
      return cudaErrorInvalidValue;
  }
}
