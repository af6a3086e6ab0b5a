// K7: blocked (flash) causal GQA attention for prefill.
//
// Replaces the Pallas kernel repro/kernels/flash_attention.py::flash_attention
// (_flash_kernel). out[b, h, i] = softmax_j(scale q_i . k_j) v_j over the keys
// of kv head h / (H / Hkv) (no repeated K/V), with the online softmax carried
// in fp32: per K/V tile the running max m, denominator l and accumulator are
// rescaled by exp(m_old - m_new), as in the TPU kernel. Causal masking keeps
// key j for query i when j <= i + (Lk - Lq) (the last query sees the last key;
// with Lq = Lk, as in prefill, the TPU kernel's rows >= cols). A fully masked
// row keeps m at -1e30 and l at 0 and writes 0 (the TPU kernel's guard).
// Rows and columns past Lq / Lk are masked, so any length works; K/V tiles
// that lie wholly above the diagonal are skipped (they add exp(-inf) = 0).
//
// Design: one block per (32-row query tile, b*H + h); 4 threads per query row
// (a quad), each owning Dh/4 of the row's dimensions in 16-byte groups, so a
// dot product is 4 partial sums joined by two quad shuffles and the P.V
// update needs no communication. K and V tiles of 32 keys are staged in
// shared memory as fp32 (converted once from bf16), read as float4 and
// broadcast to the 8 rows of a warp. fp32 FMA on the CUDA cores and the
// accurate expf (no fast math): no tensor cores yet.
//
// Bound on the H100: operations. The causal product is ~2 L^2 Dh H B flops
// (2.6e10 for llama3.2-3b at B 4, L 1024). With bf16 inputs the q.k half is
// bf16 products summed in fp32, which the bf16 tensor cores compute exactly
// (0.013 ms at 989 TFLOP/s), and the p.v half has fp32 weights (0.19 ms at
// the 67 TFLOP/s fp32 rate): 0.21 ms. The bytes (q, k, v in, out) take
// ~0.03 ms. This kernel does all of it on the CUDA cores in fp32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int BQ = 32;               // query rows per block
constexpr int LANES = 4;             // threads per query row
constexpr int BK = 32;               // keys per K/V tile
constexpr int THREADS = BQ * LANES;  // 128

struct FlashParams {
  float scale;
  int causal;
  int causal_shift;  // 0; a check plants 1 to let one future key in
};

struct Strides {  // element strides of a (B, heads, L, Dh) view; Dh stride 1
  long long b, h, l;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <int DH, typename T>
__global__ void __launch_bounds__(THREADS)
    flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 float* __restrict__ out, int H, int rep, int Lq, int Lk, Strides qs,
                 Strides ks, Strides vs, FlashParams p) {
  static_assert(DH % 16 == 0, "Dh must be a multiple of 16");
  constexpr int GROUPS = DH / 16;  // float4 groups per thread
  __shared__ __align__(16) float s_k[BK][DH];
  __shared__ __align__(16) float s_v[BK][DH];

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H, g = h / rep;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int i = q0 + tid / LANES;  // this thread's query row
  const int lane = tid % LANES;
  const bool row_ok = i < Lq;
  const int offset = Lk - Lq + p.causal_shift;  // key j is kept when j <= i + offset

  float qv[GROUPS][4], acc[GROUPS][4];
#pragma unroll
  for (int c = 0; c < GROUPS; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = 16 * c + 4 * lane + e;
      qv[c][e] = row_ok ? to_f32(q[b * qs.b + h * qs.h + i * qs.l + d]) : 0.0f;
      acc[c][e] = 0.0f;
    }
  }
  float m = NEG_INF, l = 0.0f;

  // tiles that hold a key some row of this block may see
  int last_key = Lk - 1;
  if (p.causal) last_key = min(last_key, q0 + BQ - 1 + offset);
  const int n_tiles = last_key < 0 ? 0 : last_key / BK + 1;

  const T* kb = k + b * ks.b + g * ks.h;
  const T* vb = v + b * vs.b + g * vs.h;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the previous tile is consumed
    for (int e = tid; e < BK * DH; e += THREADS) {
      const int j = e / DH, d = e % DH;
      const bool ok = k0 + j < Lk;
      s_k[j][d] = ok ? to_f32(kb[(k0 + j) * ks.l + d]) : 0.0f;
      s_v[j][d] = ok ? to_f32(vb[(k0 + j) * vs.l + d]) : 0.0f;
    }
    __syncthreads();

    float s[BK];
    float m_tile = NEG_INF;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      float part = 0.0f;
#pragma unroll
      for (int c = 0; c < GROUPS; ++c) {
        const float4 kk = *reinterpret_cast<const float4*>(&s_k[j][16 * c + 4 * lane]);
        part += qv[c][0] * kk.x + qv[c][1] * kk.y + qv[c][2] * kk.z + qv[c][3] * kk.w;
      }
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      const int col = k0 + j;
      const bool keep = row_ok && col < Lk && (!p.causal || col <= i + offset);
      s[j] = keep ? part * p.scale : NEG_INF;
      m_tile = fmaxf(m_tile, s[j]);
    }
    const float m_new = fmaxf(m, m_tile);
    const float corr = expf(m - m_new);
    float psum = 0.0f;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      s[j] = s[j] > NEG_INF / 2 ? expf(s[j] - m_new) : 0.0f;
      psum += s[j];
    }
    l = l * corr + psum;
#pragma unroll
    for (int c = 0; c < GROUPS; ++c) {
      float a[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int j = 0; j < BK; ++j) {
        const float4 vv = *reinterpret_cast<const float4*>(&s_v[j][16 * c + 4 * lane]);
        a[0] += s[j] * vv.x;
        a[1] += s[j] * vv.y;
        a[2] += s[j] * vv.z;
        a[3] += s[j] * vv.w;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c][e] = acc[c][e] * corr + a[e];
    }
    m = m_new;
  }

  if (!row_ok) return;
  const float inv_l = 1.0f / (l > 0.0f ? l : 1.0f);
  float* o = out + (static_cast<long long>(bh) * Lq + i) * DH;
#pragma unroll
  for (int c = 0; c < GROUPS; ++c) {
    float4 r;
    r.x = acc[c][0] * inv_l;
    r.y = acc[c][1] * inv_l;
    r.z = acc[c][2] * inv_l;
    r.w = acc[c][3] * inv_l;
    *reinterpret_cast<float4*>(o + 16 * c + 4 * lane) = r;
  }
}

template <int DH, typename T>
cudaError_t launch(const void* q, const void* k, const void* v, float* out, int B, int H,
                   int Hkv, int Lq, int Lk, const long long* st, FlashParams p,
                   cudaStream_t stream) {
  const dim3 grid((Lq + BQ - 1) / BQ, B * H);
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]}, vs{st[6], st[7], st[8]};
  flash_kernel<DH, T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), out, H,
      H / Hkv, Lq, Lk, qs, ks, vs, p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dh(int dh, const void* q, const void* k, const void* v, float* out, int B,
                        int H, int Hkv, int Lq, int Lk, const long long* st, FlashParams p,
                        cudaStream_t s) {
  switch (dh) {
    case 16: return launch<16, T>(q, k, v, out, B, H, Hkv, Lq, Lk, st, p, s);
    case 32: return launch<32, T>(q, k, v, out, B, H, Hkv, Lq, Lk, st, p, s);
    case 64: return launch<64, T>(q, k, v, out, B, H, Hkv, Lq, Lk, st, p, s);
    case 128: return launch<128, T>(q, k, v, out, B, H, Hkv, Lq, Lk, st, p, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 fp32, 1 bf16 (q, k and v alike). strides: q, k, v (b, head, l) each,
// in elements; out is contiguous (B, H, Lq, Dh) fp32. Returns cudaGetLastError().
extern "C" int repro_flash_attention(int dtype, int dh, const void* q, const void* k,
                                     const void* v, void* out, int B, int H, int Hkv, int Lq,
                                     int Lk, const long long* strides, const void* params,
                                     void* stream) {
  // the parameters travel as a pointer to their C struct (a ctypes.Structure):
  // a type of this file's unnamed namespace must not appear in a C signature
  const FlashParams p = *static_cast<const FlashParams*>(params);
  const auto s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  if (dtype == 0) return dispatch_dh<float>(dh, q, k, v, o, B, H, Hkv, Lq, Lk, strides, p, s);
  if (dtype == 1)
    return dispatch_dh<__nv_bfloat16>(dh, q, k, v, o, B, H, Hkv, Lq, Lk, strides, p, s);
  return cudaErrorInvalidValue;
}
