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
// For training, an optional output takes each row's logsumexp lse = m + log l
// (+inf for a row that sees no key), which the backward kernels
// (flash_attention_bwd.cu) recompute the weights from; serving passes null and
// the kernels' work and output are unchanged.
// Rows and columns past Lq / Lk are masked, so any length works; K/V tiles
// that lie wholly above the diagonal are skipped (they add exp(-inf) = 0).
// The output is fp32 (B, H, Lq, Dh), written once per row by one CTA: no
// atomics, the same bits on every launch.
//
// bf16 inputs (the serving path) take the tensor cores (namespace tc). One CTA
// per (b*H + h, 128-row query tile), the late (heavy) causal tiles launched
// first: two consumer warpgroups of 64 rows and one producer warp. The
// producer loads Q once and K/V tiles of 64 keys round a two-stage ring with
// TMA (tensor maps built per call in the C entry point, passed as
// __grid_constant__ parameters, so a launch replays in a CUDA graph; swizzled
// 128 B, or 64/32 B for Dh 32/16) and mbarriers. Per tile a consumer
// warpgroup computes S = Q K^T with wgmma m64n64k16 (bf16 x bf16 products are
// exact, summed in fp32), masks only diagonal and ragged tiles, and runs the
// online softmax in fp32 registers on the accumulator fragments with the
// accurate expf (no fast math). O += P V keeps P's fp32 weights: each weight
// is split exactly into three bf16 parts,
//   hi = bf16(p), mid = bf16(p - hi), lo = bf16(p - hi - mid),
// each subtraction exact in fp32, and 3 x 8 significand bits cover fp32's
// 24, so hi + mid + lo == p for every weight of at least 2^-110; below that lo falls under bf16's range
// and the error is at most 2^-134 absolute (tests/test_torch_lm_kernels.py
// holds the plain split, flash_attention.split_bf16x3, to both). V is bf16
// already, so three wgmma m64nDHk16 with A = P_hi, P_mid, P_lo from registers
// (the S accumulator fragment is the A fragment's layout, as in
// FlashAttention-3) and B = the V tile, MN-major, give exact products summed
// in fp32. Rounding P to bf16 once, as FlashAttention does, is another
// function (the check plants it as p_hi_only). A warpgroup runs S, the
// softmax and P V of a tile in turn; the two warpgroups overlap each other.
// Overlapping a tile's softmax with the previous tile's P V inside one
// warpgroup needs more registers than the 168 a thread of this CTA gets
// (ptxas then serializes the wgmmas; it measured slower, PERF.md PR 17).
// The barrier, TMA and wgmma helpers and the split live in hopper.cuh, shared
// with K7b.
//
// fp32 inputs keep the CUDA-core kernel (namespace simt): bf16 tensor cores
// cannot take fp32 q and k exactly. One block per (32-row query tile,
// b*H + h); 4 threads per query row, K/V tiles of 32 keys staged as fp32 in
// shared memory, fp32 FMA.
//
// Bound on the H100 (chip_smoke.py k7_work): operations. The causal product
// is 4 Dh operations per visible (query, key) pair, 2.58e10 for llama3.2-3b at
// B 4, H 24, L 1024. At fp32 accuracy on bf16 inputs q.k takes one bf16
// tensor-core pass and p.v three: 4 x 1.29e10 at 989 TFLOP/s = 0.052 ms. The
// bytes (q, k, v in, out in fp32) take 0.028 ms at 3.35 TB/s.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr float NEG_INF = -1e30f;

struct FlashParams {
  float scale;
  int causal;
  int causal_shift;  // 0; a check plants 1 to let one future key in
  int p_hi_only;     // 0; a check plants 1 to round P to bf16 once (bf16 path)
};

struct Strides {  // element strides of a (B, heads, L, Dh) view; Dh stride 1
  long long b, h, l;
};

// A row's logsumexp m + log l of its scaled scores, for the backward pass;
// +inf for a row that sees no key (l = 0), so exp(s - lse) is exactly 0.
__device__ __forceinline__ float row_lse(float m, float l) {
  return l > 0.0f ? m + logf(l) : __int_as_float(0x7f800000);
}

// --------------------------------------------------------------------------
// fp32 inputs: CUDA cores
// --------------------------------------------------------------------------
namespace simt {

constexpr int BQ = 32;               // query rows per block
constexpr int LANES = 4;             // threads per query row
constexpr int BK = 32;               // keys per K/V tile
constexpr int THREADS = BQ * LANES;  // 128

template <int DH>
__global__ void __launch_bounds__(THREADS)
    flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out, float* __restrict__ lse,
                 int H, int rep, int Lq, int Lk, Strides qs, Strides ks, Strides vs, FlashParams p) {
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
      qv[c][e] = row_ok ? q[b * qs.b + h * qs.h + i * qs.l + d] : 0.0f;
      acc[c][e] = 0.0f;
    }
  }
  float m = NEG_INF, l = 0.0f;

  // tiles that hold a key some row of this block may see
  int last_key = Lk - 1;
  if (p.causal) last_key = min(last_key, q0 + BQ - 1 + offset);
  const int n_tiles = last_key < 0 ? 0 : last_key / BK + 1;

  const float* kb = k + b * ks.b + g * ks.h;
  const float* vb = v + b * vs.b + g * vs.h;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the previous tile is consumed
    for (int e = tid; e < BK * DH; e += THREADS) {
      const int j = e / DH, d = e % DH;
      const bool ok = k0 + j < Lk;
      s_k[j][d] = ok ? kb[(k0 + j) * ks.l + d] : 0.0f;
      s_v[j][d] = ok ? vb[(k0 + j) * vs.l + d] : 0.0f;
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
  if (lse != nullptr && lane == 0) lse[static_cast<long long>(bh) * Lq + i] = row_lse(m, l);
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

template <int DH>
cudaError_t launch(const void* q, const void* k, const void* v, float* out, float* lse, int B,
                   int H, int Hkv, int Lq, int Lk, const long long* st, FlashParams p,
                   cudaStream_t stream) {
  const dim3 grid((Lq + BQ - 1) / BQ, B * H);
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]}, vs{st[6], st[7], st[8]};
  flash_kernel<DH><<<grid, THREADS, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      out, lse, H, H / Hkv, Lq, Lk, qs, ks, vs, p);
  return cudaGetLastError();
}

}  // namespace simt

// --------------------------------------------------------------------------
// bf16 inputs: TMA, mbarriers and wgmma
// --------------------------------------------------------------------------
namespace tc {

using namespace hopper;

constexpr int BQ = 128;                   // query rows per CTA
constexpr int WG_ROWS = 64;               // query rows per consumer warpgroup
constexpr int BK = 64;                    // keys per K/V tile
constexpr int STAGES = 2;                 // K/V ring depth
constexpr int CONSUMERS = 2 * 128;        // two consumer warpgroups
constexpr int THREADS = CONSUMERS + 32;   // and one producer warp

template <int DH>
struct Tile : Swizzle<DH> {  // SW, SWE, NCB, KPB, LAYOUT (hopper.cuh)
  static constexpr int Q_BYTES = BQ * DH * 2;
  static constexpr int KV_BYTES = BK * DH * 2;  // one of K, V
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;
  static constexpr int BAR_BYTES = (2 * STAGES + 1) * 8;
  // 1024 of slack to align the tiles to the 128 B swizzle's 1024 B period
  static constexpr int SMEM = 1024 + Q_BYTES + STAGES * STAGE_BYTES + BAR_BYTES;
};

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Key tiles that hold a key some row of [row_lo, row_end) may see.
__device__ __forceinline__ int tiles_for(int row_lo, int row_end, int Lk, int offset,
                                         const FlashParams& p) {
  if (row_lo >= row_end) return 0;
  int last = Lk - 1;
  if (p.causal) last = min(last, row_end - 1 + offset);
  return last < 0 ? 0 : last / BK + 1;
}

struct Rows {
  int r0, r1, cq;  // this thread's rows and first column in each 8-column group
  float m0, m1, l0, l1;
};

// Scale and mask one tile's scores in place, fold them into the row state
// (m, l) of rows r0 and r1 and leave exp(s - m_new) in sc; returns the
// rescale factors of the two rows' accumulators. Only diagonal and ragged
// tiles pay for the mask.
__device__ __forceinline__ float2 online_softmax(float (&sc)[BK / 2], Rows& r, int k0, int row_lo,
                                                 int Lq, int Lk, int offset,
                                                 const FlashParams& p) {
  const bool edge =
      k0 + BK > Lk || row_lo + WG_ROWS > Lq || (p.causal && k0 + BK - 1 > row_lo + offset);
  float mt0 = NEG_INF, mt1 = NEG_INF;
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    float x = sc[i] * p.scale;
    if (edge) {
      const int row = (i & 2) ? r.r1 : r.r0;
      const int col = k0 + 8 * (i / 4) + r.cq + (i & 1);
      const bool keep = col < Lk && row < Lq && (!p.causal || col <= row + offset);
      if (!keep) x = NEG_INF;
    }
    sc[i] = x;
    if (i & 2) mt1 = fmaxf(mt1, x);
    else mt0 = fmaxf(mt0, x);
  }
  const float mn0 = fmaxf(r.m0, quad_max(mt0)), mn1 = fmaxf(r.m1, quad_max(mt1));
  const float2 corr = make_float2(expf(r.m0 - mn0), expf(r.m1 - mn1));
  float ps0 = 0.0f, ps1 = 0.0f;
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    const float e = sc[i] > NEG_INF / 2 ? expf(sc[i] - ((i & 2) ? mn1 : mn0)) : 0.0f;
    sc[i] = e;
    if (i & 2) ps1 += e;
    else ps0 += e;
  }
  r.l0 = r.l0 * corr.x + quad_sum(ps0);
  r.l1 = r.l1 * corr.y + quad_sum(ps1);
  r.m0 = mn0;
  r.m1 = mn1;
  return corr;
}

template <int DH>
__global__ void __launch_bounds__(THREADS, 1)
    flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv, float* __restrict__ out,
                       float* __restrict__ lse, int H, int rep, int Lq, int Lk, FlashParams p) {
  using T = Tile<DH>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sq = (smem_u32(smem_raw) + 1023u) & ~1023u;  // Q: NCB boxes of BQ rows
  const uint32_t skv = sq + T::Q_BYTES;                      // stage s: K boxes, then V boxes
  const uint32_t bars = skv + STAGES * T::STAGE_BYTES;       // full[STAGES], empty[STAGES], q
  const uint32_t qbar = bars + 16 * STAGES;
  auto full = [&](int t) { return bars + 8 * (t % STAGES); };
  auto empty = [&](int t) { return bars + 8 * (STAGES + t % STAGES); };
  auto k_tile = [&](int t) { return skv + (t % STAGES) * T::STAGE_BYTES; };
  auto parity = [](int t) { return static_cast<uint32_t>((t / STAGES) & 1); };

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H, g = h / rep;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // the heavy causal tiles first
  const int offset = Lk - Lq + p.causal_shift;        // key j is kept when j <= i + offset
  const int n_tiles = tiles_for(q0, min(q0 + BQ, Lq), Lk, offset, p);
  const int tid = threadIdx.x;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), CONSUMERS);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {  // the producer warp: one thread issues every load
    if (tid == CONSUMERS && n_tiles > 0) {
      mbar_expect_tx(qbar, T::Q_BYTES);
#pragma unroll
      for (int c = 0; c < T::NCB; ++c)
        tma_load(sq + c * BQ * T::SW, &tq, qbar, c * T::SWE, q0, h, b);
      for (int t = 0; t < n_tiles; ++t) {
        if (t >= STAGES) mbar_wait(empty(t), parity(t) ^ 1);  // tile t - STAGES consumed
        mbar_expect_tx(full(t), T::STAGE_BYTES);
#pragma unroll
        for (int c = 0; c < T::NCB; ++c) {
          tma_load(k_tile(t) + c * BK * T::SW, &tk, full(t), c * T::SWE, t * BK, g, b);
          tma_load(k_tile(t) + T::KV_BYTES + c * BK * T::SW, &tv, full(t), c * T::SWE, t * BK,
                   g, b);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns query rows [row_lo, row_lo + 64); this thread
  // holds rows r0 and r0 + 8 and, in each 8-column group, columns cq and cq + 1
  const int wg = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
  const int row_lo = q0 + WG_ROWS * wg;
  Rows r{row_lo + 16 * warp + lane / 4, row_lo + 16 * warp + lane / 4 + 8, 2 * (lane % 4),
         NEG_INF, NEG_INF, 0.0f, 0.0f};
  const int my_tiles = tiles_for(row_lo, min(row_lo + WG_ROWS, Lq), Lk, offset, p);
  const uint32_t qa = sq + WG_ROWS * wg * T::SW;

  float o[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) o[i] = 0.0f;
  if (my_tiles > 0) mbar_wait(qbar, 0);
  for (int t = 0; t < n_tiles; ++t) {
    mbar_wait(full(t), parity(t));
    if (t < my_tiles) {  // uniform across the warpgroup
      float sc[BK / 2];
      uint32_t pa[3][BK / 16][4];
      wgmma_fence();
      issue_ss<DH>(sc, qa, BQ, k_tile(t), BK, false);  // S = Q K^T
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);
      const float2 corr = online_softmax(sc, r, t * BK, row_lo, Lq, Lk, offset, p);
#pragma unroll
      for (int i = 0; i < DH / 2; ++i) o[i] *= (i & 2) ? corr.y : corr.x;
      split_frag(sc, pa);
      fence_regs(o);
      wgmma_fence();
      issue_split<DH>(o, pa, k_tile(t) + T::KV_BYTES, BK, p.p_hi_only);  // O += P V
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(o);
    }
    mbar_arrive(empty(t));  // this thread is done with tile t's stage
  }

  if (lse != nullptr && lane % 4 == 0) {  // l is quad-reduced: one lane of each quad writes
    if (r.r0 < Lq) lse[static_cast<long long>(bh) * Lq + r.r0] = row_lse(r.m0, r.l0);
    if (r.r1 < Lq) lse[static_cast<long long>(bh) * Lq + r.r1] = row_lse(r.m1, r.l1);
  }
  const float inv0 = 1.0f / (r.l0 > 0.0f ? r.l0 : 1.0f), inv1 = 1.0f / (r.l1 > 0.0f ? r.l1 : 1.0f);
  float* ob = out + static_cast<long long>(bh) * Lq * DH;
#pragma unroll
  for (int i = 0; i < DH / 2; i += 2) {
    const int row = (i & 2) ? r.r1 : r.r0;
    if (row >= Lq) continue;
    const float inv = (i & 2) ? inv1 : inv0;
    *reinterpret_cast<float2*>(ob + static_cast<long long>(row) * DH + 8 * (i / 4) + r.cq) =
        make_float2(o[i] * inv, o[i + 1] * inv);
  }
}

template <int DH>
cudaError_t launch(const void* q, const void* k, const void* v, float* out, float* lse, int B,
                   int H, int Hkv, int Lq, int Lk, const long long* st, FlashParams p,
                   cudaStream_t stream) {
  using T = Tile<DH>;
  CUtensorMap tq, tk, tv;
  if (!make_map<DH>(&tq, q, Lq, H, B, st, BQ) || !make_map<DH>(&tk, k, Lk, Hkv, B, st + 3, BK) ||
      !make_map<DH>(&tv, v, Lk, Hkv, B, st + 6, BK))
    return cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_wgmma_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (Lq + BQ - 1) / BQ);
  flash_wgmma_kernel<DH><<<grid, THREADS, T::SMEM, stream>>>(tq, tk, tv, out, lse, H, H / Hkv, Lq,
                                                              Lk, p);
  return cudaGetLastError();
}

}  // namespace tc

template <typename Launch>
cudaError_t dispatch_dh(int dh, Launch&& launch) {
  switch (dh) {
    case 16: return launch(std::integral_constant<int, 16>{});
    case 32: return launch(std::integral_constant<int, 32>{});
    case 64: return launch(std::integral_constant<int, 64>{});
    case 128: return launch(std::integral_constant<int, 128>{});
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 fp32 (CUDA cores), 1 bf16 (tensor cores) (q, k and v alike). strides:
// q, k, v (b, head, l) each, in elements; for bf16 the base addresses must be
// 16-byte aligned and the strides multiples of 8 (TMA). out is contiguous
// (B, H, Lq, Dh) fp32; lse, when not null, contiguous (B, H, Lq) fp32 (each
// row's m + log l, for the backward pass; serving passes null). Returns
// cudaGetLastError() (or the refusal's error).
extern "C" int repro_flash_attention(int dtype, int dh, const void* q, const void* k,
                                     const void* v, void* out, void* lse, int B, int H, int Hkv,
                                     int Lq, int Lk, const long long* strides, const void* params,
                                     void* stream) {
  // the parameters travel as a pointer to their C struct (a ctypes.Structure):
  // a type of this file's unnamed namespace must not appear in a C signature
  const FlashParams p = *static_cast<const FlashParams*>(params);
  const auto s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  float* ls = static_cast<float*>(lse);
  if (dtype == 0)
    return dispatch_dh(dh, [&](auto d) {
      return simt::launch<decltype(d)::value>(q, k, v, o, ls, B, H, Hkv, Lq, Lk, strides, p, s);
    });
  if (dtype == 1)
    return dispatch_dh(dh, [&](auto d) {
      return tc::launch<decltype(d)::value>(q, k, v, o, ls, B, H, Hkv, Lq, Lk, strides, p, s);
    });
  return cudaErrorInvalidValue;
}
