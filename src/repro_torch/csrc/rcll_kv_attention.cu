// K6: one-token GQA decode attention over the RCLL-KV cache.
//
// Replaces the Pallas kernel repro/kernels/rcll_kv_attention.py::rcll_kv_decode
// (_decode_kernel). The cache holds each 128-token block of K and V as
//   kv = anchor (fp32, per block and dim) + scale (fp32) * residual,
// the residual int8 (levels times 1/127), fp16 or bf16. For each kv head the
// `rep` query heads that share it attend over the keys below length[b]:
// keys are dequantized on chip (never written back), scores scaled, the
// ragged last block masked, and the softmax taken in fp32. Besides
// out = acc / l it writes each row's m and l, which the TPU kernel keeps in
// scratch, so the caller can merge another part of the keys (the open fp32
// tail block) exactly. A row with length 0 gives m = -1e30, l = 0, out = 0.
//
// Bound on the H100: bytes. One decode step of llama3.2-3b (B 4, 8 kv heads,
// 9 closed blocks of 128 x 128, int8) reads ~9.4 MB of residuals and
// ~0.15 MB of anchors and scales: ~3 us at 3.35 TB/s; its ~7.5e7 fp32
// operations take ~1.1 us at 67 TFLOP/s. The TPU walks the blocks on a
// sequential grid axis; one block per (b, kv head) walking them in series
// gave 32 blocks on 132 SMs, each waiting out a round trip to device memory
// per cache block (0.1395 ms, 46x the bound).
//
// Design: the keys are split over CTAs, flash-decoding style, and a second
// kernel merges the splits; one wrapper call launches both on its stream and
// nothing lives from one call to the next, so a call replays in a CUDA graph.
//  Split kernel: one CTA of 128 threads per (cache block, b, kv head): 320
//  CTAs at the shapes above, all resident at once (~46 KB of shared memory
//  each), so the whole cache read is in flight together. A CTA whose block
//  lies at or past its row's length exits at once. A CTA:
//  1. issues its K residual tile and then its V tile as 16-byte
//     cp.async.cg copies into shared memory, in two commit groups (rows are
//     Hkv * Dh elements apart in the model's layout; K rows padded by 16
//     bytes so a thread per key reads them without bank conflicts), and
//     loads q and the block's anchors and scales meanwhile;
//  2. waits for K only: one thread per key dequantizes its row on the fly
//     and computes its `rep` scores (q broadcast from shared memory) while
//     V is still arriving; one warp per query row takes the block's max m_s,
//     weights exp(s - m_s) and sum l_s;
//  3. waits for V: each thread takes 4 dims of an interleaved quarter of the
//     keys (Dh = 128), the quarters are summed in order through shared
//     memory, and the CTA writes its partial (m_s, l_s, acc_s[rep][Dh]) to a
//     workspace.
//  Merge kernel: one thread per (b, head, dim) reads the partials of its row
//  in split order 0, 1, ... and takes merge_attention's formula,
//    m = max m_s, l = sum l_s exp(m_s - m), out = sum acc_s exp(m_s - m) / l,
//  writing out, m and l (a row with no keys gets m = -1e30, l = 0, out = 0).
//  The order does not depend on which CTA finished first: two launches on
//  the same inputs give the same bits. No atomic touches a sum.
// Layouts whose rows are not 16-byte aligned take plain loads into the same
// shared-memory tiles and one thread per dim in P.V. Dequantization rounds
// the product and the sum separately (no FMA contraction), so keys and
// values equal the plain version's bit for bit. The loops over the `rep`
// query rows are unrolled for rep 1-4 exactly (a template parameter), so no
// predicated-off row of an 8-row loop takes issue slots. Every tensor comes
// with element strides, so the model passes permuted views of its
// (B, nblk, blk, Hkv, Dh) cache, no copy. A CTA holds a whole cache block's
// K and V tiles: a block too large for shared memory is refused (the
// wrapper raises).
//
// No tensor cores: with rep = 3 query rows per kv head a wgmma tile of 64
// rows would be 95% padding, the scores and P.V are ~1 us of fp32 work, and
// fp32 keys keep the rounding the logit gate was read against. TMA would
// need a tensor map encoded on the host per layer and call, on a step that
// is already host-bound; cp.async needs none.
//
// Read on an H100 SXM at 700 W (chip_smoke.py phase 9, the served request's
// last decode step; PERF.md has the numbers): ~15.5 us a call in a CUDA
// graph, ~5x the bound, of which ~3 us is the two launches with no keys.
// The merge kernel costs ~0.8 us over merging in the last CTA of each
// (b, kv head) to arrive, which needs arrival counters that outlive a call
// (a replayed graph could find them stale). Half blocks a CTA (64 keys,
// 640 CTAs: more merging) were ~5% slower than whole blocks. Per CTA
// (clock64 stamps in an instrumented copy), the K tile lands after ~3.4 us
// (the whole grid's read at about the byte rate), then the scores and P.V
// take ~2.8 us each: with up to 3 CTAs an SM they are bound by issuing the
// dequantization and FMAs (~9 instructions a residual), not by latency;
// scoring K in 64-key groups as they land, two lanes a key, did not pay.
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
constexpr size_t SMEM_DEFAULT = 48 * 1024;  // above it a launch needs the attribute

struct KvParams {
  float scale;
  float inv_levels;  // 1/127: int8 residual levels (a check can plant 1/128)
  int len_shift_blocks;  // 0; a check plants -1 (a length mask one block short)
  int drop_last_split;   // 0; a check plants 1 (the merge skips the last split)
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

// anchor + scale * residual, the product and the sum rounded apart (dequant)
__device__ __forceinline__ float dequant_f(float anchor, float scale, float resid) {
  return __fadd_rn(anchor, __fmul_rn(scale, resid));
}
template <typename R>
__device__ __forceinline__ float dequant(float anchor, float scale, R r, float inv) {
  return dequant_f(anchor, scale, resid_f32(r, inv));
}

// Four consecutive residuals as fp32 (times 1/127 for int8), from 4 int8 in
// a word or 4 halves in two words.
__device__ __forceinline__ void resid4(const int8_t* p, float inv, float (&f)[4]) {
  const char4 c = *reinterpret_cast<const char4*>(p);
  f[0] = resid_f32(c.x, inv), f[1] = resid_f32(c.y, inv);
  f[2] = resid_f32(c.z, inv), f[3] = resid_f32(c.w, inv);
}
__device__ __forceinline__ void resid4(const __half* p, float, float (&f)[4]) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&w.x));
  const float2 b = __half22float2(*reinterpret_cast<const __half2*>(&w.y));
  f[0] = a.x, f[1] = a.y, f[2] = b.x, f[3] = b.y;
}
__device__ __forceinline__ void resid4(const __nv_bfloat16* p, float, float (&f)[4]) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w.y));
  f[0] = a.x, f[1] = a.y, f[2] = b.x, f[3] = b.y;
}

__device__ __forceinline__ long long off(const long long* s, int b, int g, int n, int t, int d) {
  return b * s[0] + g * s[1] + n * s[2] + t * s[3] + d * s[4];
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__host__ __device__ __forceinline__ size_t up16(size_t x) { return (x + 15) / 16 * 16; }

// Shared-memory layout of a split CTA, in bytes from the base (16-aligned).
struct Smem {
  size_t k, v, q, anchor, p, stats, red, total;
  int kpitch;  // elements of a K row: Dh and 16 bytes of padding
};

template <typename R>
__host__ __device__ __forceinline__ Smem smem_layout(int rep, int blk, int dh) {
  Smem m;
  m.kpitch = dh + 16 / static_cast<int>(sizeof(R));
  m.k = 0;                                                      // R [blk][kpitch]
  m.v = up16(m.k + sizeof(R) * blk * m.kpitch);                 // R [blk][dh]
  m.q = up16(m.v + sizeof(R) * blk * dh);                       // fp32 [rep][dh]
  m.anchor = up16(m.q + sizeof(float) * rep * dh);              // fp32 [4][dh]
  m.p = up16(m.anchor + sizeof(float) * 4 * dh);                // fp32 [rep][blk]
  m.stats = up16(m.p + sizeof(float) * rep * blk);              // fp32 [2][rep]
  m.red = up16(m.stats + sizeof(float) * 2 * rep);              // fp32 [key groups][rep][dh]
  m.total = up16(m.red + sizeof(float) * 4 * THREADS * rep);
  return m;
}

// Keys of batch b's rows that a launch attends over (the length, shifted by
// a planted fault, clamped to the cache).
__device__ __forceinline__ int row_keys(const int* length, int b, int nblk, int blk,
                                        const KvParams& p) {
  return min(max(length[b] + p.len_shift_blocks * blk, 0), nblk * blk);
}

// The rep scores of one key row (dequantized on the fly) against q.
template <typename R, bool VEC, int NR>
__device__ __forceinline__ void key_scores(const R* __restrict__ krow, const float* s_q,
                                           const float* s_kan, const float* s_ksc, int rep,
                                           int dh, float inv, float (&part)[NR]) {
  if constexpr (VEC) {
    constexpr int N = 16 / sizeof(R);  // residuals per 16 bytes
    for (int d0 = 0; d0 < dh; d0 += N) {
      const uint4 raw = *reinterpret_cast<const uint4*>(krow + d0);
      const R* rr = reinterpret_cast<const R*>(&raw);
#pragma unroll
      for (int j4 = 0; j4 < N / 4; ++j4) {
        const int d = d0 + 4 * j4;
        const float4 a = *reinterpret_cast<const float4*>(s_kan + d);
        const float4 c = *reinterpret_cast<const float4*>(s_ksc + d);
        float x[4];
        resid4(rr + 4 * j4, inv, x);
        const float k0 = dequant_f(a.x, c.x, x[0]);
        const float k1 = dequant_f(a.y, c.y, x[1]);
        const float k2 = dequant_f(a.z, c.z, x[2]);
        const float k3 = dequant_f(a.w, c.w, x[3]);
#pragma unroll
        for (int r = 0; r < NR; ++r) {
          if (r < rep) {
            const float4 qq = *reinterpret_cast<const float4*>(s_q + r * dh + d);
            part[r] += qq.x * k0;
            part[r] += qq.y * k1;
            part[r] += qq.z * k2;
            part[r] += qq.w * k3;
          }
        }
      }
    }
  } else {
    for (int d = 0; d < dh; ++d) {
      const float kval = dequant(s_kan[d], s_ksc[d], krow[d], inv);
#pragma unroll
      for (int r = 0; r < NR; ++r)
        if (r < rep) part[r] += s_q[r * dh + d] * kval;
    }
  }
}

// NR: query rows per kv head the loops are unrolled for; below MAX_REP it is
// the launch's rep exactly (no predicated rows), at MAX_REP rep is read at
// run time. Grid (nblk, B * hkv); the partials of row (b, h) and split s sit
// at ws[((b * H + h) * nblk + s) * dh] (acc) and at ws_ml[((b * H + h) * nblk
// + s) * 2] (m_s, l_s).
template <typename R, bool VEC, int NR>
__global__ void __launch_bounds__(THREADS)
    kv_split_kernel(const float* __restrict__ q, const R* __restrict__ kr,
                    const float* __restrict__ ka, const float* __restrict__ ks,
                    const R* __restrict__ vr, const float* __restrict__ va,
                    const float* __restrict__ vs, const int* __restrict__ length,
                    float* __restrict__ ws, float* __restrict__ ws_ml, int hkv, int rep_arg,
                    int nblk, int blk, int dh, KvStrides st, KvParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int rep = NR < MAX_REP ? NR : rep_arg;
  const Smem lay = smem_layout<R>(rep, blk, dh);
  R* s_k = reinterpret_cast<R*>(smem_raw + lay.k);
  R* s_v = reinterpret_cast<R*>(smem_raw + lay.v);
  float* s_q = reinterpret_cast<float*>(smem_raw + lay.q);
  float* s_kan = reinterpret_cast<float*>(smem_raw + lay.anchor);
  float* s_ksc = s_kan + dh;
  float* s_van = s_ksc + dh;
  float* s_vsc = s_van + dh;
  float* s_p = reinterpret_cast<float*>(smem_raw + lay.p);  // scores, then weights
  float* s_m = reinterpret_cast<float*>(smem_raw + lay.stats);
  float* s_l = s_m + rep;

  const int ib = blockIdx.x;  // the cache block this CTA takes
  const int bg = blockIdx.y, b = bg / hkv, g = bg % hkv;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long long row0 = static_cast<long long>(b) * hkv * rep + g * rep;
  const int key0 = ib * blk;
  const int n_keys = min(blk, row_keys(length, b, nblk, blk, p) - key0);
  if (n_keys <= 0) return;  // the block lies at or past the row's length

  // 1. K, then V, residual tiles into shared memory (two commit groups)
  if constexpr (VEC) {
    constexpr int N = 16 / sizeof(R);
    const int per_row = dh / N;
    for (int c = tid; c < blk * per_row; c += THREADS) {
      const int t = c / per_row, w = c % per_row;
      cp_async16(s_k + t * lay.kpitch + w * N, kr + off(st.s[0], b, g, ib, t, 0) + w * N);
    }
    cp_async_commit();
    for (int c = tid; c < blk * per_row; c += THREADS) {
      const int t = c / per_row, w = c % per_row;
      cp_async16(s_v + t * dh + w * N, vr + off(st.s[3], b, g, ib, t, 0) + w * N);
    }
    cp_async_commit();
  } else {
    for (int e = tid; e < blk * dh; e += THREADS) {
      const int t = e / dh, d = e % dh;
      s_k[t * lay.kpitch + d] = kr[off(st.s[0], b, g, ib, t, d)];
      s_v[e] = vr[off(st.s[3], b, g, ib, t, d)];
    }
  }
  for (int e = tid; e < rep * dh; e += THREADS) s_q[e] = q[row0 * dh + e];
  for (int d = tid; d < dh; d += THREADS) {
    s_kan[d] = ka[off(st.s[1], b, g, ib, 0, d)];
    s_ksc[d] = ks[off(st.s[2], b, g, ib, 0, d)];
    s_van[d] = va[off(st.s[4], b, g, ib, 0, d)];
    s_vsc[d] = vs[off(st.s[5], b, g, ib, 0, d)];
  }
  if constexpr (VEC) cp_async_wait<1>();  // this thread's K copies have landed
  __syncthreads();                          // everyone's K, q, anchors and scales

  // 2. scores, one thread per key; then one warp per query row
  for (int t = tid; t < blk; t += THREADS) {
    float part[NR];
#pragma unroll
    for (int r = 0; r < NR; ++r) part[r] = 0.0f;
    if (t < n_keys)
      key_scores<R, VEC, NR>(s_k + t * lay.kpitch, s_q, s_kan, s_ksc, rep, dh, p.inv_levels,
                             part);
#pragma unroll
    for (int r = 0; r < NR; ++r)
      if (r < rep) s_p[r * blk + t] = part[r] * p.scale;
  }
  __syncthreads();
  for (int r = warp; r < rep; r += WARPS) {
    float mx = NEG_INF;
    for (int t = lane; t < n_keys; t += 32) mx = fmaxf(mx, s_p[r * blk + t]);
#pragma unroll
    for (int o = 16; o > 0; o /= 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float sum = 0.0f;
    for (int t = lane; t < n_keys; t += 32) {
      const float w = expf(s_p[r * blk + t] - mx);
      s_p[r * blk + t] = w;
      sum += w;
    }
#pragma unroll
    for (int o = 16; o > 0; o /= 2) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (lane == 0) {
      s_m[r] = mx;
      s_l[r] = sum;
    }
  }
  if constexpr (VEC) cp_async_wait<0>();  // this thread's V copies have landed
  __syncthreads();                          // everyone's V; the weights are in place

  // 3. P.V; the partial goes to the workspace
  if constexpr (VEC) {
    // thread = (4 dims, one of `groups` interleaved key groups); the groups'
    // sums are added in group order through shared memory
    float* s_red = reinterpret_cast<float*>(smem_raw + lay.red);  // [groups][rep][dh]
    const int quads = dh / 4, groups = THREADS / quads;
    const int dq = tid % quads, kg = tid / quads;
    if (kg < groups) {
      float acc[NR][4];
#pragma unroll
      for (int r = 0; r < NR; ++r) acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.0f;
      const float4 an = *reinterpret_cast<const float4*>(s_van + 4 * dq);
      const float4 sc = *reinterpret_cast<const float4*>(s_vsc + 4 * dq);
#pragma unroll 4
      for (int t = kg; t < n_keys; t += groups) {
        float x[4];
        resid4(s_v + t * dh + 4 * dq, p.inv_levels, x);
        const float v0 = dequant_f(an.x, sc.x, x[0]), v1 = dequant_f(an.y, sc.y, x[1]);
        const float v2 = dequant_f(an.z, sc.z, x[2]), v3 = dequant_f(an.w, sc.w, x[3]);
#pragma unroll
        for (int r = 0; r < NR; ++r) {
          if (r < rep) {
            const float w = s_p[r * blk + t];
            acc[r][0] += w * v0;
            acc[r][1] += w * v1;
            acc[r][2] += w * v2;
            acc[r][3] += w * v3;
          }
        }
      }
#pragma unroll
      for (int r = 0; r < NR; ++r)
        if (r < rep)
          *reinterpret_cast<float4*>(s_red + (kg * rep + r) * dh + 4 * dq) =
              make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    }
    __syncthreads();
    for (int e = tid; e < rep * dh; e += THREADS) {
      float o = 0.0f;
      for (int k = 0; k < groups; ++k) o += s_red[k * rep * dh + e];
      const int r = e / dh, d = e % dh;
      ws[((row0 + r) * nblk + ib) * dh + d] = o;
    }
  } else if (tid < dh) {  // one thread per dim
    float acc[NR];
#pragma unroll
    for (int r = 0; r < NR; ++r) acc[r] = 0.0f;
    const float van = s_van[tid], vsc = s_vsc[tid];
    for (int t = 0; t < n_keys; ++t) {
      const float vval = dequant(van, vsc, s_v[t * dh + tid], p.inv_levels);
#pragma unroll
      for (int r = 0; r < NR; ++r)
        if (r < rep) acc[r] += s_p[r * blk + t] * vval;
    }
#pragma unroll
    for (int r = 0; r < NR; ++r)
      if (r < rep) ws[((row0 + r) * nblk + ib) * dh + tid] = acc[r];
  }
  if (tid < rep) {
    ws_ml[((row0 + tid) * nblk + ib) * 2] = s_m[tid];
    ws_ml[((row0 + tid) * nblk + ib) * 2 + 1] = s_l[tid];
  }
}

// One block per (b, head) row, one thread per dim: the row's partials merged
// in split order (every thread of a row sums l in the same order, so they
// agree bit for bit; dim 0 writes m and l).
__global__ void kv_merge_kernel(const float* __restrict__ ws, const float* __restrict__ ws_ml,
                                const int* __restrict__ length, float* __restrict__ out,
                                float* __restrict__ m_out, float* __restrict__ l_out, int h,
                                int nblk, int blk, int dh, KvParams p) {
  const int row = blockIdx.x, d = threadIdx.x;
  const int n_used = (row_keys(length, row / h, nblk, blk, p) + blk - 1) / blk;
  const int n_merge = max(n_used - p.drop_last_split, 0);
  const float* ml = ws_ml + static_cast<size_t>(row) * nblk * 2;
  const float* acc = ws + static_cast<size_t>(row) * nblk * dh + d;
  float m = NEG_INF;
  for (int s = 0; s < n_merge; ++s) m = fmaxf(m, ml[2 * s]);
  float l = 0.0f, o = 0.0f;
#pragma unroll 4
  for (int s = 0; s < n_merge; ++s) {
    const float w = expf(ml[2 * s] - m);
    l += ml[2 * s + 1] * w;
    o += acc[static_cast<size_t>(s) * dh] * w;
  }
  out[static_cast<size_t>(row) * dh + d] = o / (l > 0.0f ? l : 1.0f);
  if (d == 0) {
    m_out[row] = m;
    l_out[row] = l;
  }
}

template <typename R>
bool rows_vectorizable(const void* base, const long long* s, int dh) {
  const long long w = 16 / static_cast<long long>(sizeof(R));  // elements per 16 bytes
  return reinterpret_cast<uintptr_t>(base) % 16 == 0 && s[4] == 1 && dh % w == 0 &&
         s[0] % w == 0 && s[1] % w == 0 && s[2] % w == 0 && s[3] % w == 0;
}

template <typename R, bool VEC, int NR>
cudaError_t launch_split(const void* q, const void* kr, const void* ka, const void* ks,
                         const void* vr, const void* va, const void* vs, const int* length,
                         float* ws, float* ws_ml, int B, int hkv, int rep, int nblk, int blk,
                         int dh, const KvStrides& st, KvParams p, cudaStream_t stream) {
  const size_t smem = smem_layout<R>(rep, blk, dh).total;
  if (smem > SMEM_DEFAULT) {  // fails past the card's opt-in limit: the block is refused
    const cudaError_t err = cudaFuncSetAttribute(
        kv_split_kernel<R, VEC, NR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) {
      cudaGetLastError();  // clear it, or the next call's launch would report it
      return err;
    }
  }
  const dim3 grid(nblk, B * hkv);
  kv_split_kernel<R, VEC, NR><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const R*>(kr), static_cast<const float*>(ka),
      static_cast<const float*>(ks), static_cast<const R*>(vr), static_cast<const float*>(va),
      static_cast<const float*>(vs), length, ws, ws_ml, hkv, rep, nblk, blk, dh, st, p);
  return cudaGetLastError();
}

template <typename R>
cudaError_t launch(const void* q, const void* kr, const void* ka, const void* ks, const void* vr,
                   const void* va, const void* vs, const int* length, float* out, float* m,
                   float* l, float* ws, int B, int hkv, int rep, int nblk, int blk, int dh,
                   const KvStrides& st, KvParams p, cudaStream_t stream) {
  float* ws_ml = ws + static_cast<size_t>(B) * hkv * rep * nblk * dh;
  // 16-byte rows take the tuned path, its rows unrolled exactly for rep 1-4
  // (GQA groups of 8 and 4 kv heads at 24 and 32 query heads, and MHA)
#define REPRO_KV_SPLIT(VEC, NR)                                                            \
  launch_split<R, VEC, NR>(q, kr, ka, ks, vr, va, vs, length, ws, ws_ml, B, hkv, rep, nblk, \
                           blk, dh, st, p, stream)
  const bool vec = rows_vectorizable<R>(kr, st.s[0], dh) && rows_vectorizable<R>(vr, st.s[3], dh);
  const cudaError_t err = !vec      ? REPRO_KV_SPLIT(false, MAX_REP)
                          : rep == 1 ? REPRO_KV_SPLIT(true, 1)
                          : rep == 2 ? REPRO_KV_SPLIT(true, 2)
                          : rep == 3 ? REPRO_KV_SPLIT(true, 3)
                          : rep == 4 ? REPRO_KV_SPLIT(true, 4)
                                     : REPRO_KV_SPLIT(true, MAX_REP);
#undef REPRO_KV_SPLIT
  if (err != cudaSuccess) return err;
  kv_merge_kernel<<<B * hkv * rep, dh, 0, stream>>>(ws, ws_ml, length, out, m, l, hkv * rep, nblk,
                                                   blk, dh, p);
  return cudaGetLastError();
}

}  // namespace

// resid_kind: 0 int8, 1 fp16, 2 bf16. q (B, H, Dh) fp32 contiguous; out
// (B, H, Dh), m and l (B, H) fp32 contiguous; strides: 6 x 5 element strides
// of k_resid, k_anchor, k_scale, v_resid, v_anchor, v_scale, each viewed as
// (B, Hkv, nblk, blk, Dh). ws: fp32 scratch of B * H * nblk * (Dh + 2)
// floats (the splits' partials, written before they are read). Launches the
// split kernel and the merge kernel on `stream`; returns cudaGetLastError(),
// or the error of asking for more shared memory than the card has (a cache
// block whose K and V tiles do not fit), launching nothing.
extern "C" int repro_rcll_kv_decode(int resid_kind, const void* q, const void* kr,
                                    const void* ka, const void* ks, const void* vr,
                                    const void* va, const void* vs, const void* length,
                                    void* out, void* m, void* l, void* ws, int B, int hkv,
                                    int rep, int nblk, int blk, int dh,
                                    const long long* strides, const void* params, void* stream) {
  // the parameters travel as a pointer to their C struct (a ctypes.Structure):
  // a type of this file's unnamed namespace must not appear in a C signature
  const KvParams p = *static_cast<const KvParams*>(params);
  if (rep < 1 || rep > MAX_REP || dh < 1 || dh > MAX_DH) return cudaErrorInvalidValue;
  KvStrides st;
  for (int i = 0; i < 6; ++i)
    for (int j = 0; j < 5; ++j) st.s[i][j] = strides[5 * i + j];
  const auto s = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(length);
  float* o = static_cast<float*>(out);
  float* mo = static_cast<float*>(m);
  float* lo = static_cast<float*>(l);
  float* w = static_cast<float*>(ws);
  switch (resid_kind) {
    case 0:
      return launch<int8_t>(q, kr, ka, ks, vr, va, vs, len, o, mo, lo, w, B, hkv, rep, nblk, blk,
                            dh, st, p, s);
    case 1:
      return launch<__half>(q, kr, ka, ks, vr, va, vs, len, o, mo, lo, w, B, hkv, rep, nblk, blk,
                            dh, st, p, s);
    case 2:
      return launch<__nv_bfloat16>(q, kr, ka, ks, vr, va, vs, len, o, mo, lo, w, B, hkv, rep,
                                   nblk, blk, dh, st, p, s);
    default:
      return cudaErrorInvalidValue;
  }
}
