// K7b: the gradient of K7 (flash attention) for training.
//
// Replaces no Pallas kernel: the JAX package trains through XLA's autodiff of
// its plain attention (src/repro/models/attention.py sdpa_chunked). Given K7's
// inputs q (B, H, Lq, Dh) and k, v (B, Hkv, Lk, Dh) (fp32 or bf16, strided
// views with a unit Dh stride), its fp32 output O, each row's logsumexp
// lse = m + log l that K7's forward wrote (+inf for a row that sees no key) and
// the gradient dO of O (fp32, contiguous), it computes in fp32
//   D_i   = sum_d dO_id O_id
//   P_ij  = exp(scale q_i . k_j - lse_i)               (0 for a masked pair)
//   dV_j  = sum_i P_ij dO_i
//   dS_ij = P_ij (dO_i . v_j - D_i)
//   dQ_i  = scale sum_j dS_ij k_j
//   dK_j  = scale sum_i dS_ij q_i
// with K7's mask: key j is seen by query i when j <= i + (Lk - Lq) (causal),
// rows and columns past Lq / Lk masked. dK and dV of a kv head sum over the
// rep = H / Hkv query heads of its group. Outputs are contiguous fp32, each
// element written once by one CTA: no atomics, every sum in one fixed order,
// the same bits on every launch.
//
// Bound on the H100 (chip_smoke.py k7b_work): operations. The function is 10
// Dh operations a visible (query, key) pair (five products of Dh). At fp32
// accuracy on bf16 inputs q.k takes one bf16 tensor-core pass, the products
// with one fp32 operand (dO.v, dS k, dS q) three (its exact three-part bf16
// split) and P dO six (the parts' cross terms down to 2^-24): 16 passes,
// 0.104 ms at 989 TFLOP/s for llama3.2-3b's (2, 24, 1024, 128) causal; the
// bytes take 0.034 ms.
//
// bf16 inputs take the tensor cores (namespace tc), three launches:
//   prep_kernel:       one pass over dO and O: D_i in a fixed order, dO's exact
//                      split hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi
//                      - mid) as three bf16 planes (3, B, H, Lq, Dh) that TMA
//                      loads like q, and lse and D copied into rows padded to
//                      64 (lse +inf, D 0 past Lq) so a tile of them is one
//                      aligned bulk copy. The wrapper allocates this scratch.
//   dkdv_wgmma_kernel: one CTA per (b*Hkv + g, 64-key tile), the tiles that
//                      see the most query rows launched first. A producer warp
//                      TMA-loads the K and V tile once, then for each of the
//                      group's heads in turn the query tiles of 64 from the
//                      first row that sees the tile: Q, the three dO planes,
//                      lse and D, round a two-stage ring of mbarriers. Two
//                      consumer warpgroups hold the same 64 keys and split the
//                      work in halves of 7 passes: both compute S^T = K Q^T
//                      (wgmma m64n64k16, A and B from shared memory) and P^T =
//                      exp(scale S^T - lse) in fp32 registers with the
//                      accurate expf, masked only on diagonal and ragged
//                      tiles; warpgroup 0 then adds dV += P^T dO as six wgmmas
//                      a k16 step (A = P^T's split from registers, the
//                      accumulator's layout being the A fragment's, B = the
//                      dO planes MN-major; the cross terms hi.hi, hi.mid,
//                      mid.hi, hi.lo, mid.mid, lo.hi), warpgroup 1 dP^T = V
//                      dO^T over the three planes, dS^T = P^T (dP^T - D) and
//                      dK += dS^T Q with dS^T's split (three passes). Each
//                      writes its 64 x Dh accumulator once (dK times scale).
//   dq_wgmma_kernel:   one CTA per (b*H + h, 128-row query tile), heavy causal
//                      tiles first; two consumer warpgroups of 64 rows as K7's.
//                      The producer loads Q and the dO planes once and K/V
//                      tiles of 64 keys round a two-stage ring. Per tile: S =
//                      Q K^T (one pass), dP = dO V^T (three), dS = P (dP - D),
//                      dQ += dS K with dS's split (three).
// The dQ kernel recomputes S and dP, so the two run 21 passes against the
// bound's 16 (and S^T once more in the dK/dV kernel's second warpgroup); that
// buys a dQ written once per row by one CTA, with no atomics and no reduction
// across CTAs. The split is exact for |x| >= 2^-110 and within 2^-134 below
// (flash_attention.split_bf16x3); kernels/flash_attention.py
// flash_attention_bwd_split_ref mirrors the scheme in plain torch. The fault
// ds_hi_only feeds dQ and dK dS's hi part alone, as a bf16 FlashAttention
// backward rounds it. Registers: a consumer thread holds a 64 x Dh fp32
// accumulator (64 registers at Dh 128), two 64 x 64 score tiles (32 each) and
// the split fragments (48); a thread of a 288-thread CTA gets 168, and at Dh
// 128 ptxas spills 120 bytes in the dQ kernel and 8 in the dK/dV kernel
// (PERF.md). The barrier, TMA and wgmma helpers are K7's (hopper.cuh).
//
// fp32 inputs keep the CUDA-core kernels (namespace simt; bf16 tensor cores
// cannot take fp32 q and k exactly):
//   dq_kernel:   one block per (32-row query tile, b*H + h), 4 threads a row;
//                D_i first (written out for the second kernel), then the key
//                tiles of 32 staged in shared memory, up to the causal edge.
//   dkdv_kernel: one block per (32-key tile, b*Hkv + g), 4 threads a key; it
//                walks the group's query heads in order and, for each, the
//                query tiles of 32 (q, dO, lse and D staged) from the first
//                row that sees a key of the tile.
// Each pair's q.k and dO.v are computed in both kernels (14 Dh operations a
// visible pair against the 10 Dh of the function), in fp32 FMA.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

struct BwdParams {
  float scale;
  int causal;
  int causal_shift;     // 0; a check plants 1 to let one future key in
  int first_head_only;  // 0; a check plants 1: dK/dV take only the group's first head
  int d_from_do;        // 0; a check plants 1: D_i = sum_d dO_id, O left out
  int ds_hi_only;       // 0; a check plants 1: dQ and dK take dS's bf16 hi part alone (bf16)
};

struct Strides {  // element strides of a (B, heads, L, Dh) view; Dh stride 1
  long long b, h, l;
};

// --------------------------------------------------------------------------
// fp32 inputs: CUDA cores
// --------------------------------------------------------------------------
namespace simt {

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

}  // namespace simt

// --------------------------------------------------------------------------
// bf16 inputs: TMA, mbarriers and wgmma
// --------------------------------------------------------------------------
namespace tc {

using namespace hopper;

constexpr int ROWS = 64;              // a warpgroup's rows: keys (dK/dV), queries (dQ)
constexpr int COLS = 64;              // rows of a ring tile: queries (dK/dV), keys (dQ)
constexpr int DQ_ROWS = 2 * ROWS;     // query rows per dQ CTA
constexpr int STAGES = 2;             // ring depth
constexpr int CONSUMERS = 2 * 128;    // two consumer warpgroups
constexpr int THREADS = CONSUMERS + 32;  // and one producer warp
constexpr int PREP_THREADS = 256;

template <int DH>
struct DqTile : Swizzle<DH> {
  static constexpr int Q_BYTES = DQ_ROWS * DH * 2;  // Q, and each dO plane
  static constexpr int KV_BYTES = COLS * DH * 2;    // one of K, V
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;
  static constexpr int BAR_BYTES = (2 * STAGES + 1) * 8;
  // 1024 of slack to align the tiles to the 128 B swizzle's 1024 B period
  static constexpr int SMEM = 1024 + 4 * Q_BYTES + STAGES * STAGE_BYTES + BAR_BYTES;
};

template <int DH>
struct DkvTile : Swizzle<DH> {
  static constexpr int KV_BYTES = ROWS * DH * 2;   // one of K, V
  static constexpr int Q_BYTES = COLS * DH * 2;    // Q, and each dO plane, of a query tile
  static constexpr int STAGE_BYTES = 4 * Q_BYTES;
  static constexpr int STAT_BYTES = 2 * COLS * 4;  // lse and D of a query tile
  static constexpr int BAR_BYTES = (2 * STAGES + 1) * 8;
  static constexpr int SMEM =
      1024 + 2 * KV_BYTES + STAGES * (STAGE_BYTES + STAT_BYTES) + BAR_BYTES;
};

// D, dO's planes and the padded lse and D (see the note at the top): one row
// of Dh / 4 lanes, 4 elements a lane; D summed lane by lane, then across the
// row's lanes by a fixed shuffle tree.
template <int DH>
__global__ void __launch_bounds__(PREP_THREADS)
    prep_kernel(const float* __restrict__ o, const float* __restrict__ dout,
                const float* __restrict__ lse, float* __restrict__ lse_pad,
                float* __restrict__ d_pad, __nv_bfloat16* __restrict__ planes, int BH, int Lq,
                int Lpad, BwdParams p) {
  constexpr int LPR = DH / 4;                // lanes per row
  constexpr int RPB = PREP_THREADS / LPR;    // rows per block
  const int sub = threadIdx.x % LPR;
  const long long row = static_cast<long long>(blockIdx.x) * RPB + threadIdx.x / LPR;
  const bool in_grid = row < static_cast<long long>(BH) * Lpad;
  const long long bh = row / Lpad;
  const int i = static_cast<int>(row % Lpad);
  const bool valid = in_grid && i < Lq;
  const long long at = (bh * Lq + i) * DH + 4 * sub;
  float4 g = make_float4(0.0f, 0.0f, 0.0f, 0.0f), x = g;
  if (valid) {
    g = *reinterpret_cast<const float4*>(dout + at);
    x = *reinterpret_cast<const float4*>(o + at);
  }
  float part = p.d_from_do ? (g.x + g.y) + (g.z + g.w)
                           : (g.x * x.x + g.y * x.y) + (g.z * x.z + g.w * x.w);
#pragma unroll
  for (int m = LPR / 2; m > 0; m /= 2) part += __shfl_xor_sync(0xffffffffu, part, m);
  if (valid) {
    uint2 hi, mid, lo;
    split3(g.x, g.y, hi.x, mid.x, lo.x);
    split3(g.z, g.w, hi.y, mid.y, lo.y);
    const long long plane = static_cast<long long>(BH) * Lq * DH;
    *reinterpret_cast<uint2*>(planes + at) = hi;
    *reinterpret_cast<uint2*>(planes + plane + at) = mid;
    *reinterpret_cast<uint2*>(planes + 2 * plane + at) = lo;
  }
  if (in_grid && sub == 0) {
    lse_pad[row] = valid ? lse[bh * Lq + i] : __int_as_float(0x7f800000);
    d_pad[row] = valid ? part : 0.0f;
  }
}

// Tiles of COLS rows (keys) that hold a key some row of [row_lo, row_end) sees.
__device__ __forceinline__ int key_tiles(int row_lo, int row_end, int Lk, int offset,
                                         int causal) {
  if (row_lo >= row_end) return 0;
  int last = Lk - 1;
  if (causal) last = min(last, row_end - 1 + offset);
  return last < 0 ? 0 : last / COLS + 1;
}

// acc += A B with both split: A's parts from registers, B's three planes at
// b, b + plane_bytes, b + 2 plane_bytes; the six cross terms down to 2^-24
// (hi.hi, hi.mid, mid.hi, hi.lo, mid.mid, lo.hi) a k16 step.
template <int DH>
__device__ __forceinline__ void issue_split6(float (&acc)[DH / 2], const uint32_t (&a)[3][4][4],
                                             uint32_t b, uint32_t plane_bytes) {
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
    const uint64_t b0 = mn_desc<DH>(b, COLS, kc), b1 = mn_desc<DH>(b + plane_bytes, COLS, kc),
                   b2 = mn_desc<DH>(b + 2 * plane_bytes, COLS, kc);
    wgmma_rs(acc, a[0][kc], b0);
    wgmma_rs(acc, a[0][kc], b1);
    wgmma_rs(acc, a[1][kc], b0);
    wgmma_rs(acc, a[0][kc], b2);
    wgmma_rs(acc, a[1][kc], b1);
    wgmma_rs(acc, a[2][kc], b0);
  }
}

// Write a 64 x Dh accumulator (rows r0, r0 + 8 of this thread; rows at or
// past ``n`` skipped) times ``mul`` to rows first.. of out.
template <int DH>
__device__ __forceinline__ void store_rows(float* out, const float (&acc)[DH / 2], int first,
                                           int r0, int cq, int n, float mul) {
#pragma unroll
  for (int i = 0; i < DH / 2; i += 2) {
    const int row = first + ((i & 2) ? r0 + 8 : r0);
    if (row >= n) continue;
    *reinterpret_cast<float2*>(out + static_cast<long long>(row) * DH + 8 * (i / 4) + cq) =
        make_float2(acc[i] * mul, acc[i + 1] * mul);
  }
}

// dQ: one CTA per (b*H + h, 128-row query tile).
template <int DH>
__global__ void __launch_bounds__(THREADS, 1)
    dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
                    const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                    const float* __restrict__ lse_pad, const float* __restrict__ d_pad,
                    float* __restrict__ dq, int B, int H, int rep, int Lq, int Lk, int Lpad,
                    BwdParams p) {
  using T = DqTile<DH>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sq = (smem_u32(smem_raw) + 1023u) & ~1023u;  // Q, then the 3 dO planes
  const uint32_t skv = sq + 4 * T::Q_BYTES;                  // stage s: K boxes, then V boxes
  const uint32_t bars = skv + STAGES * T::STAGE_BYTES;       // full[STAGES], empty[STAGES], q
  const uint32_t qbar = bars + 16 * STAGES;
  auto full = [&](int t) { return bars + 8 * (t % STAGES); };
  auto empty = [&](int t) { return bars + 8 * (STAGES + t % STAGES); };
  auto k_tile = [&](int t) { return skv + (t % STAGES) * T::STAGE_BYTES; };
  auto parity = [](int t) { return static_cast<uint32_t>((t / STAGES) & 1); };

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H, g = h / rep;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * DQ_ROWS;  // the heavy causal tiles first
  const int offset = Lk - Lq + p.causal_shift;             // key j is seen when j <= i + offset
  const int n_tiles = key_tiles(q0, min(q0 + DQ_ROWS, Lq), Lk, offset, p.causal);
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
      mbar_expect_tx(qbar, 4 * T::Q_BYTES);
#pragma unroll
      for (int c = 0; c < T::NCB; ++c) {
        tma_load(sq + c * DQ_ROWS * T::SW, &tq, qbar, c * T::SWE, q0, h, b);
#pragma unroll
        for (int pl = 0; pl < 3; ++pl)
          tma_load(sq + (1 + pl) * T::Q_BYTES + c * DQ_ROWS * T::SW, &tdo, qbar, c * T::SWE, q0,
                   h, pl * B + b);
      }
      for (int t = 0; t < n_tiles; ++t) {
        if (t >= STAGES) mbar_wait(empty(t), parity(t) ^ 1);  // tile t - STAGES consumed
        mbar_expect_tx(full(t), T::STAGE_BYTES);
#pragma unroll
        for (int c = 0; c < T::NCB; ++c) {
          tma_load(k_tile(t) + c * COLS * T::SW, &tk, full(t), c * T::SWE, t * COLS, g, b);
          tma_load(k_tile(t) + T::KV_BYTES + c * COLS * T::SW, &tv, full(t), c * T::SWE,
                   t * COLS, g, b);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns query rows [row_lo, row_lo + 64); this thread
  // holds rows r0 and r0 + 8 and, in each 8-column group, columns cq and cq + 1
  const int wg = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
  const int row_lo = q0 + ROWS * wg;
  const int r0 = row_lo + 16 * warp + lane / 4, r1 = r0 + 8, cq = 2 * (lane % 4);
  const int my_tiles = key_tiles(row_lo, min(row_lo + ROWS, Lq), Lk, offset, p.causal);
  const uint32_t qa = sq + ROWS * wg * T::SW;  // this warpgroup's Q rows; plane pl's at + (1 + pl) Q_BYTES
  const long long srow = static_cast<long long>(bh) * Lpad;
  const float inf = __int_as_float(0x7f800000);
  const float lse0 = r0 < Lq ? lse_pad[srow + r0] : inf, lse1 = r1 < Lq ? lse_pad[srow + r1] : inf;
  const float d0 = r0 < Lq ? d_pad[srow + r0] : 0.0f, d1 = r1 < Lq ? d_pad[srow + r1] : 0.0f;

  float acc[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) acc[i] = 0.0f;
  if (my_tiles > 0) mbar_wait(qbar, 0);
  for (int t = 0; t < n_tiles; ++t) {
    mbar_wait(full(t), parity(t));
    if (t < my_tiles) {  // uniform across the warpgroup
      float s[32], dp[32];
      uint32_t a[3][4][4];
      wgmma_fence();
      issue_ss<DH>(s, qa, DQ_ROWS, k_tile(t), COLS, false);
#pragma unroll
      for (int pl = 0; pl < 3; ++pl)
        issue_ss<DH>(dp, qa + (1 + pl) * T::Q_BYTES, DQ_ROWS, k_tile(t) + T::KV_BYTES, COLS,
                     pl > 0);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);
      fence_regs(dp);
      const int k0 = t * COLS;
      const bool edge = k0 + COLS > Lk || row_lo + ROWS > Lq ||
                        (p.causal && k0 + COLS - 1 > row_lo + offset);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int row = (i & 2) ? r1 : r0;
        const int col = k0 + 8 * (i / 4) + cq + (i & 1);
        bool keep = true;
        if (edge) keep = col < Lk && row < Lq && (!p.causal || col <= row + offset);
        const float pij = keep ? expf(s[i] * p.scale - ((i & 2) ? lse1 : lse0)) : 0.0f;
        s[i] = pij * (dp[i] - ((i & 2) ? d1 : d0));  // dS
      }
      split_frag(s, a);
      fence_regs(acc);
      wgmma_fence();
      issue_split<DH>(acc, a, k_tile(t), COLS, p.ds_hi_only);  // dQ += dS K
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
    }
    mbar_arrive(empty(t));  // this thread is done with tile t's stage
  }
  store_rows<DH>(dq + static_cast<long long>(bh) * Lq * DH, acc, row_lo, r0 - row_lo, cq, Lq,
                 p.scale);
}

// P^T of one (key tile, query tile) in place, exp(scale s - lse_i) (0 where
// masked; only diagonal and ragged tiles pay for the mask), or with GRAD
// dS^T = P^T (dP^T - D_i). lse and D of the tile's 64 queries at sl, sd.
template <bool GRAD>
__device__ __forceinline__ void weights_t(float (&s)[32], const float (&dp)[32], const float* sl,
                                          const float* sd, int r0, int cq, int k0, int t0,
                                          int Lq, int Lk, int offset, const BwdParams& p) {
  const bool edge = k0 + ROWS > Lk || t0 + COLS > Lq || (p.causal && k0 + ROWS - 1 > t0 + offset);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = 8 * j + cq;
    const float2 l = *reinterpret_cast<const float2*>(sl + c);
    const float2 d = GRAD ? *reinterpret_cast<const float2*>(sd + c) : make_float2(0.0f, 0.0f);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * j + e;
      const int key = k0 + ((e & 2) ? r0 + 8 : r0), query = t0 + c + (e & 1);
      bool keep = true;
      if (edge) keep = key < Lk && query < Lq && (!p.causal || key <= query + offset);
      const float pij = keep ? expf(s[i] * p.scale - ((e & 1) ? l.y : l.x)) : 0.0f;
      s[i] = GRAD ? pij * (dp[i] - ((e & 1) ? d.y : d.x)) : pij;
    }
  }
}

// dK and dV: one CTA per (b*Hkv + g, 64-key tile).
template <int DH>
__global__ void __launch_bounds__(THREADS, 1)
    dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tdo,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv, const float* __restrict__ lse_pad,
                      const float* __restrict__ d_pad, float* __restrict__ dk,
                      float* __restrict__ dv, int B, int H, int Hkv, int Lq, int Lk, int Lpad,
                      BwdParams p) {
  using T = DkvTile<DH>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const uint32_t sk = smem_u32(smem), sv = sk + T::KV_BYTES;
  const uint32_t ring = sv + T::KV_BYTES;  // stage s: Q boxes, then the 3 dO planes
  const int stats = 2 * T::KV_BYTES + STAGES * T::STAGE_BYTES;  // stage s: lse, then D
  const uint32_t bars = sk + stats + STAGES * T::STAT_BYTES;    // full, empty, kv
  const uint32_t kvbar = bars + 16 * STAGES;
  auto full = [&](int t) { return bars + 8 * (t % STAGES); };
  auto empty = [&](int t) { return bars + 8 * (STAGES + t % STAGES); };
  auto stage = [&](int t) { return ring + (t % STAGES) * T::STAGE_BYTES; };
  auto stat = [&](int t) { return stats + (t % STAGES) * T::STAT_BYTES; };
  auto parity = [](int t) { return static_cast<uint32_t>((t / STAGES) & 1); };

  const int rep = H / Hkv;
  const int bg = blockIdx.x;
  const int b = bg / Hkv, g = bg % Hkv;
  const int k0 = blockIdx.y * ROWS;  // the key tiles seen by the most query rows first
  const int offset = Lk - Lq + p.causal_shift;
  const int t_first = p.causal ? max(0, k0 - offset) / COLS : 0;  // the first query tile
  const int n_qt = max(0, (Lq + COLS - 1) / COLS - t_first);
  const int n_iter = (p.first_head_only ? 1 : rep) * n_qt;
  const int tid = threadIdx.x;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), CONSUMERS);
    }
    mbar_init(kvbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {  // the producer warp: one thread issues every load
    if (tid == CONSUMERS && n_iter > 0) {
      mbar_expect_tx(kvbar, 2 * T::KV_BYTES);
#pragma unroll
      for (int c = 0; c < T::NCB; ++c) {
        tma_load(sk + c * ROWS * T::SW, &tk, kvbar, c * T::SWE, k0, g, b);
        tma_load(sv + c * ROWS * T::SW, &tv, kvbar, c * T::SWE, k0, g, b);
      }
      for (int it = 0; it < n_iter; ++it) {
        const int h = g * rep + it / n_qt, t0 = (t_first + it % n_qt) * COLS;
        const long long at = (static_cast<long long>(b) * H + h) * Lpad + t0;
        if (it >= STAGES) mbar_wait(empty(it), parity(it) ^ 1);  // tile it - STAGES consumed
        mbar_expect_tx(full(it), T::STAGE_BYTES + T::STAT_BYTES);
#pragma unroll
        for (int c = 0; c < T::NCB; ++c) {
          tma_load(stage(it) + c * COLS * T::SW, &tq, full(it), c * T::SWE, t0, h, b);
#pragma unroll
          for (int pl = 0; pl < 3; ++pl)
            tma_load(stage(it) + (1 + pl) * T::Q_BYTES + c * COLS * T::SW, &tdo, full(it),
                     c * T::SWE, t0, h, pl * B + b);
        }
        bulk_load(sk + stat(it), lse_pad + at, COLS * 4, full(it));
        bulk_load(sk + stat(it) + COLS * 4, d_pad + at, COLS * 4, full(it));
      }
    }
    return;
  }

  // consumers: both warpgroups hold keys [k0, k0 + 64); this thread keys r0 and
  // r0 + 8 (of the tile) and, in each 8-column group, queries cq and cq + 1.
  // Warpgroup 0 accumulates dV, warpgroup 1 dK.
  const int wg = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
  const int r0 = 16 * warp + lane / 4, cq = 2 * (lane % 4);
  float acc[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) acc[i] = 0.0f;
  if (n_iter > 0) mbar_wait(kvbar, 0);
  for (int it = 0; it < n_iter; ++it) {
    mbar_wait(full(it), parity(it));
    const int t0 = (t_first + it % n_qt) * COLS;
    const uint32_t qs = stage(it);
    const float* sl = reinterpret_cast<const float*>(smem + stat(it));
    float s[32];
    uint32_t a[3][4][4];
    if (wg == 0) {  // dV += P^T dO
      wgmma_fence();
      issue_ss<DH>(s, sk, ROWS, qs, COLS, false);  // S^T = K Q^T
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);
      weights_t<false>(s, s, sl, sl + COLS, r0, cq, k0, t0, Lq, Lk, offset, p);
      split_frag(s, a);
      fence_regs(acc);
      wgmma_fence();
      issue_split6<DH>(acc, a, qs + T::Q_BYTES, T::Q_BYTES);
    } else {  // dK += dS^T Q
      float dp[32];
      wgmma_fence();
      issue_ss<DH>(s, sk, ROWS, qs, COLS, false);  // S^T = K Q^T
#pragma unroll
      for (int pl = 0; pl < 3; ++pl)  // dP^T = V dO^T
        issue_ss<DH>(dp, sv, ROWS, qs + (1 + pl) * T::Q_BYTES, COLS, pl > 0);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);
      fence_regs(dp);
      weights_t<true>(s, dp, sl, sl + COLS, r0, cq, k0, t0, Lq, Lk, offset, p);
      split_frag(s, a);
      fence_regs(acc);
      wgmma_fence();
      issue_split<DH>(acc, a, qs, COLS, p.ds_hi_only);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    mbar_arrive(empty(it));  // this thread is done with tile it's stage
  }
  float* out = wg == 0 ? dv : dk;
  store_rows<DH>(out + static_cast<long long>(bg) * Lk * DH, acc, k0, r0, cq, Lk,
                 wg == 0 ? 1.0f : p.scale);
}

template <int DH>
cudaError_t launch(const void* q, const void* k, const void* v, const float* o,
                   const float* dout, const float* lse, float* scratch, float* dq, float* dk,
                   float* dv, int B, int H, int Hkv, int Lq, int Lk, const long long* st,
                   BwdParams p, cudaStream_t stream) {
  const int Lpad = (Lq + COLS - 1) / COLS * COLS;
  const long long BH = static_cast<long long>(B) * H;
  float* lse_pad = scratch;
  float* d_pad = scratch + BH * Lpad;
  __nv_bfloat16* planes = reinterpret_cast<__nv_bfloat16*>(scratch + 2 * BH * Lpad);
  const long long pst[3] = {static_cast<long long>(H) * Lq * DH, static_cast<long long>(Lq) * DH,
                            DH};  // a plane's (b, h, l) strides; plane pl is batch pl * B + b
  CUtensorMap tq_dq, tdo_dq, tq_kv, tdo_kv, tk, tv;
  if (!make_map<DH>(&tq_dq, q, Lq, H, B, st, DQ_ROWS) ||
      !make_map<DH>(&tdo_dq, planes, Lq, H, 3 * B, pst, DQ_ROWS) ||
      !make_map<DH>(&tq_kv, q, Lq, H, B, st, COLS) ||
      !make_map<DH>(&tdo_kv, planes, Lq, H, 3 * B, pst, COLS) ||
      !make_map<DH>(&tk, k, Lk, Hkv, B, st + 3, COLS) ||
      !make_map<DH>(&tv, v, Lk, Hkv, B, st + 6, COLS))
    return cudaErrorInvalidValue;
  constexpr int RPB = PREP_THREADS / (DH / 4);
  const long long prep_blocks = (BH * Lpad + RPB - 1) / RPB;
  prep_kernel<DH><<<static_cast<unsigned>(prep_blocks), PREP_THREADS, 0, stream>>>(
      o, dout, lse, lse_pad, d_pad, planes, static_cast<int>(BH), Lq, Lpad, p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dq_wgmma_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             DqTile<DH>::SMEM);
  if (err != cudaSuccess) return err;
  dq_wgmma_kernel<DH><<<dim3(B * H, (Lq + DQ_ROWS - 1) / DQ_ROWS), THREADS, DqTile<DH>::SMEM,
                        stream>>>(tq_dq, tdo_dq, tk, tv, lse_pad, d_pad, dq, B, H, H / Hkv, Lq,
                                  Lk, Lpad, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dkdv_wgmma_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             DkvTile<DH>::SMEM);
  if (err != cudaSuccess) return err;
  dkdv_wgmma_kernel<DH><<<dim3(B * Hkv, (Lk + ROWS - 1) / ROWS), THREADS, DkvTile<DH>::SMEM,
                          stream>>>(tq_kv, tdo_kv, tk, tv, lse_pad, d_pad, dk, dv, B, H, Hkv,
                                    Lq, Lk, Lpad, p);
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
// 16-byte aligned and the strides multiples of 8 (TMA). o, dout: contiguous
// (B, H, Lq, Dh) fp32; lse: contiguous (B, H, Lq) fp32; dq: contiguous (B, H,
// Lq, Dh) fp32; dk, dv: contiguous (B, Hkv, Lk, Dh) fp32. scratch (fp32 words,
// the caller's): fp32, D (B, H, Lq); bf16, the padded lse and D (2, B, H, Lpad)
// with Lpad = Lq rounded up to 64, then dO's three bf16 planes (3, B, H, Lq,
// Dh). Lq, Lk >= 1. Returns cudaGetLastError() after the launches (or the
// refusal's error).
extern "C" int repro_flash_attention_bwd(int dtype, int dh, const void* q, const void* k,
                                         const void* v, const void* o, const void* dout,
                                         const void* lse, void* scratch, void* dq, void* dk,
                                         void* dv, int B, int H, int Hkv, int Lq, int Lk,
                                         const long long* strides, const void* params,
                                         void* stream) {
  const BwdParams p = *static_cast<const BwdParams*>(params);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto of = static_cast<const float*>(o);
  const auto df = static_cast<const float*>(dout);
  const auto lf = static_cast<const float*>(lse);
  const auto sf = static_cast<float*>(scratch);
  const auto qf = static_cast<float*>(dq);
  const auto kf = static_cast<float*>(dk);
  const auto vf = static_cast<float*>(dv);
  if (dtype == 0)
    return dispatch_dh(dh, [&](auto d) {
      return simt::launch<float, decltype(d)::value>(q, k, v, of, df, lf, sf, qf, kf, vf, B, H,
                                                     Hkv, Lq, Lk, strides, p, s);
    });
  if (dtype == 1)
    return dispatch_dh(dh, [&](auto d) {
      return tc::launch<decltype(d)::value>(q, k, v, of, df, lf, sf, qf, kf, vf, B, H, Hkv, Lq,
                                            Lk, strides, p, s);
    });
  return cudaErrorInvalidValue;
}
