"""GQA attention: prefill (full-sequence causal) and single-token decode
against a KV cache.

Port of ``repro.models.attention``. Two cache representations, in JAX's layouts:
  * ``DenseKVCache``   - plain bf16 (B, L, Hkv, Dh) buffer (baseline).
  * ``AnchoredKVCache``- the paper's technique (RCLL-KV): closed 128-token
    blocks live as anchor(fp32) + scale(fp32) + residual(int8/fp16); the
    open block is an fp32 tail buffer. Block closure is a pure function of
    ``length % block``, branch-free: no host read per step.

Where JAX computes attention in plain jnp, the port calls its kernels:
``attention_full`` and ``cross_attention`` run K7
(``kernels.flash_attention``) where JAX runs ``sdpa_chunked`` (causal or
not), and ``decode_attention_anchored`` runs K6
(``kernels.rcll_kv_attention``) over the closed blocks, attends over the
fp32 tail in plain torch and merges the two parts by their softmax
statistics (m, l). On CPU tensors the kernels' wrappers run their plain
versions (``flash_attention_ref``, ``rcll_kv_decode_ref``). Dense decode
uses ``sdpa``, as in JAX. In training (an input of K7 needs a gradient)
K7's call is an autograd op whose backward is the hand-written K7b, where
JAX differentiates ``sdpa_chunked`` with XLA (``kernels.flash_attention.
Attention``); serving launches K7 as before.

Unlike JAX's immutable arrays, the caches are updated in place (the KV
cache is decode's largest tensor, and copying it per step would cost more
than the step): ``*_cache_update`` write into the cache's storage and
return it with the new length; the cache passed in must not be used again.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.core import anchored
from repro_torch.kernels import flash_attention as k7
from repro_torch.kernels import rcll_kv_attention as k6
from repro_torch.models import layers

NEG_INF = -1e30


def init_attention(gen: torch.Generator, d_model: int, n_heads: int, n_kv: int, d_head: int,
                   out_dim: int | None = None) -> dict:
    out_dim = out_dim or d_model
    return {
        "wq": layers.dense_init(gen, d_model, n_heads * d_head),
        "wk": layers.dense_init(gen, d_model, n_kv * d_head),
        "wv": layers.dense_init(gen, d_model, n_kv * d_head),
        "wo": layers.dense_init(gen, n_heads * d_head, out_dim),
    }


def _qkv(p, x, n_heads, n_kv, d_head, compute_dtype):
    b, l, _ = x.shape
    xc = x.to(compute_dtype)
    q = (xc @ p["wq"].to(compute_dtype)).reshape(b, l, n_heads, d_head)
    k = (xc @ p["wk"].to(compute_dtype)).reshape(b, l, n_kv, d_head)
    v = (xc @ p["wv"].to(compute_dtype)).reshape(b, l, n_kv, d_head)
    return q, k, v


def _scores(q, k):
    """(B, Hkv, rep, Lq, Lk) fp32 scores of q (B, Lq, H, Dh) against k
    (B, Lk, Hkv, Dh): GQA by reshape, divided by sqrt(Dh) as in JAX."""
    b, lq, h, dh = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, lq, hkv, h // hkv, dh).float()
    return torch.einsum("blgrd,bmgd->bgrlm", qg, k.float()) / math.sqrt(dh)


def _attend(s, v, b, lq, h, dh):
    out = torch.einsum("bgrlm,bmgd->blgrd", torch.softmax(s, dim=-1), v.float())
    return out.reshape(b, lq, h, dh)


def sdpa(q, k, v, *, causal: bool, length: torch.Tensor | None = None):
    """Scaled dot-product attention, fp32 accumulation, GQA via reshape.

    q: (B, Lq, H, Dh); k/v: (B, Lk, Hkv, Dh).
    length: optional (B,) valid KV length (decode masking).
    """
    b, lq, h, dh = q.shape
    lk = k.shape[1]
    s = _scores(q, k)
    rows = torch.arange(lq, device=q.device)[:, None]
    cols = torch.arange(lk, device=q.device)[None, :]
    mask = torch.ones((lq, lk), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (rows >= cols)
    if length is not None:
        mask = mask[None] & (cols[None] < length[:, None, None])
        s = torch.where(mask[:, None, None], s, NEG_INF)
    else:
        s = torch.where(mask, s, NEG_INF)
    return _attend(s, v, b, lq, h, dh)


def attention_full(p, x, positions, *, n_heads, n_kv, d_head, rope_theta=10000.0,
                   causal=True, compute_dtype=layers.DEFAULT_COMPUTE, use_rope=True):
    """Prefill self-attention through K7. Returns (out, (k, v) for caching)."""
    b, l, _ = x.shape
    q, k, v = _qkv(p, x, n_heads, n_kv, d_head, compute_dtype)
    if use_rope:
        q = layers.apply_rope(q, positions, rope_theta)
        k = layers.apply_rope(k, positions, rope_theta)
    # (B, L, heads, Dh) -> (B, heads, L, Dh) views: K7 takes the strides
    out = k7.flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                             causal=causal)
    out = out.transpose(1, 2).to(compute_dtype, memory_format=torch.contiguous_format)
    return out.reshape(b, l, n_heads * d_head) @ p["wo"].to(compute_dtype), (k, v)


def cross_attention(p, x, kv_src, *, n_heads, n_kv, d_head,
                    compute_dtype=layers.DEFAULT_COMPUTE, use_kernel: bool = True):
    """Encoder-decoder cross attention (no RoPE, non-causal): K7 in the
    prefill; the decode step's one query takes plain ``sdpa`` with
    ``use_kernel=False``, as dense decode does."""
    b, l, _ = x.shape
    s = kv_src.shape[1]
    xc = x.to(compute_dtype)
    sc = kv_src.to(compute_dtype)
    q = (xc @ p["wq"].to(compute_dtype)).reshape(b, l, n_heads, d_head)
    k = (sc @ p["wk"].to(compute_dtype)).reshape(b, s, n_kv, d_head)
    v = (sc @ p["wv"].to(compute_dtype)).reshape(b, s, n_kv, d_head)
    if use_kernel:
        out = k7.flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                 causal=False).transpose(1, 2)
    else:
        out = sdpa(q, k, v, causal=False)
    out = out.to(compute_dtype, memory_format=torch.contiguous_format)
    return out.reshape(b, l, n_heads * d_head) @ p["wo"].to(compute_dtype)


# --------------------------------------------------------------------------
# KV caches
# --------------------------------------------------------------------------
class DenseKVCache(NamedTuple):
    k: torch.Tensor  # (B, L, Hkv, Dh) cache dtype
    v: torch.Tensor
    length: torch.Tensor  # (B,) int32

    @classmethod
    def init(cls, batch, max_len, n_kv, d_head, dtype=torch.bfloat16, device=None):
        shape = (batch, max_len, n_kv, d_head)
        return cls(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device),
                   length=torch.zeros((batch,), dtype=torch.int32, device=device))


class AnchoredKVCache(NamedTuple):
    """RCLL-KV: closed blocks anchored+quantized, open block fp32 tail.

    k_resid/v_resid: (B, nblk, blk, Hkv, Dh) residual dtype
    k_anchor/k_scale/...: (B, nblk, 1, Hkv, Dh) fp32
    tail_k/tail_v: (B, blk, Hkv, Dh) fp32 - the open (unquantized) block
    length: (B,) int32 total tokens
    """

    k_resid: torch.Tensor
    k_anchor: torch.Tensor
    k_scale: torch.Tensor
    v_resid: torch.Tensor
    v_anchor: torch.Tensor
    v_scale: torch.Tensor
    tail_k: torch.Tensor
    tail_v: torch.Tensor
    length: torch.Tensor

    @classmethod
    def init(cls, batch, max_len, n_kv, d_head, block=128, resid_dtype=torch.int8, device=None):
        nblk = max_len // block
        rs = (batch, nblk, block, n_kv, d_head)
        an = (batch, nblk, 1, n_kv, d_head)
        tl = (batch, block, n_kv, d_head)

        def z(shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=device)

        return cls(k_resid=z(rs, resid_dtype), k_anchor=z(an), k_scale=z(an),
                   v_resid=z(rs, resid_dtype), v_anchor=z(an), v_scale=z(an),
                   tail_k=z(tl), tail_v=z(tl), length=z((batch,), torch.int32))

    @property
    def block(self) -> int:
        return self.tail_k.shape[1]


def dense_cache_update(cache: DenseKVCache, k_new, v_new) -> DenseKVCache:
    """Write one token's k/v (B, 1, Hkv, Dh) at position ``length`` (per
    row; clamped to the last slot, as ``dynamic_update_slice`` clamps)."""
    rows = torch.arange(k_new.shape[0], device=k_new.device)
    idx = cache.length.long().clamp(max=cache.k.shape[1] - 1)
    cache.k[rows, idx] = k_new[:, 0].to(cache.k.dtype)
    cache.v[rows, idx] = v_new[:, 0].to(cache.v.dtype)
    return cache._replace(length=cache.length + 1)


def decode_attention_dense(p, x, cache: DenseKVCache, *, n_heads, n_kv, d_head,
                           rope_theta=10000.0, compute_dtype=layers.DEFAULT_COMPUTE,
                           use_rope=True):
    """One-token decode with a dense cache. x: (B, 1, d_model)."""
    b = x.shape[0]
    q, k_new, v_new = _qkv(p, x, n_heads, n_kv, d_head, compute_dtype)
    pos = cache.length[:, None]
    if use_rope:
        q = layers.apply_rope(q, pos, rope_theta)
        k_new = layers.apply_rope(k_new, pos, rope_theta)
    cache = dense_cache_update(cache, k_new, v_new)
    out = sdpa(q, cache.k, cache.v, causal=False, length=cache.length)
    out = out.to(compute_dtype).reshape(b, 1, n_heads * d_head)
    return out @ p["wo"].to(compute_dtype), cache


def _quant_blocks(xb, resid_dtype):
    """xb: (B, nblk, blk, Hkv, Dh) -> anchors, scales (B, nblk, 1, ...), residuals."""
    anchor = torch.mean(xb, dim=2, keepdim=True)
    dev = xb - anchor
    scale = torch.clamp_min(torch.amax(torch.abs(dev), dim=2, keepdim=True), 1e-30)
    return anchor, scale, anchored.quantize_residual(dev, scale, resid_dtype)


def _quantize_block(tail, resid_dtype):
    """anchor/scale (B, 1, Hkv, Dh) and residual (B, blk, Hkv, Dh) of one
    (B, blk, Hkv, Dh) block - the same math as ``core.anchored.encode``."""
    a, s, r = _quant_blocks(tail[:, None], resid_dtype)
    return a[:, 0], s[:, 0], r[:, 0]


def anchored_cache_update(cache: AnchoredKVCache, k_new, v_new) -> AnchoredKVCache:
    """Append one token (B, 1, Hkv, Dh) to the tail. Every step quantizes
    the tail and writes it into its block slot where the tail has just
    completed a block, and keeps the slot elsewhere (a ``where`` on
    ``length % blk == blk - 1``, as in JAX: no branch, no host read)."""
    b, blk = cache.tail_k.shape[0], cache.block
    rows = torch.arange(b, device=k_new.device)
    length = cache.length.long()
    pos_in_blk = length % blk
    blk_idx = (length // blk).clamp(max=cache.k_resid.shape[1] - 1)
    cache.tail_k[rows, pos_in_blk] = k_new[:, 0].to(cache.tail_k.dtype)
    cache.tail_v[rows, pos_in_blk] = v_new[:, 0].to(cache.tail_v.dtype)
    full = (pos_in_blk == blk - 1)[:, None, None, None]
    kq = _quantize_block(cache.tail_k, cache.k_resid.dtype)
    vq = _quantize_block(cache.tail_v, cache.v_resid.dtype)
    dsts = (cache.k_anchor, cache.k_scale, cache.k_resid,
            cache.v_anchor, cache.v_scale, cache.v_resid)
    for dst, src in zip(dsts, kq + vq):
        dst[rows, blk_idx] = torch.where(full, src, dst[rows, blk_idx])
    return cache._replace(length=cache.length + 1)


def anchored_cache_from_prefill(k, v, length, block=128, resid_dtype=torch.int8):
    """Quantize prefill K/V (B, L, Hkv, Dh) into an AnchoredKVCache: all
    L // block blocks close and the tail starts empty, as in JAX (so with
    a padded prompt the tokens past the last whole block are read from
    the zero tail: JAX's behaviour, kept for parity)."""
    b, l, hkv, dh = k.shape
    nblk = l // block
    kb = k.float().reshape(b, nblk, block, hkv, dh)
    vb = v.float().reshape(b, nblk, block, hkv, dh)
    ka, ks, kr = _quant_blocks(kb, resid_dtype)
    va, vs, vr = _quant_blocks(vb, resid_dtype)
    tail = torch.zeros((b, block, hkv, dh), dtype=torch.float32, device=k.device)
    return AnchoredKVCache(k_resid=kr, k_anchor=ka, k_scale=ks, v_resid=vr, v_anchor=va,
                           v_scale=vs, tail_k=tail, tail_v=tail.clone(), length=length)


def _heads_major(x):
    """(B, nblk, rows, Hkv, Dh) -> a (B, Hkv, nblk, rows, Dh) view."""
    return x.permute(0, 3, 1, 2, 4)


def tail_attention(q, tail_k, tail_v, n_tail):
    """Attention of q (B, 1, H, Dh) over the first ``n_tail`` (B,) rows of
    the fp32 tail (B, blk, Hkv, Dh): out (B, H, Dh) and the softmax max m
    and denominator l (B, H); an empty tail gives out 0, m -1e30, l 0."""
    b, _, h, dh = q.shape
    s = _scores(q, tail_k)[:, :, :, 0]  # (B, Hkv, rep, blk)
    cols = torch.arange(tail_k.shape[1], device=q.device)
    s = torch.where((cols[None] < n_tail[:, None])[:, None, None], s, NEG_INF)
    m = s.amax(dim=-1)
    p = torch.where(s > NEG_INF / 2, torch.exp(s - m[..., None]), 0.0)
    den = p.sum(dim=-1)
    out = torch.einsum("bgrt,btgd->bgrd", p, tail_v) / torch.where(den > 0, den, 1.0)[..., None]
    return out.reshape(b, h, dh), m.reshape(b, h), den.reshape(b, h)


def merge_attention(out_a, m_a, l_a, out_b, m_b, l_b):
    """Attention over two disjoint key sets from each part's normalized
    output and softmax statistics (B, H): with the weights w = l exp(m -
    max m), out = out_a w_a / (w_a + w_b) + out_b w_b / (w_a + w_b), so a
    part with no keys (l = 0) leaves the other part's output unchanged."""
    m = torch.maximum(m_a, m_b)
    w_a = l_a * torch.exp(m_a - m)
    w_b = l_b * torch.exp(m_b - m)
    den = w_a + w_b
    den = torch.where(den > 0, den, 1.0)
    return out_a * (w_a / den)[..., None] + out_b * (w_b / den)[..., None]


def decode_attention_anchored(p, x, cache: AnchoredKVCache, *, n_heads, n_kv, d_head,
                              rope_theta=10000.0, compute_dtype=layers.DEFAULT_COMPUTE,
                              use_rope=True):
    """One-token decode over the RCLL-KV cache: K6 over the closed blocks,
    plain torch over the open tail, merged by (m, l)."""
    b = x.shape[0]
    q, k_new, v_new = _qkv(p, x, n_heads, n_kv, d_head, compute_dtype)
    pos = cache.length[:, None]
    if use_rope:
        q = layers.apply_rope(q, pos, rope_theta)
        k_new = layers.apply_rope(k_new, pos, rope_theta)
    cache = anchored_cache_update(cache, k_new.float(), v_new.float())
    out = anchored_attention(q, cache).to(compute_dtype).reshape(b, 1, n_heads * d_head)
    return out @ p["wo"].to(compute_dtype), cache


def anchored_attention(q, cache: AnchoredKVCache) -> torch.Tensor:
    """Attention of q (B, 1, H, Dh) over the cache's ``length`` tokens ->
    (B, H, Dh) f32: K6 over the closed blocks [0, length - length % blk),
    the fp32 tail over the rest, merged by their (m, l)."""
    closed_len = (cache.length // cache.block) * cache.block
    out_c, m_c, l_c = k6.rcll_kv_decode(
        q[:, 0].float(), _heads_major(cache.k_resid), _heads_major(cache.k_anchor),
        _heads_major(cache.k_scale), _heads_major(cache.v_resid), _heads_major(cache.v_anchor),
        _heads_major(cache.v_scale), closed_len, return_stats=True)
    out_t, m_t, l_t = tail_attention(q, cache.tail_k, cache.tail_v, cache.length - closed_len)
    return merge_attention(out_c, m_c, l_c, out_t, m_t, l_t)

