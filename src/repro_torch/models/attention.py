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
from repro_torch.models import partitioning as pt

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


def _qkv(p, x, n_heads, n_kv, compute_dtype):
    xc = x.to(compute_dtype)
    q = pt.column_parallel(xc, p["wq"].to(compute_dtype), n_heads)
    k = pt.column_parallel(xc, p["wk"].to(compute_dtype), n_kv)
    v = pt.column_parallel(xc, p["wv"].to(compute_dtype), n_kv)
    q = pt.act(q, "batch", None, "model", None)
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


def kernel_attention(q, k, v, *, causal: bool) -> torch.Tensor:
    """K7 on q (B, Lq, H, Dh) and k/v (B, Lk, Hkv, Dh) -> (B, Lq, H, Dh)
    f32, a view of K7's (B, H, Lq, Dh) output: one call on the tensors as
    they are, or, where q is a DTensor (a mesh run), one call on each
    rank's shard (:func:`sharded_attention`)."""
    if pt.is_dtensor(q):
        return sharded_attention(q, k, v, causal=causal)
    return k7.flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                              causal=causal).transpose(1, 2)


def head_range(n_heads: int, degree: int, rank: int) -> tuple[int, int]:
    """The query heads [h0, h1) that model rank ``rank`` of ``degree``
    holds when the heads are sharded over "model": ``torch.chunk``'s
    sizes, as a DTensor's ``Shard`` splits (ceil(H / degree) a rank, the
    last ranks fewer or none)."""
    size = -(-n_heads // degree)
    return min(rank * size, n_heads), min((rank + 1) * size, n_heads)


def head_pieces(h0: int, h1: int, rep: int) -> list:
    """[h0, h1) cut where it cuts a kv group (``rep`` query heads a kv
    head): a piece inside one group, then the whole groups, then a piece
    inside one group; each piece is a GQA call of its own."""
    pieces, a = [], h0
    if h0 % rep and h0 < h1:
        a = min(-(-h0 // rep) * rep, h1)
        pieces.append((h0, a))
    last = h1 // rep * rep
    if a < last:
        pieces.append((a, last))
        a = last
    if a < h1:
        pieces.append((a, h1))
    return pieces


def local_attention(q, k, v, h0: int, h1: int, n_heads: int, *, causal: bool,
                    attend=k7.flash_attention) -> torch.Tensor:
    """One model rank's attention over its query heads [h0, h1) of
    ``n_heads``: q (B, h1 - h0, Lq, Dh) those heads, k/v (B, Hkv, Lk, Dh)
    every kv head (JAX replicates K and V over "model"); ``attend`` is K7's
    wrapper (or its plain path). Returns (B, h1 - h0, Lq, Dh) f32.

    K7 maps its local head h to kv head h // rep' (rep' its own ratio of
    heads), so the kv heads a call gets must start at its first head's
    group. Where the rank holds whole groups (h0 and h1 multiples of rep =
    H / Hkv) that is one call on the kv heads [h0 / rep, h1 / rep), rep' =
    rep. A layout that cuts a group (H 24, rep 3 over 16 ranks: two heads
    a rank) takes one call per :func:`head_pieces` piece, each on its own
    groups' kv heads (a piece inside a group at rep' = its head count).
    Either way each call's heads are the unsharded call's, so outputs and
    dQ are bit-equal to it, and K7b sums each kv head's gradient over the
    rank's heads of its group in fp32: with whole groups dK and dV are the
    unsharded call's too; a cut group's gradient is the sum, over the
    ranks that share it, of each rank's part (rounded to K's dtype once).
    A rank past the last head (an empty range) attends nothing; its output
    stays on the graph, so every rank runs the same collectives backward."""
    if h1 == h0:
        return q.float() + (k[:, :0].sum() + v[:, :0].sum())
    rep = n_heads // k.shape[1]
    outs = []
    for a, b in head_pieces(h0, h1, rep):
        g0, g1 = a // rep, -(-b // rep)
        outs.append(attend(q[:, a - h0:b - h0], k[:, g0:g1], v[:, g0:g1], causal=causal))
    return outs[0] if len(outs) == 1 else torch.cat(outs, 1)


def check_head_shards(q, k, v, dout, degree: int, *, causal: bool = True, local=None) -> dict:
    """Each of ``degree`` model ranks' :func:`local_attention` (or
    ``local``, same signature) on its head shard of q (B, H, Lq, Dh) over
    k/v (B, Hkv, Lk, Dh), forward and backward (dO ``dout``, (B, H, Lq,
    Dh) f32), concatenated over the ranks (dK, dV summed, their
    ``Partial``) and held against one whole :func:`kernels.flash_attention`
    call: K7 and K7b on CUDA tensors, their plain versions on CPU tensors.
    Outputs and dQ must be bit-equal; dK and dV bit-equal where every rank
    holds whole kv groups, else within K7b's ``rounding_bound_bwd`` plus one
    rounding to K's dtype of each rank's part and of the whole call's
    gradient (2^-8 of each for bf16, 2^-24 for fp32, relative) and the fp32
    sum over the ranks here. Returns {"calls": the shards' kernel calls
    (:func:`head_pieces` of the ranks that attend), "whole_groups",
    "out_equal", "dq_equal", "dkv_equal", "dkv_ratio": max dK/dV error
    over that bound, "ok"}. The shard calls come first, so a launch
    counter read before the whole call counts theirs."""
    local = local or local_attention
    h = q.shape[1]
    rep = h // k.shape[1]
    outs, dqs, calls, whole = [], [], 0, True
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    mag = [torch.zeros_like(dk), torch.zeros_like(dv)]
    for r in range(degree):
        h0, h1 = head_range(h, degree, r)
        ql = q[:, h0:h1].detach().requires_grad_(True)
        kl, vl = (t.detach().requires_grad_(True) for t in (k, v))
        out = local(ql, kl, vl, h0, h1, h, causal=causal)
        out.backward(dout[:, h0:h1])
        outs.append(out.detach())
        dqs.append(ql.grad.float())
        dk += kl.grad.float()
        dv += vl.grad.float()
        mag[0] += kl.grad.float().abs()
        mag[1] += vl.grad.float().abs()
        calls += len(head_pieces(h0, h1, rep))
        whole = whole and h0 % rep == 0 and h1 % rep == 0
    qw, kw, vw = (t.detach().requires_grad_(True) for t in (q, k, v))
    ow = k7.flash_attention(qw, kw, vw, causal=causal)
    ow.backward(dout)
    got = (torch.cat(outs, 1), torch.cat(dqs, 1), dk, dv)
    want = (ow.detach(), qw.grad.float(), kw.grad.float(), vw.grad.float())
    res = {"calls": calls, "whole_groups": whole,
           "out_equal": torch.equal(got[0], want[0]), "dq_equal": torch.equal(got[1], want[1]),
           "dkv_equal": torch.equal(got[2], want[2]) and torch.equal(got[3], want[3])}
    lse = k7.lse_ref(q, k, causal=causal)
    bnd = k7.rounding_bound_bwd(q, k, v, want[0], lse, dout, causal=causal)[1:]
    unit = 2.0**-8 if k.dtype == torch.bfloat16 else 2.0**-24
    ratio = 0.0
    for g, w, b, m in zip(got[2:], want[2:], bnd, mag):
        lim = b + unit / (1 - unit) * (m + w.abs()) + degree * 2.0**-24 * m
        ratio = max(ratio, float(((g - w).abs() / lim).max()) if g.numel() else 0.0)
    res["dkv_ratio"] = ratio
    res["ok"] = (res["out_equal"] and res["dq_equal"]
                 and (res["dkv_equal"] if whole else ratio <= 1.0))
    return res


def sharded_attention(q, k, v, *, causal: bool) -> torch.Tensor:
    """K7 (and K7b backward) on DTensors q (B, Lq, H, Dh), k/v (B, Lk, Hkv,
    Dh) of the current mesh: q laid out batch over the DP axes and heads
    over "model" (JAX's ``act(q, "batch", None, "model", None)``), k and v
    batch over DP and replicated over "model" (the layout JAX's
    ``attn_kv_hoist`` asks for, which attention needs either way), then
    :func:`local_attention` on each rank's local tensors, so a kernel only
    ever sees a rank's plain shard.
    The output has q's placements. Backward, dQ keeps q's placements and dK,
    dV are partial sums over "model" (each rank's heads add to theirs)."""
    from torch.distributed.tensor import DTensor, Partial

    mesh = q.device_mesh
    names = pt.axis_names(mesh)
    q = pt.act(q, "batch", None, "model", None)
    k = pt.act(k, "batch", None, None, None)
    v = pt.act(v, "batch", None, None, None)
    kv_grads = [Partial() if n == "model" else p for n, p in zip(names, k.placements)]
    ql = q.to_local()
    kl, vl = (t.to_local(grad_placements=kv_grads) for t in (k, v))
    n_heads = q.shape[2]
    deg, rank = ((mesh.size(names.index("model")), mesh.get_local_rank("model"))
                 if "model" in names else (1, 0))
    h0, h1 = head_range(n_heads, deg, rank)
    if ql.shape[2] != h1 - h0:
        raise ValueError(f"rank {rank} of {deg} holds {ql.shape[2]} heads, not [{h0}, {h1})")
    out = local_attention(ql.transpose(1, 2), kl.transpose(1, 2), vl.transpose(1, 2), h0, h1,
                          n_heads, causal=causal).transpose(1, 2)
    b, lq, h, dh = q.shape
    return DTensor.from_local(out, mesh, q.placements, shape=torch.Size((b, lq, h, dh)),
                              stride=(h * lq * dh, dh, lq * dh, 1))


def attention_full(p, x, positions, *, n_heads, n_kv, d_head, rope_theta=10000.0,
                   causal=True, compute_dtype=layers.DEFAULT_COMPUTE, use_rope=True):
    """Prefill self-attention through K7. Returns (out, (k, v) for caching)."""
    b, l, _ = x.shape
    q, k, v = _qkv(p, x, n_heads, n_kv, compute_dtype)
    if use_rope:
        q = layers.apply_rope(q, positions, rope_theta)
        k = layers.apply_rope(k, positions, rope_theta)
    # (B, L, heads, Dh) -> (B, heads, L, Dh) views: K7 takes the strides
    out = kernel_attention(q, k, v, causal=causal)
    out = out.to(compute_dtype, memory_format=torch.contiguous_format)
    return pt.row_parallel(out.reshape(b, l, n_heads * d_head), p["wo"].to(compute_dtype)), (k, v)


def cross_attention(p, x, kv_src, *, n_heads, n_kv, d_head,
                    compute_dtype=layers.DEFAULT_COMPUTE, use_kernel: bool = True):
    """Encoder-decoder cross attention (no RoPE, non-causal): K7 in the
    prefill; the decode step's one query takes plain ``sdpa`` with
    ``use_kernel=False``, as dense decode does."""
    b, l, _ = x.shape
    xc = x.to(compute_dtype)
    sc = kv_src.to(compute_dtype)
    q = pt.column_parallel(xc, p["wq"].to(compute_dtype), n_heads)
    k = pt.column_parallel(sc, p["wk"].to(compute_dtype), n_kv)
    v = pt.column_parallel(sc, p["wv"].to(compute_dtype), n_kv)
    if use_kernel:
        out = kernel_attention(q, k, v, causal=False)
    else:
        out = sdpa(q, k, v, causal=False)
    out = out.to(compute_dtype, memory_format=torch.contiguous_format)
    return pt.row_parallel(out.reshape(b, l, n_heads * d_head), p["wo"].to(compute_dtype))


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
    q, k_new, v_new = _qkv(p, x, n_heads, n_kv, compute_dtype)
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
    q, k_new, v_new = _qkv(p, x, n_heads, n_kv, compute_dtype)
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

