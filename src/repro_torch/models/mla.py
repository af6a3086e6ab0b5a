"""Multi-head Latent Attention (DeepSeek-V2, arXiv:2405.04434).

Port of ``repro.models.mla``. The cache holds only the latent c_kv
(kv_lora dims) plus a shared decoupled RoPE key (qk_rope dims) per token.
Decode uses the absorbed form: W_uk is folded into the query so attention
runs in the latent space; W_uv is applied after the value aggregation.

MLA's attention is plain torch, as it is plain jnp in JAX (no Pallas
kernel computes it; its qk head dim, qk_nope + qk_rope = 192 at full
size, differs from its v dim). ``MLACache`` is updated in place, like the
port's other caches: ``mla_decode`` writes the new token into the
cache's storage and returns it with the new length.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.models import layers
from repro_torch.models import partitioning as pt


def init_mla(gen: torch.Generator, d_model: int, n_heads: int, *, q_lora: int, kv_lora: int,
             qk_nope: int, qk_rope: int, v_head: int) -> dict:
    dqk = qk_nope + qk_rope
    dev = gen.device
    return {
        # query path: d -> q_lora -> heads*(qk_nope + qk_rope)
        "wq_a": layers.dense_init(gen, d_model, q_lora),
        "q_norm": layers.init_rmsnorm(q_lora, dev),
        "wq_b": layers.dense_init(gen, q_lora, n_heads * dqk),
        # kv path: d -> kv_lora (cached) + shared rope key (cached)
        "wkv_a": layers.dense_init(gen, d_model, kv_lora + qk_rope),
        "kv_norm": layers.init_rmsnorm(kv_lora, dev),
        # up-projections from the latent
        "wkv_b": layers.dense_init(gen, kv_lora, n_heads * (qk_nope + v_head)),
        "wo": layers.dense_init(gen, n_heads * v_head, d_model),
    }


class MLADims(NamedTuple):
    n_heads: int
    q_lora: int
    kv_lora: int
    qk_nope: int
    qk_rope: int
    v_head: int


class MLACache(NamedTuple):
    c_kv: torch.Tensor  # (B, L, kv_lora) latent cache
    k_rope: torch.Tensor  # (B, L, qk_rope) shared rope key
    length: torch.Tensor  # (B,) int32

    @classmethod
    def init(cls, batch, max_len, kv_lora, qk_rope, dtype=torch.bfloat16, device=None):
        return cls(c_kv=torch.zeros((batch, max_len, kv_lora), dtype=dtype, device=device),
                   k_rope=torch.zeros((batch, max_len, qk_rope), dtype=dtype, device=device),
                   length=torch.zeros((batch,), dtype=torch.int32, device=device))


def _project_q(p, x, dims: MLADims, compute_dtype):
    cq = pt.replica_product(x.to(compute_dtype), p["wq_a"].to(compute_dtype))
    cq = layers.rms_norm(p["q_norm"], cq)
    q = pt.column_parallel(cq, p["wq_b"].to(compute_dtype), dims.n_heads)
    return q[..., :dims.qk_nope], q[..., dims.qk_nope:]


def _project_kv_latent(p, x, dims: MLADims, compute_dtype):
    ckv = pt.replica_product(x.to(compute_dtype), p["wkv_a"].to(compute_dtype))
    c_kv, k_rope = ckv[..., :dims.kv_lora], ckv[..., dims.kv_lora:]
    return layers.rms_norm(p["kv_norm"], c_kv), k_rope


def _attend(q_nope, q_rope, k_nope, v, k_rope, scale: float):
    """Query-blocked (memory-linear) causal attention, JAX's tiling: the
    scores never materialize beyond (B, H, chunk, L); the math is exact
    per row. q_nope, q_rope, k_nope, v (B, L, H, *), k_rope (B, L, dr);
    returns (B, L, H, dv) f32."""
    l = q_nope.shape[1]
    k_nope, v, kr = k_nope.float(), v.float(), k_rope.float()
    chunk = 256 if (l % 256 == 0 and l > 256) else l
    cols = torch.arange(l, device=q_nope.device)[None, :]
    outs = []
    for i in range(l // chunk):
        rows = slice(i * chunk, (i + 1) * chunk)
        s = (torch.einsum("blhd,bmhd->bhlm", q_nope[:, rows].float(), k_nope)
             + torch.einsum("blhd,bmd->bhlm", q_rope[:, rows].float(), kr)) * scale
        causal = (i * chunk + torch.arange(chunk, device=q_nope.device))[:, None] >= cols
        s = torch.where(causal, s, -1e30)
        outs.append(torch.einsum("bhlm,bmhd->blhd", torch.softmax(s, dim=-1), v))
    return torch.cat(outs, dim=1)


def mla_full(p, x, positions, dims: MLADims, *, rope_theta=10000.0,
             compute_dtype=layers.DEFAULT_COMPUTE):
    """Prefill MLA (naive materialized form). Returns (out, cache tensors
    (c_kv, k_rope)).

    Under a mesh the heads of q (JAX's hint) and of k and v go on "model"
    and the batch on DP (``wq_b`` and ``wkv_b`` split over "model",
    ``partitioning.column_parallel``), k_rope whole over "model", and each
    rank attends over its own heads and rows (``partitioning.on_local``:
    the unsharded math a head at a time). The low-rank projections
    ``wq_a`` and ``wkv_a`` run whole on every model rank: their norms read
    the whole latent."""
    b, l, _ = x.shape
    h, dn, dr, dv = dims.n_heads, dims.qk_nope, dims.qk_rope, dims.v_head
    q_nope, q_rope = _project_q(p, x, dims, compute_dtype)
    q_rope = layers.apply_rope(q_rope, positions, rope_theta)
    c_kv, k_rope = _project_kv_latent(p, x, dims, compute_dtype)
    k_rope = layers.apply_rope(k_rope[..., None, :], positions, rope_theta)[..., 0, :]
    kv = pt.column_parallel(c_kv, p["wkv_b"].to(compute_dtype), h)
    k_nope, v = kv[..., :dn], kv[..., dn:]
    heads = ("batch", None, "model", None)
    q_nope = pt.act(q_nope, *heads)
    out = pt.on_local(lambda *a: _attend(*a, scale=1.0 / math.sqrt(dn + dr)),
                      (q_nope, q_rope, k_nope, v, k_rope), (heads,) * 4 + (("batch", None, None),),
                      (heads,), ((b, l, h, dv),), partial={4: ("model",)})
    out = pt.whole_dims(out.to(compute_dtype), (2,), unless_divides=h).reshape(b, l, h * dv)
    return pt.row_parallel(out, p["wo"].to(compute_dtype)), (c_kv, k_rope)


def mla_decode(p, x, cache: MLACache, dims: MLADims, *, rope_theta=10000.0,
               compute_dtype=layers.DEFAULT_COMPUTE):
    """Absorbed-form single-token decode: attention in the latent space.

    score_h(t) = q_nope_h . (W_uk_h c_t) + q_rope_h . k_rope_t
               = (W_uk_h^T q_nope_h) . c_t + q_rope_h . k_rope_t
    out_h      = W_uv_h (sum_t a_t c_t)
    """
    b = x.shape[0]
    h, dn, dr, dv = dims.n_heads, dims.qk_nope, dims.qk_rope, dims.v_head
    q_nope, q_rope = _project_q(p, x, dims, compute_dtype)  # (B, 1, H, *)
    pos = cache.length[:, None]
    q_rope = layers.apply_rope(q_rope, pos, rope_theta)
    c_new, kr_new = _project_kv_latent(p, x, dims, compute_dtype)
    kr_new = layers.apply_rope(kr_new[..., None, :], pos, rope_theta)[..., 0, :]

    idx = cache.length.long().clamp(max=cache.c_kv.shape[1] - 1)
    pt.write_positions(cache.c_kv, idx, c_new[:, 0].to(cache.c_kv.dtype))
    pt.write_positions(cache.k_rope, idx, kr_new[:, 0].to(cache.k_rope.dtype))
    cache = cache._replace(length=cache.length + 1)

    if pt.is_dtensor(cache.c_kv):
        out = _sharded_absorbed(q_nope, q_rope, cache, p["wkv_b"].to(compute_dtype), dims)
    else:
        out = _absorbed(q_nope[:, 0].float(), q_rope[:, 0].float(), cache.c_kv.float(),
                        cache.k_rope.float(), cache.length, p["wkv_b"].to(compute_dtype),
                        dims)
    out = out.to(compute_dtype).reshape(b, 1, h * dv)
    return pt.row_parallel(out, p["wo"].to(compute_dtype)), cache


def _absorbed(q_nope, q_rope, c_kv, k_rope, length, wkv_b, dims: MLADims,
              reduce=lambda t, which: t, t0: int = 0, merge=None):
    """The absorbed attention of q_nope (B, H, dn), q_rope (B, H, dr)
    over the latent cache c_kv (B, T, c), k_rope (B, T, dr) (fp32), the
    first ``length`` (B,) positions, with ``wkv_b`` (c, H (dn + dv)) ->
    (B, H, dv) f32. A mesh run's: ``reduce(t, "c" | "rope")`` sums a
    partial product over the ranks that split that axis; the cache's
    positions start at ``t0``, and where ``merge`` is given (the positions
    split over ranks) each rank's softmax part is merged by it
    (``attention.merge_over``)."""
    h, dn, dv = dims.n_heads, dims.qk_nope, dims.v_head
    wkv_b = wkv_b.reshape(wkv_b.shape[0], h, dn + dv).float()
    w_uk, w_uv = wkv_b[..., :dn], wkv_b[..., dn:]  # (kvl, H, dn/dv)
    q_lat = torch.einsum("bhd,chd->bhc", q_nope, w_uk)  # absorbed
    s = (reduce(torch.einsum("bhc,btc->bht", q_lat, c_kv), "c")
         + reduce(torch.einsum("bhd,btd->bht", q_rope, k_rope), "rope")
         ) / math.sqrt(dn + dims.qk_rope)
    t = t0 + torch.arange(c_kv.shape[1], device=c_kv.device)[None, None, :]
    s = torch.where(t < length[:, None, None], s, -1e30)
    if merge is None:
        ctx = torch.einsum("bht,btc->bhc", torch.softmax(s, dim=-1), c_kv)
    else:
        mx = s.amax(dim=-1)
        p = torch.where(s > -5e29, torch.exp(s - mx[..., None]), 0.0)
        den = p.sum(dim=-1)
        ctx = torch.einsum("bht,btc->bhc", p, c_kv) / torch.where(den > 0, den, 1.0)[..., None]
        ctx, _, _ = merge(ctx, mx, den)
    return reduce(torch.einsum("bhc,chd->bhd", ctx, w_uv), "c")


def _sharded_absorbed(q_nope, q_rope, cache: MLACache, wkv_b, dims: MLADims):
    """:func:`_absorbed` on each rank's cache shard (DTensors of the
    current mesh; JAX's layouts split the rows over DP and the latent and
    rope axes over "model", or, where the rows do not divide, the
    positions): ``wkv_b``'s rows of the rank's latent slice, q's rows and
    its rope slice; the dot products over a split axis summed over its
    ranks, and split positions' softmax parts merged (all-reduces).
    Returns (B, H, dv) f32 split by rows only."""
    from repro_torch.models.attention import merge_over

    c_kv, k_rope = cache.c_kv, cache.k_rope
    mesh = c_kv.device_mesh
    pos = pt.split_axes(c_kv, 1)
    if pos != pt.split_axes(k_rope, 1):
        raise NotImplementedError(f"an MLA cache whose latent and rope positions are split "
                                  f"apart ({c_kv.placements}, {k_rope.placements})")
    axes = {"c": pt.split_axes(c_kv, 2), "rope": pt.split_axes(k_rope, 2)}
    out = _absorbed(pt.local_as(q_nope, c_kv, {0: 0})[:, 0].float(),
                    pt.local_as(q_rope, k_rope, {0: 0, 2: 3})[:, 0].float(),
                    c_kv.to_local().float(), k_rope.to_local().float(),
                    pt.local_as(cache.length, c_kv, {0: 0}),
                    pt.local_as(wkv_b, c_kv, {2: 0}), dims,
                    reduce=lambda t, which: pt.reduce_over(t, mesh, axes[which]),
                    t0=pt.local_offset(c_kv)[1][1],
                    merge=(lambda *a: merge_over(*a, mesh, pos)) if pos else None)
    b, h = q_nope.shape[0], q_nope.shape[2]
    return pt.wrap_like(out, c_kv, {0: 0}, (b, h, dims.v_head))
