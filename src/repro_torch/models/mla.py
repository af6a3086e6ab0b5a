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
    cq = x.to(compute_dtype) @ p["wq_a"].to(compute_dtype)
    cq = layers.rms_norm(p["q_norm"], cq)
    q = pt.column_parallel(cq, p["wq_b"].to(compute_dtype), dims.n_heads)
    return q[..., :dims.qk_nope], q[..., dims.qk_nope:]


def _project_kv_latent(p, x, dims: MLADims, compute_dtype):
    ckv = x.to(compute_dtype) @ p["wkv_a"].to(compute_dtype)
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
    out = out.to(compute_dtype).reshape(b, l, h * dv)
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

    rows = torch.arange(b, device=x.device)
    idx = cache.length.long().clamp(max=cache.c_kv.shape[1] - 1)
    cache.c_kv[rows, idx] = c_new[:, 0].to(cache.c_kv.dtype)
    cache.k_rope[rows, idx] = kr_new[:, 0].to(cache.k_rope.dtype)
    cache = cache._replace(length=cache.length + 1)

    wkv_b = p["wkv_b"].to(compute_dtype).reshape(dims.kv_lora, h, dn + dv).float()
    w_uk, w_uv = wkv_b[..., :dn], wkv_b[..., dn:]  # (kvl, H, dn/dv)
    q_lat = torch.einsum("bhd,chd->bhc", q_nope[:, 0].float(), w_uk)  # absorbed
    c_kv = cache.c_kv.float()
    s = (torch.einsum("bhc,btc->bht", q_lat, c_kv)
         + torch.einsum("bhd,btd->bht", q_rope[:, 0].float(), cache.k_rope.float())
         ) / math.sqrt(dn + dr)
    t = torch.arange(c_kv.shape[1], device=x.device)[None, None, :]
    s = torch.where(t < cache.length[:, None, None], s, -1e30)
    ctx = torch.einsum("bht,btc->bhc", torch.softmax(s, dim=-1), c_kv)
    out = torch.einsum("bhc,chd->bhd", ctx, w_uv)
    out = out.to(compute_dtype).reshape(b, 1, h * dv)
    return out @ p["wo"].to(compute_dtype), cache
