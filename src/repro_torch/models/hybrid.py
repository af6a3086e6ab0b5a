"""Zamba2-style hybrid: Mamba2 backbone + one *shared* attention block
applied every ``attn_every`` layers (arXiv:2411.15242).

Port of ``repro.models.hybrid``. The shared block's weights are reused at
every application site. Its input is concat(hidden, original embedding)
in 2*d_model; attention (K7 in the prefill) and a SwiGLU MLP run in
2*d_model, and ``w_down`` brings the result back to d_model as a
residual add. The first ``n_sites * attn_every`` mamba layers run as
``n_sites`` groups, the shared block after each group, then the
remaining tail layers without it. The shared block decodes with a
``DenseKVCache`` under either ``kv_mode``, as in JAX; every cache is
updated in place.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.models import attention as attn_lib
from repro_torch.models import layers, mamba2
from repro_torch.models import partitioning as pt
from repro_torch.models import transformer as tf


def n_sites(cfg) -> int:
    return cfg.n_layers // cfg.attn_every


def tail_layers(cfg) -> int:
    return cfg.n_layers - n_sites(cfg) * cfg.attn_every


def shared_d(cfg) -> int:
    return 2 * cfg.d_model


def _shared_head_dim(cfg) -> int:
    return shared_d(cfg) // cfg.n_heads


def init_shared_block(gen: torch.Generator, cfg) -> dict:
    d2 = shared_d(cfg)
    return {
        "ln1": layers.init_rmsnorm(d2, gen.device),
        "attn": attn_lib.init_attention(gen, d2, cfg.n_heads, cfg.n_kv, _shared_head_dim(cfg),
                                        out_dim=d2),
        "ln2": layers.init_rmsnorm(d2, gen.device),
        "mlp": layers.init_swiglu(gen, d2, cfg.d_ff),
        "w_down": layers.dense_init(gen, d2, cfg.d_model),
    }


def init_params(gen: torch.Generator, cfg, dtype=torch.float32) -> dict:
    """The embedding, the stacked mamba layers, then the shared block,
    drawn in that order from ``gen`` (see ``transformer.init_params``)."""
    p = {"embed_tokens": tf.cast_tree(layers.init_embed(gen, cfg.vocab, cfg.d_model,
                                                        tied=cfg.tied_embeddings), dtype),
         "layers": tf.stacked_layers(gen, cfg.n_layers, lambda: tf.init_layer(gen, cfg), dtype)}
    p["shared_attn"] = tf.cast_tree(init_shared_block(gen, cfg), dtype)
    p["final_norm"] = layers.init_rmsnorm(cfg.d_model, gen.device)
    return p


def _shared_forward(p, h, emb0, positions, cfg):
    """Full-seq shared block. Returns (residual for h, (k, v) cache)."""
    x = torch.cat([h, emb0], dim=-1)
    out, (k, v) = attn_lib.attention_full(
        p["attn"], layers.rms_norm(p["ln1"], x), positions, n_heads=cfg.n_heads, n_kv=cfg.n_kv,
        d_head=_shared_head_dim(cfg), rope_theta=cfg.rope_theta)
    x = x + out
    x = x + layers.swiglu(p["mlp"], layers.rms_norm(p["ln2"], x))
    return pt.replica_product(x.to(h.dtype), p["w_down"].to(h.dtype)), (k, v)


def _shared_decode(p, h, emb0, cache_s, cfg):
    x = torch.cat([h, emb0], dim=-1)
    out, new_cache = attn_lib.decode_attention_dense(
        p["attn"], layers.rms_norm(p["ln1"], x), cache_s, n_heads=cfg.n_heads, n_kv=cfg.n_kv,
        d_head=_shared_head_dim(cfg), rope_theta=cfg.rope_theta)
    x = x + out
    x = x + layers.swiglu(p["mlp"], layers.rms_norm(p["ln2"], x))
    return pt.replica_product(x.to(h.dtype), p["w_down"].to(h.dtype)), new_cache


class HybridCache(NamedTuple):
    mamba: mamba2.Mamba2Cache  # stacked (n_layers, ...)
    shared: attn_lib.DenseKVCache  # stacked (n_sites, ...)


def _site_after(cfg, i: int) -> int | None:
    """The shared-block site that follows mamba layer i, if any."""
    ae = cfg.attn_every
    return i // ae if (i + 1) % ae == 0 and i < n_sites(cfg) * ae else None


def _mamba_body(cfg, p_l, h):
    """One mamba layer with its residual (JAX's ``mamba_body``, the part
    ``remat`` checkpoints; the shared block is not)."""
    h = pt.seq_whole(h)
    out, cache = mamba2.mamba2_forward(p_l["mixer"], layers.rms_norm(p_l["ln1"], h),
                                       cfg.ssm_dims, chunk=cfg.ssd_chunk)
    return pt.act_seq(h + out), cache


def forward(params, tokens, cfg, *, patch_embeds=None, return_cache=False):
    b, l = tokens.shape
    h = layers.embed(params["embed_tokens"], tokens)
    emb0 = h
    positions = torch.arange(l, device=tokens.device)[None].expand(b, l)
    m_caches, s_caches = [], []
    remat = tf.remat_active(cfg, params)
    for i in range(cfg.n_layers):
        # layer 0's input is emb0, which every shared-block site reads too
        h, cache = tf.run_body(remat, _mamba_body, cfg, tf.layer_params(params, i), h,
                               reentrant=i > 0)
        if return_cache:
            m_caches.append(cache)
        if _site_after(cfg, i) is not None:
            h = pt.seq_whole(h)  # the shared block and its residual read whole rows
            res, kv = _shared_forward(params["shared_attn"], h, emb0, positions, cfg)
            h = h + res
            if return_cache:
                s_caches.append(kv)
    h = layers.rms_norm(params["final_norm"], h)
    lg = layers.logits(params["embed_tokens"], h)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    if not return_cache:
        return lg, None, aux
    mamba = mamba2.Mamba2Cache(*(torch.stack(ts) for ts in zip(*m_caches)))
    return lg, (mamba, tuple(torch.stack(ts) for ts in zip(*s_caches))), aux


def loss_fn(params, batch, cfg):
    lg, _, aux = forward(params, batch["tokens"], cfg)
    loss = layers.cross_entropy(lg[:, :-1], batch["labels"][:, 1:])
    return loss, {"ce": loss, "aux": aux}


def init_cache(cfg, batch: int, max_len: int, device=None) -> HybridCache:
    return HybridCache(
        mamba=tf.stack_cache(mamba2.Mamba2Cache.init(batch, cfg.ssm_dims, device=device),
                             cfg.n_layers),
        shared=tf.stack_cache(attn_lib.DenseKVCache.init(batch, max_len, cfg.n_kv,
                                                         _shared_head_dim(cfg), device=device),
                              n_sites(cfg)))


def prefill(params, tokens, cfg, max_len: int, *, patch_embeds=None):
    b, l = tokens.shape
    lg, (m_cache, (k, v)), _ = forward(params, tokens, cfg, return_cache=True)
    length = torch.full((n_sites(cfg), b), l, dtype=torch.int32, device=tokens.device)
    return lg, HybridCache(mamba=m_cache, shared=attn_lib.DenseKVCache(
        k=tf.pad_seq(k, max_len), v=tf.pad_seq(v, max_len), length=length))


def decode_step(params, tokens, cache: HybridCache, cfg):
    """One-token decode; the caches' storage is updated in place and the
    returned cache carries the shared block's new lengths."""
    h = layers.embed(params["embed_tokens"], tokens)
    emb0 = h
    lengths = []
    for i in range(cfg.n_layers):
        p_l = tf.layer_params(params, i)
        out, _ = mamba2.mamba2_decode(p_l["mixer"], layers.rms_norm(p_l["ln1"], h),
                                      tf.layer_cache(cache.mamba, i), cfg.ssm_dims)
        h = h + out
        site = _site_after(cfg, i)
        if site is not None:
            res, new_s = _shared_decode(params["shared_attn"], h, emb0,
                                        tf.layer_cache(cache.shared, site), cfg)
            h = h + res
            lengths.append(new_s.length)
    h = layers.rms_norm(params["final_norm"], h)
    shared = cache.shared._replace(length=torch.stack(lengths)) if lengths else cache.shared
    return layers.logits(params["embed_tokens"], h), cache._replace(shared=shared)
