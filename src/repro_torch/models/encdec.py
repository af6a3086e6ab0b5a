"""Whisper-style encoder-decoder backbone (arXiv:2212.04356).

Port of ``repro.models.encdec``. The audio frontend is a stub: the
encoder takes frame embeddings (B, src_len, d_model). Decoder = causal
self-attention + cross-attention + GELU MLP, LayerNorm, sinusoidal
positions. K7 runs the prefill's three attentions: the encoder's
non-causal self-attention, the decoder's causal self-attention (no RoPE)
and the cross-attention over the encoder output. The decode step is
plain torch, as the port's dense decode is: its self-attention over the
``DenseKVCache`` (updated in place) and its one query's cross-attention.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.models import attention as attn_lib
from repro_torch.models import layers
from repro_torch.models import partitioning as pt
from repro_torch.models import transformer as tf


def init_enc_layer(gen: torch.Generator, cfg) -> dict:
    dev = gen.device
    return {
        "ln1": layers.init_layernorm(cfg.d_model, dev),
        "attn": attn_lib.init_attention(gen, cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim),
        "ln2": layers.init_layernorm(cfg.d_model, dev),
        "mlp": layers.init_gelu_mlp(gen, cfg.d_model, cfg.d_ff),
    }


def init_dec_layer(gen: torch.Generator, cfg) -> dict:
    dev = gen.device
    return {
        "ln1": layers.init_layernorm(cfg.d_model, dev),
        "attn": attn_lib.init_attention(gen, cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim),
        "ln_x": layers.init_layernorm(cfg.d_model, dev),
        "xattn": attn_lib.init_attention(gen, cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim),
        "ln2": layers.init_layernorm(cfg.d_model, dev),
        "mlp": layers.init_gelu_mlp(gen, cfg.d_model, cfg.d_ff),
    }


def init_params(gen: torch.Generator, cfg, dtype=torch.float32) -> dict:
    """The embedding, the encoder layers, then the decoder layers, drawn
    in that order from ``gen`` (see ``transformer.init_params``)."""
    dev = gen.device
    p = {"embed_tokens": tf.cast_tree(layers.init_embed(gen, cfg.vocab, cfg.d_model,
                                                        tied=cfg.tied_embeddings), dtype)}
    p["enc_layers"] = tf.stacked_layers(gen, cfg.n_enc_layers, lambda: init_enc_layer(gen, cfg),
                                        dtype)
    p["layers"] = tf.stacked_layers(gen, cfg.n_layers, lambda: init_dec_layer(gen, cfg), dtype)
    p["enc_norm"] = layers.init_layernorm(cfg.d_model, dev)
    p["final_norm"] = layers.init_layernorm(cfg.d_model, dev)
    return p


def _heads(cfg) -> dict:
    return dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv, d_head=cfg.head_dim)


def encode(params, frames, cfg):
    """frames: (B, S, d_model) stub embeddings -> encoder output."""
    b, s, _ = frames.shape
    h = frames.to(layers.DEFAULT_COMPUTE)
    h = h + layers.sinusoidal_positions(s, cfg.d_model, h.device).to(h.dtype)
    positions = torch.arange(s, device=h.device)[None].expand(b, s)
    remat = tf.remat_active(cfg, params)
    for i in range(cfg.n_enc_layers):
        # the frames need no gradient, so the reentrant form would see none
        h = tf.run_body(remat, _enc_body, cfg, tf.layer_params(params, i, "enc_layers"), h,
                        positions, reentrant=False)
    # whole along the frames once: every decoder layer's cross-attention reads it
    return pt.seq_whole(layers.layer_norm(params["enc_norm"], h))


def _enc_body(cfg, p_l, h, positions):
    """One encoder layer (JAX's encoder ``body``, checkpointed under ``remat``)."""
    h = pt.seq_whole(h)
    out, _ = attn_lib.attention_full(p_l["attn"], layers.layer_norm(p_l["ln1"], h), positions,
                                     causal=False, use_rope=False, **_heads(cfg))
    h = h + out
    return pt.act_seq(h + layers.gelu_mlp(p_l["mlp"], layers.layer_norm(p_l["ln2"], h)))


def _dec_body(cfg, p_l, h, enc_out, positions):
    """One decoder layer and its (k, v) (JAX's decoder ``body``,
    checkpointed under ``remat``)."""
    h = pt.seq_whole(h)
    out, kv = attn_lib.attention_full(p_l["attn"], layers.layer_norm(p_l["ln1"], h), positions,
                                      use_rope=False, **_heads(cfg))
    h = h + out
    h = h + attn_lib.cross_attention(p_l["xattn"], layers.layer_norm(p_l["ln_x"], h), enc_out,
                                     **_heads(cfg))
    return pt.act_seq(h + layers.gelu_mlp(p_l["mlp"], layers.layer_norm(p_l["ln2"], h))), kv


def decoder_forward(params, tokens, enc_out, cfg, *, return_cache=False):
    """Returns (logits, stacked (n_layers, B, L, Hkv, Dh) k and v, or
    None without ``return_cache``)."""
    b, l = tokens.shape
    h = layers.embed(params["embed_tokens"], tokens)
    h = h + layers.sinusoidal_positions(l, cfg.d_model, h.device).to(h.dtype)
    positions = torch.arange(l, device=h.device)[None].expand(b, l)
    ks, vs = [], []
    remat = tf.remat_active(cfg, params)
    for i in range(cfg.n_layers):
        # every decoder layer reads enc_out
        h, (k, v) = tf.run_body(remat, _dec_body, cfg, tf.layer_params(params, i), h, enc_out,
                                positions, reentrant=False)
        if return_cache:
            ks.append(k)
            vs.append(v)
    h = layers.layer_norm(params["final_norm"], h)
    lg = layers.logits(params["embed_tokens"], h)
    return lg, ((torch.stack(ks), torch.stack(vs)) if return_cache else None)


def forward(params, tokens, cfg, *, frames=None, return_cache=False):
    enc_out = encode(params, frames, cfg)
    lg, kv = decoder_forward(params, tokens, enc_out, cfg, return_cache=return_cache)
    return lg, kv, torch.zeros((), dtype=torch.float32, device=lg.device)


def loss_fn(params, batch, cfg):
    lg, _, _ = forward(params, batch["tokens"], cfg, frames=batch["frames"])
    loss = layers.cross_entropy(lg[:, :-1], batch["labels"][:, 1:])
    return loss, {"ce": loss, "aux": torch.zeros((), dtype=torch.float32, device=lg.device)}


class EncDecCache(NamedTuple):
    self_kv: attn_lib.DenseKVCache  # stacked (n_layers, ...)
    enc_out: torch.Tensor  # (B, S, d_model)


def init_cache(cfg, batch: int, max_len: int, device=None) -> EncDecCache:
    return EncDecCache(
        self_kv=tf.stack_cache(attn_lib.DenseKVCache.init(batch, max_len, cfg.n_kv,
                                                          cfg.head_dim, device=device),
                               cfg.n_layers),
        enc_out=torch.zeros((batch, cfg.src_len, cfg.d_model), dtype=torch.bfloat16,
                            device=device))


def prefill(params, tokens, cfg, max_len: int, *, frames=None):
    b, l = tokens.shape
    enc_out = encode(params, frames, cfg)
    lg, (k, v) = decoder_forward(params, tokens, enc_out, cfg, return_cache=True)
    length = torch.full((cfg.n_layers, b), l, dtype=torch.int32, device=tokens.device)
    return lg, EncDecCache(
        self_kv=attn_lib.DenseKVCache(k=tf.pad_seq(k, max_len), v=tf.pad_seq(v, max_len),
                                      length=length),
        enc_out=enc_out.to(torch.bfloat16))


def decode_step(params, tokens, cache: EncDecCache, cfg):
    """One-token decode; the self-attention caches are updated in place
    and the returned cache carries their new lengths."""
    h = layers.embed(params["embed_tokens"], tokens)
    # sinusoidal position of the current token, from a table of the
    # cache's max_len rows (an index past it clamps, as JAX's gather does)
    max_len = cache.self_kv.k.shape[2]
    pos = cache.self_kv.length[0].long().clamp(0, max_len - 1)  # all layers share length
    pe = layers.sinusoidal_positions(max_len, cfg.d_model, h.device)
    pe = pt.on_local(lambda t, i: t[i], (pe, pos), ((), ("batch",)), (("batch", None),),
                     ((pos.shape[0], cfg.d_model),))  # each rank's rows
    h = h + pe[:, None, :].to(h.dtype)
    lengths = []
    for i in range(cfg.n_layers):
        p_l = tf.layer_params(params, i)
        out, new_l = attn_lib.decode_attention_dense(
            p_l["attn"], layers.layer_norm(p_l["ln1"], h), tf.layer_cache(cache.self_kv, i),
            use_rope=False, **_heads(cfg))
        h = h + out
        h = h + attn_lib.cross_attention(p_l["xattn"], layers.layer_norm(p_l["ln_x"], h),
                                         cache.enc_out, use_kernel=False, **_heads(cfg))
        h = h + layers.gelu_mlp(p_l["mlp"], layers.layer_norm(p_l["ln2"], h))
        lengths.append(new_l.length)
    h = layers.layer_norm(params["final_norm"], h)
    return layers.logits(params["embed_tokens"], h), cache._replace(
        self_kv=cache.self_kv._replace(length=torch.stack(lengths)))
