"""Shared building blocks: norms, RoPE, MLPs, embeddings.

Port of ``repro.models.layers``.
Functional style as there: ``init_*(gen, ...) -> params dict`` and pure
apply functions. Parameters are fp32 masters; each apply function casts
a weight to the compute dtype at use (``Tensor.to`` is free when the
caller passes the one bf16 copy that ``transformer.compute_weights``
makes). Normalization and softmax accumulate in fp32. JAX's sharding
constraints (``pt.act*``, ``models.partitioning``) stand where JAX has
them: the identity without a mesh, a DTensor redistribution under one.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from repro_torch.models import partitioning as pt

DEFAULT_COMPUTE = torch.bfloat16

#: Standard-normal CDF at the truncation points -3 and 3.
_PHI_LO = 0.5 * (1.0 + math.erf(-3.0 / math.sqrt(2.0)))
_PHI_HI = 0.5 * (1.0 + math.erf(3.0 / math.sqrt(2.0)))


class ShapeOnly:
    """Stands in for a ``torch.Generator`` on the meta device, which torch
    cannot make: the ``init_*`` functions given :data:`SHAPE_ONLY` run as
    they do for a real generator and return meta tensors of the same
    shapes and dtypes, drawing and allocating nothing (the registry's
    ``abstract_params``)."""

    device = torch.device("meta")


SHAPE_ONLY = ShapeOnly()


def truncated_normal(gen: torch.Generator, shape, scale: float, dtype=torch.float32):
    """``scale`` times a standard normal truncated to [-3, 3], drawn by
    inverse-CDF sampling from ``gen`` on its device (JAX's
    ``truncated_normal(key, -3, 3)``; the two give different numbers
    from the same seed). With :data:`SHAPE_ONLY`, an empty meta tensor."""
    out = torch.empty(shape, dtype=dtype, device=gen.device)
    if out.is_meta:
        return out
    out.uniform_(2.0 * _PHI_LO - 1.0, 2.0 * _PHI_HI - 1.0, generator=gen)
    return out.erfinv_().mul_(math.sqrt(2.0)).clamp_(-3.0, 3.0).mul_(scale)


def dense_init(gen: torch.Generator, d_in: int, d_out: int):
    return truncated_normal(gen, (d_in, d_out), 1.0 / math.sqrt(d_in))


# --------------------------------------------------------------------------
# Norms
# --------------------------------------------------------------------------
def init_rmsnorm(d: int, device) -> dict:
    return {"norm_w": torch.ones((d,), dtype=torch.float32, device=device)}


def rms_norm(p: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * p["norm_w"]
    return out.to(x.dtype)


def init_layernorm(d: int, device) -> dict:
    return {"norm_w": torch.ones((d,), dtype=torch.float32, device=device),
            "norm_bias": torch.zeros((d,), dtype=torch.float32, device=device)}


def layer_norm(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)  # jnp.var
    out = (xf - mu) * torch.rsqrt(var + eps) * p["norm_w"] + p["norm_bias"]
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# RoPE (half-split, not interleaved; fp32 angles)
# --------------------------------------------------------------------------
def rope_freqs(d_head: int, theta: float = 10000.0, device=None) -> torch.Tensor:
    exps = torch.arange(0, d_head, 2, dtype=torch.float32, device=device) / d_head
    return 1.0 / (torch.tensor(theta, dtype=torch.float32, device=device) ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """x: (..., L, H, Dh) or (..., L, Dh); positions: (..., L)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)  # (dh/2,)
    ang = positions[..., None].float() * freqs  # (..., L, dh/2)
    if x.dim() == ang.dim() + 1:  # head axis present
        ang = ang[..., None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


@functools.lru_cache(maxsize=16)
def _sinusoidal_table(length: int, d: int) -> torch.Tensor:
    pos = np.arange(length)[:, None]
    div = np.exp(np.arange(0, d, 2) * (-np.log(10000.0) / d))
    pe = np.zeros((length, d), np.float32)
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return torch.from_numpy(pe)


def sinusoidal_positions(length: int, d: int, device=None) -> torch.Tensor:
    """(length, d) fp32 sin/cos table, computed in float64 numpy as JAX's
    is (so the two are bit-equal); a copy on every device, the CPU too,
    so the dry run's counter sees the same ops everywhere."""
    return _sinusoidal_table(length, d).to(device, copy=True)


# --------------------------------------------------------------------------
# MLPs
# --------------------------------------------------------------------------
def init_swiglu(gen: torch.Generator, d_model: int, d_ff: int) -> dict:
    return {
        "w_gate": dense_init(gen, d_model, d_ff),
        "w_up": dense_init(gen, d_model, d_ff),
        "w_down": dense_init(gen, d_ff, d_model),
    }


def _act_hidden(h: torch.Tensor) -> torch.Tensor:
    """Constrain an MLP hidden activation of any rank: leading axis on
    the DP axes, trailing (ffn) axis on "model"."""
    return pt.act(h, "batch", *([None] * (h.dim() - 2)), "model")


def swiglu(p: dict, x: torch.Tensor, compute_dtype=DEFAULT_COMPUTE) -> torch.Tensor:
    xc = x.to(compute_dtype)
    g = pt.column_parallel(xc, p["w_gate"].to(compute_dtype))
    u = pt.column_parallel(xc, p["w_up"].to(compute_dtype))
    h = torch.nn.functional.silu(g.float()).to(compute_dtype) * u
    return pt.row_parallel(_act_hidden(h), p["w_down"].to(compute_dtype))


def init_gelu_mlp(gen: torch.Generator, d_model: int, d_ff: int) -> dict:
    return {"w_up": dense_init(gen, d_model, d_ff), "w_down": dense_init(gen, d_ff, d_model)}


def gelu_mlp(p: dict, x: torch.Tensor, compute_dtype=DEFAULT_COMPUTE) -> torch.Tensor:
    xc = x.to(compute_dtype)
    h = pt.column_parallel(xc, p["w_up"].to(compute_dtype))
    # jax.nn.gelu's default is the tanh approximation
    h = torch.nn.functional.gelu(h.float(), approximate="tanh").to(compute_dtype)
    return pt.row_parallel(_act_hidden(h), p["w_down"].to(compute_dtype))


# --------------------------------------------------------------------------
# Embedding / logits
# --------------------------------------------------------------------------
def init_embed(gen: torch.Generator, vocab: int, d_model: int, tied: bool = True) -> dict:
    # 1/sqrt(d) scale keeps tied-unembedding logits O(1) at init.
    p = {"embed": truncated_normal(gen, (vocab, d_model), 1.0 / math.sqrt(d_model))}
    if not tied:
        p["unembed"] = truncated_normal(gen, (vocab, d_model), 1.0 / math.sqrt(d_model))
    return p


def embed(p: dict, tokens: torch.Tensor, compute_dtype=DEFAULT_COMPUTE) -> torch.Tensor:
    """Gather, then cast: the same values as JAX's cast-then-take. Under a
    mesh each rank gathers its own rows (batch over DP) from its whole
    copy of the table (``partitioning.on_local``; DTensor in torch 2.11
    cannot lay out the backward's ``index_put``), and the table's gradient
    is the sum over DP of the ranks' scatter-adds."""
    w = p["embed"]
    rows = ("batch",) + (None,) * (tokens.dim() - 1)
    out = pt.on_local(lambda w, t: w[t.long()].to(compute_dtype), (w, tokens), ((), rows),
                      (rows + (None,),), (tuple(tokens.shape) + (w.shape[-1],),),
                      partial={0: ("batch",)})
    return pt.act(out, "batch", None, None)


def logits(p: dict, x: torch.Tensor, compute_dtype=DEFAULT_COMPUTE) -> torch.Tensor:
    w = p.get("unembed", p["embed"]).to(compute_dtype)
    xc = pt.seq_whole(x).to(compute_dtype)
    lg = (pt.column_parallel(xc, w.T) if pt.vocab_split(w.shape[0])
          else pt.replica_product(xc, w.T))
    return pt.act_vocab(lg).float()


def cross_entropy(lg: torch.Tensor, labels: torch.Tensor, z_loss: float = 1e-4) -> torch.Tensor:
    """Mean token cross-entropy with optional z-loss, fp32 accumulation.

    JAX picks the label's logit by an iota-compare sum over the vocab (a
    sum of zeros and one term: the same value as a gather), so that
    vocab-sharded logits need no all-gather. Plain tensors take the
    gather; DTensor logits (a mesh run, the vocab maybe on "model") take
    JAX's sum."""
    lg = lg.float()
    lse = torch.logsumexp(lg, dim=-1)
    if pt.is_dtensor(lg):
        vocab = torch.arange(lg.shape[-1], device=lg.device)
        ll = torch.where(vocab == labels.long()[..., None], lg, 0.0).sum(dim=-1)
    else:
        ll = torch.gather(lg, -1, labels.long()[..., None])[..., 0]
    loss = lse - ll
    if z_loss:
        loss = loss + z_loss * lse**2
    return torch.mean(loss)
