"""Mixture-of-Experts: shared + routed experts, top-k, sort-based
static-capacity dispatch (DeepSeek-MoE / DeepSeek-V2 style).

Port of ``repro.models.moe``. Dispatch is JAX's sort formulation: flatten
the (token, slot) assignments, sort them by expert id (stably, so token
order is kept within an expert), take each entry's rank within its
expert and scatter it into an (E, capacity, d) buffer; entries past an
expert's capacity go to one extra row that is dropped (JAX's
``mode="drop"``), and the dropped fraction is returned as a metric.

The router runs in fp32. Top-k breaks ties to the lower expert index,
as ``jax.lax.top_k`` does (a stable descending sort; ``torch.topk`` makes
no such promise). The combine adds each token's k weighted expert
outputs in bf16 in one fixed order, the order of JAX's scatter-add (by
expert id), with gathers and no atomics, so two runs on the card are
bit-equal. The expert products are plain batched products, as in JAX,
where no Pallas kernel computes them.

Under a mesh (``partitioning.use_mesh``) the (E, capacity, d) buffer and
the experts' hidden take JAX's hints: experts on "model", and with
``cap_shard`` the capacity on the DP axes. Routing, dispatch and combine
are global (the sort and the capacity drops run over every token of the
batch), so each rank runs them on whole copies of their inputs
(``partitioning.on_replicas``): the routers and drops are those of the
run without a mesh, given the same router inputs.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models import layers
from repro_torch.models import partitioning as pt


def init_moe(gen: torch.Generator, d_model: int, d_expert: int, n_routed: int, n_shared: int,
             d_shared: int | None = None) -> dict:
    """Routed experts stored stacked on a leading E axis."""
    d_shared = d_shared or d_expert * n_shared
    p = {
        "router": layers.truncated_normal(gen, (d_model, n_routed), 1.0 / math.sqrt(d_model)),
        "experts": {
            "w_gate": layers.truncated_normal(gen, (n_routed, d_model, d_expert),
                                              1.0 / math.sqrt(d_model)),
            "w_up": layers.truncated_normal(gen, (n_routed, d_model, d_expert),
                                            1.0 / math.sqrt(d_model)),
            "w_down": layers.truncated_normal(gen, (n_routed, d_expert, d_model),
                                              1.0 / math.sqrt(d_expert)),
        },
    }
    if n_shared:
        p["shared"] = layers.init_swiglu(gen, d_model, d_shared)
    return p


def top_k(score: torch.Tensor, k: int):
    """The k largest entries of each row and their indices, ties to the
    lower index (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(score, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def expert_counts(idx: torch.Tensor, n_experts: int) -> torch.Tensor:
    """(n_experts,) int64: how often each expert id occurs in ``idx``
    (``torch.bincount``'s integers, by a scatter-add that every device,
    meta included, runs; integer sums do not depend on their order)."""
    flat = idx.reshape(-1).long()
    return torch.zeros(n_experts, dtype=torch.int64, device=idx.device).scatter_add_(
        0, flat, torch.ones_like(flat))


def router_topk(p: dict, x: torch.Tensor, top_k_: int, *, bias=None):
    """Softmax-then-topk router (DeepSeek style). x: (T, d). Returns
    (weights (T, k) fp32, experts (T, k) int32, aux load-balance loss)."""
    probs = torch.softmax(x.float() @ p["router"].float(), dim=-1)  # (T, E)
    score = probs if bias is None else probs + bias
    w, idx = top_k(score, top_k_)
    if bias is not None:
        w = torch.gather(probs, 1, idx)
    # aux loss (Switch): E * mean_e(frac_tokens_e * mean_prob_e)
    n_experts = probs.shape[-1]
    hits = expert_counts(idx, n_experts).float()
    frac = hits / hits.sum().clamp_min(1.0)
    aux = n_experts * torch.sum(frac * probs.mean(dim=0))
    return w, idx.to(torch.int32), aux


def capacity(n_tokens: int, top_k_: int, n_routed: int, capacity_factor: float) -> int:
    """Rows per expert: ceil(T k / E cf) in Python floats, as JAX's
    ``np.ceil``, at least 8 and padded to a multiple of 8."""
    cap = math.ceil(n_tokens * top_k_ / n_routed * capacity_factor)
    return max(8, -(-cap // 8) * 8)


def dispatch_sort(x: torch.Tensor, expert_idx: torch.Tensor, weights: torch.Tensor,
                  n_experts: int, capacity_: int, cap_shard: bool = False):
    """Sort-based dispatch. x: (T, d); expert_idx/weights: (T, k).

    Returns (buf (E, cap, d), combine-info (order, slot, keep, token_of,
    drop_frac)) where combine-info lets :func:`combine_sort` gather the
    expert outputs back per (token, slot). Under a mesh the dispatch runs
    on whole copies (:func:`partitioning.on_replicas`) and ``buf`` is laid
    out experts on "model" (and, with ``cap_shard``, capacity on DP).
    """
    buf, info = pt.on_replicas(_dispatch_sort, x, expert_idx, weights, n_experts, capacity_)
    # sharding capacity over the data axis keeps the dispatch scatter
    # distributed (E on "model" alone gathers the buffer to every shard)
    buf = (pt.act(buf, "model", "batch", None) if cap_shard
           else pt.act(buf, "model", None, None))
    return buf, info


def _dispatch_sort(x, expert_idx, weights, n_experts: int, capacity_: int):
    n_tok, d = x.shape
    k = expert_idx.shape[1]
    flat_e = expert_idx.reshape(-1).long()  # (T*k,)
    order = torch.argsort(flat_e, stable=True)  # stable: token order kept
    sorted_e = flat_e[order]
    counts = expert_counts(flat_e, n_experts)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(n_tok * k, device=x.device) - starts[sorted_e]
    keep = pos < capacity_
    slot = torch.where(keep, sorted_e * capacity_ + pos, n_experts * capacity_)
    token_of = order // k  # original token per sorted entry
    buf = x.new_zeros((n_experts * capacity_ + 1, d))
    buf[slot] = x[token_of]  # the dropped entries all land in the extra last row
    buf = buf[:-1].reshape(n_experts, capacity_, d)
    drop_frac = 1.0 - keep.float().mean()
    return buf, (order, slot, keep, token_of, drop_frac)


def combine_positions(order: torch.Tensor, n_tok: int, k: int) -> torch.Tensor:
    """(T, k): each token's positions in the sorted entries, ascending,
    which is the order JAX's ``.at[token_of].add`` adds them in."""
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.numel(), device=order.device)
    return torch.sort(inv.reshape(n_tok, k), dim=1).values


def combine_sort(y_buf: torch.Tensor, info, weights: torch.Tensor, n_tok: int) -> torch.Tensor:
    """Gather expert outputs back and weight-combine. y_buf: (E, cap, d).
    Each token's k terms are added in y_buf's dtype, one after another in
    :func:`combine_positions`' order, onto zeros: no atomics, one order.
    Under a mesh, on whole copies (:func:`partitioning.on_replicas`)."""
    return pt.on_replicas(_combine_sort, y_buf, info, weights, n_tok)


def _combine_sort(y_buf, info, weights, n_tok: int):
    order, slot, keep, _, _ = info
    n_exp, cap, d = y_buf.shape
    k = order.numel() // n_tok
    flat = torch.cat([y_buf.reshape(n_exp * cap, d), y_buf.new_zeros((1, d))])
    y_sorted = flat[slot.clamp(max=n_exp * cap)]  # (T*k, d), dropped -> 0
    y_sorted = torch.where(keep[:, None], y_sorted, 0)
    w_flat = weights.reshape(-1)[order].to(y_buf.dtype)
    terms = y_sorted * w_flat[:, None]
    out = y_buf.new_zeros((n_tok, d))
    for pos in combine_positions(order, n_tok, k).T:
        out = out + terms[pos]
    return out


def expert_ffn(p_experts: dict, buf: torch.Tensor, compute_dtype=layers.DEFAULT_COMPUTE,
               cap_shard: bool = False) -> torch.Tensor:
    """Batched SwiGLU over the (E, cap, d) buffer."""
    xc = buf.to(compute_dtype)
    g = torch.bmm(xc, p_experts["w_gate"].to(compute_dtype))
    u = torch.bmm(xc, p_experts["w_up"].to(compute_dtype))
    h = torch.nn.functional.silu(g.float()).to(compute_dtype) * u
    h = (pt.act(h, "model", "batch", None) if cap_shard
         else pt.act(h, "model", None, None))
    return torch.bmm(h, p_experts["w_down"].to(compute_dtype))


def moe_block(p: dict, x: torch.Tensor, *, top_k: int, n_routed: int,
              capacity_factor: float = 1.25, compute_dtype=layers.DEFAULT_COMPUTE,
              cap_shard: bool = False):
    """Full MoE block on (B, L, d). Returns (out, metrics dict with the
    0-d tensors ``aux_loss`` and ``drop_frac``)."""
    b, l, d = x.shape
    n_tok = b * l
    xf = x.reshape(n_tok, d)
    w, idx, aux = pt.on_replicas(lambda r, xs: router_topk({"router": r}, xs, top_k),
                                 p["router"], xf)
    cap = capacity(n_tok, top_k, n_routed, capacity_factor)
    buf, info = dispatch_sort(xf, idx, w, n_routed, cap, cap_shard=cap_shard)
    y_buf = expert_ffn(p["experts"], buf, compute_dtype, cap_shard=cap_shard)
    out = combine_sort(y_buf, info, w, n_tok)
    if "shared" in p:
        out = out + layers.swiglu(p["shared"], xf, compute_dtype)
    return out.reshape(b, l, d), {"aux_loss": aux, "drop_frac": info[4]}
