"""Decoder-only LM assembly: dense / vlm / MoE / MLA-MoE / SSM families
behind one config and three entry points (forward, prefill, decode_step).

Port of ``repro.models.transformer`` (the hybrid and encdec families are
``models.hybrid`` and ``models.encdec``, which use this module's layer
bodies and helpers). Parameters are a nested dict with JAX's keys
(``embed_tokens.embed``, ``layers.attn.wq``, ``final_norm.norm_w``, ...),
the per-layer tensors stacked along a leading (n_layers, ...) axis; caches
are NamedTuples of stacked (n_layers, ...) tensors, in JAX's layouts. A
Python loop over layers takes the place of ``lax.scan``. ``remat="full"``
runs each layer body under ``torch.utils.checkpoint`` where JAX wraps it
in ``jax.checkpoint`` (:func:`run_body`): a training forward keeps only
each layer's input and the backward recomputes the body. JAX's sharding
hints (``pt.act*``, ``models.partitioning``) stand where JAX has them, the
inter-layer carry's ``act_seq`` outside the checkpointed body; with
``moe_cap_shard`` the MoE buffers shard their capacity over DP. All of
them are the identity without a mesh (``partitioning.use_mesh``).
``attn_kv_hoist`` is kept for JAX's config and has no effect: JAX's hint
lays K and V out before its query-chunk loop, and here attention lays
them out once before it attends in every case.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.models import attention as attn_lib
from repro_torch.models import layers, mamba2, mla, moe
from repro_torch.models import partitioning as pt

@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | mla_moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    d_head: int = 0  # 0 -> d_model // n_heads
    rope_theta: float = 500000.0
    tied_embeddings: bool = True
    norm: str = "rms"
    mlp: str = "swiglu"
    # moe
    n_routed: int = 0
    n_shared: int = 0
    top_k: int = 0
    d_expert: int = 0
    first_k_dense: int = 0
    dense_ff: int = 0  # d_ff of the first_k_dense layers
    capacity_factor: float = 1.25
    # mla
    q_lora: int = 0
    kv_lora: int = 0
    qk_nope: int = 0
    qk_rope: int = 0
    v_head: int = 0
    # ssm / hybrid
    d_state: int = 0
    expand: int = 2
    ssm_head_dim: int = 64
    n_groups: int = 1
    d_conv: int = 4
    attn_every: int = 6  # hybrid: shared attn block period
    # encdec
    n_enc_layers: int = 0
    src_len: int = 1500
    # vlm
    n_patches: int = 0
    # execution
    remat: str = "none"  # none | full
    kv_mode: str = "dense"  # dense | anchored (RCLL-KV)
    kv_block: int = 128
    ssd_chunk: int = 128
    # perf variants of the JAX package (sharding and SSD options)
    attn_kv_hoist: bool = False
    ssd_compute: str = "fp32"
    moe_cap_shard: bool = False

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    @property
    def ssm_dims(self) -> mamba2.SSMDims:
        return mamba2.make_dims(self.d_model, self.d_state, expand=self.expand,
                                head_dim=self.ssm_head_dim, n_groups=self.n_groups,
                                d_conv=self.d_conv)

    @property
    def mla_dims(self) -> mla.MLADims:
        return mla.MLADims(self.n_heads, self.q_lora, self.kv_lora, self.qk_nope, self.qk_rope,
                           self.v_head)

    def param_count(self, params) -> int:
        return sum(t.numel() for t in _leaves(params))


#: Two bf16 evaluations of the model (the port against JAX on the CPU, the
#: kernel path against the plain path on the card) give teacher-forced
#: logits within this many bf16 ulps of each row's largest |logit|. Each
#: logit is rounded once to bf16 (half an ulp of itself), on top of the
#: bf16 roundings that flip where two evaluations accumulate in another
#: order or keep excess precision (XLA fuses without rounding): JAX's own
#: jitted and op-by-op runs of the SMOKE config differ by 1.75 such ulps,
#: the port and jitted JAX by 2 over a 140-step decode. 8 leaves 4x room.
LOGIT_TOL_ULPS = 8


def logit_tolerance(lg: torch.Tensor) -> torch.Tensor:
    """Per-row tolerance (..., 1) of logits ``lg`` (..., vocab):
    :data:`LOGIT_TOL_ULPS` bf16 ulps (2^(e - 7) for |x| in [2^e, 2^(e+1)))
    of the row's largest |logit|."""
    top = lg.abs().amax(dim=-1, keepdim=True).float().clamp_min(2.0**-126)
    return LOGIT_TOL_ULPS * torch.exp2(torch.floor(torch.log2(top)) - 7)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _map(tree, fn, key=""):
    if isinstance(tree, dict):
        return {k: _map(v, fn, k) for k, v in tree.items()}
    return fn(key, tree)


class _LayerSlice(torch.autograd.Function):
    """Layer i of a stacked (n_layers, ...) leaf that needs a gradient.
    The backward adds the layer's gradient into ``stacked.grad[i]`` in
    place (zeros first) and passes none on: ``select``'s backward would
    build a zero tensor of the whole stack for every layer and sum them,
    n_layers x the stack's bytes a step (~11 GB each time for
    llama3.2-3b). The stacked leaf's ``.grad`` is the same either way. On a
    mesh the zeros take the stack's placements and the in-place add
    brings each layer's gradient to them first (a gradient ``Partial``
    over an axis is summed over it as it is added)."""

    @staticmethod
    def forward(ctx, stacked, i):
        ctx.stacked, ctx.i = stacked, i
        return stacked[i]

    @staticmethod
    def backward(ctx, grad):
        stacked = ctx.stacked
        if stacked.grad is None:
            stacked.grad = torch.zeros_like(stacked)
        stacked.grad[ctx.i].add_(grad)
        return None, None


def _layer(t: torch.Tensor, i: int) -> torch.Tensor:
    if t.requires_grad and t.is_leaf and torch.is_grad_enabled():
        return _LayerSlice.apply(t, i)
    return t[i]


def remat_active(cfg, params: dict) -> bool:
    """Whether a forward runs its layer bodies under :func:`run_body`'s
    checkpoint: ``cfg.remat == "full"`` and autograd records (grad mode on,
    a parameter needs a gradient). Serving (``no_grad``, inference mode)
    never pays for a checkpoint."""
    return (cfg.remat == "full" and torch.is_grad_enabled()
            and any(t.requires_grad for t in _leaves(params)))


def run_body(remat: bool, body, *args, reentrant: bool = True):
    """``body(*args)``; with ``remat``, under ``torch.utils.checkpoint``,
    JAX's ``jax.checkpoint``: the forward keeps ``args`` and none of the
    body's own tensors, and the backward runs the body again to rebuild
    them (K7 again, with its logsumexp, where the body attends). The
    layers' parameters come in ``args``, sliced outside the body, so each
    layer's ``_LayerSlice`` backward runs once a step. No layer draws
    random numbers, so no RNG state is kept.

    The reentrant form runs the forward under ``no_grad`` and, in the
    backward, backpropagates through the recomputed body as one node: the
    gradient of a tensor in ``args`` reaches the rest of the graph as one
    sum. The non-reentrant form records the graph in the forward and drops
    each saved tensor through a Python hook (1,247 a llama3.2-3b forward),
    which made the forward host-bound and the step ~30 ms slower on the
    H100 (``tools/remat_forms.py``, PERF.md), but it keeps the graph's
    nodes, so every gradient sums in the order it would without remat. A
    caller whose ``args`` hold a tensor that is also read outside the body
    passes ``reentrant=False``, so that remat stays bit-equal to none. So
    does one whose tensor ``args`` need no gradient: the reentrant form
    sees only tensor ``args`` (not the parameters' dict), and would give
    the body's parameters none (raises ValueError)."""
    if not remat:
        return body(*args)
    if reentrant and not any(isinstance(a, torch.Tensor) and a.requires_grad for a in args):
        raise ValueError("reentrant remat needs a tensor argument that requires a gradient")
    return torch.utils.checkpoint.checkpoint(body, *args, use_reentrant=reentrant,
                                             preserve_rng_state=False)


def layer_params(params: dict, i: int, stack: str = "layers") -> dict:
    """Layer i's parameters: views into the stacked (n_layers, ...) tensors
    (for leaves that need a gradient, through :class:`_LayerSlice`: their
    gradients reach ``.grad`` by ``backward()``, not ``autograd.grad``)."""
    return _map(params[stack], lambda _, t: _layer(t, i))


#: The leaves JAX's apply functions read in fp32 (``.astype(f32)`` or
#: used as they are beside fp32 math): the norms' weights and biases, the
#: MoE router, mamba2's conv weights and bias and its SSM scalars. Every
#: other leaf is a matrix that JAX casts to the compute dtype at use.
FP32_LEAVES = frozenset({"norm_w", "norm_bias", "router", "conv_w", "conv_bias", "a_log",
                         "dt_bias", "d_skip"})


def _leaf_dtype(key: str, dtype):
    return torch.float32 if key in FP32_LEAVES else dtype


def cast_tree(tree: dict, dtype) -> dict:
    """``tree`` with every leaf but :data:`FP32_LEAVES` cast to ``dtype``."""
    return _map(tree, lambda key, t: t.to(_leaf_dtype(key, dtype)))


def compute_weights(params: dict, dtype=layers.DEFAULT_COMPUTE) -> dict:
    """The parameters with every matrix JAX casts at use cast once to the
    compute dtype; :data:`FP32_LEAVES` stay fp32. The apply functions cast
    each weight at use, as JAX does; handed this copy, those casts are
    free, and the values are the same (both round fp32 to bf16 to nearest
    even). A tree already in the compute dtype is returned as it is."""
    return cast_tree(params, dtype)


def stacked_layers(gen: torch.Generator, n: int, init_one, dtype=torch.float32) -> dict:
    """``n`` layers drawn one after another by ``init_one()`` (fp32, from
    ``gen``), each written into (n, ...) stacks made in ``dtype`` (fp32
    for :data:`FP32_LEAVES`) and released, so at most one fp32 layer
    lives beside the stacks."""
    stacked = None
    for i in range(n):
        layer = init_one()
        if stacked is None:
            stacked = _map(layer, lambda key, t: t.new_empty((n,) + tuple(t.shape),
                                                             dtype=_leaf_dtype(key, dtype)))
        for dst, src in zip(_leaves(stacked), _leaves(layer)):
            dst[i].copy_(src)  # a cast rounds to nearest even, as Tensor.to does
        del layer
    return stacked


# --------------------------------------------------------------------------
# Layer bodies (full-sequence + decode variants per family)
# --------------------------------------------------------------------------
def _init_norm(cfg, device) -> dict:
    return (layers.init_rmsnorm(cfg.d_model, device) if cfg.norm == "rms"
            else layers.init_layernorm(cfg.d_model, device))


def _norm(cfg, p, x):
    return layers.rms_norm(p, x) if cfg.norm == "rms" else layers.layer_norm(p, x)


def _init_mlp(gen, cfg, d_ff):
    return (layers.init_swiglu(gen, cfg.d_model, d_ff) if cfg.mlp == "swiglu"
            else layers.init_gelu_mlp(gen, cfg.d_model, d_ff))


def _mlp(cfg, p, x):
    return layers.swiglu(p, x) if cfg.mlp == "swiglu" else layers.gelu_mlp(p, x)


def _moe(cfg, p, x):
    return moe.moe_block(p, x, top_k=cfg.top_k, n_routed=cfg.n_routed,
                         capacity_factor=cfg.capacity_factor, cap_shard=cfg.moe_cap_shard)


def init_layer(gen: torch.Generator, cfg: ArchConfig) -> dict:
    """One layer's params (stacked into (n_layers, ...) by init_params)."""
    dev = gen.device
    p = {"ln1": _init_norm(cfg, dev)}
    if cfg.family in ("dense", "vlm", "moe"):
        p["attn"] = attn_lib.init_attention(gen, cfg.d_model, cfg.n_heads, cfg.n_kv,
                                            cfg.head_dim)
    elif cfg.family == "mla_moe":
        p["attn"] = mla.init_mla(gen, cfg.d_model, cfg.n_heads, q_lora=cfg.q_lora,
                                 kv_lora=cfg.kv_lora, qk_nope=cfg.qk_nope, qk_rope=cfg.qk_rope,
                                 v_head=cfg.v_head)
    elif cfg.family in ("ssm", "hybrid"):
        p["mixer"] = mamba2.init_mamba2(gen, cfg.ssm_dims)
    else:
        raise ValueError(cfg.family)
    if cfg.family in ("dense", "vlm", "mla_moe", "moe"):
        p["ln2"] = _init_norm(cfg, dev)
        if cfg.family in ("moe", "mla_moe"):
            p["moe"] = moe.init_moe(gen, cfg.d_model, cfg.d_expert, cfg.n_routed, cfg.n_shared,
                                    d_shared=cfg.n_shared * cfg.d_expert)
        else:
            p["mlp"] = _init_mlp(gen, cfg, cfg.d_ff)
    return p


def layer_forward(cfg: ArchConfig, p: dict, h, positions):
    """Full-sequence layer. Returns (h, cache tensors, aux)."""
    h = pt.seq_whole(h)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    if cfg.family in ("ssm", "hybrid"):
        out, cache = mamba2.mamba2_forward(p["mixer"], _norm(cfg, p["ln1"], h), cfg.ssm_dims,
                                           chunk=cfg.ssd_chunk, ssd_compute=cfg.ssd_compute)
        return h + out, cache, aux
    if cfg.family == "mla_moe":
        out, cache = mla.mla_full(p["attn"], _norm(cfg, p["ln1"], h), positions, cfg.mla_dims,
                                  rope_theta=cfg.rope_theta)
    else:  # dense / vlm / moe: GQA attention through K7
        out, cache = attn_lib.attention_full(
            p["attn"], _norm(cfg, p["ln1"], h), positions, n_heads=cfg.n_heads, n_kv=cfg.n_kv,
            d_head=cfg.head_dim, rope_theta=cfg.rope_theta)
    h = h + out
    if cfg.family in ("moe", "mla_moe"):
        mo, metrics = _moe(cfg, p["moe"], _norm(cfg, p["ln2"], h))
        return h + mo, cache, metrics["aux_loss"]
    return h + _mlp(cfg, p["mlp"], _norm(cfg, p["ln2"], h)), cache, aux


def layer_decode(cfg: ArchConfig, p: dict, h, cache_l):
    """Single-token decode layer. cache_l: this layer's cache (views)."""
    if cfg.family in ("ssm", "hybrid"):
        out, new_cache = mamba2.mamba2_decode(p["mixer"], _norm(cfg, p["ln1"], h), cache_l,
                                              cfg.ssm_dims)
        return h + out, new_cache
    if cfg.family == "mla_moe":
        out, new_cache = mla.mla_decode(p["attn"], _norm(cfg, p["ln1"], h), cache_l,
                                        cfg.mla_dims, rope_theta=cfg.rope_theta)
    else:
        dec = (attn_lib.decode_attention_anchored if cfg.kv_mode == "anchored"
               else attn_lib.decode_attention_dense)
        out, new_cache = dec(p["attn"], _norm(cfg, p["ln1"], h), cache_l, n_heads=cfg.n_heads,
                             n_kv=cfg.n_kv, d_head=cfg.head_dim, rope_theta=cfg.rope_theta)
    h = h + out
    if cfg.family in ("moe", "mla_moe"):
        mo, _ = _moe(cfg, p["moe"], _norm(cfg, p["ln2"], h))
        return h + mo, new_cache
    return h + _mlp(cfg, p["mlp"], _norm(cfg, p["ln2"], h)), new_cache


# --------------------------------------------------------------------------
# Model init / forward / decode
# --------------------------------------------------------------------------
def init_params(gen: torch.Generator, cfg: ArchConfig, dtype=torch.float32) -> dict:
    """Parameters on ``gen``'s device, drawn from ``gen`` in fp32 (the
    embedding, then layer by layer, then vlm's ``w_patch``), the layers
    stacked (n_layers, ...). With ``dtype`` bf16 every leaf but
    :data:`FP32_LEAVES` is cast as it is drawn, one layer at a time: the
    result equals ``compute_weights(init_params(gen, cfg))`` bit for bit,
    and peak memory is the bf16 model plus one fp32 layer."""
    p = {"embed_tokens": cast_tree(layers.init_embed(gen, cfg.vocab, cfg.d_model,
                                                     tied=cfg.tied_embeddings), dtype),
         "layers": stacked_layers(gen, cfg.n_layers, lambda: init_layer(gen, cfg), dtype),
         "final_norm": _init_norm(cfg, gen.device)}
    if cfg.family == "vlm":
        p["w_patch"] = layers.dense_init(gen, cfg.d_model, cfg.d_model).to(dtype)
    return p


def forward(params: dict, tokens: torch.Tensor, cfg: ArchConfig, *, patch_embeds=None,
            return_cache: bool = False):
    """Full-sequence forward. tokens: (B, L). Returns (logits, caches, aux):
    caches are the stacked (n_layers, ...) cache tensors of the family
    ((k, v), (c_kv, k_rope) or a ``Mamba2Cache``), aux the layers' summed
    MoE load-balance loss.

    vlm: patch_embeds (B, n_patches, d_model) replace the first n_patches
    positions (the modality-frontend stub)."""
    b, l = tokens.shape
    h = layers.embed(params["embed_tokens"], tokens)
    if cfg.family == "vlm" and patch_embeds is not None:
        pe = pt.replica_product(patch_embeds.to(h.dtype), params["w_patch"].to(h.dtype))
        h = torch.cat([pe, h[:, cfg.n_patches:]], dim=1)
    positions = torch.arange(l, device=tokens.device)[None].expand(b, l)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    caches = []
    remat = remat_active(cfg, params)
    for i in range(cfg.n_layers):
        h, cache_l, aux_l = run_body(remat, layer_forward, cfg, layer_params(params, i), h,
                                     positions)
        h = pt.act_seq(h)  # sequence-parallel inter-layer carry
        aux = aux + aux_l
        if return_cache:
            caches.append(cache_l)
    h = _norm(cfg, params["final_norm"], h)
    lg = layers.logits(params["embed_tokens"], h)
    if not return_cache:
        return lg, None, aux
    stacked = tuple(torch.stack(ts) for ts in zip(*caches))
    return lg, (type(caches[0])(*stacked) if hasattr(caches[0], "_fields") else stacked), aux


def loss_fn(params: dict, batch: dict, cfg: ArchConfig):
    """Next-token cross-entropy of ``batch["tokens"]`` against
    ``batch["labels"]`` shifted by one, plus 0.01 x the MoE load-balance
    loss; returns (loss, {"ce", "aux"})."""
    lg, _, aux = forward(params, batch["tokens"], cfg, patch_embeds=batch.get("patch_embeds"))
    loss = layers.cross_entropy(lg[:, :-1], batch["labels"][:, 1:])
    return loss + 0.01 * aux, {"ce": loss, "aux": aux}


def stack_cache(cache, n: int):
    """``n`` copies of a cache stacked on a new leading axis."""
    return type(cache)(*(t.unsqueeze(0).repeat(n, *([1] * t.dim())) for t in cache))


def layer_cache(cache, i: int):
    """Layer i's cache: views into the stacked tensors."""
    return type(cache)(*(t[i] for t in cache))


def init_cache(cfg: ArchConfig, batch: int, max_len: int, device=None):
    """Stacked (n_layers leading axis) empty cache."""
    if cfg.family in ("ssm", "hybrid"):
        one = mamba2.Mamba2Cache.init(batch, cfg.ssm_dims, device=device)
    elif cfg.family == "mla_moe":
        one = mla.MLACache.init(batch, max_len, cfg.kv_lora, cfg.qk_rope, device=device)
    elif cfg.kv_mode == "anchored":
        one = attn_lib.AnchoredKVCache.init(batch, max_len, cfg.n_kv, cfg.head_dim,
                                            block=cfg.kv_block, device=device)
    else:
        one = attn_lib.DenseKVCache.init(batch, max_len, cfg.n_kv, cfg.head_dim, device=device)
    return stack_cache(one, cfg.n_layers)


def decode_step(params: dict, tokens: torch.Tensor, cache, cfg: ArchConfig):
    """One-token decode. tokens: (B, 1). Returns (logits, cache): the
    cache's storage is updated in place (``models.attention``, ``mla``,
    ``mamba2``) and the returned cache carries the new lengths."""
    h = layers.embed(params["embed_tokens"], tokens)
    lengths = []
    for i in range(cfg.n_layers):
        h, new_l = layer_decode(cfg, layer_params(params, i), h, layer_cache(cache, i))
        if hasattr(new_l, "length"):
            lengths.append(new_l.length)
    h = _norm(cfg, params["final_norm"], h)
    lg = layers.logits(params["embed_tokens"], h)
    return lg, (cache._replace(length=torch.stack(lengths)) if lengths else cache)


def pad_seq(t: torch.Tensor, max_len: int) -> torch.Tensor:
    """(n_layers, B, L, ...) -> bf16, zero-padded to max_len along L (no
    pad where L is max_len: DTensor in torch 2.11 refuses even a pad of
    nothing)."""
    t = t.to(torch.bfloat16)
    if t.shape[2] == max_len:
        return t
    return F.pad(t, (0, 0) * (t.dim() - 3) + (0, max_len - t.shape[2]))


def prefill(params: dict, tokens: torch.Tensor, cfg: ArchConfig, max_len: int, *,
            patch_embeds=None):
    """Prefill: forward + build a decode-ready cache of size max_len."""
    b, l = tokens.shape
    lg, caches, _ = forward(params, tokens, cfg, patch_embeds=patch_embeds, return_cache=True)
    if cfg.family in ("ssm", "hybrid"):
        return lg, caches  # stacked Mamba2Cache (state + conv tail)
    length = torch.full((b,), l, dtype=torch.int32, device=tokens.device)
    stacked_length = length.expand(cfg.n_layers, b).clone()
    if cfg.family == "mla_moe":
        c_kv, k_rope = caches  # (n_layers, B, L, *)
        return lg, mla.MLACache(c_kv=pad_seq(c_kv, max_len), k_rope=pad_seq(k_rope, max_len),
                                length=stacked_length)
    k, v = (pad_seq(t, max_len) for t in caches)  # (n_layers, B, max_len, Hkv, Dh)
    if cfg.kv_mode == "anchored":
        per_layer = [attn_lib.anchored_cache_from_prefill(k[i], v[i], length, block=cfg.kv_block)
                     for i in range(cfg.n_layers)]
        return lg, attn_lib.AnchoredKVCache(*(torch.stack(ts) for ts in zip(*per_layer)))
    return lg, attn_lib.DenseKVCache(k=k, v=v, length=stacked_length)
