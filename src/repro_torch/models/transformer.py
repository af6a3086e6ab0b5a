"""Decoder-only LM assembly: one config and three entry points (forward,
prefill, decode_step).

Port of ``repro.models.transformer`` for the dense family (the
llama3.2-3b serving path). Parameters are a nested dict with JAX's keys
(``embed_tokens.embed``, ``layers.attn.wq``, ``final_norm.norm_w``, ...),
the per-layer tensors stacked along a leading (n_layers, ...) axis; caches
are NamedTuples of stacked (n_layers, ...) tensors, in JAX's layouts. A
Python loop over layers takes the place of ``lax.scan``; ``remat`` only
changes what JAX keeps for a backward pass and has no meaning here. The
moe, mla_moe, ssm/hybrid, encdec and vlm families are not ported (ROADMAP
Queue 1 item 10b).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.models import attention as attn_lib
from repro_torch.models import layers

#: Families of the JAX package the port does not run yet.
UNPORTED_FAMILIES = ("moe", "mla_moe", "ssm", "hybrid", "encdec", "vlm")
UNPORTED_ITEM = "ROADMAP Queue 1 item 10b (the other model families)"


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


def _require_dense(cfg: ArchConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(f"family {cfg.family!r} ({cfg.name}) is not ported: "
                                  f"{UNPORTED_ITEM}")
    if cfg.norm != "rms" or cfg.mlp != "swiglu":
        raise NotImplementedError(f"{cfg.name}: only rms norm and the SwiGLU MLP are ported "
                                  f"({UNPORTED_ITEM})")


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


def layer_params(params: dict, i: int) -> dict:
    """Layer i's parameters: views into the stacked (n_layers, ...) tensors."""
    return _map(params["layers"], lambda _, t: t[i])


def compute_weights(params: dict, dtype=layers.DEFAULT_COMPUTE) -> dict:
    """The parameters with every weight matrix cast once to the compute
    dtype (the norm weights stay fp32). The apply functions cast each
    weight at use, as JAX does; handed this copy, those casts are free,
    and the values are the same (both round fp32 to bf16 to nearest even)."""
    return _map(params, lambda key, t: t if key == "norm_w" else t.to(dtype))


# --------------------------------------------------------------------------
# Layer bodies
# --------------------------------------------------------------------------
def init_layer(gen: torch.Generator, cfg: ArchConfig) -> dict:
    """One layer's params (stacked into (n_layers, ...) by init_params)."""
    _require_dense(cfg)
    dev = gen.device
    return {
        "ln1": layers.init_rmsnorm(cfg.d_model, dev),
        "attn": attn_lib.init_attention(gen, cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim),
        "ln2": layers.init_rmsnorm(cfg.d_model, dev),
        "mlp": layers.init_swiglu(gen, cfg.d_model, cfg.d_ff),
    }


def layer_forward(cfg: ArchConfig, p: dict, h, positions):
    """Full-sequence layer. Returns (h, (k, v), aux)."""
    out, (k, v) = attn_lib.attention_full(
        p["attn"], layers.rms_norm(p["ln1"], h), positions, n_heads=cfg.n_heads, n_kv=cfg.n_kv,
        d_head=cfg.head_dim, rope_theta=cfg.rope_theta)
    h = h + out
    h = h + layers.swiglu(p["mlp"], layers.rms_norm(p["ln2"], h))
    return h, (k, v), torch.zeros((), dtype=torch.float32, device=h.device)


def layer_decode(cfg: ArchConfig, p: dict, h, cache_l):
    """Single-token decode layer. cache_l: this layer's cache (views)."""
    dec = (attn_lib.decode_attention_anchored if cfg.kv_mode == "anchored"
           else attn_lib.decode_attention_dense)
    out, new_cache = dec(p["attn"], layers.rms_norm(p["ln1"], h), cache_l, n_heads=cfg.n_heads,
                         n_kv=cfg.n_kv, d_head=cfg.head_dim, rope_theta=cfg.rope_theta)
    h = h + out
    return h + layers.swiglu(p["mlp"], layers.rms_norm(p["ln2"], h)), new_cache


# --------------------------------------------------------------------------
# Model init / forward / decode
# --------------------------------------------------------------------------
def init_params(gen: torch.Generator, cfg: ArchConfig) -> dict:
    """fp32 master parameters on ``gen``'s device, drawn from ``gen`` (the
    embedding, then layer by layer), the layers stacked (n_layers, ...)."""
    _require_dense(cfg)
    p = {"embed_tokens": layers.init_embed(gen, cfg.vocab, cfg.d_model,
                                           tied=cfg.tied_embeddings)}
    first = init_layer(gen, cfg)
    stacked = _map(first, lambda _, t: t.new_empty((cfg.n_layers,) + tuple(t.shape)))
    for i in range(cfg.n_layers):
        layer = first if i == 0 else init_layer(gen, cfg)
        for dst, src in zip(_leaves(stacked), _leaves(layer)):
            dst[i].copy_(src)
    p["layers"] = stacked
    p["final_norm"] = layers.init_rmsnorm(cfg.d_model, gen.device)
    return p


def forward(params: dict, tokens: torch.Tensor, cfg: ArchConfig, *, return_cache: bool = False):
    """Full-sequence forward. tokens: (B, L). Returns (logits, caches, aux);
    caches are the stacked (n_layers, B, L, Hkv, Dh) k and v."""
    _require_dense(cfg)
    b, l = tokens.shape
    h = layers.embed(params["embed_tokens"], tokens)
    positions = torch.arange(l, device=tokens.device)[None].expand(b, l)
    ks, vs = [], []
    for i in range(cfg.n_layers):
        h, (k, v), _ = layer_forward(cfg, layer_params(params, i), h, positions)
        if return_cache:
            ks.append(k)
            vs.append(v)
    h = layers.rms_norm(params["final_norm"], h)
    lg = layers.logits(params["embed_tokens"], h)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)  # dense layers add none
    return lg, ((torch.stack(ks), torch.stack(vs)) if return_cache else None), aux


def _stack(cache, n_layers: int):
    return type(cache)(*(t.unsqueeze(0).repeat(n_layers, *([1] * t.dim())) for t in cache))


def _layer_cache(cache, i: int):
    return type(cache)(*(t[i] for t in cache))


def init_cache(cfg: ArchConfig, batch: int, max_len: int, device=None):
    """Stacked (n_layers leading axis) empty cache."""
    _require_dense(cfg)
    if cfg.kv_mode == "anchored":
        one = attn_lib.AnchoredKVCache.init(batch, max_len, cfg.n_kv, cfg.head_dim,
                                            block=cfg.kv_block, device=device)
    else:
        one = attn_lib.DenseKVCache.init(batch, max_len, cfg.n_kv, cfg.head_dim, device=device)
    return _stack(one, cfg.n_layers)


def decode_step(params: dict, tokens: torch.Tensor, cache, cfg: ArchConfig):
    """One-token decode. tokens: (B, 1). Returns (logits, cache): the
    cache's storage is updated in place (``models.attention``) and the
    returned cache carries the new lengths."""
    _require_dense(cfg)
    h = layers.embed(params["embed_tokens"], tokens)
    lengths = []
    for i in range(cfg.n_layers):
        h, new_l = layer_decode(cfg, layer_params(params, i), h, _layer_cache(cache, i))
        lengths.append(new_l.length)
    h = layers.rms_norm(params["final_norm"], h)
    return layers.logits(params["embed_tokens"], h), cache._replace(length=torch.stack(lengths))


def prefill(params: dict, tokens: torch.Tensor, cfg: ArchConfig, max_len: int):
    """Prefill: forward + build a decode-ready cache of size max_len."""
    b, l = tokens.shape
    lg, (k, v), _ = forward(params, tokens, cfg, return_cache=True)
    length = torch.full((b,), l, dtype=torch.int32, device=tokens.device)
    pad = (0, 0, 0, 0, 0, max_len - l)  # along the sequence axis
    k = F.pad(k.to(torch.bfloat16), pad)
    v = F.pad(v.to(torch.bfloat16), pad)
    if cfg.kv_mode == "anchored":
        per_layer = [attn_lib.anchored_cache_from_prefill(k[i], v[i], length, block=cfg.kv_block)
                     for i in range(cfg.n_layers)]
        return lg, attn_lib.AnchoredKVCache(*(torch.stack(ts) for ts in zip(*per_layer)))
    return lg, attn_lib.DenseKVCache(k=k, v=v, length=length.expand(cfg.n_layers, b).clone())
