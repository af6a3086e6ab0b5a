"""Port parity, the mla_moe family: ``models.mla`` (init_mla, MLACache,
mla_full, mla_decode with the absorbed W_uk / W_uv) against JAX's on the
same seeded inputs, and deepseek-v2-236b's SMOKE config served against
JAX (run op by op there, see ``lm_parity``).

Stated bounds: MLA's attention is fp32 over bf16 projections, as in JAX;
the projections may flip a bf16 rounding where their fp32 sums run in
another order, so the outputs (bf16) and the cached latents and rope
keys are held to ``lm_parity.assert_bf16_close`` (8 bf16 ulps of each
row's largest entry), the logits to ``transformer.logit_tolerance``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lm_parity as lp
from repro.models import mla as jmla
from repro.models import transformer as jtr
from repro_torch.core import interop
from repro_torch.models import mla as tmla
from repro_torch.models import transformer as ttr
from test_torch_helpers import one_torch_thread  # noqa: F401  (autouse fixture)

ARCH = "deepseek-v2-236b"


def _layer(seed=0):
    cj, ct = lp.cfgs(ARCH)
    d = cj.mla_dims
    pj = jmla.init_mla(jax.random.key(seed), cj.d_model, cj.n_heads, q_lora=d.q_lora,
                       kv_lora=d.kv_lora, qk_nope=d.qk_nope, qk_rope=d.qk_rope, v_head=d.v_head)
    pt = ttr.compute_weights(interop.lm_params_from_numpy(lp.flat_params(pj), "cpu"))
    return cj, ct, pj, pt


def _x(b, l, d, seed=1):
    xj = jnp.asarray(np.random.default_rng(seed).normal(size=(b, l, d)), jnp.bfloat16)
    return xj, torch.as_tensor(np.asarray(xj.astype(jnp.float32))).to(torch.bfloat16)


def _f32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32)) if not isinstance(
        x, torch.Tensor) else x.float().numpy()


def test_init_and_cache_layout():
    cj, ct, pj, _ = _layer()
    own = tmla.init_mla(torch.Generator().manual_seed(0), ct.d_model, ct.n_heads,
                        q_lora=ct.q_lora, kv_lora=ct.kv_lora, qk_nope=ct.qk_nope,
                        qk_rope=ct.qk_rope, v_head=ct.v_head)
    assert {k: tuple(v.shape) for k, v in lp.flat_params_t(own).items()} == {
        k: v.shape for k, v in lp.flat_params(pj).items()}
    want = jmla.MLACache.init(3, 40, cj.kv_lora, cj.qk_rope)
    got = tmla.MLACache.init(3, 40, ct.kv_lora, ct.qk_rope)
    assert got._fields == want._fields
    for k in want._fields:
        w, g = getattr(want, k), getattr(got, k)
        assert tuple(g.shape) == w.shape and str(g.dtype).split(".")[-1] == str(w.dtype), k
    for mode in ("anchored", "dense"):  # MLA keeps its latent cache under either kv_mode
        cj_m, ct_m = lp.cfgs(ARCH, mode)
        assert type(ttr.init_cache(ct_m, 2, 256)).__name__ == "MLACache"
        assert type(jtr.init_cache(cj_m, 2, 256)).__name__ == "MLACache"


@pytest.mark.parametrize("l", [64, 512])
def test_mla_full(l):
    """L 512 takes JAX's 256-row query chunks, 64 a single chunk."""
    cj, ct, pj, pt = _layer()
    xj, xt = _x(2, l, cj.d_model)
    pos = np.broadcast_to(np.arange(l)[None], (2, l))
    out_j, (ckv_j, kr_j) = jmla.mla_full(pj, xj, jnp.asarray(pos), cj.mla_dims,
                                         rope_theta=cj.rope_theta)
    out_t, (ckv_t, kr_t) = tmla.mla_full(pt, xt, torch.as_tensor(pos), ct.mla_dims,
                                         rope_theta=ct.rope_theta)
    assert out_t.dtype == torch.bfloat16 and ckv_t.dtype == torch.bfloat16
    lp.assert_bf16_close(_f32(out_t), _f32(out_j), "out")
    lp.assert_bf16_close(_f32(ckv_t), _f32(ckv_j), "c_kv")
    lp.assert_bf16_close(_f32(kr_t), _f32(kr_j), "k_rope")


def test_mla_decode_in_place():
    """Three absorbed-form steps from a cache of JAX's values: the same
    outputs and cache rows; the port writes into the cache's storage."""
    cj, ct, pj, pt = _layer()
    rng = np.random.default_rng(2)
    c_j = jmla.MLACache(
        c_kv=jnp.asarray(rng.normal(size=(2, 48, cj.kv_lora)), jnp.bfloat16),
        k_rope=jnp.asarray(rng.normal(size=(2, 48, cj.qk_rope)), jnp.bfloat16),
        length=jnp.asarray([20, 33], jnp.int32))
    c_t = interop.kv_cache_from_numpy(tmla.MLACache, lp.jax_cache_numpy(c_j), "cpu")
    storage = c_t.c_kv
    for step in range(3):
        xj, xt = _x(2, 1, cj.d_model, seed=10 + step)
        out_j, c_j = jmla.mla_decode(pj, xj, c_j, cj.mla_dims, rope_theta=cj.rope_theta)
        out_t, c_t = tmla.mla_decode(pt, xt, c_t, ct.mla_dims, rope_theta=ct.rope_theta)
        lp.assert_bf16_close(_f32(out_t), _f32(out_j), f"step {step}")
    assert c_t.c_kv is storage
    got, want = interop.kv_cache_to_numpy(c_t), lp.jax_cache_numpy(c_j)
    np.testing.assert_array_equal(got["length"], [23, 36])
    np.testing.assert_array_equal(got["length"], want["length"])
    for k in ("c_kv", "k_rope"):
        lp.assert_bf16_close(got[k], want[k], k)


def test_mla_decode_matches_full():
    """The absorbed decode of the next token against the materialized
    full-sequence form (the port alone): W_uk folded into the query is
    the same attention."""
    _, ct, _, pt = _layer()
    _, xt = _x(2, 17, ct.d_model, seed=3)
    pos = torch.arange(17)[None].expand(2, 17)
    out_full, (ckv, kr) = tmla.mla_full(pt, xt, pos, ct.mla_dims, rope_theta=ct.rope_theta)
    cache = tmla.MLACache.init(2, 24, ct.kv_lora, ct.qk_rope)
    cache.c_kv[:, :16] = ckv[:, :16]
    cache.k_rope[:, :16] = kr[:, :16]
    cache = cache._replace(length=torch.full((2,), 16, dtype=torch.int32))
    out_dec, _ = tmla.mla_decode(pt, xt[:, 16:], cache, ct.mla_dims, rope_theta=ct.rope_theta)
    lp.assert_bf16_close(out_dec.float().numpy(), out_full[:, 16:].float().numpy(), "decode")


def test_prefill_and_teacher_forced_decode():
    """SMOKE prefill logits and MLACache, then 3 decode steps fed JAX's
    tokens."""
    out = lp.run_both(ARCH, "dense", 2, 128, 256, 3)
    assert out["cache_types"][0].__name__ == out["cache_types"][1].__name__ == "MLACache"
    lp.assert_logits_close(*out["prefill"], "prefill", out["prefill_rows"])
    got, want = out["prefill_cache"]
    lp.assert_same_layout(got, want)
    np.testing.assert_array_equal(got["length"], want["length"])
    for k in ("c_kv", "k_rope"):
        lp.assert_bf16_close(got[k], want[k], k)
    lp.assert_logits_close(*out["decode"], "teacher-forced decode", out["decode_rows"])
    got, want = out["cache"]
    np.testing.assert_array_equal(got["length"], want["length"])


def test_serve_run_tokens():
    lp.serve_tokens_match(ARCH, "anchored", b=2, gen=6)  # max_len 256, run_both's shapes
