"""Port parity, the encdec family: ``layers`` (init_layernorm/layer_norm,
init_gelu_mlp/gelu_mlp, sinusoidal_positions), ``attention.
cross_attention`` and ``models.encdec`` (encode, decoder_forward,
EncDecCache, prefill, decode_step) against JAX's, and whisper-large-v3's
SMOKE config served against JAX (src_len 64).

Stated bounds: the sinusoidal table is float64 numpy in both (equal);
layer norm's fp32 mean and variance sum in another order (n u relative,
one bf16 rounding flip in bf16); GELU (tanh form) and the products flip
bf16 roundings where the fp32 sums differ (``lm_parity.assert_bf16_close``);
logits within ``transformer.logit_tolerance``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lm_parity as lp
from repro.models import attention as jattn
from repro.models import encdec as jed
from repro.models import layers as jl
from repro_torch.core import interop
from repro_torch.models import attention as tattn
from repro_torch.models import encdec as ted
from repro_torch.models import layers as tl
from repro_torch.models import transformer as ttr
from test_torch_helpers import one_torch_thread  # noqa: F401  (autouse fixture)

ARCH = "whisper-large-v3"


def _bf16(x):
    xj = jnp.asarray(x, jnp.bfloat16)
    return xj, torch.as_tensor(np.asarray(xj.astype(jnp.float32))).to(torch.bfloat16)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.mark.parametrize("length,d", [(64, 64), (448, 1280), (1500, 1280), (7, 6)])
def test_sinusoidal_positions_bitwise(length, d):
    want = np.asarray(jl.sinusoidal_positions(length, d))
    got = tl.sinusoidal_positions(length, d).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
def test_layer_norm(dt):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 17, 96)) * 3.0 + 1.0
    p = {"norm_w": rng.uniform(0.5, 1.5, 96).astype(np.float32),
         "norm_bias": rng.normal(size=96).astype(np.float32)}
    xj = jnp.asarray(x, jnp.float32 if dt == "fp32" else jnp.bfloat16)
    xt = torch.as_tensor(_f32(xj)).to(torch.float32 if dt == "fp32" else torch.bfloat16)
    out_j = _f32(jl.layer_norm({k: jnp.asarray(v) for k, v in p.items()}, xj))
    out_t = tl.layer_norm({k: torch.as_tensor(v) for k, v in p.items()}, xt)
    assert out_t.dtype == xt.dtype
    if dt == "fp32":
        np.testing.assert_allclose(_f32(out_t), out_j, rtol=(96 + 4) * 2.0**-24, atol=1e-6)
    else:
        assert np.all(np.abs(_f32(out_t) - out_j) <= lp.bf16_ulp(out_j))
    init = tl.init_layernorm(5, "cpu")
    assert init["norm_w"].eq(1).all() and init["norm_bias"].eq(0).all()


def test_gelu_mlp():
    rng = np.random.default_rng(1)
    pj = {"w_up": jnp.asarray(rng.normal(size=(64, 128)) / 8, jnp.float32),
          "w_down": jnp.asarray(rng.normal(size=(128, 64)) / 11, jnp.float32)}
    pt = {k: torch.as_tensor(np.asarray(v)) for k, v in pj.items()}
    xj, xt = _bf16(rng.normal(size=(2, 33, 64)))
    lp.assert_bf16_close(_f32(tl.gelu_mlp(pt, xt)), _f32(jl.gelu_mlp(pj, xj)), "gelu_mlp")
    own = tl.init_gelu_mlp(torch.Generator().manual_seed(0), 64, 128)
    assert {k: tuple(v.shape) for k, v in own.items()} == {k: v.shape for k, v in pj.items()}


@pytest.mark.parametrize("lq,s", [(1, 64), (40, 64), (40, 1500)])
def test_cross_attention(lq, s):
    """K7's plain version (prefill) and plain sdpa (decode, one query):
    the same function as JAX's."""
    rng = np.random.default_rng(2)
    _, ct = lp.cfgs(ARCH)
    d, h, dh = ct.d_model, ct.n_heads, ct.head_dim
    pj = {k: jnp.asarray(rng.normal(size=shape) / np.sqrt(shape[0]), jnp.float32)
          for k, shape in (("wq", (d, h * dh)), ("wk", (d, h * dh)), ("wv", (d, h * dh)),
                           ("wo", (h * dh, d)))}
    pt = {k: torch.as_tensor(np.asarray(v)) for k, v in pj.items()}
    xj, xt = _bf16(rng.normal(size=(2, lq, d)))
    sj, st = _bf16(rng.normal(size=(2, s, d)))
    want = _f32(jattn.cross_attention(pj, xj, sj, n_heads=h, n_kv=h, d_head=dh))
    for use_kernel in (True, False):
        got = tattn.cross_attention(pt, xt, st, n_heads=h, n_kv=h, d_head=dh,
                                    use_kernel=use_kernel)
        lp.assert_bf16_close(_f32(got), want, f"use_kernel={use_kernel}")


def test_encode():
    cj, ct = lp.cfgs(ARCH)
    pj, pt = lp.params(ARCH)
    kw_j, kw_t = lp.stubs(cj, 2)
    want = _f32(jed.encode(pj, kw_j["frames"], cj))
    got = ted.encode(ttr.compute_weights(pt), kw_t["frames"], ct)
    assert got.dtype == torch.bfloat16
    lp.assert_bf16_close(_f32(got), want, "encoder output")


def test_init_cache_matches_jax():
    cj, ct = lp.cfgs(ARCH)
    want = lp.jax_cache_numpy(jed.init_cache(cj, 3, 96))
    got = interop.kv_cache_to_numpy(ted.init_cache(ct, 3, 96))
    lp.assert_same_layout(got, want)
    assert not any(v.any() for v in got.values())


@pytest.mark.parametrize("mode", ["anchored", "dense"])
def test_prefill_and_teacher_forced_decode(mode):
    """SMOKE prefill logits and EncDecCache (a DenseKVCache under either
    kv_mode, as JAX builds it), then 4 decode steps fed JAX's tokens."""
    out = lp.run_both(ARCH, mode, 2, 40, 48, 4)
    lp.assert_logits_close(*out["prefill"], "prefill")
    got, want = out["prefill_cache"]
    lp.assert_same_layout(got, want)
    np.testing.assert_array_equal(got["self_kv.length"], want["self_kv.length"])
    for k in ("self_kv.k", "self_kv.v", "enc_out"):
        lp.assert_bf16_close(got[k], want[k], k)
    lp.assert_logits_close(*out["decode"], "teacher-forced decode")
    got, want = out["cache"]
    np.testing.assert_array_equal(got["self_kv.length"], want["self_kv.length"])
    assert int(got["self_kv.length"][0, 0]) == 44


def test_decode_position_table_is_the_caches_max_len():
    """The decode step's sinusoidal row comes from a table of the cache's
    max_len rows, as in JAX: the same logits whatever the prompt length
    used to build it, and a position past it clamps to the last row."""
    cj, ct = lp.cfgs(ARCH)
    _, pt = lp.params(ARCH)
    _, kw = lp.stubs(ct, 2)
    toks = torch.as_tensor(lp.prompt(ct.vocab, 2, 8))
    _, cache = ted.prefill(pt, toks, ct, 9, **kw)
    lg1, cache = ted.decode_step(pt, toks[:, :1], cache, ct)  # position 8, the last row
    assert cache.self_kv.length.tolist() == [[9, 9]] * ct.n_layers
    lg2, _ = ted.decode_step(pt, toks[:, :1], cache, ct)  # position 9 clamps to row 8
    assert torch.isfinite(lg2).all() and lg1.shape == lg2.shape


@pytest.mark.parametrize("mode", ["dense"])
def test_serve_run_tokens(mode):
    lp.serve_tokens_match(ARCH, mode)
