"""Port parity, the LM building blocks: ``models.layers`` (rms_norm, RoPE,
SwiGLU, embed, logits) and ``core.anchored`` (encode, decode,
quantization_error_bound), held against the JAX package on the same
seeded numpy inputs. JAX's functions run eagerly here, op by op, so each
op rounds to its dtype as the port's does.

Stated bounds: elementwise fp32 ops equal bit for bit except
transcendentals (RoPE's cos/sin, rsqrt), which differ by a few ulps
between the two libraries; bf16 outputs of a product (SwiGLU, logits)
may flip one bf16 rounding where the fp32 accumulation orders differ.
The anchors are means over a block, summed in another order, so they
and the scales may differ by a few fp32 ulps, and an int8 residual by
one level where the quotient sits at a rounding tie.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import anchored as janch
from repro.models import layers as jl
from repro_torch.core import anchored as tanch
from repro_torch.models import layers as tl
from test_torch_helpers import one_torch_thread  # noqa: F401  (autouse fixture)

TDT = {"fp32": torch.float32, "bf16": torch.bfloat16}
JDT = {"fp32": jnp.float32, "bf16": jnp.bfloat16}


def _both(x: np.ndarray, dt: str):
    """The same values in both packages (rounded once to dt by JAX)."""
    xj = jnp.asarray(x, JDT[dt])
    return xj, torch.as_tensor(np.asarray(xj.astype(jnp.float32))).to(TDT[dt])


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bf16 ulp at each |x| (2^(e - 7) for |x| in [2^e, 2^(e+1)))."""
    return np.exp2(np.floor(np.log2(np.maximum(np.abs(x), 2.0**-126))) - 7)


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
def test_rms_norm(dt):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 17, 96)) * 3.0
    w = rng.uniform(0.5, 1.5, 96).astype(np.float32)
    xj, xt = _both(x, dt)
    out_j = _np(jl.rms_norm({"norm_w": jnp.asarray(w)}, xj))
    out_t = _np(tl.rms_norm({"norm_w": torch.as_tensor(w)}, xt))
    assert tl.rms_norm({"norm_w": torch.as_tensor(w)}, xt).dtype == TDT[dt]
    # the mean of n squares is summed in another order (n u relative, half
    # of it after the rsqrt) and rsqrt may differ by an ulp; in bf16 that
    # flips at most one rounding
    n = x.shape[-1]
    tol = (n / 2 + 4) * 2.0**-24 * np.abs(out_j) if dt == "fp32" else _bf16_ulp(out_j)
    assert np.all(np.abs(out_t - out_j) <= tol)


@pytest.mark.parametrize("d_head,theta", [(16, 5e5), (128, 5e5), (64, 1e4)])
def test_rope_freqs_bitwise(d_head, theta):
    fj = np.asarray(jl.rope_freqs(d_head, theta))
    ft = tl.rope_freqs(d_head, theta).numpy()
    assert ft.dtype == np.float32
    np.testing.assert_array_equal(fj.view(np.int32), ft.view(np.int32))


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("with_heads", [True, False])
def test_apply_rope(dt, with_heads):
    """Half-split RoPE with fp32 angles; positions up to 1100 (angles past
    1000 rad, where cos/sin are hardest)."""
    rng = np.random.default_rng(1)
    shape = (2, 40, 6, 16) if with_heads else (2, 40, 16)
    x = rng.normal(size=shape)
    pos = np.stack([np.arange(40), 1060 + np.arange(40)]).astype(np.int32)
    xj, xt = _both(x, dt)
    out_j = _np(jl.apply_rope(xj, jnp.asarray(pos), 5e5))
    out_t = tl.apply_rope(xt, torch.as_tensor(pos), 5e5)
    assert out_t.dtype == TDT[dt]
    # cos/sin of the same fp32 angle differ by at most an ulp between the
    # libraries: |d| <= 2 ulp(1) |x|max, then rounded to dt
    xmax = np.abs(_np(xt)).max()
    tol = 4 * 2.0**-24 * xmax + (0.0 if dt == "fp32" else _bf16_ulp(out_j))
    assert np.all(np.abs(_np(out_t) - out_j) <= tol)


def test_swiglu_bf16():
    rng = np.random.default_rng(2)
    d, f = 96, 192
    x = rng.normal(size=(2, 9, d))
    p = {k: (rng.normal(size=s) / math.sqrt(s[0])).astype(np.float32)
         for k, s in (("w_gate", (d, f)), ("w_up", (d, f)), ("w_down", (f, d)))}
    xj, xt = _both(x, "bf16")
    out_j = _np(jl.swiglu({k: jnp.asarray(v) for k, v in p.items()}, xj))
    out_t = tl.swiglu({k: torch.as_tensor(v) for k, v in p.items()}, xt)
    assert out_t.dtype == torch.bfloat16
    # the hidden product may flip one bf16 rounding (fp32 sums in another
    # order); the down projection then moves by at most one hidden ulp
    # times |w_down| summed, plus its own rounding
    hid = np.abs(_np(jl.swiglu({**{k: jnp.asarray(v) for k, v in p.items()},
                                "w_down": jnp.eye(f, dtype=jnp.float32)},
                               jnp.asarray(np.asarray(xj), jnp.bfloat16))))
    prop = _bf16_ulp(hid) @ np.abs(p["w_down"])
    assert np.all(np.abs(_np(out_t) - out_j) <= prop + _bf16_ulp(out_j))


def test_embed_and_logits():
    rng = np.random.default_rng(3)
    vocab, d = 512, 96
    emb = (rng.normal(size=(vocab, d)) / math.sqrt(d)).astype(np.float32)
    tok = rng.integers(0, vocab, (2, 7)).astype(np.int32)
    e_j = _np(jl.embed({"embed": jnp.asarray(emb)}, jnp.asarray(tok)))
    e_t = tl.embed({"embed": torch.as_tensor(emb)}, torch.as_tensor(tok))
    assert e_t.dtype == torch.bfloat16
    np.testing.assert_array_equal(e_j, _np(e_t))  # a gather of rounded rows
    h = rng.normal(size=(2, 7, d))
    hj, ht = _both(h, "bf16")
    lg_j = np.asarray(jl.logits({"embed": jnp.asarray(emb)}, hj))
    lg_t = tl.logits({"embed": torch.as_tensor(emb)}, ht)
    assert lg_t.dtype == torch.float32
    # one bf16 product, rounded once: at most one flipped rounding
    assert np.all(np.abs(lg_t.numpy() - lg_j) <= _bf16_ulp(lg_j))


def test_truncated_normal_draws():
    """The port's own draws (JAX's bits differ by design): within +-3
    sigma, mean ~0, the std of a normal truncated at 3 sigma."""
    gen = torch.Generator().manual_seed(0)
    x = tl.truncated_normal(gen, (200_000,), 0.5)
    assert x.dtype == torch.float32
    assert float(x.abs().max()) <= 1.5
    assert abs(float(x.mean())) < 0.01
    assert abs(float(x.std()) - 0.5 * 0.98658) < 0.005
    w = tl.dense_init(torch.Generator().manual_seed(1), 64, 32)
    assert w.shape == (64, 32) and float(w.abs().max()) <= 3.0 / 8.0


ANCHOR_ULPS = 8  # fp32 ulps of the block's largest |x| an anchor or scale may differ by


@pytest.mark.parametrize("dtype", ["int8", "fp16", "bf16"])
@pytest.mark.parametrize("shape,axis,block", [((3, 300, 16), 1, 128), ((2, 4, 256, 8), 2, 64),
                                              ((1000,), 0, 128)])
def test_anchored_encode_decode(dtype, shape, axis, block):
    rng = np.random.default_rng(4)
    x = (rng.normal(size=shape) * 2.0 + 5.0).astype(np.float32)  # data far from zero
    jdt = {"int8": jnp.int8, "fp16": jnp.float16, "bf16": jnp.bfloat16}[dtype]
    tdt = {"int8": torch.int8, "fp16": torch.float16, "bf16": torch.bfloat16}[dtype]
    aj = janch.encode(jnp.asarray(x), block=block, axis=axis, dtype=jdt)
    at = tanch.encode(torch.as_tensor(x), block=block, axis=axis, dtype=tdt)
    assert at.residual.dtype == tdt and (at.axis, at.orig_len) == (aj.axis, aj.orig_len)
    assert at.anchor.shape == aj.anchor.shape and at.residual.shape == aj.residual.shape
    tol = ANCHOR_ULPS * 2.0**-24 * np.abs(x).max()
    for name in ("anchor", "scale"):
        assert np.abs(_np(getattr(at, name)) - np.asarray(getattr(aj, name))).max() <= tol
    rj, rt = _np(aj.residual), _np(at.residual)
    if dtype == "int8":
        assert np.abs(rt - rj).max() <= 1  # a tie in round(127 r) may go either way
        assert np.mean(rt != rj) < 0.01
    else:  # the same quotient up to the anchor's ulps, rounded once to dtype
        step = float(torch.finfo(tdt).eps)
        assert np.abs(rt - rj).max() <= step
    dj = np.asarray(janch.decode(aj))
    dt = tanch.decode(at).numpy()
    assert dt.shape == x.shape
    bound_t = _np(tanch.quantization_error_bound(at))
    bound_j = np.asarray(janch.quantization_error_bound(aj))
    np.testing.assert_allclose(bound_t, bound_j, rtol=1e-6)
    # both reconstruct x within the quantization bound (+ fp32 rounding)
    err_t = np.abs(_np(tanch.decode(at)) - x)
    assert err_t.max() <= bound_t.max() + 4 * tol
    assert np.abs(dt - dj).max() <= bound_t.max() + 4 * tol
