"""Port parity, the ssm family: ``models.mamba2`` (make_dims, init_mamba2,
_segsum, ssd_chunked with the dt = 0 padding, mamba2_forward, Mamba2Cache,
mamba2_decode) against JAX's on the same seeded inputs, and mamba2-130m's
SMOKE config served against JAX.

Stated bounds: the SSD is fp32 throughout (bf16 for the products with
``ssd_compute="bf16"``); its einsums sum in another order and group the
four-operand product otherwise, and exp/softplus differ by an ulp or two,
so outputs and states are held to a relative 1e-4 of each row's largest
|entry| in fp32, and to 8 bf16 ulps of it with bf16 products. The bf16
block outputs are held to ``lm_parity.assert_bf16_close``, logits to
``transformer.logit_tolerance``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lm_parity as lp
from repro.models import mamba2 as jm2
from repro_torch.core import interop
from repro_torch.models import mamba2 as tm2
from repro_torch.models import transformer as ttr
from test_torch_helpers import one_torch_thread  # noqa: F401  (autouse fixture)

ARCH = "mamba2-130m"


def _dims():
    cj, ct = lp.cfgs(ARCH)
    return cj.ssm_dims, ct.ssm_dims


def _rel_close(got, want, what, rel=1e-4):
    tol = rel * np.abs(want).max(axis=-1, keepdims=True) + 1e-30
    err = np.abs(np.asarray(got) - np.asarray(want))
    assert np.all(err <= tol), f"{what}: max err / tol {(err / tol).max():.3g}"


def test_dims_and_init():
    dj, dt_ = _dims()
    assert tuple(dj) == tuple(dt_)
    full_j, full_t = (c.ssm_dims for c in (lp.jreg.get_config(ARCH), lp.treg.get_config(ARCH)))
    assert tuple(full_j) == tuple(full_t) and full_t.n_heads == 24
    pj = jm2.init_mamba2(jax.random.key(0), dj)
    pt = tm2.init_mamba2(torch.Generator().manual_seed(0), dt_)
    assert {k: tuple(v.shape) for k, v in lp.flat_params_t(pt).items()} == {
        k: v.shape for k, v in lp.flat_params(pj).items()}
    for k in ("a_log", "dt_bias", "d_skip", "conv_bias"):  # deterministic, not drawn
        np.testing.assert_allclose(pt[k].numpy(), np.asarray(pj[k]), rtol=2e-7, atol=0)
    want = jm2.Mamba2Cache.init(3, dj)
    got = tm2.Mamba2Cache.init(3, dt_)
    for k in want._fields:
        assert tuple(getattr(got, k).shape) == getattr(want, k).shape, k


def test_segsum():
    a = np.random.default_rng(0).normal(size=(3, 2, 16)).astype(np.float32)
    want = np.asarray(jm2._segsum(jnp.asarray(a)))
    got = tm2._segsum(torch.as_tensor(a)).numpy()
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(np.exp(got) == 0, np.isneginf(got))


@pytest.mark.parametrize("compute", ["fp32", "bf16"])
@pytest.mark.parametrize("l", [64, 77])
def test_ssd_chunked(l, compute):
    """L a multiple of the 16-row chunk and not (dt = 0 padding), with and
    without an initial state."""
    dj, dt_ = _dims()
    rng = np.random.default_rng(1)
    b, h, p, g, n = 2, dj.n_heads, dj.head_dim, dj.n_groups, dj.d_state
    x = rng.normal(size=(b, l, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(b, l, h)))).astype(np.float32)
    a = -np.exp(np.log(np.linspace(1.0, 16.0, h))).astype(np.float32)
    B = rng.normal(size=(b, l, g, n)).astype(np.float32)
    C = rng.normal(size=(b, l, g, n)).astype(np.float32)
    s0 = rng.normal(size=(b, h, p, n)).astype(np.float32)
    ej, et = (jnp.bfloat16, torch.bfloat16) if compute == "bf16" else (None, None)
    for init in (None, s0):
        yj, sj = jm2.ssd_chunked(*map(jnp.asarray, (x, dt, a, B, C)), dj, 16,
                                 init_state=None if init is None else jnp.asarray(init),
                                 einsum_dtype=ej)
        yt, st = tm2.ssd_chunked(*map(torch.as_tensor, (x, dt, a, B, C)), dt_, 16,
                                 init_state=None if init is None else torch.as_tensor(init),
                                 einsum_dtype=et)
        assert tuple(yt.shape) == (b, l, h, p) and yt.dtype == torch.float32
        if compute == "fp32":
            _rel_close(yt.numpy(), np.asarray(yj), "y")
            _rel_close(st.numpy(), np.asarray(sj), "state")
        else:
            lp.assert_bf16_close(yt.numpy(), np.asarray(yj), "y")
            lp.assert_bf16_close(st.numpy(), np.asarray(sj), "state")


def _layer():
    cj, ct = lp.cfgs(ARCH)
    pj = jm2.init_mamba2(jax.random.key(3), cj.ssm_dims)
    pt = ttr.compute_weights(interop.lm_params_from_numpy(lp.flat_params(pj), "cpu"))
    return cj, ct, pj, pt


@pytest.mark.parametrize("l", [64, 77])
def test_mamba2_forward_and_decode(l):
    """The block over L tokens (its conv tail the last d_conv - 1 raw
    inputs), then 3 recurrent steps from its cache, written in place."""
    cj, ct, pj, pt = _layer()
    rng = np.random.default_rng(4)
    xj = jnp.asarray(rng.normal(size=(2, l, cj.d_model)), jnp.bfloat16)
    xt = torch.as_tensor(np.asarray(xj.astype(jnp.float32))).to(torch.bfloat16)
    out_j, c_j = jm2.mamba2_forward(pj, xj, cj.ssm_dims, chunk=16)
    out_t, c_t = tm2.mamba2_forward(pt, xt, ct.ssm_dims, chunk=16)
    lp.assert_bf16_close(out_t.float().numpy(), np.asarray(out_j.astype(jnp.float32)), "out")
    _rel_close(c_t.conv_buf.numpy(), np.asarray(c_j.conv_buf), "conv tail", rel=2**-7)
    lp.assert_bf16_close(c_t.state.numpy(), np.asarray(c_j.state), "state")
    storage = c_t.state
    for step in range(3):
        yj = jnp.asarray(rng.normal(size=(2, 1, cj.d_model)), jnp.bfloat16)
        yt = torch.as_tensor(np.asarray(yj.astype(jnp.float32))).to(torch.bfloat16)
        o_j, c_j = jm2.mamba2_decode(pj, yj, c_j, cj.ssm_dims)
        o_t, c_t = tm2.mamba2_decode(pt, yt, c_t, ct.ssm_dims)
        lp.assert_bf16_close(o_t.float().numpy(), np.asarray(o_j.astype(jnp.float32)),
                             f"step {step}")
    assert c_t.state is storage
    lp.assert_bf16_close(c_t.state.numpy(), np.asarray(c_j.state), "state after decode")
    lp.assert_bf16_close(c_t.conv_buf.numpy(), np.asarray(c_j.conv_buf), "conv after decode")


def test_prefill_and_teacher_forced_decode():
    """SMOKE prefill logits and stacked Mamba2Cache (L 100: the SSD pads
    its last 128-row chunk), then 4 decode steps fed JAX's tokens."""
    out = lp.run_both(ARCH, "dense", 2, 100, 128, 4)
    lp.assert_logits_close(*out["prefill"], "prefill")
    got, want = out["prefill_cache"]
    lp.assert_same_layout(got, want)
    for k in ("state", "conv_buf"):
        lp.assert_bf16_close(got[k], want[k], k)
    lp.assert_logits_close(*out["decode"], "teacher-forced decode")
    got, want = out["cache"]
    lp.assert_bf16_close(got["state"], want["state"], "state after decode")


@pytest.mark.parametrize("mode", ["anchored", "dense"])
def test_serve_run_tokens(mode):
    lp.serve_tokens_match(ARCH, mode)
