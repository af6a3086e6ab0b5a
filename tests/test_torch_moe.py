"""Port parity, the MoE family: ``models.moe`` (router_topk, capacity,
dispatch_sort, combine_sort, moe_block) against JAX's on the same seeded
inputs, and deepseek-moe-16b's SMOKE config served against JAX (run op by
op there, see ``lm_parity``).

Stated bounds: the router's fp32 product and softmax sum in another order
(a few fp32 ulps of each probability); the experts are picked by a
stable descending sort, so ties go to the lower index as ``lax.top_k``
sends them, and compared wherever JAX's k-th/(k+1)-th margin is above
``lm_parity.router_margin_bound``. The dispatch is integer bookkeeping
and a copy (equal); the combine adds each token's k bf16 terms in JAX's
scatter order (equal, bit for bit); the expert products are bf16 with
fp32 sums in another order (one flipped bf16 rounding of a product's
row maximum, then the combine's k terms: k + 1 bf16 ulps of the row's
largest entry).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lm_parity as lp
from repro.models import moe as jmoe
from repro.models import transformer as jtr
from repro_torch.core import interop
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttr
from test_torch_helpers import one_torch_thread  # noqa: F401  (autouse fixture)

ARCH = "deepseek-moe-16b"


def _bf16(x: np.ndarray):
    xj = jnp.asarray(x, jnp.bfloat16)
    return xj, torch.as_tensor(np.asarray(xj.astype(jnp.float32))).to(torch.bfloat16)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _router(seed, t, d, e, ties=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(t, d)).astype(np.float32)
    w = (rng.normal(size=(d, e)) / math.sqrt(d)).astype(np.float32)
    if ties:  # experts 5 and 6 copy 1 and 2: their scores tie exactly
        w[:, 5], w[:, 6] = w[:, 1], w[:, 2]
    return x, w


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("k", [2, 6])
def test_router_topk(k, ties):
    x, w = _router(0, 96, 48, 8, ties)
    wj, ij, aj = jmoe.router_topk({"router": jnp.asarray(w)}, jnp.asarray(x), k)
    wt, it, at = tmoe.router_topk({"router": torch.as_tensor(w)}, torch.as_tensor(x), k)
    assert it.dtype == torch.int32
    probs = np.asarray(jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(w), -1))
    bound, margin = lp.router_margin_bound(x, w, probs, k, input_ulps=0)
    # an exact tie (copied columns: equal scores in both) is decided by index
    decided = (margin > bound) | (margin == 0)
    assert decided.mean() > 0.8
    np.testing.assert_array_equal(it.numpy()[decided], np.asarray(ij)[decided])
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(float(at), float(aj), rtol=1e-5)
    if ties:  # a tie goes to the lower index, in both
        both = np.isin(it.numpy(), [1, 5]).sum(-1) == 2
        assert both.any()
        for row in np.flatnonzero(both):
            pos = list(it[row].numpy())
            assert pos.index(1) < pos.index(5)


def test_top_k_breaks_ties_to_the_lower_index():
    score = torch.tensor([[0.1, 0.3, 0.3, 0.2, 0.3], [0.5, 0.5, 0.5, 0.5, 0.5]])
    vals, idx = tmoe.top_k(score, 3)
    wv, wi = jax.lax.top_k(jnp.asarray(score.numpy()), 3)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(wv))


@pytest.mark.parametrize("t,k,e,cf", [(256, 2, 8, 1.25), (4096, 6, 64, 1.25), (4, 6, 64, 1.25),
                                      (4096, 6, 160, 1.25), (100, 3, 7, 1.0), (33, 2, 8, 0.3)])
def test_capacity_is_jaxs(t, k, e, cf):
    want = int(np.ceil(t * k / e * cf))
    want = max(8, -(-want // 8) * 8)
    assert tmoe.capacity(t, k, e, cf) == want


@pytest.mark.parametrize("cap", [8, 24, 64])
def test_dispatch_sort(cap):
    """The same buffer, bit for bit, the same bookkeeping and drop fraction;
    at capacity 8 and 24 tokens are dropped."""
    x, w = _router(1, 64, 32, 8)
    wj, ij, _ = jmoe.router_topk({"router": jnp.asarray(w)}, jnp.asarray(x), 3)
    xj, xt = _bf16(x)
    buf_j, info_j = jmoe.dispatch_sort(xj, ij, wj, 8, cap)
    buf_t, info_t = tmoe.dispatch_sort(xt, torch.as_tensor(np.asarray(ij)),
                                       torch.as_tensor(np.asarray(wj)), 8, cap)
    assert buf_t.dtype == torch.bfloat16 and tuple(buf_t.shape) == buf_j.shape
    np.testing.assert_array_equal(_np(buf_t), _np(buf_j))
    for a, b in zip(info_t[:4], info_j[:4]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert float(info_t[4]) == float(info_j[4])
    assert (float(info_t[4]) > 0) == (cap < 64)


@pytest.mark.parametrize("k", [2, 6])
def test_combine_sort_is_jaxs_bit_for_bit(k):
    """Each token's k bf16 terms added in JAX's scatter order, dropped
    entries included as zeros."""
    x, w = _router(2, 96, 32, 16)
    wj, ij, _ = jmoe.router_topk({"router": jnp.asarray(w)}, jnp.asarray(x), k)
    xj, xt = _bf16(x)
    cap = 16  # below the ~18 entries an expert gets at k = 6: drops
    _, info_j = jmoe.dispatch_sort(xj, ij, wj, 16, cap)
    _, info_t = tmoe.dispatch_sort(xt, torch.as_tensor(np.asarray(ij)),
                                   torch.as_tensor(np.asarray(wj)), 16, cap)
    y = np.random.default_rng(3).normal(size=(16, cap, 32))
    yj, yt = _bf16(y)
    out_j = jmoe.combine_sort(yj, info_j, wj, 96)
    out_t = tmoe.combine_sort(yt, info_t, torch.as_tensor(np.asarray(wj)), 96)
    assert out_t.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(out_t), _np(out_j))
    jitted = jax.jit(jmoe.combine_sort, static_argnums=3)(yj, info_j, wj, 96)
    np.testing.assert_array_equal(_np(out_t), _np(jitted))
    # and in one order: a second call is bit-equal
    np.testing.assert_array_equal(
        _np(tmoe.combine_sort(yt, info_t, torch.as_tensor(np.asarray(wj)), 96)), _np(out_t))


@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_moe_block(cf):
    """A SMOKE-sized MoE layer (8 experts, 1 shared, top-2) on the same
    bf16 input in both: the same experts wherever the margin is decided,
    the output within k + 1 bf16 ulps of each token's largest entry, the
    same drop fraction and aux."""
    cfg = lp.cfgs(ARCH)[0]
    pj = jmoe.init_moe(jax.random.key(4), cfg.d_model, cfg.d_expert, cfg.n_routed,
                       cfg.n_shared, d_shared=cfg.n_shared * cfg.d_expert)
    pt = ttr.compute_weights(interop.lm_params_from_numpy(lp.flat_params(pj), "cpu"))
    x = np.random.default_rng(5).normal(size=(2, 64, cfg.d_model))
    xj, xt = _bf16(x)
    kw = dict(top_k=cfg.top_k, n_routed=cfg.n_routed, capacity_factor=cf)
    with lp.router_log() as log:
        out_j, m_j = jmoe.moe_block(pj, xj, **kw)
        out_t, m_t = tmoe.moe_block(pt, xt, **kw)
        flips = lp.router_flips(log, input_ulps=0)
    decided = ~np.isin(np.arange(x.shape[0] * x.shape[1]), flips)
    assert float(m_t["drop_frac"]) == float(m_j["drop_frac"])
    assert (float(m_t["drop_frac"]) > 0) == (cf < 1)
    np.testing.assert_allclose(float(m_t["aux_loss"]), float(m_j["aux_loss"]), rtol=1e-5)
    got, want = (_np(o).reshape(-1, cfg.d_model)[decided] for o in (out_t, out_j))
    lp.assert_bf16_close(got, want, "moe_block", ulps=cfg.top_k + 1)


@pytest.mark.parametrize("mode", ["anchored", "dense"])
def test_prefill_and_teacher_forced_decode(mode):
    """SMOKE prefill logits and caches, then 3 decode steps fed JAX's
    tokens."""
    out = lp.run_both(ARCH, mode, 2, 128, 256, 3)
    lp.assert_logits_close(*out["prefill"], "prefill", out["prefill_rows"])
    got, want = out["prefill_cache"]
    lp.assert_same_layout(got, want)
    np.testing.assert_array_equal(got["length"], want["length"])
    if mode == "dense":
        for k in ("k", "v"):
            lp.assert_bf16_close(got[k], want[k], k)
    else:
        lp.assert_anchored_close(got, want)
    lp.assert_logits_close(*out["decode"], "teacher-forced decode", out["decode_rows"])


def test_forward_aux_is_the_layers_sum():
    cj, ct = lp.cfgs(ARCH)
    pj, pt = lp.params(ARCH)
    toks = lp.prompt(cj.vocab, 2, 128, seed=6)
    with jax.disable_jit():
        _, _, aux_j = jtr.forward(pj, jnp.asarray(toks), cj)
    _, _, aux_t = ttr.forward(ttr.compute_weights(pt), torch.as_tensor(toks), ct)
    assert aux_t.dtype == torch.float32 and aux_t.dim() == 0
    np.testing.assert_allclose(float(aux_t), float(aux_j), rtol=1e-4)
    assert float(aux_t) > 0


@pytest.mark.parametrize("mode", ["anchored", "dense"])
def test_serve_run_tokens(mode):
    lp.serve_tokens_match(ARCH, mode, b=2, gen=6)  # run_both's shapes: JAX compiles each op once
