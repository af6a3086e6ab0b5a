"""K7's gradient on the CPU (``kernels.flash_attention``): the plain
backward ``flash_attention_bwd_ref`` (what the card's K7b is held to)
against float64 autograd of the attention and against ``jax.vjp`` of
JAX's ``sdpa`` (whose XLA autodiff is what JAX trains with), causal and
not, Lq != Lk, rep > 1 and fully masked rows; the autograd op
``Attention`` that ``flash_attention`` becomes when an input needs a
gradient, and the serving path, which it leaves as it was; the
backward's rounding bound against planted faults written in plain torch
(the card tests plant the same faults in the kernel); the plain mirror
of the bf16 kernel's tensor-core scheme (``flash_attention_bwd_split_ref``:
dO, P and dS split exactly into three bf16 parts) within the same bound;
and the layer slice that gathers the stacked layers' gradients.

Tolerance: ``rounding_bound_bwd`` (elementwise, derived in its docstring:
two fp32 evaluations of the backward summing in different orders, 2x to
spare). float64 autograd is one exact-enough evaluation; JAX's autodiff
another fp32 one (its D is sum_j P dP rather than dO . O, the same value
up to that bound's terms).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro_torch.kernels import flash_attention as k7
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as ttr
from test_torch_helpers import one_torch_thread  # noqa: F401  (autouse fixture)

CASES = [  # b, h, hkv, lq, lk, dh, causal
    (2, 4, 2, 33, 33, 16, True),     # rep 2, causal
    (1, 6, 2, 20, 45, 32, False),    # cross-attention shape, Lq < Lk
    (2, 4, 4, 40, 17, 16, True),     # Lq > Lk: rows 0..22 see no key
    (1, 8, 1, 25, 60, 64, True),     # rep 8, Lq < Lk causal (the offset mask)
    (2, 3, 3, 9, 9, 128, False),     # rep 1, non-causal, Dh 128
]


def _exact_grads(q, k, v, dout, causal):
    """float64 autograd of masked-softmax attention (0 for keyless rows)."""
    q64, k64, v64 = (t.double().requires_grad_() for t in (q, k, v))
    rep = q.shape[1] // k.shape[1]
    s = torch.einsum("bhqd,bhkd->bhqk", q64, k64.repeat_interleave(rep, 1)) / math.sqrt(
        q.shape[-1])
    valid = k7._valid(q.shape[2], k.shape[2], causal, "cpu")
    s = torch.where(valid, s, -math.inf)
    m = torch.where(valid.any(-1, keepdim=True), s.amax(-1, keepdim=True), 0.0)
    p = torch.exp(s - m)
    p = p / p.sum(-1, keepdim=True).clamp_min(1e-300)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v64.repeat_interleave(rep, 1))
    return torch.autograd.grad(out, (q64, k64, v64), dout.double())


def _assert_within(got, want, bounds, what):
    for name, g, w, bnd in zip(("dq", "dk", "dv"), got, want, bounds):
        ratio = float(((g.double() - w.double()).abs() / bnd.double().clamp_min(1e-30)).max())
        assert ratio <= 1.0, f"{what} {name}: max err / bound {ratio:.3g}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("b,h,hkv,lq,lk,dh,causal", CASES)
def test_plain_backward_matches_float64_autograd(b, h, hkv, lq, lk, dh, causal, dtype):
    args = k7.random_bwd_inputs(7, b, h, hkv, lq, lk, dh, dtype, causal=causal)
    got = k7.flash_attention_bwd_ref(*args, causal=causal)
    assert [tuple(g.shape) for g in got] == [(b, h, lq, dh), (b, hkv, lk, dh), (b, hkv, lk, dh)]
    assert all(g.dtype == torch.float32 for g in got)
    want = _exact_grads(args[0], args[1], args[2], args[5], causal)
    _assert_within(got, want, k7.rounding_bound_bwd(*args, causal=causal), "plain vs float64")
    if causal and lq > lk:  # rows that see no key: dq 0, and they give dk, dv nothing
        keyless = lq - lk
        assert not got[0][:, :, :keyless].any()


@pytest.mark.parametrize("b,h,hkv,lq,lk,dh,causal", [c for c in CASES if c[3] <= c[4]])
def test_plain_backward_matches_jax_vjp_of_sdpa(b, h, hkv, lq, lk, dh, causal):
    """JAX's ``sdpa`` (its mask offset to K7's with ``q_offset = Lk - Lq``)
    differentiated by ``jax.vjp``, on (B, L, heads, Dh) copies."""
    q, k, v, out, lse, dout = k7.random_bwd_inputs(11, b, h, hkv, lq, lk, dh, torch.float32,
                                                   causal=causal)
    def bl(t):
        return jnp.asarray(t.transpose(1, 2).numpy())

    f = lambda q_, k_, v_: jattn.sdpa(q_, k_, v_, causal=causal, q_offset=lk - lq)
    out_j, vjp = jax.vjp(f, bl(q), bl(k), bl(v))
    np.testing.assert_allclose(np.asarray(out_j), out.transpose(1, 2).numpy(), rtol=0,
                               atol=float(k7.rounding_bound(*k7._gqa(q, k, v), k7._valid(
                                   lq, lk, causal, "cpu"), 1 / math.sqrt(dh)).max()))
    gj = [torch.as_tensor(np.array(g)).transpose(1, 2) for g in vjp(bl(dout))]
    got = k7.flash_attention_bwd_ref(q, k, v, out, lse, dout, causal=causal)
    _assert_within(got, gj, k7.rounding_bound_bwd(q, k, v, out, lse, dout, causal=causal),
                   "plain vs jax.vjp(sdpa)")


def test_lse_ref():
    q, k, _ = k7.random_inputs(3, 1, 2, 1, 6, 4, 16, torch.float32)
    lse = k7.lse_ref(q, k, causal=True)
    assert torch.isinf(lse[:, :, :2]).all() and (lse[:, :, :2] > 0).all()  # keyless rows
    s = torch.einsum("bhqd,bhkd->bhqk", q, k.repeat_interleave(2, 1)) / 4.0
    for i in range(2, 6):
        want = torch.logsumexp(s[:, :, i, :i - 2 + 1], dim=-1)
        torch.testing.assert_close(lse[:, :, i], want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("causal", [True, False])
def test_attention_op_on_cpu(causal):
    """With an input that needs a gradient, ``flash_attention`` is the
    autograd op: the plain forward's values, and the plain backward's
    gradients cast to q's, k's and v's dtypes."""
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (t.requires_grad_() for t in k7.random_inputs(5, 2, 4, 2, 12, 12, 16, dtype))
        out = k7.flash_attention(q, k, v, causal=causal)
        assert type(out.grad_fn).__name__ == "AttentionBackward"
        torch.testing.assert_close(out, k7.flash_attention_ref(q, k, v, causal=causal), rtol=0,
                                   atol=0)
        dout = torch.randn(out.shape, generator=torch.Generator().manual_seed(0))
        got = torch.autograd.grad(out, (q, k, v), dout)
        want = k7.flash_attention_bwd_ref(q.detach(), k.detach(), v.detach(), out.detach(),
                                          k7.lse_ref(q.detach(), k.detach(), causal=causal),
                                          dout, causal=causal)
        for g, w, t in zip(got, want, (q, k, v)):
            assert g.dtype == t.dtype
            torch.testing.assert_close(g, w.to(dtype), rtol=0, atol=0)
        # flash_attention_plain is the same op through the plain versions
        out_p = k7.flash_attention_plain(q, k, v, causal=causal)
        got_p = torch.autograd.grad(out_p, (q, k, v), dout)
        for g, w in zip(got_p, got):
            torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_serving_path_is_unchanged():
    """No input needs a gradient (inference, no_grad, or plain tensors):
    the plain forward's bits and no autograd node."""
    q, k, v = k7.random_inputs(6, 1, 4, 2, 10, 10, 32, torch.bfloat16)
    out = k7.flash_attention(q, k, v)
    assert out.grad_fn is None
    torch.testing.assert_close(out, k7.flash_attention_ref(q, k, v), rtol=0, atol=0)
    qg = q.clone().requires_grad_()
    with torch.no_grad():
        assert k7.flash_attention(qg, k, v).grad_fn is None
    with torch.inference_mode():
        assert k7.flash_attention(q, k, v).grad_fn is None


def _faulty_bwd(fault, q, k, v, out, lse, dout, causal):
    """The plain backward with one of K7b's planted faults, in plain torch."""
    lq, lk, dh = q.shape[2], k.shape[2], q.shape[3]
    hkv, rep = k.shape[1], q.shape[1] // k.shape[1]
    scale = 1 / math.sqrt(dh)
    qf, kf, vf = k7._gqa(q, k, v)
    valid = k7._valid(lq, lk, causal, "cpu", shift=int(fault == "causal_plus_one"))
    p = torch.where(valid, torch.exp(torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
                                     - lse[..., None]), 0.0)
    d = dout.sum(-1) if fault == "d_from_do" else (dout * out).sum(-1)
    ds = p * (torch.einsum("bhqd,bhkd->bhqk", dout, vf) - d[..., None])
    if fault == "ds_hi_only":  # dQ and dK take dS rounded to bf16 once
        ds = ds.to(torch.bfloat16).float()
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf) * scale
    dkh = torch.einsum("bhqk,bhqd->bhkd", ds, qf) * scale
    dvh = torch.einsum("bhqk,bhqd->bhkd", p, dout)
    if fault == "gqa_first_head":
        b = q.shape[0]
        return (dq, dkh.reshape(b, hkv, rep, lk, dh)[:, :, 0],
                dvh.reshape(b, hkv, rep, lk, dh)[:, :, 0])
    return dq, k7._group_sum(dkh, hkv), k7._group_sum(dvh, hkv)


@pytest.mark.parametrize("fault", k7.BACKWARD_FAULTS)
def test_check_catches_each_planted_fault(fault):
    args = k7.random_bwd_inputs(9, 2, 8, 2, 64, 64, 32, torch.bfloat16)
    clean = k7.check_bwd_against_plain(args, {"causal": True},
                                       grads_k=k7.flash_attention_bwd_ref(*args, causal=True))
    assert clean["max_ratio"] == 0.0
    with pytest.raises(AssertionError, match="disagrees"):
        k7.check_bwd_against_plain(args, {"causal": True},
                                   grads_k=_faulty_bwd(fault, *args, causal=True))


def test_planted_backward_params():
    base = k7.backward_params(scale=0.125, causal=True)
    assert (base.scale, base.causal, base.causal_shift, base.first_head_only,
            base.d_from_do, base.ds_hi_only) == (0.125, 1, 0, 0, 0, 0)
    fields = ("first_head_only", "causal_shift", "d_from_do", "ds_hi_only")
    assert len(k7.BACKWARD_FAULTS) == len(fields)
    for fault, field in zip(k7.BACKWARD_FAULTS, fields):
        p = k7.planted_backward_params(fault)(scale=0.125, causal=True)
        assert getattr(p, field) == 1
        assert sum(getattr(p, f) for f in fields) == 1
    with pytest.raises(ValueError):
        k7.planted_backward_params("nope")


#: The split mirror's cases: b, h, hkv, lq, lk, dh, causal, and the factor
#: q and k are scaled by (x30 puts some visible weights below 2^-110,
#: where the split is no longer exact, and underflows most others to 0).
SPLIT_CASES = [
    (2, 8, 2, 96, 96, 64, True, 1.0),
    (2, 8, 2, 96, 96, 64, True, 8.0),
    (2, 8, 2, 96, 96, 64, True, 30.0),
    (2, 4, 4, 40, 17, 16, True, 1.0),     # Lq > Lk: rows that see no key
    (1, 6, 2, 20, 45, 32, False, 1.0),    # cross-attention shape, Lq < Lk
    (1, 8, 1, 25, 60, 128, True, 4.0),    # rep 8, the offset mask, Dh 128
]


def _scaled_bwd_inputs(seed, b, h, hkv, lq, lk, dh, causal, mult):
    """``random_bwd_inputs`` in bf16 with q and k scaled by ``mult`` (then
    rounded to bf16), K7's output and logsumexp recomputed."""
    q, k, v, out, lse, dout = k7.random_bwd_inputs(seed, b, h, hkv, lq, lk, dh, torch.bfloat16,
                                                   causal=causal)
    if mult != 1.0:
        q, k = ((t.float() * mult).to(torch.bfloat16) for t in (q, k))
        out = k7.flash_attention_ref(q, k, v, causal=causal)
        lse = k7.lse_ref(q, k, causal=causal)
    return q, k, v, out, lse, dout


@pytest.mark.parametrize("b,h,hkv,lq,lk,dh,causal,mult", SPLIT_CASES)
def test_split_mirror_within_the_bound(b, h, hkv, lq, lk, dh, causal, mult):
    """The bf16 kernel's scheme in plain torch (dO, P and dS as exact
    three-part bf16 splits, P dO's six cross terms) within the unchanged
    ``rounding_bound_bwd`` and ``BWD_NORMWISE_LIMIT`` of the plain backward;
    rows that see no key give exactly 0; and the ``ds_hi_only`` fault's
    mirror fails the same check."""
    args = _scaled_bwd_inputs(41, b, h, hkv, lq, lk, dh, causal, mult)
    kw = {"causal": causal}
    got = k7.flash_attention_bwd_split_ref(*args, **kw)
    assert [tuple(g.shape) for g in got] == [(b, h, lq, dh), (b, hkv, lk, dh), (b, hkv, lk, dh)]
    res = k7.check_bwd_against_plain(args, kw, grads_k=got)
    assert res["max_ratio"] <= 1.0 and res["normwise"] <= k7.BWD_NORMWISE_LIMIT
    if causal and lq > lk:
        assert not got[0][:, :, :lq - lk].any()
    if mult == 30.0:  # the split's inexact range is exercised
        q, k, _, _, lse, _ = args
        s = torch.einsum("bhqd,bhkd->bhqk", *k7._gqa(q, k, k)[:2]) / math.sqrt(dh)
        p = torch.where(k7._valid(lq, lk, causal, "cpu"), torch.exp(s - lse[..., None]), 0.0)
        assert int(((p > 0) & (p < 2.0**-110)).sum()) > 0
    with pytest.raises(AssertionError, match="disagrees"):
        k7.check_bwd_against_plain(
            args, kw, grads_k=k7.flash_attention_bwd_split_ref(*args, **kw, ds_hi_only=True))


def test_bwd_scratch_words():
    """K7b's scratch: D for fp32; for bf16 the padded lse and D (rows
    rounded up to the dK/dV kernel's 64 keys) and dO's three bf16 planes."""
    assert k7._bwd_scratch_words(torch.float32, 2, 3, 100, 64) == 2 * 3 * 100
    assert k7._bwd_scratch_words(torch.bfloat16, 2, 3, 100, 64) == (
        2 * 2 * 3 * 128 + 3 * 2 * 3 * 100 * 64 // 2)
    assert k7._bwd_scratch_words(torch.bfloat16, 1, 1, 64, 16) == 2 * 64 + 3 * 64 * 16 // 2


def test_bwd_wrapper_cpu_and_device_rules():
    args = k7.random_bwd_inputs(2, 1, 2, 1, 8, 8, 16, torch.float32)
    for g, w in zip(k7.flash_attention_bwd(*args), k7.flash_attention_bwd_ref(*args)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    meta = k7.flash_attention_bwd(*(t.to("meta") for t in args))
    for g, t in zip(meta, args[:3]):  # the dry run's shape-only path
        assert g.is_meta and g.shape == t.shape and g.dtype == torch.float32
    with pytest.raises(ValueError, match="cuda, cpu or meta"):
        k7._bwd_launch(*args, True, None)


def test_attention_full_gradients_reach_the_weights():
    """Through ``attention_full`` (rope, K7's op, wo) every projection gets
    a gradient, equal to autograd through the plain forward within 8 bf16
    ulps of the leaf's largest |gradient| (both are bf16 products whose
    roundings may flip: dq, dk, dv are rounded from the plain backward's
    fp32 here, from autograd's there)."""
    gen = torch.Generator().manual_seed(0)
    p = tattn.init_attention(gen, 32, 4, 2, 8)
    x = torch.randn(2, 16, 32, generator=gen)
    pos = torch.arange(16)[None].expand(2, 16)
    grads = []
    for fn in (k7.flash_attention, k7.flash_attention_ref):
        leaves = {key: t.clone().requires_grad_() for key, t in p.items()}
        saved = k7.flash_attention
        k7.flash_attention = fn
        try:
            out, _ = tattn.attention_full(leaves, x, pos, n_heads=4, n_kv=2, d_head=8)
        finally:
            k7.flash_attention = saved
        out.float().square().sum().backward()
        grads.append({key: t.grad for key, t in leaves.items()})
    for key in p:
        assert grads[0][key].abs().sum() > 0, key
        tol = 8 * 2.0**-8 * float(grads[1][key].abs().max())
        torch.testing.assert_close(grads[0][key], grads[1][key], rtol=0, atol=tol)


def test_layer_slice_gradients_equal_select():
    """``transformer.layer_params``' slice op gives the stacked leaves the
    gradients that plain indexing gives, bit for bit."""
    gen = torch.Generator().manual_seed(1)
    w = torch.randn(3, 5, 4, generator=gen)
    x = torch.randn(4, 5, generator=gen)
    grads = []
    for use_slice in (True, False):
        leaf = w.clone().requires_grad_()
        layers = [ttr.layer_params({"layers": {"w": leaf}}, i)["w"] if use_slice else leaf[i]
                  for i in range(3)]
        h = x
        for wi in layers:
            h = torch.tanh(h @ wi).repeat(1, 2)[:, :5]
        h.sum().backward()
        grads.append(leaf.grad)
    torch.testing.assert_close(grads[0], grads[1], rtol=0, atol=0)
