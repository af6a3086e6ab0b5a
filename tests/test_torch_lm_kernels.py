"""Port parity, the LM kernels K6 (RCLL-KV decode attention) and K7 (flash
prefill attention). On the CPU the wrappers run their plain versions,
held against JAX's references (``kernels/ref.py``) and the Pallas kernels
in interpret mode, on a thinned copy of ``tests/test_kernels.py``'s grid
and at that file's tolerances: 2e-5 fp32 and 2e-2 bf16 for K7, rtol 2e-4
/ atol 2e-5 for K6. The K6 inputs are built by the port's
``core.anchored.encode`` and handed to both packages bit for bit.

Then the decode path's split attention: K6 over the closed blocks, plain
torch over the open fp32 tail, merged by their (m, l), against JAX's
one-softmax ``_sdpa_masked`` over the concatenated keys, with no closed
block, with a partial tail and with an empty tail (2e-6: fp32 sums in
another order over at most a few hundred keys).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jfa
from repro.kernels import rcll_kv_attention as jkv
from repro.kernels import ref as jref
from repro.models import attention as jattn
from repro_torch.core import anchored as tanch
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import rcll_kv_attention as tkv
from repro_torch.models import attention as tattn
from test_torch_helpers import one_torch_thread  # noqa: F401  (autouse fixture)

JDT = {"fp32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"fp32": torch.float32, "bf16": torch.bfloat16}


def _qkv(b, h, hkv, lq, lk, dh, dt, seed):
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=s).astype(np.float32)
            for s in ((b, h, lq, dh), (b, hkv, lk, dh), (b, hkv, lk, dh))]
    js = [jnp.asarray(a, JDT[dt]) for a in arrs]
    ts = [torch.as_tensor(np.asarray(a.astype(jnp.float32))).to(TDT[dt]) for a in js]
    return js, ts


@pytest.mark.parametrize("B,H,Hkv,L,Dh,bq,bk", [(1, 2, 2, 128, 32, 64, 64),
                                                (2, 4, 2, 256, 64, 128, 64)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dt", ["fp32", "bf16"])
def test_flash_attention_ref_matches_jax(B, H, Hkv, L, Dh, bq, bk, causal, dt):
    js, ts = _qkv(B, H, Hkv, L, L, Dh, dt, seed=0)
    out_t = tfa.flash_attention(*ts, causal=causal)  # CPU: the plain version
    assert out_t.dtype == torch.float32 and out_t.shape == (B, H, L, Dh)
    tol = 2e-5 if dt == "fp32" else 2e-2
    ref = np.asarray(jref.ref_attention(*js, causal=causal))
    np.testing.assert_allclose(out_t.numpy(), ref, rtol=tol, atol=tol)
    pallas = np.asarray(jfa.flash_attention(*js, causal=causal, block_q=bq, block_k=bk,
                                            interpret=True))
    np.testing.assert_allclose(out_t.numpy(), pallas, rtol=tol, atol=tol)


@pytest.mark.parametrize("lq,lk,causal", [(100, 100, True), (37, 130, True), (90, 70, False)])
def test_flash_attention_ref_any_length(lq, lk, causal):
    """Ragged lengths (no multiple of a tile) and Lq < Lk, where the causal
    mask aligns the last query with the last key (``ref_attention``'s
    ``tril(k=Lk-Lq)``)."""
    js, ts = _qkv(2, 6, 2, lq, lk, 16, "fp32", seed=1)
    ref = np.asarray(jref.ref_attention(*js, causal=causal))
    np.testing.assert_allclose(tfa.flash_attention_ref(*ts, causal=causal).numpy(), ref,
                               rtol=2e-5, atol=2e-5)


def test_flash_attention_ref_fully_masked_rows_give_zero():
    """With Lq > Lk a causal row can see no key: the TPU kernel's guard and
    the port give 0 there (``ref_attention`` would average v)."""
    _, ts = _qkv(1, 2, 1, 6, 4, 16, "fp32", seed=2)
    out = tfa.flash_attention_ref(*ts, causal=True)
    assert torch.equal(out[:, :, :2], torch.zeros_like(out[:, :, :2]))
    assert bool((out[:, :, 2:].abs() > 0).all())


def test_split_bf16x3_is_exact():
    """The plain three-part bf16 split that the bf16 kernel feeds to the
    tensor cores: hi + mid + lo == p bit for bit for fp32 weights in
    [2^-110, 1], 1.0 included; below 2^-110 (exp(-87), fp32 subnormals)
    lo would fall under bf16's range, and the parts are within 2^-133 of
    p, which ``rounding_bound`` absorbs."""
    rng = np.random.default_rng(4)
    e = rng.uniform(-110, 0, 200_000)
    p = np.minimum(2.0 ** e * rng.uniform(1, 2, e.size), 1.0).astype(np.float32)
    edges = np.float32([1.0, 2.0**-110, np.nextafter(np.float32(1), np.float32(0))])
    p = torch.as_tensor(np.concatenate([p, edges]))
    hi, mid, lo = tfa.split_bf16x3(p)
    assert all(x.dtype == torch.bfloat16 for x in (hi, mid, lo))
    assert torch.equal(hi.double() + mid.double() + lo.double(), p.double())
    tiny = np.concatenate([np.exp(np.float32([-87.0, -100.0])), np.float32([2.0**-126, 2.0**-149]),
                           (2.0 ** rng.uniform(-149, -110, 20_000)).astype(np.float32)])
    tiny = torch.as_tensor(tiny.astype(np.float32))
    hi, mid, lo = tfa.split_bf16x3(tiny)
    err = (hi.double() + mid.double() + lo.double() - tiny.double()).abs()
    assert float(err.max()) <= 2.0**-133


def test_sdpa_chunked_matches_jax():
    """K7's plain version, in the kernel's (B, H, L, Dh) layout, against
    JAX's ``sdpa_chunked``, the attention its prefill runs in (B, L, H, Dh)."""
    rng = np.random.default_rng(3)
    q, k, v = (rng.normal(size=(2, 128, h, 16)).astype(np.float32) for h in (6, 2, 2))
    out_j = np.asarray(jattn.sdpa_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                          causal=True, chunk=32))
    tr = [torch.as_tensor(x).transpose(1, 2) for x in (q, k, v)]
    np.testing.assert_allclose(tfa.flash_attention(*tr).transpose(1, 2).numpy(), out_j,
                               rtol=2e-5, atol=2e-5)


def _kv_inputs(b, h, hkv, dh, nblk, blk, resid, seed, lengths=None):
    """q, the encoded K/V (port's ``anchored.encode``) and lengths as
    numpy, plus the torch tensors."""
    rng = np.random.default_rng(seed)
    n = nblk * blk
    q = rng.normal(size=(b, h, dh)).astype(np.float32)
    k = rng.normal(size=(b, hkv, n, dh)).astype(np.float32)
    v = rng.normal(size=(b, hkv, n, dh)).astype(np.float32)
    length = (rng.integers(1, n + 1, (b,)) if lengths is None else np.asarray(lengths))
    parts = [torch.as_tensor(q)]
    for x in (k, v):
        e = tanch.encode(torch.as_tensor(x), block=blk, axis=2, dtype=resid)
        parts += [e.residual, e.anchor, e.scale]
    parts.append(torch.as_tensor(length.astype(np.int32)))
    return parts, k, v


def _to_jax(t: torch.Tensor):
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.float().numpy(), jnp.bfloat16)
    return jnp.asarray(t.numpy())


KV_GRID = [(1, 4, 4, 32, 2, 128), (2, 8, 2, 64, 4, 128), (3, 6, 2, 16, 3, 64)]


@pytest.mark.parametrize("B,H,Hkv,Dh,nblk,blk,resid", [
    g + (r,) for g in KV_GRID for r in (torch.float16, torch.int8)
] + [KV_GRID[2] + (torch.bfloat16,)])
def test_rcll_kv_decode_ref_matches_jax(B, H, Hkv, Dh, nblk, blk, resid):
    ts, k, v = _kv_inputs(B, H, Hkv, Dh, nblk, blk, resid, seed=5)
    js = [_to_jax(t) for t in ts]
    out_t = tkv.rcll_kv_decode(*ts)  # CPU: the plain version
    assert out_t.dtype == torch.float32 and out_t.shape == (B, H, Dh)
    ref = np.asarray(jref.ref_rcll_kv_decode(*js))
    np.testing.assert_allclose(out_t.numpy(), ref, rtol=2e-4, atol=2e-5)
    pallas = np.asarray(jkv.rcll_kv_decode(*js, interpret=True))
    np.testing.assert_allclose(out_t.numpy(), pallas, rtol=2e-4, atol=2e-5)
    # quantization keeps the output close to exact attention (test_kernels' gate)
    full = ts[-1].numpy() == nblk * blk
    if full.any():
        exact = np.asarray(jref.ref_attention(jnp.asarray(ts[0].numpy())[:, :, None],
                                              jnp.asarray(k), jnp.asarray(v),
                                              causal=False))[:, :, 0]
        err = np.abs(out_t.numpy()[full] - exact[full]).max()
        assert err < (0.01 if resid == torch.int8 else 0.001)


def test_rcll_kv_decode_ref_stats():
    """(m, l) are the masked scores' max and the sum of exp(s - m); a row
    of length 0 gives out 0, m = -1e30, l = 0."""
    ts, _, _ = _kv_inputs(3, 4, 2, 16, 2, 64, torch.int8, seed=6, lengths=[0, 1, 128])
    out, m, den = tkv.rcll_kv_decode(*ts, return_stats=True)
    assert torch.equal(out[0], torch.zeros_like(out[0]))
    assert bool((m[0] == tattn.NEG_INF).all()) and bool((den[0] == 0).all())
    kk = tkv.dequant(*ts[1:4]).reshape(3, 2, 128, 16).repeat_interleave(2, dim=1)
    s1 = torch.einsum("hd,hkd->hk", ts[0][1], kk[1]) / 4.0
    torch.testing.assert_close(m[1], s1[:, 0], rtol=0, atol=0)
    torch.testing.assert_close(den[1], torch.ones(4), rtol=0, atol=0)  # exp(0)
    s2 = torch.einsum("hd,hkd->hk", ts[0][2], kk[2]) / 4.0
    torch.testing.assert_close(m[2], s2.amax(-1), rtol=0, atol=0)
    torch.testing.assert_close(den[2], torch.exp(s2 - m[2][:, None]).sum(-1), rtol=1e-6,
                               atol=0)


def test_wrappers_reject_other_devices():
    """Meta tensors (the dry run) take the shape-only path; the launch
    paths take CUDA tensors alone and raise on any other device."""
    ts, _, _ = _kv_inputs(1, 2, 1, 16, 1, 64, torch.int8, seed=7)
    out = tkv.rcll_kv_decode(*(t.to("meta") for t in ts))
    assert out.is_meta and out.shape == ts[0].shape and out.dtype == torch.float32
    with pytest.raises(ValueError, match="cuda, cpu or meta"):
        tkv._launch(ts, None, False)
    _, qkv = _qkv(1, 2, 1, 8, 8, 16, "fp32", seed=8)
    out = tfa.flash_attention(*(t.to("meta") for t in qkv))
    assert out.is_meta and out.shape == qkv[0].shape and out.dtype == torch.float32
    with pytest.raises(ValueError, match="cuda, cpu or meta"):
        tfa._launch(*qkv, True, None, False)
    with pytest.raises(ValueError, match="cuda, cpu or meta"):
        tfa._bwd_launch(*qkv, qkv[0], torch.zeros(qkv[0].shape[:3]), qkv[0], True, None)


# --------------------------------------------------------------------------
# the decode path's split attention against JAX's one softmax
# --------------------------------------------------------------------------
def _cache_state(lengths, nblk=3, blk=32, hkv=2, dh=16, seed=9):
    """A random AnchoredKVCache state (JAX's layout) in both packages."""
    rng = np.random.default_rng(seed)
    b = len(lengths)
    f = {
        "k_resid": rng.integers(-127, 128, (b, nblk, blk, hkv, dh)).astype(np.int8),
        "v_resid": rng.integers(-127, 128, (b, nblk, blk, hkv, dh)).astype(np.int8),
        "tail_k": rng.normal(size=(b, blk, hkv, dh)).astype(np.float32),
        "tail_v": rng.normal(size=(b, blk, hkv, dh)).astype(np.float32),
        "length": np.asarray(lengths, np.int32),
    }
    for name in ("k_anchor", "v_anchor"):
        f[name] = rng.normal(size=(b, nblk, 1, hkv, dh)).astype(np.float32)
    for name in ("k_scale", "v_scale"):
        f[name] = rng.uniform(0.5, 2.0, (b, nblk, 1, hkv, dh)).astype(np.float32)
    jc = jattn.AnchoredKVCache(**{k: jnp.asarray(v) for k, v in f.items()})
    tc = tattn.AnchoredKVCache(**{k: torch.as_tensor(v) for k, v in f.items()})
    q = rng.normal(size=(b, 1, 3 * hkv, dh)).astype(np.float32)
    return jc, tc, q


def _jax_one_softmax(jc, q):
    """decode_attention_anchored's attention, as JAX computes it."""
    b, nblk, blk, hkv, dh = jc.k_resid.shape
    k_closed = jattn._dequant(jc.k_resid, jc.k_anchor, jc.k_scale).reshape(b, -1, hkv, dh)
    v_closed = jattn._dequant(jc.v_resid, jc.v_anchor, jc.v_scale).reshape(b, -1, hkv, dh)
    closed_len = (jc.length // blk) * blk
    cols = jnp.arange(nblk * blk + blk)[None, :]
    valid = (cols < closed_len[:, None]) | ((cols >= nblk * blk) & (
        (cols - nblk * blk) < (jc.length - closed_len)[:, None]))
    return np.asarray(jattn._sdpa_masked(
        jnp.asarray(q), jnp.concatenate([k_closed, jc.tail_k], axis=1),
        jnp.concatenate([v_closed, jc.tail_v], axis=1), valid))[:, 0]


@pytest.mark.parametrize("lengths,case", [
    ([5, 31], "no closed block (closed_len = 0): the tail alone"),
    ([37, 70, 90], "closed blocks and a partial tail"),
    ([32, 64, 96], "closed blocks and an empty tail: K6 alone"),
])
def test_split_decode_attention_matches_one_softmax(lengths, case):
    jc, tc, q = _cache_state(lengths)
    out_t = tattn.anchored_attention(torch.as_tensor(q), tc)
    np.testing.assert_allclose(out_t.numpy(), _jax_one_softmax(jc, q), rtol=2e-6, atol=2e-6,
                               err_msg=case)
    blk = tc.block
    closed = (tc.length // blk) * blk
    tail = tattn.tail_attention(torch.as_tensor(q), tc.tail_k, tc.tail_v, tc.length - closed)
    if int(closed.max()) == 0:  # the merge hands the tail's output through exactly
        assert torch.equal(out_t, tail[0])
    if bool((tc.length == closed).all()):  # and K6's, with an empty tail
        k6_out = tkv.rcll_kv_decode(
            torch.as_tensor(q)[:, 0], *(tattn._heads_major(t) for t in tc[:6]), closed)
        assert torch.equal(out_t, k6_out)
