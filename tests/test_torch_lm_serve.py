"""Port parity, the LM serving slice at llama3.2-3b's SMOKE config: JAX's
parameters carried across by ``interop.lm_params_from_numpy``, the same
prompt through JAX's jitted ``prefill``/``decode_step`` and the port's
(on the CPU, so K6 and K7 run their plain versions).

Logits are held, teacher-forced (JAX's tokens fed to both), within
``transformer.logit_tolerance``: 8 bf16 ulps of each row's largest
|logit|. XLA fuses the bf16 products into what follows without rounding
them (excess precision), the port rounds each to bf16 as JAX's op-by-op
run does, so the two differ by flipped bf16 roundings. Greedy tokens are
compared up to the first position whose top-2 margin is not above twice
the logit difference measured there.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import serve as jserve
from repro.models import attention as jattn
from repro.models import registry as jreg
from repro.models import transformer as jtr
from repro_torch.core import interop
from repro_torch.launch import serve as tserve
from repro_torch.models import attention as tattn
from repro_torch.models import registry as treg
from repro_torch.models import transformer as ttr
from test_torch_helpers import one_torch_thread  # noqa: F401  (autouse fixture)

ARCH = "llama3.2-3b"


def _cfgs(mode: str, **kw):
    return (dataclasses.replace(jreg.get_config(ARCH, smoke=True), kv_mode=mode, **kw),
            dataclasses.replace(treg.get_config(ARCH, smoke=True), kv_mode=mode, **kw))


def _params(seed: int = 0):
    """JAX's SMOKE parameters and the port's copy of them."""
    pj = jtr.init_params(jax.random.key(seed), jreg.get_config(ARCH, smoke=True))
    leaves = jax.tree_util.tree_flatten_with_path(pj)[0]
    flat = {".".join(k.key for k in path): np.asarray(v) for path, v in leaves}
    return pj, interop.lm_params_from_numpy(flat, "cpu")


def _prompt(vocab, b, n, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, n)).astype(np.int32)


def _assert_logits_close(lt: torch.Tensor, lj, what: str):
    lj = np.asarray(lj)
    tol = ttr.logit_tolerance(torch.as_tensor(lj)).numpy()
    ratio = float((np.abs(lt.numpy() - lj) / tol).max())
    assert ratio <= 1.0, f"{what}: max |dlogit| is {ratio:.3g} x the tolerance"


def _bf16_ulp(x):
    return np.exp2(np.floor(np.log2(np.maximum(np.abs(x), 2.0**-126))) - 7)


def test_config_is_jaxs():
    for smoke in (False, True):
        cj, ct = jreg.get_config(ARCH, smoke=smoke), treg.get_config(ARCH, smoke=smoke)
        assert dataclasses.asdict(cj) == dataclasses.asdict(ct)
        assert cj.head_dim == ct.head_dim
    assert treg.ARCH_IDS == jreg.ARCH_IDS


def test_serve_run_needs_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tserve.ServeRun(arch=ARCH, smoke=True).run()


def test_param_tree_and_counts():
    pj, pt = _params()
    cfg = treg.get_config(ARCH, smoke=True)
    own = ttr.init_params(torch.Generator().manual_seed(0), cfg)
    shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), pj)
    assert ttr._map(pt, lambda _, t: tuple(t.shape)) == shapes
    assert ttr._map(own, lambda _, t: tuple(t.shape)) == shapes
    assert cfg.param_count(own) == jreg.get_config(ARCH, smoke=True).param_count(pj)
    w = ttr.compute_weights(own)
    assert w["layers"]["attn"]["wq"].dtype == torch.bfloat16
    assert w["layers"]["ln1"]["norm_w"].dtype == torch.float32
    # the bf16 copy holds the values of JAX's cast at use
    wq = pt["layers"]["attn"]["wq"]
    np.testing.assert_array_equal(
        ttr.compute_weights(pt)["layers"]["attn"]["wq"].float().numpy(),
        np.asarray(jnp.asarray(wq.numpy()).astype(jnp.bfloat16).astype(jnp.float32)))


@pytest.mark.parametrize("mode", ["anchored", "dense"])
def test_prefill_logits_and_caches(mode):
    cj, ct = _cfgs(mode)
    pj, pt = _params()
    toks = _prompt(cj.vocab, 2, 128)
    lj, cache_j = jax.jit(lambda p, t: jtr.prefill(p, t, cj, 256))(pj, jnp.asarray(toks))
    lt, cache_t = ttr.prefill(pt, torch.as_tensor(toks), ct, 256)
    _assert_logits_close(lt, lj, "prefill")
    got = interop.kv_cache_to_numpy(cache_t)
    want = {k: np.asarray(jnp.asarray(v).astype(jnp.float32)) if v.dtype == jnp.bfloat16
            else np.asarray(v) for k, v in cache_j._asdict().items()}
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, k
    np.testing.assert_array_equal(got["length"], want["length"])
    if mode == "dense":
        # k, v are bf16 products (+ RoPE) of inputs that differ by flipped
        # roundings: within 4 bf16 ulps of each row's largest entry
        for k in ("k", "v"):
            tol = 4 * _bf16_ulp(np.abs(want[k]).max(axis=-1, keepdims=True))
            assert np.all(np.abs(got[k] - want[k]) <= tol), k
    else:
        np.testing.assert_array_equal(got["tail_k"], want["tail_k"])  # empty after prefill
        for kv in ("k", "v"):
            dq = {}
            for name, c in (("t", got), ("j", want)):
                dq[name] = c[f"{kv}_anchor"] + c[f"{kv}_scale"] * (
                    c[f"{kv}_resid"].astype(np.float32) / 127.0)
            # the same bf16 inputs up to flips (4 ulps of the block's largest
            # entry), then one int8 level either way
            step = want[f"{kv}_scale"] / 127.0
            kmax = np.abs(dq["j"]).max(axis=(2, 4), keepdims=True)
            assert np.all(np.abs(dq["t"] - dq["j"]) <= 4 * _bf16_ulp(kmax) + 2 * step), kv
    # the interchange is lossless both ways
    back = interop.kv_cache_from_numpy(type(cache_t), cache_j._asdict(), "cpu")
    for k, t in back._asdict().items():
        assert t.dtype == getattr(cache_t, k).dtype
        np.testing.assert_array_equal(interop.kv_cache_to_numpy(back)[k], want[k])


@pytest.mark.parametrize("mode", ["anchored", "dense"])
def test_teacher_forced_decode_over_block_closures(mode):
    """64-token prompt, 32-token blocks, 90 decode steps: blocks close when
    positions 95, 127 and 159 are appended."""
    cj, ct = _cfgs(mode, kv_block=32)
    pj, pt = _params()
    toks = _prompt(cj.vocab, 2, 64, seed=1)
    lj, cache_j = jax.jit(lambda p, t: jtr.prefill(p, t, cj, 160))(pj, jnp.asarray(toks))
    lt, cache_t = ttr.prefill(pt, torch.as_tensor(toks), ct, 160)
    dec = jax.jit(lambda p, t, c: jtr.decode_step(p, t, c, cj))
    cur = np.argmax(np.asarray(lj)[:, -1:], -1).astype(np.int32)
    for step in range(90):
        lj, cache_j = dec(pj, jnp.asarray(cur), cache_j)
        lt, cache_t = ttr.decode_step(pt, torch.as_tensor(cur), cache_t, ct)
        _assert_logits_close(lt, lj, f"decode step {step}")
        cur = np.argmax(np.asarray(lj), -1).astype(np.int32)
    np.testing.assert_array_equal(cache_t.length.numpy(), np.asarray(cache_j.length))
    assert int(cache_t.length[0, 0]) == 154
    if mode == "anchored":  # the blocks closed in decode hold the same tokens
        for k in ("k_scale", "v_scale"):
            got = getattr(cache_t, k)[:, :, 2:4].numpy()
            want = np.asarray(getattr(cache_j, k))[:, :, 2:4]
            assert np.all(got > 0) and np.abs(got - want).max() <= 0.05 * np.abs(want).max()


def _teacher_forced(step_fns, prompt, tokens):
    """Logits (B, gen, vocab) at each generated position, fed ``tokens``."""
    prefill, decode = step_fns
    lg, cache = prefill(prompt)
    rows = [np.asarray(lg)[:, -1]]
    for i in range(tokens.shape[1] - 1):
        lg, cache = decode(tokens[:, i:i + 1], cache)
        rows.append(np.asarray(lg)[:, 0])
    return np.stack(rows, axis=1)


@pytest.mark.parametrize("mode", ["anchored", "dense"])
def test_serve_run_tokens_and_cache_bytes(mode):
    """ServeRun in both packages: the same cache bytes, and the same greedy
    tokens up to the first position where JAX's top-2 margin is not above
    twice the two packages' logit difference there (teacher-forced), where
    a flipped rounding may pick the other token."""
    pj, pt = _params()
    kw = dict(arch=ARCH, smoke=True, batch=4, prompt_len=128, gen=12, kv_mode=mode, seed=0)
    out_j = jserve.ServeRun(**kw).run()
    out_t = tserve.ServeRun(**kw, device="cpu", params=pt).run()
    assert out_t["cache_bytes"] == out_j["cache_bytes"]
    assert out_t["kv_mode"] == mode and out_t["tokens"].shape == out_j["tokens"].shape
    assert out_t["tokens"].dtype == np.int32
    cj, ct = _cfgs(mode)
    max_len = 256 if mode == "anchored" else 140
    prompt, toks = _prompt(cj.vocab, 4, 128), out_j["tokens"]
    dec_j = jax.jit(lambda p, t, c: jtr.decode_step(p, t, c, cj))
    lj = _teacher_forced(
        (lambda t: jax.jit(lambda p, t: jtr.prefill(p, t, cj, max_len))(pj, jnp.asarray(t)),
         lambda t, c: dec_j(pj, jnp.asarray(t), c)), prompt, toks)
    lt = _teacher_forced(
        (lambda t: ttr.prefill(pt, torch.as_tensor(t), ct, max_len),
         lambda t, c: ttr.decode_step(pt, torch.as_tensor(t), c, ct)), prompt, toks)
    _assert_logits_close(torch.as_tensor(lt), lj, "ServeRun's request, teacher-forced")
    top = np.sort(lj, axis=-1)
    margin = top[..., -1] - top[..., -2]
    diff = np.abs(lt - lj).max(axis=-1)
    compared = 0
    for b in range(4):
        close = np.flatnonzero(margin[b] <= 2 * diff[b])
        upto = close[0] if close.size else margin.shape[1]
        np.testing.assert_array_equal(out_t["tokens"][b, :upto], out_j["tokens"][b, :upto])
        compared += upto
    assert compared >= 24, compared  # the seeded request is mostly decided apart from ties


def test_partial_block_prompt_reproduces_jax():
    """A 100-token prompt with 128-token blocks: JAX quantizes the padded
    prompt into a closed block and reads tokens 0-99 from the zero tail
    (ROADMAP Queue 3); the port does the same, so its first decode logits
    match JAX's and both stand far from a full forward over the same tokens."""
    cj, ct = _cfgs("anchored")
    pj, pt = _params()
    toks = _prompt(cj.vocab, 2, 100, seed=2)
    lj, cache_j = jax.jit(lambda p, t: jtr.prefill(p, t, cj, 256))(pj, jnp.asarray(toks))
    lt, cache_t = ttr.prefill(pt, torch.as_tensor(toks), ct, 256)
    nxt = np.argmax(np.asarray(lj)[:, -1:], -1).astype(np.int32)
    l2j, _ = jax.jit(lambda p, t, c: jtr.decode_step(p, t, c, cj))(pj, jnp.asarray(nxt), cache_j)
    l2t, _ = ttr.decode_step(pt, torch.as_tensor(nxt), cache_t, ct)
    _assert_logits_close(l2t, l2j, "first decode step after a 100-token prompt")
    full, _, _ = jtr.forward(pj, jnp.asarray(np.concatenate([toks, nxt], 1)), cj)
    gap = np.abs(np.asarray(full)[:, -1:] - np.asarray(l2j)).max()
    assert gap > 1.0  # JAX measured 4.03 in a scratch run; a whole block gives ~0.04


def test_anchored_cache_update_is_branch_free_and_in_place():
    """One token appended at the last slot of a block closes it; elsewhere
    the block slots keep their contents (JAX's where on the flag)."""
    b, blk, hkv, dh = 2, 8, 2, 4
    rng = np.random.default_rng(5)
    tc = tattn.AnchoredKVCache.init(b, 3 * blk, hkv, dh, block=blk)
    tc = tc._replace(tail_k=torch.as_tensor(rng.normal(size=(b, blk, hkv, dh)).astype(np.float32)),
                     length=torch.tensor([blk - 1, 2 * blk + 3], dtype=torch.int32))
    jc = jattn.AnchoredKVCache(**{k: jnp.asarray(v.numpy()) for k, v in tc._asdict().items()})
    new = rng.normal(size=(b, 1, hkv, dh)).astype(np.float32)
    storage = tc.k_resid
    out_t = tattn.anchored_cache_update(tc, torch.as_tensor(new), torch.as_tensor(new))
    out_j = jattn.anchored_cache_update(jc, jnp.asarray(new), jnp.asarray(new))
    assert out_t.k_resid is storage  # written in place
    np.testing.assert_array_equal(out_t.length.numpy(), np.asarray(out_j.length))
    for k in ("k_resid", "tail_k", "v_resid"):
        np.testing.assert_array_equal(getattr(out_t, k).numpy(), np.asarray(getattr(out_j, k)))
    for k in ("k_anchor", "k_scale"):
        np.testing.assert_allclose(getattr(out_t, k).numpy(), np.asarray(getattr(out_j, k)),
                                   rtol=1e-6, atol=1e-7)
    assert int((out_t.k_resid[0, 0] != 0).sum()) > 0 and int((out_t.k_resid[1] != 0).sum()) == 0


@pytest.mark.parametrize("mode", ["anchored", "dense"])
def test_init_cache_matches_jax(mode):
    """The empty stacked caches: JAX's fields, shapes and dtypes, all zero."""
    cj, ct = _cfgs(mode)
    want = jtr.init_cache(cj, 3, 256)
    got = ttr.init_cache(ct, 3, 256, device="cpu")
    assert type(got).__name__ == type(want).__name__ and got._fields == want._fields
    for k in want._fields:
        w, g = getattr(want, k), getattr(got, k)
        assert tuple(g.shape) == w.shape and str(g.dtype).split(".")[-1] == str(w.dtype), k
        assert not bool(g.any()), k
    assert tserve.cache_bytes(got) == jserve.cache_bytes(want)
