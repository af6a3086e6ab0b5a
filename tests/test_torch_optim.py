"""Port parity of ``repro_torch.optim``: AdamW (``adamw.apply_updates``,
in place, sliced) against JAX's ``apply_updates`` on identical fp32 trees
and gradients, the schedule, the global norm and clip, and the anchored
gradient compression (``compress`` / ``decompress``) against JAX's.

Tolerances (u = 2^-24, fp32's unit roundoff):
  * a step of AdamW rounds a handful of times per element (the moments,
    the bias corrections, sqrt, the division, lr x u and the subtraction;
    JAX's jit may contract some into FMAs, the port's ops do not), each at
    most u of |p| or of lr |u_t|, where |u_t| = |m^|/(sqrt(v^) + eps)
    <= U = 1.17 for b1 0.9, b2 0.95 (Cauchy-Schwarz over the moments'
    geometric sums: (1 - b1)/sqrt(1 - b2) sqrt(sum_k (b1^2/b2)^k) at
    most, with the bias corrections); so after T steps |dp| <= 8 u (T |p|
    + U sum_t lr_t), 8 roundings a step. Readings: at most 2.2 u (T |p| +
    U sum lr). The moments alike, of their terms' magnitudes.
  * the schedule: its cosine is a few u off, which 1 + cos near -1 turns
    into a few u of the base rate, absolute.
  * compress: the per-block mean and max differ by the sum's order, at
    most 256 u of the block's sum of |x|; a residual level may then
    differ by one only where JAX's quotient dev / scale x 127 lies within
    that difference (times 127 / scale) plus 8 u of itself of a rounding
    tie (x.5); elsewhere the levels are equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as jadamw
from repro.optim import compress as jcompress
from repro_torch.optim import adamw as tadamw
from repro_torch.optim import compress as tcompress
from test_torch_helpers import one_torch_thread  # noqa: F401  (autouse fixture)

U32 = 2.0**-24
U_MAX = 1.17
SHAPES = {"embed_tokens": {"embed": (64, 16)},
          "layers": {"attn": {"wq": (3, 16, 32)}, "ln1": {"norm_w": (3, 16)}},
          "final_norm": {"norm_w": (16,)}}


def _tree(rng, scale):
    def mk(s):
        return {k: mk(v) for k, v in s.items()} if isinstance(s, dict) else (
            rng.normal(size=s) * scale).astype(np.float32)
    return mk(SHAPES)


def _leaves_np(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def _leaves_t(tree):
    """The port's leaves in JAX's (sorted-key) order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves_t(tree[k])]
    return [tree.numpy()]


def _torch_tree(tree):
    return jax.tree.map(lambda a: torch.tensor(np.asarray(a)), tree)


@pytest.mark.parametrize("lr,warmup,total,wd", [(1e-2, 3, 10, 0.1), (3e-3, 20, 50, 0.0),
                                                (1e-3, 0, 5, 0.1)])
def test_adamw_matches_jax(lr, warmup, total, wd):
    rng = np.random.default_rng(0)
    cfg_j = jadamw.OptConfig(lr=lr, warmup_steps=warmup, total_steps=total, weight_decay=wd)
    cfg_t = tadamw.OptConfig(lr=lr, warmup_steps=warmup, total_steps=total, weight_decay=wd)
    p0 = _tree(rng, 0.1)
    pj, sj = jax.tree.map(jnp.asarray, p0), jadamw.init(jax.tree.map(jnp.asarray, p0))
    pt = _torch_tree(p0)
    st = tadamw.init(pt)
    ptrs = [t.data_ptr() for t in tadamw.tree_leaves(pt)]
    upd = jax.jit(lambda p, g, s: jadamw.apply_updates(cfg_j, p, g, s))
    lr_sum, gmax, g2max = 0.0, None, None
    for step in range(12):
        g = _tree(rng, 3.0 if step % 2 else 0.01)  # clip on odd steps (norm > 1), off on even
        pj, sj, mj = upd(pj, jax.tree.map(jnp.asarray, g), sj)
        pt, st, mt = tadamw.apply_updates(cfg_t, pt, _torch_tree(g), st)
        assert int(st.step) == int(sj.step) == step + 1 and st.step.dtype == torch.int32
        # cos near -1 cancels in 1 + cos: a few u of the base rate, absolute
        assert abs(float(mt["lr"]) - float(mj["lr"])) <= 4 * U32 * (float(mj["lr"]) + lr)
        assert float(mt["grad_norm"]) == pytest.approx(float(mj["grad_norm"]), rel=64 * U32)
        lr_sum += float(mj["lr"])
        scale = min(1.0, 1.0 / max(float(mj["grad_norm"]), 1e-12))
        ga = [np.abs(a) * scale for a in _leaves_np(g)]
        gmax = ga if gmax is None else [np.maximum(a, b) for a, b in zip(gmax, ga)]
        g2max = [a * a for a in gmax]
        t = step + 1
        for a, b in zip(_leaves_np(pj), _leaves_t(pt)):
            tol = 8 * U32 * (t * np.abs(a) + U_MAX * lr_sum)
            assert np.all(np.abs(a - b) <= tol), float((np.abs(a - b) / tol).max())
        for mom_j, mom_t, gm in ((sj.mu, st.mu, gmax), (sj.nu, st.nu, g2max)):
            for a, b, m in zip(_leaves_np(mom_j), _leaves_t(mom_t), gm):
                tol = 8 * U32 * t * (np.abs(a) + m)
                assert np.all(np.abs(a - b) <= tol), float((np.abs(a - b) / tol).max())
    # in place: the same storages hold the new parameters
    assert [t.data_ptr() for t in tadamw.tree_leaves(pt)] == ptrs


def test_schedule_matches_jax():
    for cfg in (dict(lr=1.0, warmup_steps=10, total_steps=100, min_lr_frac=0.1),
                dict(lr=3e-4, warmup_steps=0, total_steps=7), dict(lr=1e-3, warmup_steps=20,
                                                                   total_steps=50)):
        cj, ct = jadamw.OptConfig(**cfg), tadamw.OptConfig(**cfg)
        for s in range(0, 120):
            a = float(jadamw.schedule(cj, jnp.asarray(s, jnp.int32)))
            b = float(tadamw.schedule(ct, torch.tensor(s, dtype=torch.int32)))
            assert abs(a - b) <= 4 * U32 * (abs(a) + cfg["lr"]), (cfg, s, a, b)
    ct = tadamw.OptConfig(lr=1.0, warmup_steps=10, total_steps=100, min_lr_frac=0.1)
    assert float(tadamw.schedule(ct, torch.tensor(5))) == 0.5
    assert abs(float(tadamw.schedule(ct, torch.tensor(100))) - 0.1) < 1e-6


def test_global_norm_and_clip_match_jax():
    rng = np.random.default_rng(1)
    g = _tree(rng, 5.0)
    nj = float(jadamw.global_norm(jax.tree.map(jnp.asarray, g)))
    gt = _torch_tree(g)
    assert float(tadamw.global_norm(gt)) == pytest.approx(nj, rel=64 * U32)
    cj, nj2 = jadamw.clip_by_global_norm(jax.tree.map(jnp.asarray, g), 1.0)
    ct, nt = tadamw.clip_by_global_norm(gt, 1.0)
    assert ct is gt  # in place
    assert float(nt) == pytest.approx(float(nj2), rel=64 * U32)
    for a, b in zip(_leaves_np(cj), _leaves_t(ct)):
        np.testing.assert_allclose(b, a, rtol=128 * U32, atol=0)
    assert abs(float(tadamw.global_norm(ct)) - 1.0) < 1e-5


def test_sliced_update_is_bit_equal(monkeypatch):
    """The update a slice at a time equals one slice a leaf bit for bit
    (clip off: the scale is exactly 1, and each element's arithmetic is
    its own)."""
    rng = np.random.default_rng(2)
    p0, cfg = _tree(rng, 0.1), tadamw.OptConfig(lr=1e-2, warmup_steps=2, total_steps=8)
    outs = []
    for chunk in (tadamw.CHUNK, 7):
        monkeypatch.setattr(tadamw, "CHUNK", chunk)
        r = np.random.default_rng(3)
        pt = _torch_tree(p0)
        st = tadamw.init(pt)
        for _ in range(5):
            pt, st, _ = tadamw.apply_updates(cfg, pt, _torch_tree(_tree(r, 0.01)), st)
        outs.append(_leaves_t(pt) + _leaves_t(st.mu) + _leaves_t(st.nu))
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


def test_decay_mask_is_jaxs():
    for shape in [(16,), (3, 16), (3, 16, 32), ()]:
        x = np.zeros(shape, np.float32)
        assert tadamw._decay_mask(torch.tensor(x)) == jadamw._decay_mask(jnp.asarray(x))


def test_adamw_minimizes_quadratic():
    cfg = tadamw.OptConfig(lr=0.1, warmup_steps=5, total_steps=200, weight_decay=0.0,
                           clip_norm=100.0)
    params = {"w": torch.tensor([3.0, -2.0, 5.0], requires_grad=True)}
    st = tadamw.init(params)
    for _ in range(150):
        params["w"].grad = None
        torch.sum(params["w"] ** 2).backward()
        params, st, _ = tadamw.apply_updates(cfg, params, {"w": params["w"].grad}, st)
    assert float(params["w"].detach().abs().max()) < 0.05


def _resid_ties(x: np.ndarray, c) -> np.ndarray:
    """Where a residual level may legitimately differ from JAX's: JAX's
    quotient within the derived distance of a rounding tie."""
    n = x.size
    blocks = np.pad(x.reshape(-1), (0, (-n) % tcompress.BLOCK)).reshape(-1, tcompress.BLOCK)
    anchor, scale = np.asarray(c.anchor), np.asarray(c.scale)
    q = (blocks - anchor[:, None]) / scale[:, None] * 127.0
    dq = 127.0 * 256 * U32 * np.abs(blocks).sum(1, keepdims=True) / tcompress.BLOCK \
        / scale[:, None] * 2 + 8 * U32 * np.abs(q)
    return np.abs(np.abs(q - np.floor(q)) - 0.5) <= dq


@pytest.mark.parametrize("n,loc,spread,carry", [(1000, 2.0, 0.5, False), (4096, 0.0, 1e-3, True),
                                                (257, -5.0, 3.0, True), (256 * 7, 0.0, 0.0, False)])
def test_compress_matches_jax(n, loc, spread, carry):
    rng = np.random.default_rng(n)
    g = rng.normal(loc, spread, (n,)).astype(np.float32)
    c0 = rng.normal(0, 1e-3, (n,)).astype(np.float32) if carry else None
    cj, carry_j = jcompress.compress(jnp.asarray(g), None if c0 is None else jnp.asarray(c0))
    ct, carry_t = tcompress.compress(torch.tensor(g), None if c0 is None else torch.tensor(c0))
    assert ct.n == cj.n == n and ct.resid.dtype == torch.int8
    x = g + (c0 if carry else 0)
    sums = np.abs(np.pad(x, (0, (-n) % 256)).reshape(-1, 256)).sum(1)
    np.testing.assert_array_less(np.abs(ct.anchor.numpy() - np.asarray(cj.anchor)),
                                 256 * U32 * sums / 256 + 1e-38)
    np.testing.assert_allclose(ct.scale.numpy(), np.asarray(cj.scale), rtol=0,
                               atol=float(2 * 256 * U32 * sums.max() / 256) + 1e-38)
    diff = ct.resid.numpy().astype(np.int32) - np.asarray(cj.resid).astype(np.int32)
    assert np.abs(diff).max(initial=0) <= 1
    assert np.all((diff == 0) | _resid_ties(x, cj)), "a level differs away from a rounding tie"
    dec_t = tcompress.decompress(ct, (n,)).numpy()
    dec_j = np.asarray(jcompress.decompress(cj, (n,)))
    step = np.repeat(np.asarray(cj.scale) / 127.0, 256)[:n]
    assert np.all(np.abs(dec_t - dec_j) <= np.abs(diff.reshape(-1)[:n]) * step * 1.01
                  + 8 * U32 * (np.abs(dec_j) + step * 127))
    np.testing.assert_allclose(carry_t.numpy(), x - dec_t, atol=1e-6)
    assert carry_j.shape == tuple(carry_t.shape)


def test_compress_error_feedback_is_unbiased():
    rng = np.random.default_rng(0)
    g = torch.tensor(rng.normal(2.0, 0.5, (1000,)).astype(np.float32))
    c, carry = tcompress.compress(g)
    dec = tcompress.decompress(c, g.shape)
    assert float((dec - g).abs().max()) < 0.5 * 2 / 127 * 4 + 1e-3
    total, carry = torch.zeros_like(g), torch.zeros_like(g)
    for _ in range(50):
        c, carry = tcompress.compress(g, carry)
        total = total + tcompress.decompress(c, g.shape)
    np.testing.assert_allclose((total / 50).numpy(), g.numpy(), atol=2e-3)


@pytest.mark.parametrize("shape", [(1024, 1024), (7,), (3, 257), (128256, 3072)])
def test_compression_ratio_is_jaxs(shape):
    assert tcompress.compression_ratio(shape) == jcompress.compression_ratio(shape)
