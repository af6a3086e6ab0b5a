"""Port parity, the hybrid family: ``models.hybrid`` (n_sites, tail_layers,
the shared attention block at 2 d_model with ``w_down``, HybridCache, the
site groups and the tail) against JAX's, zamba2-1.2b's SMOKE config served
against JAX (5 layers: 2 sites of 2, a tail of 1). The shared block
decodes with a ``DenseKVCache`` under either kv_mode, as in JAX.

Stated bounds: ``lm_parity``'s (logits within
``transformer.logit_tolerance``; cached K/V and conv tails within 8 bf16
ulps of each row's largest entry). The SSM states are held normwise to
``lm_parity.STATE_NORMWISE``: after the first shared block (a bf16
product at 2 d_model, 0.1% normwise apart in the two packages on the
same inputs) the next mamba layer's state sums terms whose three factors
each carry such flips, 0.7-1% normwise apart on the SMOKE prompt.
"""
import numpy as np
import pytest
import torch

import lm_parity as lp
from repro.models import hybrid as jhy
from repro.models import registry as jreg
from repro_torch.core import interop
from repro_torch.models import hybrid as thy
from repro_torch.models import registry as treg
from test_torch_helpers import one_torch_thread  # noqa: F401  (autouse fixture)

ARCH = "zamba2-1.2b"


@pytest.mark.parametrize("smoke", [False, True])
def test_sites_and_tail(smoke):
    cj, ct = jreg.get_config(ARCH, smoke=smoke), treg.get_config(ARCH, smoke=smoke)
    assert (thy.n_sites(ct), thy.tail_layers(ct), thy.shared_d(ct)) == (
        jhy.n_sites(cj), jhy.tail_layers(cj), jhy.shared_d(cj))
    if not smoke:  # 38 layers: 6 sites of 6 layers and a tail of 2
        assert (thy.n_sites(ct), thy.tail_layers(ct)) == (6, 2)
    sites = [thy._site_after(ct, i) for i in range(ct.n_layers)]
    ae = ct.attn_every
    assert [s for s in sites if s is not None] == list(range(thy.n_sites(ct)))
    assert all(s is None for s in sites[thy.n_sites(ct) * ae:])


@pytest.mark.parametrize("mode", ["anchored", "dense"])
def test_init_cache_matches_jax(mode):
    cj, ct = lp.cfgs(ARCH, mode)
    want = lp.jax_cache_numpy(jhy.init_cache(cj, 3, 256))
    got = thy.init_cache(ct, 3, 256, device="cpu")
    assert type(got.shared).__name__ == "DenseKVCache"
    got = interop.kv_cache_to_numpy(got)
    lp.assert_same_layout(got, want)
    assert not any(v.any() for v in got.values())


@pytest.mark.parametrize("mode", ["anchored", "dense"])
def test_prefill_and_teacher_forced_decode(mode):
    """SMOKE prefill logits and HybridCache, then 4 decode steps fed JAX's
    tokens."""
    out = lp.run_both(ARCH, mode, 2, 128, 256, 4)
    lp.assert_logits_close(*out["prefill"], "prefill")
    got, want = out["prefill_cache"]
    lp.assert_same_layout(got, want)
    np.testing.assert_array_equal(got["shared.length"], want["shared.length"])
    lp.assert_state_close(got["mamba.state"], want["mamba.state"], "mamba.state")
    for k in ("mamba.conv_buf", "shared.k", "shared.v"):
        lp.assert_bf16_close(got[k], want[k], k)
    lp.assert_logits_close(*out["decode"], "teacher-forced decode")
    got, want = out["cache"]
    np.testing.assert_array_equal(got["shared.length"], want["shared.length"])
    assert int(got["shared.length"][0, 0]) == 132
    lp.assert_state_close(got["mamba.state"], want["mamba.state"], "mamba.state")
    lp.assert_bf16_close(got["shared.k"], want["shared.k"], "shared.k")


def test_decode_writes_in_place():
    """The stacked mamba states and the shared KV cache are updated in
    their storage; the returned cache carries the new shared lengths."""
    _, ct = lp.cfgs(ARCH)
    _, pt = lp.params(ARCH)
    toks = torch.as_tensor(lp.prompt(ct.vocab, 2, 32))
    lg, cache = thy.prefill(pt, toks, ct, 64)
    state, k = cache.mamba.state, cache.shared.k
    before = state.clone()
    cur = torch.argmax(lg[:, -1:], -1).to(torch.int32)
    _, new = thy.decode_step(pt, cur, cache, ct)
    assert new.mamba.state is state and new.shared.k is k
    assert not torch.equal(state, before)
    assert new.shared.length.tolist() == [[33, 33]] * thy.n_sites(ct)


@pytest.mark.parametrize("mode", ["anchored", "dense"])
def test_serve_run_tokens(mode):
    lp.serve_tokens_match(ARCH, mode)


def test_shared_block_width():
    """The shared block attends in 2 d_model (head dim 2 d / heads: 128
    for zamba2-1.2b, a head dim K7 takes)."""
    ct = treg.get_config(ARCH)
    assert thy._shared_head_dim(ct) == 128
    small = treg.get_config(ARCH, smoke=True)
    p = thy.init_shared_block(torch.Generator().manual_seed(0), small)
    assert tuple(p["attn"]["wq"].shape) == (2 * small.d_model, 2 * small.d_model)
    assert tuple(p["w_down"].shape) == (2 * small.d_model, small.d_model)
