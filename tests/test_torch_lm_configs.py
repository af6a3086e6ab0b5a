"""Port parity, the registry and every architecture's config and weights:
the ten ids' CONFIG and SMOKE equal to JAX's field for field, each family
module and parameter tree, ``compute_weights`` keeping the leaves JAX
reads in fp32 (router, norm biases, mamba2's conv and SSM scalars) fp32,
``init_params(dtype=bf16)`` bit-equal to ``compute_weights(init_params())``,
``ServeRun`` on the CPU for every id, and the dense configs (granite,
stablelm, internlm2) and the vlm (pixtral) served against JAX at SMOKE
size (``lm_parity``'s tolerances, stated there), and the port's own
decode-vs-forward check as JAX's ``test_models.py`` runs it.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lm_parity as lp
from repro.launch import serve as jserve
from repro.models import registry as jreg
from repro_torch.launch import serve as tserve
from repro_torch.models import encdec, hybrid
from repro_torch.models import registry as treg
from repro_torch.models import transformer as ttr
from test_torch_helpers import one_torch_thread  # noqa: F401  (autouse fixture)

ARCHS = jreg.ARCH_IDS
#: One architecture of each family.
FAMILY_ARCH = {"dense": "granite-3-8b", "vlm": "pixtral-12b", "moe": "deepseek-moe-16b",
               "mla_moe": "deepseek-v2-236b", "ssm": "mamba2-130m", "hybrid": "zamba2-1.2b",
               "encdec": "whisper-large-v3"}
#: The leaves each family's JAX apply functions read in fp32 (by leaf name).
JAX_FP32 = {"dense": {"norm_w"}, "vlm": {"norm_w"}, "moe": {"norm_w", "router"},
            "mla_moe": {"norm_w", "router"},
            "ssm": {"norm_w", "conv_w", "conv_bias", "a_log", "dt_bias", "d_skip"},
            "hybrid": {"norm_w", "conv_w", "conv_bias", "a_log", "dt_bias", "d_skip"},
            "encdec": {"norm_w", "norm_bias"}}


def test_arch_ids_are_jaxs():
    assert treg.ARCH_IDS == jreg.ARCH_IDS


@pytest.mark.parametrize("smoke", [False, True], ids=["config", "smoke"])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_is_jaxs(arch, smoke):
    cj, ct = jreg.get_config(arch, smoke=smoke), treg.get_config(arch, smoke=smoke)
    assert dataclasses.asdict(cj) == dataclasses.asdict(ct)
    if cj.n_heads:
        assert cj.head_dim == ct.head_dim
    if cj.family in ("ssm", "hybrid"):
        assert tuple(ct.ssm_dims) == tuple(cj.ssm_dims)
    if cj.family == "mla_moe":
        assert tuple(ct.mla_dims) == tuple(cj.mla_dims)


@pytest.mark.parametrize("arch", ARCHS)
def test_module_and_param_tree(arch):
    """The family module JAX's registry picks, and the port's own draw has
    JAX's parameter paths, shapes and count."""
    cj, ct = jreg.get_config(arch, smoke=True), treg.get_config(arch, smoke=True)
    mod = treg.get_module(ct)
    assert mod.__name__.split(".")[-1] == jreg.get_module(cj).__name__.split(".")[-1]
    assert mod is {"hybrid": hybrid, "encdec": encdec}.get(ct.family, ttr)
    pj = jreg.get_module(cj).init_params(jax.random.key(0), cj)
    own = treg.init_params(torch.Generator().manual_seed(0), ct)
    shapes = {k: v.shape for k, v in lp.flat_params(pj).items()}
    got = {k: tuple(v.shape) for k, v in lp.flat_params_t(own).items()}
    assert got == shapes
    assert ct.param_count(own) == cj.param_count(pj)
    assert all(t.dtype == torch.float32 for t in ttr._leaves(own))


@pytest.mark.parametrize("family", list(FAMILY_ARCH))
def test_compute_weights_keeps_jaxs_fp32_leaves(family):
    """JAX's fp32 masters through ``compute_weights``: the leaves JAX reads
    in fp32 keep their values and dtype, every other leaf holds JAX's cast
    at use (fp32 -> bf16, nearest even)."""
    arch = FAMILY_ARCH[family]
    pj, pt = lp.params(arch)
    w = lp.flat_params_t(ttr.compute_weights(pt))
    seen = set()
    for path, arr in lp.flat_params(pj).items():
        leaf = path.split(".")[-1]
        if leaf in JAX_FP32[family]:
            seen.add(leaf)
            assert w[path].dtype == torch.float32, path
            np.testing.assert_array_equal(w[path].numpy(), arr)
        else:
            assert w[path].dtype == torch.bfloat16, path
            np.testing.assert_array_equal(
                w[path].float().numpy(),
                np.asarray(jnp.asarray(arr).astype(jnp.bfloat16).astype(jnp.float32)))
    assert seen == JAX_FP32[family]


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_in_bf16_is_bit_equal(arch):
    """Drawn straight into bf16 stacks, one fp32 layer at a time: the same
    tensors, bit for bit, as the fp32 draw cast by ``compute_weights``."""
    ct = treg.get_config(arch, smoke=True)
    want = lp.flat_params_t(ttr.compute_weights(treg.init_params(
        torch.Generator().manual_seed(3), ct)))
    got = lp.flat_params_t(treg.init_params(torch.Generator().manual_seed(3), ct,
                                            dtype=torch.bfloat16))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_run_on_cpu(arch):
    """ServeRun draws its weights and stubs and serves every id on the CPU,
    with the cache bytes of JAX's cache of the same shapes."""
    cj, ct = jreg.get_config(arch, smoke=True), treg.get_config(arch, smoke=True)
    out = tserve.ServeRun(arch=arch, smoke=True, batch=2, prompt_len=32, gen=4,
                          device="cpu").run()
    assert out["tokens"].shape == (2, 4) and out["tokens"].dtype == np.int32
    assert ((0 <= out["tokens"]) & (out["tokens"] < ct.vocab)).all()
    want = jax.eval_shape(lambda: jreg.get_module(cj).init_cache(cj, 2, 36))
    assert out["cache_bytes"] == jserve.cache_bytes(want)


@pytest.mark.parametrize("arch", ["granite-3-8b", "stablelm-1.6b", "internlm2-20b",
                                  "pixtral-12b"])
@pytest.mark.parametrize("mode", ["anchored", "dense"])
def test_prefill_and_teacher_forced_decode(arch, mode):
    """Prefill logits and caches, then 4 decode steps fed JAX's tokens
    (pixtral's patch embeddings replace its first 8 positions)."""
    out = lp.run_both(arch, mode, 2, 128, 256, 4)
    lp.assert_logits_close(*out["prefill"], "prefill")
    got, want = out["prefill_cache"]
    lp.assert_same_layout(got, want)
    np.testing.assert_array_equal(got["length"], want["length"])
    if mode == "dense":
        for k in ("k", "v"):
            lp.assert_bf16_close(got[k], want[k], k)
    else:
        lp.assert_anchored_close(got, want)
    lp.assert_logits_close(*out["decode"], "teacher-forced decode")
    got, want = out["cache"]
    np.testing.assert_array_equal(got["length"], want["length"])
    assert int(got["length"][0, 0]) == 132


@pytest.mark.parametrize("arch", ["granite-3-8b", "stablelm-1.6b", "internlm2-20b",
                                  "pixtral-12b"])
def test_serve_run_tokens(arch):
    lp.serve_tokens_match(arch, "anchored")


def test_vlm_patch_embeds_replace_the_first_positions():
    """pixtral: with patch embeddings the tokens at the first n_patches
    positions are not read (two prompts that differ only there give the
    same logits), and the logits differ from the text-only forward's."""
    _, ct = lp.cfgs("pixtral-12b")
    _, pt = lp.params("pixtral-12b")
    toks = torch.as_tensor(lp.prompt(ct.vocab, 2, 32))
    other = toks.clone()
    other[:, :ct.n_patches] = (other[:, :ct.n_patches] + 1) % ct.vocab
    _, kw = lp.stubs(ct, 2)
    with_pe, _, _ = ttr.forward(pt, toks, ct, **kw)
    assert torch.equal(ttr.forward(pt, other, ct, **kw)[0], with_pe)
    text, _, _ = ttr.forward(pt, toks, ct)
    assert not torch.equal(with_pe[:, :ct.n_patches], text[:, :ct.n_patches])


@pytest.mark.parametrize("arch", [
    "llama3.2-3b", "mamba2-130m",
    # a copy of JAX's own non-strict xfail (tests/test_models.py)
    pytest.param("deepseek-v2-236b",
                 marks=pytest.mark.xfail(
                     strict=False,
                     reason="top-k router near-tie flips under "
                     "forward-vs-decode XLA fusion differences")),
    "whisper-large-v3", "zamba2-1.2b"])
def test_decode_consistent_with_forward(arch):
    """The port's logits(prefill(t[:L]) then decode(t[L])) against its
    logits(forward(t[:L+1])) at the last position, as JAX's test checks
    its own (ample expert capacity, rtol 0.1 / atol 0.15, same top-1)."""
    rng = np.random.default_rng(0)
    cfg = treg.get_config(arch, smoke=True)
    if cfg.n_routed:
        cfg = dataclasses.replace(cfg, capacity_factor=16.0)
    mod = treg.get_module(cfg)
    params = treg.init_params(torch.Generator().manual_seed(0), cfg)
    b, l = 2, 31
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (b, l + 1)), dtype=torch.int32)
    kw = {}
    if cfg.family == "encdec":
        kw["frames"] = torch.as_tensor(rng.normal(size=(b, cfg.src_len, cfg.d_model)),
                                       dtype=torch.float32).bfloat16()
    full, _, _ = mod.forward(params, toks, cfg, **kw)
    _, cache = mod.prefill(params, toks[:, :l], cfg, l + 8, **kw)
    lg_d, _ = mod.decode_step(params, toks[:, l:], cache, cfg)
    a, d = full[:, -1].numpy(), lg_d[:, 0].numpy()
    np.testing.assert_allclose(a, d, rtol=0.1, atol=0.15)
    assert np.all(np.argmax(a, -1) == np.argmax(d, -1))
