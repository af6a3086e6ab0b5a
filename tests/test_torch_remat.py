"""``remat="full"`` in the port (each layer body under
``torch.utils.checkpoint``, where JAX wraps it in ``jax.checkpoint``), on
the CPU at SMOKE size with ``remat`` set by ``dataclasses.replace``:

- every family's loss and every parameter gradient with remat are
  bit-equal to the same step without it (the recompute reruns the same
  ops on the same inputs, and each layer's ``_LayerSlice`` backward adds
  its gradient once);
- with remat on both sides the port agrees with JAX's ``loss_fn`` under
  ``jax.value_and_grad`` at ``lm_parity``'s unchanged tolerances (the MoE
  ids, which JAX runs op by op, are in ``test_torch_loss_moe_remat.py``);
- the recompute happens: K7 runs twice a layer a step (once a layer
  without remat), K7b once, and the bytes the backward holds at the end of
  the forward drop; a planted remat that keeps the config but skips the
  checkpoint fails these checks;
- serving (``no_grad``, inference mode) runs no checkpoint.
"""
import dataclasses

import pytest
import torch
import torch.utils.checkpoint

import lm_parity as lp
from repro_torch.data.pipeline import DataConfig, make_batch
from repro_torch.kernels import flash_attention as k7
from repro_torch.kernels.cost import CostCounter
from repro_torch.launch.serve import modality_inputs
from repro_torch.launch.train import TrainRun, train_step
from repro_torch.models import hybrid, registry, transformer
from repro_torch.optim import adamw
from test_torch_helpers import one_torch_thread  # noqa: F401  (autouse fixture)

#: One id of each family.
FAMILIES = {"dense": "llama3.2-3b", "moe": "deepseek-moe-16b", "mla_moe": "deepseek-v2-236b",
            "vlm": "pixtral-12b", "ssm": "mamba2-130m", "hybrid": "zamba2-1.2b",
            "encdec": "whisper-large-v3"}
#: The ids whose JAX gradients run jitted (the MoE ids run op by op, in
#: their own file).
JAX_JITTED = ["granite-3-8b", "stablelm-1.6b", "internlm2-20b", "llama3.2-3b",
              "whisper-large-v3", "zamba2-1.2b", "pixtral-12b", "mamba2-130m"]


def _setup(arch: str, remat: str, seed: int = 0):
    cfg = dataclasses.replace(registry.get_config(arch, smoke=True), remat=remat)
    mod = registry.get_module(cfg)
    params = mod.init_params(torch.Generator().manual_seed(seed), cfg)
    for t in adamw.tree_leaves(params):
        t.requires_grad_(True)
    batch = make_batch(DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=2), 0, "cpu")
    return cfg, mod, params, TrainRun._with_stubs(batch, cfg)


@pytest.fixture
def checkpoints(monkeypatch):
    """Counts ``torch.utils.checkpoint.checkpoint`` calls."""
    calls = []
    orig = torch.utils.checkpoint.checkpoint

    def counted(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)

    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint", counted)
    return calls


def _loss_and_grads(arch: str, remat: str):
    cfg, mod, params, batch = _setup(arch, remat)
    loss, metrics = mod.loss_fn(params, batch, cfg)
    loss.backward()
    return (loss.detach(), metrics["aux"].detach(),
            [t.grad for t in adamw.tree_leaves(params)])


@pytest.mark.parametrize("family", list(FAMILIES))
def test_remat_is_bit_equal(family, checkpoints):
    arch = FAMILIES[family]
    loss_n, aux_n, g_n = _loss_and_grads(arch, "none")
    assert not checkpoints
    loss_f, aux_f, g_f = _loss_and_grads(arch, "full")
    assert checkpoints, "remat='full' ran no checkpoint"
    assert torch.equal(loss_n, loss_f) and torch.equal(aux_n, aux_f)
    assert len(g_n) == len(g_f)
    for a, b in zip(g_n, g_f):
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a, b)


@pytest.mark.parametrize("arch", JAX_JITTED)
def test_remat_matches_jax(arch):
    worst = lp.assert_loss_and_grads_close(arch, remat="full")
    print(f"{arch}: worst gradient normwise {worst:.4g}")


def _attention_calls(cfg) -> int:
    """K7 calls of one forward of the SMOKE config: one a dense layer, a
    shared-block site (hybrid), an encoder layer, two a decoder layer;
    none in an SSM."""
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return hybrid.n_sites(cfg)
    if cfg.family == "encdec":
        return cfg.n_enc_layers + 2 * cfg.n_layers
    return cfg.n_layers


def remat_checks(arch: str, monkeypatch) -> dict:
    """One training step with remat and one without: K7 (``_forward``, the
    one path of every K7 call, in the op or not) runs again in the backward
    for each checkpointed layer (hybrid: its shared block is not
    checkpointed), K7b once a call either way, and the bytes held at the
    end of the forward drop. Raises AssertionError."""
    counts = {"fwd": 0, "bwd": 0}
    fwd, bwd = k7._forward, k7.flash_attention_bwd

    def counted_fwd(*a, **kw):
        counts["fwd"] += 1
        return fwd(*a, **kw)

    def counted_bwd(*a, **kw):
        counts["bwd"] += 1
        return bwd(*a, **kw)

    monkeypatch.setattr(k7, "_forward", counted_fwd)
    monkeypatch.setattr(k7, "flash_attention_bwd", counted_bwd)
    out = {}
    for remat in ("none", "full"):
        counts.update(fwd=0, bwd=0)
        cfg, mod, params, batch = _setup(arch, remat)
        held = {}
        with CostCounter() as counter:
            train_step(mod, cfg, adamw.OptConfig(), params, adamw.init(params), batch,
                       mark=lambda part: held.update({part: counter.held_bytes()}))
        out[remat] = dict(counts, held=held["forward"])
    n = _attention_calls(cfg)
    recomputed = 0 if cfg.family == "hybrid" else n
    assert out["none"]["fwd"] == n and out["none"]["bwd"] == n, out
    assert out["full"]["fwd"] == n + recomputed and out["full"]["bwd"] == n, out
    assert out["full"]["held"] < out["none"]["held"], out
    return out


@pytest.mark.parametrize("arch", ["llama3.2-3b", "zamba2-1.2b", "whisper-large-v3",
                                  "mamba2-130m"])
def test_remat_recomputes_and_holds_less(arch, monkeypatch):
    out = remat_checks(arch, monkeypatch)
    print(arch, out)


def test_planted_noop_remat_is_caught(monkeypatch):
    """A remat that keeps the config's "full" but runs each body plainly
    (no recompute, every activation kept) must fail the checks."""
    monkeypatch.setattr(transformer, "run_body", lambda remat, body, *a, **_: body(*a))
    with pytest.raises(AssertionError):
        remat_checks("llama3.2-3b", monkeypatch)


@pytest.mark.parametrize("arch", ["llama3.2-3b", "zamba2-1.2b", "whisper-large-v3"])
def test_serving_runs_no_checkpoint(arch, checkpoints):
    """Prefill and decode under ``no_grad`` and in inference mode (as
    ``ServeRun`` runs them), with parameters that need gradients and the
    config's remat on, and a forward with grad mode on but no parameter
    that needs a gradient, run no checkpoint."""
    cfg, mod, params, batch = _setup(arch, "full")
    tokens = batch["tokens"]
    kw = modality_inputs(cfg, tokens.shape[0], "cpu")
    for ctx in (torch.no_grad, torch.inference_mode):
        with ctx():
            lg, cache = mod.prefill(params, tokens, cfg, 40, **kw)
            mod.decode_step(params, tokens[:, :1], cache, cfg)
    frozen = adamw.tree_map(lambda t: t.detach(), params)
    mod.forward(frozen, tokens, cfg, **{k: v for k, v in batch.items()
                                        if k in ("frames", "patch_embeds")})
    assert not checkpoints
    assert not transformer.remat_active(cfg, frozen) and transformer.remat_active(cfg, params)


def test_reentrant_remat_refuses_inputs_without_gradient():
    """The reentrant form sees only tensor arguments: where none needs a
    gradient it would give the body's parameters none, so ``run_body``
    raises; the non-reentrant form takes such inputs and gives them."""
    w = torch.ones(3, requires_grad=True)
    x = torch.ones(3)

    def body(p, h):
        return h * p["w"]

    with pytest.raises(ValueError):
        transformer.run_body(True, body, {"w": w}, x)
    transformer.run_body(True, body, {"w": w}, x, reentrant=False).sum().backward()
    assert torch.equal(w.grad, x)
