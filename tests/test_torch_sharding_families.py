"""Port parity of every model family on a (2, 2) ("data", "model") mesh of
four gloo ranks on the CPU: ``loss_fn`` and its gradients with the
parameters replicated as DTensors, the batch's rows over "data" and the
models' sharding hints laying the activations out (heads, ffn, experts
and vocab over "model", the inter-layer carry's sequence too), against
JAX's ``loss_fn`` without a mesh at ``lm_parity``'s tolerances
(``check_loss_and_grads``: the cross-entropy within twice the logits'
tolerance, each gradient within ``GRAD_TOL_ULPS`` normwise). The MoE
routers must pick, call by call, the experts of the port's run without a
mesh, bit for bit, on every rank: the port sums every forward product in
one order under any mesh (each rank's columns of a column-parallel
product, ``partitioning.column_parallel``; the gathered input of a
row-parallel one, ``partitioning.row_parallel``), and routes on whole
copies of the router's inputs (``partitioning.on_replicas``).

The cases here: the dense, vlm, SSM, hybrid and encdec families, a second
dense id, internlm2, whose 6 heads over 1 kv head cut its kv group at
model degree 2 (its ranks attend in two pieces each) and which runs
with ``attn_kv_hoist`` and ``moe_cap_shard`` set (the others without;
JAX's config fields, which change nothing for a dense model here), and
a vocab (509) that the model degree does not divide, whose logits stay
whole over "model".
``test_torch_sharding_moe.py`` runs the MoE and MLA families the same way
(JAX runs them op by op, which takes longer). The ranks' code is
``sharding_ranks.py`` (no JAX); JAX runs here while they do.
"""
import dataclasses
import threading

import jax
import numpy as np
import pytest
import torch

import lm_parity as lp
import sharding_ranks as sr
from repro.models import registry as jreg
from repro_torch.core import interop
from repro_torch.models import registry as treg

B, L = 2, 32
FLAGS = {"attn_kv_hoist": True, "moe_cap_shard": True}
#: (case name, arch, inputs key, config fields of both packages)
CASES = ([(a, a, a, FLAGS if a == "internlm2-20b" else {})
          for a in ("llama3.2-3b", "internlm2-20b", "pixtral-12b", "mamba2-130m", "zamba2-1.2b",
                    "whisper-large-v3")]
         + [("llama3.2-3b@vocab509", "llama3.2-3b", "vocab509", {"vocab": 509})])


def _inputs(key: str, arch: str, cfg_kw: dict):
    """(JAX's config, JAX's parameters, numpy batch with JAX's stubs, JAX's
    batch) of a case."""
    cj = dataclasses.replace(jreg.get_config(arch, smoke=True), **cfg_kw)
    pj = jax.jit(lambda k: jreg.get_module(cj).init_params(k, cj))(jax.random.key(0))
    toks, bj, bt = lp.train_batch(cj, B, L)
    batch = {k: v.float().numpy() if k in ("frames", "patch_embeds") else v.numpy()
             for k, v in bt.items()}
    return cj, pj, batch, bj


def _jax_side(cj, pj, bj) -> dict:
    """JAX's loss, metrics and gradients (``lm_parity.jax_mode``: op by op
    for the MoE families) and its router calls."""
    jm = jreg.get_module(cj)
    vg = jax.value_and_grad(lambda p: jm.loss_fn(p, bj, cj), has_aux=True)
    moe = cj.family in ("moe", "mla_moe")
    with lp.router_log() as log, lp.jax_mode(cj):
        (lj, mj), gj = (vg if moe else jax.jit(vg))(pj)
        if moe:
            jax.effects_barrier()
    return {"loss": float(lj), "ce": float(mj["ce"]), "aux": float(mj["aux"]),
            "grads": lp.flat_params(gj), "routers": log["jax"]}


def run_cases(workdir, cases: list):
    """The ranks' results (every case, one group of four ranks) and JAX's
    (computed while the ranks run): (each rank's {case: result}, {inputs
    key: JAX's}, {inputs key: the inputs})."""
    inputs = {}
    for name, arch, key, cfg_kw in cases:
        if key not in inputs:
            inputs[key] = _inputs(key, arch, {k: v for k, v in cfg_kw.items()
                                              if k == "vocab"})
    params = {k: lp.flat_params(v[1]) for k, v in inputs.items()}
    batches = {k: v[2] for k, v in inputs.items()}
    box = {}

    def ranks():
        try:
            box["ranks"] = sr.launch(workdir, 4, timeout=300,
                                     families=dict(cases=cases, params=params, batches=batches))
        except BaseException as e:  # re-raised in the test's thread
            box["error"] = e

    t = threading.Thread(target=ranks)
    t.start()
    jax_out = {key: _jax_side(cj, pj, bj) for key, (cj, pj, _, bj) in inputs.items()}
    t.join()
    if "error" in box:
        raise box["error"]
    return [r["families"] for r in box["ranks"]], jax_out, inputs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_cases(tmp_path_factory.mktemp("families"), CASES)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_family_on_a_2x2_mesh_matches_jax(case, runs):
    check_case(case, CASES, runs)


def check_case(case, cases: list, runs):
    """One case's checks: every rank's loss and routers the same, the
    routers the port's without a mesh, and ``lm_parity``'s checks against
    JAX with the port's logits (no mesh) for the tolerance."""
    name, arch, key, cfg_kw = case
    ranks, jax_out, inputs = runs
    got, want = ranks[0][name], jax_out[key]
    cj = inputs[key][0]
    # every rank computed the same loss and picked the same experts
    for r in ranks[1:]:
        assert r[name]["loss"] == got["loss"]
        assert len(r[name]["routers"]) == len(got["routers"])
        for a, b in zip(r[name]["routers"], got["routers"]):
            np.testing.assert_array_equal(a, b)
    # the routers are the port's without a mesh, bit for bit
    plain = ranks[cases.index(case) % len(ranks)][name]["plain"]
    assert len(got["routers"]) == len(plain["routers"]) == (
        cj.n_layers - cj.first_k_dense if cj.family in ("moe", "mla_moe") else 0)
    for a, b in zip(got["routers"], plain["routers"]):
        np.testing.assert_array_equal(a, b)
    # against JAX: lm_parity's checks, with the port's logits for the tolerance
    log = {"jax": want["routers"], "port": got["routers"]}
    moe = cj.family in ("moe", "mla_moe")
    ct = dataclasses.replace(treg.get_config(arch, smoke=True), **cfg_kw)
    pt_ = interop.lm_params_from_numpy(lp.flat_params(inputs[key][1]), "cpu")
    bt = sr.batch_tensors(inputs[key][2])
    kw_t = {k: v for k, v in bt.items() if k in ("frames", "patch_embeds")}
    with torch.no_grad():
        lg = treg.get_module(ct).forward(pt_, bt["tokens"], ct, **kw_t)[0]
    r = {"loss": (got["loss"], want["loss"]), "ce": (got["ce"], want["ce"]),
         "aux": (got["aux"], want["aux"]), "grads": (got["grads"], want["grads"]),
         "logits": lg.numpy()[:, :-1], "flips": lp.router_flips(log) if moe else np.zeros(0),
         "family": cj.family, "router_log": log}
    lp.check_loss_and_grads(arch, r)
