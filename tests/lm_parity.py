"""Shared cases of the port's LM parity tests against the JAX package:
JAX's SMOKE parameters carried across by ``interop.lm_params_from_numpy``,
the same seeded prompts and modality stubs through JAX's jitted entry
points and the port's (on the CPU, so K6 and K7 run their plain
versions), and the MoE routers of both recorded call by call.

Logits are held within ``transformer.logit_tolerance`` (8 bf16 ulps of
each row's largest |logit|; ``test_torch_lm_serve.py`` derives it).

The MoE families run JAX op by op (``jax.disable_jit``), so each of its
ops rounds to its dtype as the port's do: jitted, XLA fuses the bf16
products of the experts and the combine into what follows without
rounding them, and its routers then flip at 7 of 256 SMOKE tokens, some
at margins (5e-2) no rounding of the router's inputs explains. A router
that sits near a tie may still pick another expert in the two packages.
Such a flip is allowed only where JAX's k-th/(k+1)-th probability margin
is inside :func:`router_margin_bound`, and is printed. It changes that
token's MoE output, every later position of its row through attention,
and, through the experts' capacity, the drops of every token after it in
the flattened (B*L) order; so the logits are compared before the first
flip in that order, and a row's decode steps until a flip reaches it.
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.models import moe as jmoe
from repro.models import registry as jreg
from repro_torch.core import interop
from repro_torch.models import moe as tmoe
from repro_torch.models import registry as treg
from repro_torch.models import transformer as ttr


def cfgs(arch: str, mode: str = "dense", **kw):
    """(JAX's, the port's) SMOKE config of ``arch`` with ``kv_mode`` and ``kw``."""
    return (dataclasses.replace(jreg.get_config(arch, smoke=True), kv_mode=mode, **kw),
            dataclasses.replace(treg.get_config(arch, smoke=True), kv_mode=mode, **kw))


def flat_params(tree) -> dict:
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {".".join(k.key for k in path): np.asarray(v) for path, v in leaves}


def flat_params_t(tree: dict, prefix: str = "") -> dict:
    """The port's parameter dict flattened to JAX's dotted paths."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_params_t(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def params(arch: str, seed: int = 0):
    """JAX's SMOKE parameters of ``arch`` and the port's copy of them."""
    cj = jreg.get_config(arch, smoke=True)
    pj = jreg.get_module(cj).init_params(jax.random.key(seed), cj)
    return pj, interop.lm_params_from_numpy(flat_params(pj), "cpu")


def prompt(vocab: int, b: int, n: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, (b, n)).astype(np.int32)


def stubs(cfg, b: int):
    """JAX's modality stubs for a batch of ``b`` (as its ServeRun draws
    them) and the port's bf16 copies of the same values."""
    kw = {}
    if cfg.family == "encdec":
        kw["frames"] = jax.random.normal(jax.random.key(7), (b, cfg.src_len, cfg.d_model),
                                         jnp.bfloat16)
    if cfg.family == "vlm":
        kw["patch_embeds"] = jax.random.normal(jax.random.key(8), (b, cfg.n_patches, cfg.d_model),
                                               jnp.bfloat16)
    return kw, {k: torch.as_tensor(np.asarray(v.astype(jnp.float32))).to(torch.bfloat16)
                for k, v in kw.items()}


def bf16_ulp(x):
    """One bf16 ulp at each |x| (2^(e - 7) for |x| in [2^e, 2^(e+1)))."""
    return np.exp2(np.floor(np.log2(np.maximum(np.abs(x), 2.0**-126))) - 7)


def logit_ratio(lt, lj) -> np.ndarray:
    """|port - JAX| over the tolerance, the max over the vocab axis."""
    lj = np.asarray(lj)
    tol = ttr.logit_tolerance(torch.as_tensor(lj)).numpy()
    return (np.abs(np.asarray(lt) - lj) / tol).max(axis=-1)


def assert_logits_close(lt, lj, what: str, rows=None):
    """Every compared logit within the tolerance; ``rows`` (bool, the
    logits' leading shape) selects the rows to compare."""
    ratio = logit_ratio(lt, lj)
    if rows is not None:
        ratio = np.where(rows, ratio, 0.0)
    assert ratio.max() <= 1.0, f"{what}: max |dlogit| is {ratio.max():.3g} x the tolerance"


def jax_cache_numpy(cache, prefix: str = "") -> dict:
    """A JAX cache (nested NamedTuples) as numpy arrays keyed by dotted
    field path, bf16 as fp32 (``interop.kv_cache_to_numpy``'s keys)."""
    out = {}
    for key, v in cache._asdict().items():
        if hasattr(v, "_fields"):
            out.update(jax_cache_numpy(v, f"{prefix}{key}."))
        else:
            out[prefix + key] = (np.asarray(v.astype(jnp.float32)) if v.dtype == jnp.bfloat16
                                 else np.asarray(v))
    return out


def assert_same_layout(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, k


def assert_bf16_close(got, want, what: str, ulps: int = ttr.LOGIT_TOL_ULPS):
    """Within ``ulps`` bf16 ulps of each row's largest |entry| (a row is
    the last axis): cached K/V and latents are bf16 products of layer
    inputs that differ by flipped roundings, as the logits are, and are
    held to the logits' tolerance."""
    tol = ulps * bf16_ulp(np.abs(want).max(axis=-1, keepdims=True))
    err = np.abs(got - want)
    assert np.all(err <= tol), f"{what}: max err / tol {(err / tol).max():.3g}"


#: Normwise limit on an SSM state (fp32) of a layer whose inputs carry
#: flipped bf16 roundings: each term of its sum is a product of three
#: factors derived from bf16 products (dt, x, B), each of which may be
#: rounded the other way (2^-8 relative) in either package.
STATE_NORMWISE = 2 * 3 * 2.0**-8


def assert_state_close(got, want, what: str):
    """Each layer's (leading axis) state within :data:`STATE_NORMWISE` of
    JAX's, normwise."""
    for i in range(want.shape[0]):
        rel = np.linalg.norm(got[i] - want[i]) / max(np.linalg.norm(want[i]), 1e-30)
        assert rel <= STATE_NORMWISE, f"{what}, layer {i}: normwise {rel:.3g}"


def assert_anchored_close(got: dict, want: dict, prefix: str = ""):
    """Two anchored caches (``kv_cache_to_numpy``'s keys) quantized from
    bf16 K/V that differ by flipped roundings: the same empty tail, and
    the dequantized blocks within the tolerance of :func:`assert_bf16_close`
    of each block's largest entry plus one int8 level either way."""
    np.testing.assert_array_equal(got[prefix + "tail_k"], want[prefix + "tail_k"])
    for kv in ("k", "v"):
        dq = [c[f"{prefix}{kv}_anchor"] + c[f"{prefix}{kv}_scale"]
              * (c[f"{prefix}{kv}_resid"].astype(np.float32) / 127.0) for c in (got, want)]
        step = want[f"{prefix}{kv}_scale"] / 127.0
        kmax = np.abs(dq[1]).max(axis=(-3, -1), keepdims=True)
        tol = ttr.LOGIT_TOL_ULPS * bf16_ulp(kmax) + 2 * step
        assert np.all(np.abs(dq[0] - dq[1]) <= tol), kv


# --------------------------------------------------------------------------
# MoE routers, call by call
# --------------------------------------------------------------------------
def router_margin_bound(x: np.ndarray, router: np.ndarray, probs: np.ndarray, k: int,
                        input_ulps: int = 4):
    """(T,) bound on how far the k-th and (k+1)-th router probabilities of
    each token can move between the two packages, and JAX's margin
    between them (T,). x (T, d) is JAX's router input, router (d, E).

    If each bf16 input element may be off by up to ``input_ulps`` ulps of
    itself (4 by default, the bound the KV caches, bf16 products of the
    same inputs, are held to in ``test_torch_lm_serve.py``, there of the
    row's largest entry; 0 for inputs the two share), each router logit
    moves by at most δ = (input_ulps 2^-8 + (d + 2) 2^-24) Σ_i |x_i w_ij|
    (the second term the fp32 sum's rounding); a softmax probability then
    moves by at most p (e^(2δ) - 1) plus a few fp32 ulps of its own sums.
    A flip needs the margin p_k - p_(k+1) to be within the two moves."""
    xa, wa = np.abs(x).astype(np.float64), np.abs(router).astype(np.float64)
    d, n_exp = x.shape[-1], router.shape[-1]
    delta = ((input_ulps * 2.0**-8 + (d + 2) * 2.0**-24) * (xa @ wa)).max(axis=-1)
    top = -np.sort(-probs.astype(np.float64), axis=-1)
    bound = (top[:, k - 1] + top[:, k]) * (np.expm1(2 * delta) + (n_exp + 4) * 2.0**-24)
    return bound, top[:, k - 1] - top[:, k]


@contextlib.contextmanager
def router_log():
    """Record every router call of both packages, in call order: JAX's
    (x, router, probs, experts) through ``jax.debug.callback`` (so it
    works under jit and scan) and the port's experts."""
    log = {"jax": [], "port": []}
    orig_j, orig_t = jmoe.router_topk, tmoe.router_topk

    def rec_j(x, router, probs, idx):
        log["jax"].append(tuple(np.asarray(a) for a in (x, router, probs, idx)))

    def wrap_j(p, x, k, **kw):
        out = orig_j(p, x, k, **kw)
        probs = jax.nn.softmax(x.astype(jnp.float32) @ p["router"].astype(jnp.float32), -1)
        jax.debug.callback(rec_j, x.astype(jnp.float32), p["router"], probs, out[1],
                           ordered=True)
        return out

    def wrap_t(p, x, k, **kw):
        out = orig_t(p, x, k, **kw)
        log["port"].append(out[1].numpy())
        return out

    jmoe.router_topk, tmoe.router_topk = wrap_j, wrap_t
    try:
        yield log
    finally:
        jmoe.router_topk, tmoe.router_topk = orig_j, orig_t


def router_flips(log: dict, first: int = 0, last: int | None = None,
                 input_ulps: int = 4) -> np.ndarray:
    """Tokens (indices into a call's T rows) whose expert set differs in
    any of the calls ``first:last``; raises if one lies outside
    :func:`router_margin_bound`. Prints each flip (the report)."""
    jax.effects_barrier()
    calls_j, calls_t = log["jax"][first:last], log["port"][first:last]
    assert len(calls_j) == len(calls_t) > 0, (len(calls_j), len(calls_t))
    flipped = set()
    for c, ((x, router, probs, idx_j), idx_t) in enumerate(zip(calls_j, calls_t)):
        diff = np.flatnonzero((np.sort(idx_j, -1) != np.sort(idx_t, -1)).any(-1))
        if diff.size == 0:
            continue
        bound, margin = router_margin_bound(x, router, probs, idx_j.shape[1], input_ulps)
        for t in diff:
            print(f"router call {first + c}, token {t}: expert flip at margin {margin[t]:.3g} "
                  f"(bound {bound[t]:.3g})")
            assert margin[t] <= bound[t], (
                f"router call {first + c}, token {t}: experts {idx_t[t]} vs JAX's {idx_j[t]} at a "
                f"margin {margin[t]:.3g} above the rounding bound {bound[t]:.3g}")
        flipped.update(diff.tolist())
    return np.array(sorted(flipped), dtype=np.int64)


def before_first_flip(flips: np.ndarray, b: int, l: int) -> np.ndarray:
    """(B, L) bool: the prefill tokens before the first flipped one in the
    flattened (B*L) order."""
    first = flips.min() if flips.size else b * l
    return (np.arange(b * l) < first).reshape(b, l)


# --------------------------------------------------------------------------
# Prefill and teacher-forced decode in both packages
# --------------------------------------------------------------------------
def jax_mode(cfg):
    """How JAX runs ``cfg``'s family here: op by op for the MoE families
    (see the module's note), jitted for the others."""
    return jax.disable_jit() if cfg.family in ("moe", "mla_moe") else contextlib.nullcontext()


def run_both(arch: str, mode: str, b: int, n_prompt: int, max_len: int, steps: int,
             seed: int = 0, **cfg_kw):
    """Prefill then ``steps`` decode steps fed JAX's greedy tokens, in both
    packages. Returns a dict: prefill logits and caches of both, the
    decode logits (steps, B, vocab) of both, the final caches, and the
    compared rows (prefill (B, L), decode (steps, B); all True for a
    family without a router)."""
    cj, ct = cfgs(arch, mode, **cfg_kw)
    jm, tm = jreg.get_module(cj), treg.get_module(ct)
    pj, pt = params(arch)
    toks = prompt(cj.vocab, b, n_prompt, seed)
    kw_j, kw_t = stubs(cj, b)
    moe = cj.family in ("moe", "mla_moe")
    with router_log() as log, jax_mode(cj):
        lj, cache_j = jax.jit(lambda p, t: jm.prefill(p, t, cj, max_len, **kw_j))(
            pj, jnp.asarray(toks))
        lt, cache_t = tm.prefill(pt, torch.as_tensor(toks), ct, max_len, **kw_t)
        out = {"prefill": (lt.numpy(), np.asarray(lj)),
               "prefill_cache": (interop.kv_cache_to_numpy(cache_t), jax_cache_numpy(cache_j)),
               "cache_types": (type(cache_t), type(cache_j))}
        rows = np.ones((b, n_prompt), bool)
        if moe:
            rows = before_first_flip(router_flips(log, 0, cj.n_layers), b, n_prompt)
        out["prefill_rows"] = rows
        live = rows[:, -1].copy()  # the rows a prefill flip reached are not compared on
        dec = jax.jit(lambda p, t, c: jm.decode_step(p, t, c, cj))
        cur = np.argmax(np.asarray(lj)[:, -1:], -1).astype(np.int32)
        dj, dt_, drows = [], [], []
        for s in range(steps):
            lj, cache_j = dec(pj, jnp.asarray(cur), cache_j)
            lt, cache_t = tm.decode_step(pt, torch.as_tensor(cur), cache_t, ct)
            if moe:
                first = cj.n_layers * (s + 1)
                for t in router_flips(log, first, first + cj.n_layers):
                    live[t] = False
            drows.append(live.copy())
            dj.append(np.asarray(lj)[:, 0])
            dt_.append(lt.numpy()[:, 0])
            cur = np.argmax(np.asarray(lj), -1).astype(np.int32)
    out["decode"] = (np.stack(dt_), np.stack(dj))
    out["decode_rows"] = np.stack(drows)
    out["cache"] = (interop.kv_cache_to_numpy(cache_t), jax_cache_numpy(cache_j))
    return out


def teacher_forced_both(arch: str, mode: str, prompt_: np.ndarray, tokens: np.ndarray,
                        max_len: int):
    """Logits (B, gen, vocab) of both packages at each generated position,
    the prefill then decode steps fed ``tokens`` (B, gen), and the rows
    compared (B, gen): all but those a router flip has reached (the
    decode steps of a row with a flipped token, or after a prefill flip,
    every row at or after the flip's in the flattened order)."""
    cj, ct = cfgs(arch, mode)
    jm, tm = jreg.get_module(cj), treg.get_module(ct)
    pj, pt = params(arch)
    b, n = prompt_.shape
    kw_j, kw_t = stubs(cj, b)
    moe = cj.family in ("moe", "mla_moe")
    rows = np.ones(tokens.shape, bool)
    with router_log() as log, jax_mode(cj):
        lj, cache_j = jax.jit(lambda p, t: jm.prefill(p, t, cj, max_len, **kw_j))(
            pj, jnp.asarray(prompt_))
        lt, cache_t = tm.prefill(pt, torch.as_tensor(prompt_), ct, max_len, **kw_t)
        if moe:
            flips = router_flips(log, 0, cj.n_layers)
            if flips.size:
                rows[flips.min() // n:] = False
        out_j, out_t = [np.asarray(lj)[:, -1]], [lt.numpy()[:, -1]]
        dec = jax.jit(lambda p, t, c: jm.decode_step(p, t, c, cj))
        for i in range(tokens.shape[1] - 1):
            cur = tokens[:, i:i + 1]
            lj, cache_j = dec(pj, jnp.asarray(cur), cache_j)
            lt, cache_t = tm.decode_step(pt, torch.as_tensor(cur), cache_t, ct)
            if moe:
                first = cj.n_layers * (i + 1)
                for t in router_flips(log, first, first + cj.n_layers):
                    rows[t, i + 1:] = False
            out_j.append(np.asarray(lj)[:, 0])
            out_t.append(lt.numpy()[:, 0])
    return np.stack(out_t, axis=1), np.stack(out_j, axis=1), rows


def serve_tokens_match(arch: str, mode: str, b: int = 4, n_prompt: int = 128, gen: int = 12):
    """ServeRun in both packages: the same cache bytes, the teacher-forced
    logits (fed JAX's tokens) within the tolerance, and the same greedy
    tokens up to the first position where JAX's top-2 margin is not above
    twice the two packages' logit difference there, where a flipped
    rounding may pick the other token (SMOKE heads of 512 tokens give
    top-2 margins near the logit differences, so some rows stop at their
    first token). Returns the number of tokens compared, at least one."""
    from repro.launch import serve as jserve
    from repro_torch.launch import serve as tserve

    cj, _ = cfgs(arch, mode)
    _, pt = params(arch)
    _, kw_t = stubs(cj, b)
    run = dict(arch=arch, smoke=True, batch=b, prompt_len=n_prompt, gen=gen, kv_mode=mode,
               seed=0)
    with jax_mode(cj):
        out_j = jserve.ServeRun(**run).run()
    out_t = tserve.ServeRun(**run, device="cpu", params=pt, inputs=kw_t).run()
    assert out_t["cache_bytes"] == out_j["cache_bytes"]
    assert out_t["kv_mode"] == mode and out_t["tokens"].shape == out_j["tokens"].shape
    assert out_t["tokens"].dtype == np.int32
    max_len = n_prompt + gen
    if mode == "anchored":
        max_len = -(-max_len // cj.kv_block) * cj.kv_block
    lt, lj, rows = teacher_forced_both(arch, mode, prompt(cj.vocab, b, n_prompt),
                                       out_j["tokens"], max_len)
    assert_logits_close(lt, lj, "ServeRun's request, teacher-forced", rows)
    top = np.sort(lj, axis=-1)
    margin = top[..., -1] - top[..., -2]
    diff = np.abs(lt - lj).max(axis=-1)
    compared = 0
    for r in range(b):
        close = np.flatnonzero((margin[r] <= 2 * diff[r]) | ~rows[r])
        upto = close[0] if close.size else margin.shape[1]
        np.testing.assert_array_equal(out_t["tokens"][r, :upto], out_j["tokens"][r, :upto])
        compared += upto
    assert compared > 0
    return compared


# --------------------------------------------------------------------------
# Training: loss_fn and its gradients in both packages
# --------------------------------------------------------------------------
#: Normwise limit on each parameter's gradient, port against JAX, in bf16
#: ulps (2^-8 each, relative): the loss's gradient reaches every leaf
#: through bf16 cotangents rounded at each product, so two evaluations that
#: round differently (JAX jitted fuses without rounding, op by op rounds
#: each op, the port as op by op in another order) differ by a few ulps.
#: JAX's own jitted and op-by-op gradients at SMOKE (B 2, L 32) differ by
#: up to 0.0331 normwise (zamba2's ln1 norm weights; 0.0088-0.011 for the
#: dense, vlm and encdec configs, 0.032 deepseek-moe's router); the port
#: and JAX by as much (0.0335 at most). 16 ulps = 0.0625 leaves ~2x room.
GRAD_TOL_ULPS = 16


def train_batch(cfg, b: int = 2, l: int = 32, step: int = 0):
    """The data pipeline's tokens (JAX's) for a SMOKE loss: (tokens (B, L)
    int32 numpy, JAX's batch, the port's batch), JAX's modality stubs in
    both (``stubs``)."""
    from repro.data.pipeline import DataConfig, global_batch_np

    toks = global_batch_np(DataConfig(vocab=cfg.vocab, seq_len=l, global_batch=b), step)
    kw_j, kw_t = stubs(cfg, b)
    return (toks, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks), **kw_j},
            {"tokens": torch.as_tensor(toks), "labels": torch.as_tensor(toks), **kw_t})


def loss_and_grads_both(arch: str, b: int = 2, l: int = 32, **cfg_kw):
    """``loss_fn`` and every parameter's gradient of ``arch`` at SMOKE in
    both packages, from JAX's parameters carried across: JAX by
    ``jax.value_and_grad`` (``jax_mode``: op by op for the MoE families),
    the port by ``backward()``. Returns a dict: the losses and metrics of
    both, the gradients of both keyed by JAX path (None where the port
    gave none), the port's logits for the tolerance, and the router flips (an
    empty array without a router). ``cfg_kw`` replaces config fields in
    both (e.g. ``remat``)."""
    cj, ct = cfgs(arch, **cfg_kw)
    jm, tm = jreg.get_module(cj), treg.get_module(ct)
    pj, pt = params(arch)
    _, bj, bt = train_batch(cj, b, l)
    flat_t = flat_params_t(pt)
    for t in flat_t.values():
        t.requires_grad_(True)
    vg = jax.value_and_grad(lambda p: jm.loss_fn(p, bj, cj), has_aux=True)
    moe = cj.family in ("moe", "mla_moe")
    with router_log() as log, jax_mode(cj):
        (lj, mj), gj = (vg if moe else jax.jit(vg))(pj)
        lt, mt = tm.loss_fn(pt, bt, ct)
        lt.backward()
        flips = router_flips(log) if moe else np.zeros(0, np.int64)
    kw_t = {k: v for k, v in bt.items() if k in ("frames", "patch_embeds")}
    with torch.no_grad():
        lg_t = tm.forward(pt, bt["tokens"], ct, **kw_t)[0]
    return {"loss": (float(lt.detach()), float(lj)),
            "ce": (float(mt["ce"].detach()), float(mj["ce"])),
            "aux": (float(mt["aux"].detach()), float(mj["aux"])),
            "grads": ({k: (None if t.grad is None else t.grad.numpy()) for k, t in flat_t.items()},
                      flat_params(gj)),
            "logits": lg_t.numpy()[:, :-1], "flips": flips, "family": cj.family,
            "router_log": log}


def assert_loss_and_grads_close(arch: str, b: int = 2, l: int = 32, **cfg_kw):
    """The port's ``loss_fn`` against JAX's: the cross-entropy within twice
    the logits' tolerance (``lse`` and the label's logit each move by at
    most the largest logit difference; the z-loss adds 2e-4 |lse| of it),
    the MoE load-balance loss within the router's bound (each probability
    within ``expm1(2 delta)`` relative, ``router_margin_bound``'s delta at 4
    input ulps), and each gradient within :data:`GRAD_TOL_ULPS` normwise,
    every leaf differentiable. Returns the worst normwise reading.
    ``cfg_kw`` replaces config fields in both packages."""
    return check_loss_and_grads(arch, loss_and_grads_both(arch, b, l, **cfg_kw))


def check_loss_and_grads(arch: str, r: dict):
    """:func:`assert_loss_and_grads_close`'s checks on ``r``, a dict as
    :func:`loss_and_grads_both` returns (the port's side from any run,
    e.g. on a mesh). Returns the worst normwise gradient reading."""
    assert r["flips"].size == 0, f"router flips at tokens {r['flips']}: not comparable"
    tol = float(ttr.logit_tolerance(torch.as_tensor(r["logits"])).max())
    lse_max = float(np.abs(np.log(np.exp(r["logits"].astype(np.float64)).sum(-1))).max())
    ce_t, ce_j = r["ce"]
    assert abs(ce_t - ce_j) <= (2 + 2e-4 * lse_max) * tol, (ce_t, ce_j, tol)
    aux_t, aux_j = r["aux"]
    aux_tol = 0.0
    if r["family"] in ("moe", "mla_moe"):
        deltas = [((4 * 2.0**-8 + (x.shape[-1] + 2) * 2.0**-24)
                   * (np.abs(x).astype(np.float64) @ np.abs(w).astype(np.float64))).max()
                  for x, w, _, _ in r["router_log"]["jax"]]
        aux_tol = 2 * np.expm1(2 * max(deltas)) * abs(aux_j) + 1e-6 * abs(aux_j)
        assert abs(aux_t - aux_j) <= aux_tol, (aux_t, aux_j, aux_tol)
    else:
        assert aux_t == aux_j == 0.0
    loss_t, loss_j = r["loss"]
    assert abs(loss_t - loss_j) <= (2 + 2e-4 * lse_max) * tol + 0.01 * aux_tol + 1e-6
    g_t, g_j = r["grads"]
    assert set(g_t) == set(g_j)
    worst = 0.0
    for k, want in g_j.items():
        want = np.asarray(want, np.float32)
        got = g_t[k]
        if got is None:  # the port's leaf took no part: JAX's gradient must be zero
            assert not want.any(), f"{arch}: {k} has no gradient in the port"
            continue
        assert got.shape == want.shape and np.all(np.isfinite(got)), k
        rel = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
        worst = max(worst, rel)
        assert rel <= GRAD_TOL_ULPS * 2.0**-8, f"{arch}: d{k} normwise {rel:.3g}"
    return worst
