"""Port parity of the training driver (``repro_torch.launch.train``):
a few ``TrainRun`` steps against JAX's ``TrainRun`` from the same
parameters (carried across by ``interop``) and tokens, checkpoint/resume
bit-equal to the uninterrupted run on the CPU (JAX's
``tests/test_integration.py`` resume test), a resume from a checkpoint
JAX's trainer wrote, the heartbeat, the CLI, and the driver's refusals.

Tolerances, from ``lm_parity``'s (stated there) and AdamW's algebra
(b1 0.9, b2 0.95; ``c_s = (1-b1) b1^(T-s)`` and ``d_s = (1-b2) b2^(T-s)``
weigh step s's gradient in the moments after T steps):
  * losses: twice the logits' tolerance (8 bf16 ulps of the largest
    |logit|), the first step's bound for ``loss_fn``; later steps also
    carry the parameters' differences;
  * each step's clipped gradient of a leaf: within e = 2 x
    ``GRAD_TOL_ULPS`` bf16 ulps (0.125) normwise of JAX's; one
    ``GRAD_TOL_ULPS`` for the gradient itself, one for the clip's scale
    ``c / ||g||``, whose norm is within the same relative error;
  * first moment, linear in the gradients: ||mu_port - mu_jax|| <=
    sum_s c_s e ||g_s|| <= e K_T sqrt(sum nu_T) (Cauchy-Schwarz,
    ``K_T^2 = sum_s c_s^2 / d_s``; ``sum nu_T = sum_s d_s ||g_s||^2``);
  * second moment: ||sqrt(nu_port) - sqrt(nu_jax)|| <= e sqrt(sum nu_T)
    (the triangle inequality of each element's d-weighted norm over the
    steps);
  * parameters, each leaf's change p_T - p_0 normwise, weighted by the
    run's gradient scale s = sqrt(nu_T / bc2_T) + eps (JAX's). A step's
    update is u = m^ / s, so |du| s' <= |dm^| + U |ds| with |u| <= U = 1.17
    (``test_torch_optim.py``): a gradient near 0 that flips sign moves
    its element by up to 2 U lr, but weighs what its |g| weighs, which
    the gradient's own tolerance bounds. Step r then adds at most
    lr_r e (K_r sqrt(bc2_r) / bc1_r + U) sqrt(sum nu^_T), with the final
    scale standing for each step's (exact at T = 1; four steps of one
    warm-up). The rounding of p (8 ulps a step) comes on top.
A zeroed, negated or mismatched leaf gradient reads 1.9-8.8 times its
leaf's parameter and first-moment limits (a negated one leaves the second
moment as it was; ``test_a_planted_gradient_fault_fails_the_comparison``);
the port's readings are 0.002-0.06 of them.
"""
import functools
import math
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lm_parity as lp
from repro.checkpoint.manager import CheckpointManager as JCheckpointManager
from repro.data.pipeline import DataConfig, global_batch_np
from repro.launch.train import TrainRun as JTrainRun
from repro.optim import adamw as jadamw
from repro_torch.core import interop
from repro_torch.launch import train as ttrain
from repro_torch.models import registry as treg
from repro_torch.models import transformer as ttr
from repro_torch.optim import adamw as tadamw
from test_torch_helpers import one_torch_thread  # noqa: F401  (autouse fixture)

ROOT = Path(__file__).resolve().parents[1]
U_MAX = 1.17
B1, B2, EPS = 0.9, 0.95, 1e-8
GRAD_EPS = 2 * lp.GRAD_TOL_ULPS * 2.0**-8
RUN = dict(smoke=True, steps=4, batch=2, seq=32, lr=1e-3, log_every=100)


def _lrs(steps: int, lr: float = 1e-3, warmup: int = 20):
    return [lr * (s + 1) / warmup for s in range(steps)]  # inside the warmup


def _k(steps: int) -> float:
    """K_T: sum_s c_s ||g_s|| <= K_T sqrt(sum_s d_s ||g_s||^2)."""
    return math.sqrt(sum(((1 - B1) * B1**(steps - s))**2 / ((1 - B2) * B2**(steps - s))
                         for s in range(1, steps + 1)))


@functools.lru_cache(maxsize=None)
def _jax_run(arch: str, ckpt_root: str, steps: int = RUN["steps"]) -> dict:
    """JAX's ``TrainRun`` (its own final checkpoint gives its moments):
    losses and flat parameters, mu and nu, and the initial parameters."""
    pj0, _ = lp.params(arch)
    d = f"{ckpt_root}/{arch}-{steps}"
    out = JTrainRun(arch=arch, ckpt_dir=d, **{**RUN, "steps": steps}).run()
    (_, st), at = JCheckpointManager(d).restore((pj0, jadamw.init(pj0)))
    assert at == steps
    return {"losses": out["losses"], "params": lp.flat_params(out["params"]),
            "mu": lp.flat_params(st.mu), "nu": lp.flat_params(st.nu),
            "p0": lp.flat_params(pj0)}


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("jax_ckpt"))
    return lambda arch, steps=RUN["steps"]: _jax_run(arch, root, steps)


def run_readings(out: dict, ref: dict, steps: int) -> dict:
    """{leaf: (params, mu, nu) reading / its limit} of the port's run
    ``out`` against JAX's ``ref`` (see the module's docstring)."""
    lrs, bc2 = _lrs(steps), 1 - B2**steps
    ft = lp.flat_params_t(out["params"])
    mt, nt = lp.flat_params_t(out["opt_state"].mu), lp.flat_params_t(out["opt_state"].nu)
    assert set(ft) == set(ref["params"]) == set(mt)
    growth = sum(lr * (_k(r) * math.sqrt(1 - B2**r) / (1 - B1**r) + U_MAX)
                 for r, lr in zip(range(1, steps + 1), lrs))
    res = {}
    for key, p_j in ref["params"].items():
        p0, p_j = ref["p0"][key].astype(np.float64), p_j.astype(np.float64)
        p_t = ft[key].detach().numpy().astype(np.float64)
        mu_j, nu_j = ref["mu"][key].astype(np.float64), ref["nu"][key].astype(np.float64)
        energy = math.sqrt(nu_j.sum())
        s = np.sqrt(nu_j / bc2) + EPS
        lim_p = (GRAD_EPS * growth * energy / math.sqrt(bc2)
                 + np.linalg.norm(8 * 2.0**-24 * steps * np.abs(p_j) * s)) * 1.01
        dp = np.linalg.norm(((p_t - p0) - (p_j - p0)) * s)
        dmu = np.linalg.norm(mt[key].numpy() - mu_j)
        dnu = np.linalg.norm(np.sqrt(nt[key].numpy().astype(np.float64)) - np.sqrt(nu_j))
        lim = max(GRAD_EPS * energy, 1e-30)
        res[key] = (dp / max(lim_p, 1e-30), dmu / (_k(steps) * lim), dnu / lim)
    return res


def assert_run_close(out: dict, ref: dict, steps: int):
    for key, (rp, rm, rn) in run_readings(out, ref, steps).items():
        assert rp <= 1, f"{key}: parameters' change {rp:.3g} of its limit"
        assert rm <= 1, f"{key}: first moment {rm:.3g} of its limit"
        assert rn <= 1, f"{key}: second moment {rn:.3g} of its limit"


def _port_run(arch: str, **kw) -> dict:
    _, pt = lp.params(arch)
    return ttrain.TrainRun(arch=arch, **{**RUN, **kw}, device="cpu", params=pt).run()


@pytest.mark.parametrize("arch", ["llama3.2-3b", "mamba2-130m"])
def test_train_run_matches_jax(arch, jax_runs):
    """Families without modality stubs (JAX draws whisper's frames and
    pixtral's patches from ``jax.random``; their ``loss_fn`` is held to
    JAX's with JAX's stubs in ``test_torch_loss.py``)."""
    ref = jax_runs(arch)
    _, pt = lp.params(arch)
    ot = ttrain.TrainRun(arch=arch, **RUN, device="cpu", params=pt).run()
    ct = lp.cfgs(arch)[1]
    tok = torch.as_tensor(global_batch_np(DataConfig(vocab=ct.vocab, seq_len=RUN["seq"],
                                                     global_batch=RUN["batch"]), 0))
    with torch.no_grad():
        lg = treg.get_module(ct).forward(pt, tok, ct)[0]
    tol = 2.0002 * float(ttr.logit_tolerance(lg).max())
    assert len(ot["losses"]) == len(ref["losses"]) == len(ot["parts"]) == RUN["steps"]
    assert set(ot["parts"][0]) == {"forward", "backward", "optimizer"}
    np.testing.assert_allclose(ot["losses"], ref["losses"], rtol=0, atol=tol)
    assert all(np.isfinite(ot["grad_norms"]))
    assert int(ot["opt_state"].step) == RUN["steps"]
    assert_run_close(ot, ref, RUN["steps"])
    # the caller's tree is copied, not trained in place
    assert all(not t.requires_grad for t in lp.flat_params_t(pt).values())


def _faulty_updates(fault: str):
    """``apply_updates`` with one leaf's gradient broken: the attention's
    wq negated, zeroed, or its two layers' gradients swapped."""
    clean = tadamw.apply_updates

    def apply(cfg, params, grads, state):
        g = grads["layers"]["attn"]["wq"]
        grads["layers"]["attn"]["wq"] = {"negated": lambda: -g,
                                         "zeroed": lambda: torch.zeros_like(g),
                                         "swapped": lambda: g.flip(0)}[fault]()
        return clean(cfg, params, grads, state)

    return apply


@pytest.mark.parametrize("fault", ["negated", "zeroed", "swapped"])
def test_a_planted_gradient_fault_fails_the_comparison(fault, jax_runs, monkeypatch):
    """The comparison has power: a run whose optimizer gets one broken leaf
    gradient is refused on that leaf, well past each limit it fails."""
    arch = "llama3.2-3b"
    ref = jax_runs(arch)
    monkeypatch.setattr(tadamw, "apply_updates", _faulty_updates(fault))
    out = _port_run(arch)
    r = run_readings(out, ref, RUN["steps"])
    worst = max(r, key=lambda k: max(r[k]))
    assert worst == "layers.attn.wq", r
    assert max(r[worst]) > 1.5, r[worst]
    with pytest.raises(AssertionError, match="layers.attn.wq"):
        assert_run_close(out, ref, RUN["steps"])


@pytest.mark.parametrize("arch", ["mamba2-130m", "llama3.2-3b"])
def test_resume_is_bit_equal(tmp_path, arch):
    """JAX's integration test on the port: 6 steps uninterrupted, and 3
    steps with a checkpoint then a resume to 6, bit for bit."""
    kw = dict(arch=arch, smoke=True, steps=6, batch=4, seq=64, lr=1e-3, ckpt_every=3,
              log_every=100, device="cpu")
    ref = ttrain.TrainRun(ckpt_dir=None, **kw).run()
    d = str(tmp_path / "ck")
    first = ttrain.TrainRun(ckpt_dir=d, **{**kw, "steps": 3}).run()
    resumed = ttrain.TrainRun(ckpt_dir=d, **kw).run()
    assert first["losses"] + resumed["losses"] == ref["losses"]
    assert resumed["final_loss"] == ref["final_loss"]
    for a, b in zip(tadamw.tree_leaves(ref["params"]), tadamw.tree_leaves(resumed["params"])):
        assert torch.equal(a, b)
    for field in ("mu", "nu"):
        for a, b in zip(tadamw.tree_leaves(getattr(ref["opt_state"], field)),
                        tadamw.tree_leaves(getattr(resumed["opt_state"], field))):
            assert torch.equal(a, b)
    assert int(resumed["opt_state"].step) == 6


def test_resume_from_a_jax_checkpoint(tmp_path, jax_runs):
    """JAX's trainer checkpoints at step 2; the port's resumes there (the
    same on-disk layout) and finishes within the bounds of JAX's own
    uninterrupted run (parameters and both moments)."""
    arch = "llama3.2-3b"
    d = str(tmp_path / "ck")
    JTrainRun(arch=arch, ckpt_dir=d, **{**RUN, "steps": 2}).run()
    ref = jax_runs(arch)
    _, pt = lp.params(arch, seed=1)  # other weights: the restore must replace them
    out = ttrain.TrainRun(arch=arch, **RUN, device="cpu", params=pt, ckpt_dir=d).run()
    assert len(out["losses"]) == 2
    np.testing.assert_allclose(out["losses"], ref["losses"][2:], rtol=0, atol=0.05)
    assert int(out["opt_state"].step) == RUN["steps"]
    assert_run_close(out, ref, RUN["steps"])


def test_jax_opt_state_carries_into_the_port():
    """JAX's ``OptState`` after one update, flattened (``step``,
    ``mu.<path>``, ``nu.<path>``), comes back in the port's layout with
    every value, and a port update from it and JAX's parameters matches
    JAX's next update within ``test_torch_optim.py``'s bound."""
    import jax
    from repro.optim import adamw as jadamw

    pj, pt = lp.params("llama3.2-3b")
    cfg_j, cfg_t = jadamw.OptConfig(lr=1e-2, warmup_steps=2), tadamw.OptConfig(lr=1e-2,
                                                                              warmup_steps=2)
    rng = np.random.default_rng(0)
    grads = [jax.tree.map(lambda a: jnp.asarray(rng.normal(size=a.shape).astype(np.float32)), pj)
             for _ in range(2)]
    pj1, sj1, _ = jadamw.apply_updates(cfg_j, pj, grads[0], jadamw.init(pj))
    flat = {"step": np.asarray(sj1.step)}
    flat.update({f"mu.{k}": v for k, v in lp.flat_params(sj1.mu).items()})
    flat.update({f"nu.{k}": v for k, v in lp.flat_params(sj1.nu).items()})
    st = interop.opt_state_from_numpy({k: np.array(v) for k, v in flat.items()}, "cpu")
    assert int(st.step) == 1
    for k, v in lp.flat_params(sj1.mu).items():
        np.testing.assert_array_equal(lp.flat_params_t(st.mu)[k].numpy(), v)
    # copies: the port updates in place, and JAX's host arrays must stay JAX's
    p_t = interop.lm_params_from_numpy({k: np.array(v) for k, v in lp.flat_params(pj1).items()},
                                       "cpu")
    g_t = interop.lm_params_from_numpy({k: np.array(v) for k, v in
                                        lp.flat_params(grads[1]).items()}, "cpu")
    p_t, st, _ = tadamw.apply_updates(cfg_t, p_t, g_t, st)
    pj2, _, mj = jadamw.apply_updates(cfg_j, pj1, grads[1], sj1)
    lr_sum = 1e-2 * (1 / 2 + 1)
    for k, a in lp.flat_params(pj2).items():
        tol = 8 * 2.0**-24 * (2 * np.abs(a) + U_MAX * lr_sum)
        assert np.all(np.abs(lp.flat_params_t(p_t)[k].numpy() - a) <= tol), k


def test_opt_state_interop_roundtrip():
    _, pt = lp.params("llama3.2-3b")
    st = tadamw.init(pt)
    st = st._replace(step=torch.tensor(7, dtype=torch.int32))
    for t in tadamw.tree_leaves(st.mu):
        t.normal_()
    host = interop.opt_state_to_numpy(st)
    assert host["step"].dtype == np.int32 and int(host["step"]) == 7
    back = interop.opt_state_from_numpy(host, "cpu")
    assert int(back.step) == 7 and back.step.dtype == torch.int32
    for a, b in zip(tadamw.tree_leaves(st.mu) + tadamw.tree_leaves(st.nu),
                    tadamw.tree_leaves(back.mu) + tadamw.tree_leaves(back.nu)):
        assert torch.equal(a, b)
    assert set(host) == {"step"} | {f"mu.{k}" for k in lp.flat_params_t(pt)} | {
        f"nu.{k}" for k in lp.flat_params_t(pt)}
    flat = interop.lm_params_to_numpy(pt)
    assert set(flat) == set(lp.flat_params_t(pt))


def test_heartbeat_and_guard(tmp_path):
    import json

    hb = tmp_path / "hb"
    out = ttrain.TrainRun(arch="llama3.2-3b", steps=3, batch=2, seq=16, device="cpu",
                          heartbeat_dir=str(hb), log_every=100).run()
    assert len(out["losses"]) == 3
    assert json.loads((hb / "host_0.hb").read_text())["step"] == 2


def test_refusals(monkeypatch):
    """No GPU without ``device``; a mesh whose size is not the process
    group's world size, or a mesh of several devices with no group."""
    import torch.distributed as dist

    with pytest.raises(RuntimeError, match="needs an initialized process group"):
        ttrain.TrainRun(arch="llama3.2-3b", mesh_shape=(2, 2), device="cpu").build()
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        with pytest.raises(ValueError, match="has 2 devices; the process group has 1 ranks"):
            ttrain.TrainRun(arch="llama3.2-3b", mesh_shape=(1, 2), device="cpu").build()
    finally:
        dist.destroy_process_group()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttrain.TrainRun(arch="llama3.2-3b").build()


def test_depth_cut_keeps_the_widths():
    cfg = ttrain.TrainRun(arch="llama3.2-3b", smoke=False, n_layers=2).config()
    assert cfg.n_layers == 2 and cfg.d_model == 3072 and cfg.vocab == 128256


def test_cli_on_the_cpu():
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--arch",
                        "llama3.2-3b", "--smoke", "--steps", "2", "--batch", "2", "--seq", "16",
                        "--device", "cpu"], cwd=ROOT, capture_output=True, text=True,
                       timeout=300, env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
                                         "OMP_NUM_THREADS": "1"})
    assert r.returncode == 0, r.stderr[-2000:]
    assert "[train] done; final loss" in r.stdout
