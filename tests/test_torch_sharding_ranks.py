"""Port parity of the trainer and the collectives on four gloo ranks on the
CPU (one group; the ranks' code is ``sharding_ranks.py``, no JAX):

  * ``TrainRun(mesh_shape=(2, 2))`` of llama3.2-3b at SMOKE, 3 steps of
    B 4 x 32 from JAX's parameters, against JAX's ``TrainRun`` without a
    mesh and against the port's without one, at
    ``test_torch_train.py``'s tolerances (losses within twice the logits'
    tolerance; parameters, first and second moments within the limits
    ``run_readings`` derives), every rank's losses the same;
  * every gradient brought to its parameter's placement before AdamW (on
    the first step some came back ``Partial`` over "data"), and a run whose
    gradients are left ``Partial`` (each rank's own part) refused by the
    same comparison;
  * a mesh run checkpointed at step 2 and resumed to 4, bit-equal to the
    run uninterrupted;
  * ``optim.compress.all_reduce_compressed`` over the four ranks against
    JAX's under ``jax.vmap(axis_name=)`` on the same four gradients and
    carries: the int32 residual sums bit-equal, the mean and each rank's
    carry within the bound :func:`compress_bound` derives;
  * ``checkpoint.reshard`` of a host tree onto a (2, 2) mesh's shardings
    (sharded over one axis, over two, unevenly, replicated) and back
    through ``full_tensor``, bit for bit, each rank's local shape DTensor's;
  * each rank's share of a step's FLOPs (``sharding_ranks.case_flops``):
    a quarter of the run without a mesh, but for the row-parallel
    products, which "data" alone splits.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lm_parity as lp
import sharding_ranks as sr
from repro.checkpoint.manager import CheckpointManager as JCheckpointManager
from repro.data.pipeline import DataConfig, global_batch_np
from repro.launch.train import TrainRun as JTrainRun
from repro.optim import adamw as jadamw
from repro.optim import compress as jcompress
from repro_torch.launch import train as ttrain
from repro_torch.models import registry as treg
from repro_torch.models import transformer as ttr
from repro_torch.optim import adamw as tadamw
from test_torch_helpers import one_torch_thread  # noqa: F401  (autouse fixture)
from test_torch_train import assert_run_close, run_readings

ARCH = "llama3.2-3b"
RUN = dict(smoke=True, steps=3, batch=4, seq=32, lr=1e-3, log_every=100)
U = 2.0**-24
#: The dry run's SMOKE train cells the four ranks count (arch, kind, B, L).
DRY_CELLS = [("llama3.2-3b", "train", RUN["batch"], RUN["seq"]),
             ("deepseek-moe-16b", "train", RUN["batch"], RUN["seq"])]
#: Decode on the dry run's cache layouts (arch, kv_mode, B, max_len) at
#: SMOKE on (2, 2): at B 4 x 256 the positions (or an anchored cache's
#: blocks and tail rows) go over "model"; at B 1 x 8192 the positions over
#: "data" and the kv heads (llama3.2-3b), Dh (granite-3-8b, one kv head)
#: or MLA's latent over "model"; mamba2's state by heads, zamba2's and
#: whisper's caches as the heuristic splits them.
DECODE_CELLS = [("llama3.2-3b", "dense", 4, 256), ("llama3.2-3b", "dense", 1, 8192),
                ("granite-3-8b", "dense", 1, 8192), ("llama3.2-3b", "anchored", 4, 256),
                ("llama3.2-3b", "anchored", 1, 8192), ("deepseek-v2-236b", "dense", 4, 256),
                ("deepseek-v2-236b", "dense", 1, 8192), ("mamba2-130m", "dense", 4, 256),
                ("zamba2-1.2b", "dense", 4, 256), ("whisper-large-v3", "dense", 4, 256)]
RESHARD = {"w": ((8, 6), ("data", "model")), "v": ((3, 8), (None, ("data", "model"))),
           "u": ((5,), ("model",)), "s": ((), ()), "i": ((4, 4), ("data", None))}


def _jax_reference(ckpt: str) -> dict:
    """JAX's ``TrainRun`` (no mesh): losses, flat parameters, moments, and
    the initial parameters."""
    pj0, _ = lp.params(ARCH)
    out = JTrainRun(arch=ARCH, ckpt_dir=ckpt, **RUN).run()
    (_, st), at = JCheckpointManager(ckpt).restore((pj0, jadamw.init(pj0)))
    assert at == RUN["steps"]
    return {"losses": out["losses"], "params": lp.flat_params(out["params"]),
            "mu": lp.flat_params(st.mu), "nu": lp.flat_params(st.nu), "p0": lp.flat_params(pj0)}


def _fsdp_batch() -> dict:
    """``TrainRun``'s first batch at :data:`RUN`'s size."""
    ct = lp.cfgs(ARCH)[1]
    tok = global_batch_np(DataConfig(vocab=ct.vocab, seq_len=RUN["seq"],
                                     global_batch=RUN["batch"]), 0)
    return {"tokens": tok, "labels": tok}


def _compress_inputs():
    rng = np.random.default_rng(3)
    grads = rng.normal(size=(4, 1000)).astype(np.float32) * np.float32(1e-2)
    grads[:, 700:] *= np.float32(50.0)  # blocks of other scales
    carry = rng.normal(size=(4, 1000)).astype(np.float32) * np.float32(1e-4)
    return grads, carry


def _reshard_tree() -> dict:
    rng = np.random.default_rng(4)
    tree = {k: rng.normal(size=shape).astype(np.float32) for k, (shape, _) in RESHARD.items()}
    tree["i"] = rng.integers(-9, 9, RESHARD["i"][0]).astype(np.int32)
    return tree


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every rank's results, JAX's ``TrainRun`` and the port's run without a
    mesh (computed while the ranks run)."""
    import threading

    pj0, _ = lp.params(ARCH)
    grads, carry = _compress_inputs()
    # the directories first: tmp_path_factory is not thread-safe
    work, ckpt, jax_ckpt = (tmp_path_factory.mktemp(n) for n in ("ranks", "ckpt", "jax_ckpt"))
    box = {}

    def ranks():
        try:
            box["ranks"] = sr.launch(
                work, 4, timeout=300,
                train=dict(params=lp.flat_params(pj0), run=RUN, ckpt_root=str(ckpt)),
                collectives=dict(grads=grads, carry=carry, tree=_reshard_tree(),
                                 specs={k: s for k, (_, s) in RESHARD.items()}),
                flops=dict(archs=[ARCH], run=RUN),
                fsdp_step=dict(params=lp.flat_params(pj0), batch=_fsdp_batch(),
                               steps=RUN["steps"]),
                dry_cells=dict(cells=DRY_CELLS),
                decode=dict(cells=DECODE_CELLS, steps=2))
        except BaseException as e:  # re-raised in the test's thread
            box["error"] = e

    t = threading.Thread(target=ranks)
    t.start()
    ref = _jax_reference(str(jax_ckpt))
    _, pt = lp.params(ARCH)
    plain = ttrain.TrainRun(arch=ARCH, **RUN, device="cpu", params=pt).run()
    t.join()
    if "error" in box:
        raise box["error"]
    return box["ranks"], ref, plain


def _as_run(trees: dict) -> dict:
    """A rank's numpy trees as ``run_readings`` reads a ``TrainRun``'s."""
    tt = {k: {p: torch.as_tensor(v) for p, v in trees[k].items()} for k in ("params", "mu", "nu")}
    return {"params": tt["params"], "opt_state": tadamw.OptState(
        torch.tensor(trees["step"]), tt["mu"], tt["nu"])}


def _plain_ref(plain: dict, ref: dict) -> dict:
    """The port's run without a mesh as ``run_readings``' reference."""
    return {"losses": plain["losses"], "p0": ref["p0"],
            **{k: {p: v.detach().numpy() for p, v in lp.flat_params_t(t).items()}
               for k, t in (("params", plain["params"]), ("mu", plain["opt_state"].mu),
                            ("nu", plain["opt_state"].nu))}}


def _loss_tol() -> float:
    _, pt = lp.params(ARCH)
    ct = lp.cfgs(ARCH)[1]
    tok = torch.as_tensor(global_batch_np(DataConfig(vocab=ct.vocab, seq_len=RUN["seq"],
                                                     global_batch=RUN["batch"]), 0))
    with torch.no_grad():
        lg = treg.get_module(ct).forward(pt, tok, ct)[0]
    return 2.0002 * float(ttr.logit_tolerance(lg).max())


def test_train_run_on_a_2x2_mesh_matches_jax(runs):
    ranks, ref, plain = runs
    got = ranks[0]["train"]
    assert all(r["train"]["losses"] == got["losses"] for r in ranks)
    assert all(r["train"]["grad_norms"] == got["grad_norms"] for r in ranks)
    assert len(got["losses"]) == RUN["steps"] and got["step"] == RUN["steps"]
    tol = _loss_tol()
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=0, atol=tol)
    np.testing.assert_allclose(got["losses"], plain["losses"], rtol=0, atol=tol)
    out = _as_run(got)
    assert_run_close(out, ref, RUN["steps"])
    assert_run_close(out, _plain_ref(plain, ref), RUN["steps"])


def test_every_gradient_reaches_adamw_in_its_parameters_placement(runs):
    ranks, _, _ = runs
    for r in ranks:
        seen = r["train"]["placements"]
        assert len(seen) == len(lp.flat_params(lp.params(ARCH)[0]))
        assert all(whole for _, _, whole in seen)
        assert all(param == ("Replicate()", "Replicate()") for _, param, _ in seen)
    raw = [g for g, _, _ in ranks[0]["train"]["placements"]]
    assert any("Partial" in g[0] for g in raw), raw  # the data axis's sum was owed


def test_a_gradient_left_partial_fails_the_comparison(runs):
    ranks, ref, _ = runs
    out = _as_run(ranks[0]["train"]["planted"])
    r = run_readings(out, ref, RUN["steps"])
    assert max(max(v) for v in r.values()) > 1.5, r
    with pytest.raises(AssertionError, match="limit"):
        assert_run_close(out, ref, RUN["steps"])


def test_a_resumed_mesh_run_is_bit_equal(runs):
    ranks, _, _ = runs
    for r in ranks:
        (lw, tw), (lr, tr) = r["train"]["resume"]["whole"], r["train"]["resume"]["resumed"]
        assert lw[2:] == lr
        assert tw["step"] == tr["step"] == 4
        for part in ("params", "mu", "nu"):
            for k in tw[part]:
                np.testing.assert_array_equal(tr[part][k], tw[part][k], err_msg=(part, k))


def compress_bound(grads: np.ndarray, carry: np.ndarray, resid_sum: np.ndarray,
                   mean_j: np.ndarray):
    """Elementwise bounds (mean, carry) on two evaluations of the
    compressed all-reduce with the same int32 residual sums. Per 256-wide
    block b a worker's anchor is a mean of 256 fp32 values (x = g + carry),
    off by at most delta_b = 256 u A_b in either evaluation (A_b the
    largest mean |x| of the block over the workers); the scale (a max of
    |x - anchor|) moves by as much. The anchors' 4-term sum adds (n+1) u
    sum |anchor|; resid_sum * scale / 127 moves by |resid_sum| / 127 x
    2 delta_b; each final op rounds once more (4 u of its value). A carry
    (x - anchor - resid * scale / 127) moves by 2 delta_b (1 + |resid| /
    127) <= 4 delta_b plus its rounding."""
    n_w, n = grads.shape
    pad = (-n) % jcompress.BLOCK
    x = np.pad((grads + carry).astype(np.float64), ((0, 0), (0, pad))).reshape(
        n_w, -1, jcompress.BLOCK)
    delta = 256 * U * np.abs(x).mean(axis=2).max(axis=0)  # (nblk,)
    anchor_abs = np.abs(x.mean(axis=2)).sum(axis=0)
    mean_tol = (2 * delta * n_w + (n_w + 1) * U * anchor_abs
                + np.abs(resid_sum).max(axis=1) / 127.0 * 2 * delta) / n_w
    mean_tol = np.repeat(mean_tol, jcompress.BLOCK)[:n] + 4 * U * np.abs(mean_j)
    dev_max = np.abs(x - x.mean(axis=2, keepdims=True)).max(axis=(0, 2))
    carry_tol = np.repeat(4 * delta + 4 * U * dev_max, jcompress.BLOCK)[:n]
    return mean_tol, carry_tol


def test_all_reduce_compressed_matches_jax(runs):
    ranks, _, _ = runs
    grads, carry = _compress_inputs()
    sums = []
    orig = jax.lax.psum

    def psum(x, axis_name, **kw):
        out = orig(x, axis_name, **kw)
        if getattr(out, "dtype", None) == jnp.int32 and getattr(out, "ndim", 0) >= 1:
            jax.debug.callback(lambda v: sums.append(np.asarray(v)), out)
        return out

    jax.lax.psum = psum
    try:
        mean_j, carry_j = jax.vmap(lambda g, c: jcompress.all_reduce_compressed(g, "d", c),
                                   axis_name="d")(grads, carry)
        jax.effects_barrier()
    finally:
        jax.lax.psum = orig
    mean_j, carry_j = np.asarray(mean_j), np.asarray(carry_j)
    assert len(sums) == 1 and sums[0].dtype == np.int32
    mean_tol, carry_tol = compress_bound(grads, carry, sums[0], mean_j[0])
    for rank, r in enumerate(ranks):
        c = r["collectives"]
        assert len(c["resid_sum"]) == 1
        np.testing.assert_array_equal(c["resid_sum"][0], sums[0])
        assert np.all(np.abs(c["mean"] - mean_j[rank]) <= mean_tol)
        assert np.all(np.abs(c["carry"] - carry_j[rank]) <= carry_tol)
        np.testing.assert_array_equal(c["mean"], ranks[0]["collectives"]["mean"])
    # the mean is near the plain mean of the four gradients (compression error)
    assert np.abs(ranks[0]["collectives"]["mean"] - (grads + carry).mean(0)).max() < 1e-2


def test_reshard_round_trip_on_a_2x2_mesh(runs):
    ranks, _, _ = runs
    tree = _reshard_tree()
    for rank, r in enumerate(ranks):
        c = r["collectives"]
        d, m = divmod(rank, 2)
        for k, (shape, _) in RESHARD.items():
            np.testing.assert_array_equal(c["back"][k], tree[k].astype(np.float32))
        want = {"w": (("Shard(dim=0)", "Shard(dim=1)"), (4, 3)),
                "v": (("Shard(dim=1)", "Shard(dim=1)"), (3, 2)),
                "u": (("Replicate()", "Shard(dim=0)"), ((3,) if m == 0 else (2,))),
                "s": (("Replicate()", "Replicate()"), ()),
                "i": (("Shard(dim=0)", "Replicate()"), (2, 4))}
        assert c["local"] == want, (rank, c["local"])


def test_each_rank_does_its_share_of_a_step(runs):
    """On the (2, 2) mesh each rank's matmul FLOPs in a train step are a
    quarter of the run's without a mesh (rows over "data"; heads, ffn
    columns, vocab and attention over "model"), plus a quarter more of the
    row-parallel products (``wo``, ``w_down``: x's gathered last axis, split
    over "data" only), counted here from the config: forward and the two
    backward products, 2 T (H Dh d + d_ff d) FLOPs each, a layer."""
    ranks, _, _ = runs
    cfg = lp.cfgs(ARCH)[1]
    mesh, plain = ranks[0]["flops"][ARCH]
    tokens = RUN["batch"] * RUN["seq"]
    row = cfg.n_layers * 3 * 2 * tokens * (cfg.n_heads * cfg.head_dim + cfg.d_ff) * cfg.d_model
    assert sum(plain.values()) % 4 == 0 and row % 4 == 0
    for r in ranks:
        assert r["flops"][ARCH][0] == mesh
        assert r["flops"][ARCH][1] == plain
    assert sum(mesh.values()) == (sum(plain.values()) + row) // 4, (mesh, plain, row)


def test_a_step_on_fsdp_parameters_matches_the_replicated_one(runs):
    """One ``train_step`` with the parameters and moments laid out by
    ``param_shardings(fsdp=True)`` on the (2, 2) mesh (FSDP over "data", TP
    over "model": each rank holds shards) against the same step with them
    replicated, from the same inputs.

    The clip's grad norm must be the norm over every rank's shards
    (``train.mesh_grad_norm``), on every rank the same: the norm of the
    gradients AdamW was handed, gathered whole, to the rounding of summing
    their squares in another order: each sum of N positive fp32 terms is
    within (log2(N) + 1) u of its value (u = 2^-24; torch sums a tensor
    pairwise), the L leaves' and R ranks' partial sums add L + R more, so
    |n_a^2 - n_b^2| <= 2 (log2(N) + L + R + 1) u n^2 and |n_a - n_b| <=
    (log2(N) + L + R + 1) u n. Against the replicated run (whose gradients
    reach their sums in another order, bf16 products included) the norm
    agrees to ``lm_parity.GRAD_TOL_ULPS`` bf16 ulps, the gradients'
    normwise tolerance; the loss is the forward's (weights gathered whole
    before use), and the updated parameters and both moments are within
    ``run_readings``' limits (``test_torch_train.py``)."""
    ranks, ref, _ = runs
    got = [r["fsdp_step"] for r in ranks]
    rep, fsdp = got[0]["replicated"], got[0]["fsdp"]
    assert any("Shard" in p[0] for p in fsdp["placements"].values())  # split over "data"
    assert all(r["fsdp"]["grad_norm"] == fsdp["grad_norm"] for r in got)
    leaves = ref["p0"]
    n_el = max(v.size for v in leaves.values())
    for run in (fsdp, rep):
        bound = (np.ceil(np.log2(n_el)) + len(leaves) + len(ranks) + 1) * U * run["whole_norm"]
        assert abs(run["grad_norm"] - run["whole_norm"]) <= bound, (run["grad_norm"],
                                                                    run["whole_norm"], bound)
    assert abs(fsdp["grad_norm"] - rep["grad_norm"]) <= (
        lp.GRAD_TOL_ULPS * 2.0**-8 * rep["grad_norm"])
    np.testing.assert_allclose(fsdp["loss"], rep["loss"], rtol=0, atol=_loss_tol())
    assert fsdp["step"] == rep["step"] == 1
    ref_rep = {"p0": ref["p0"], "params": rep["params"], "mu": rep["mu"], "nu": rep["nu"]}
    assert_run_close(_as_run(fsdp), ref_rep, 1)


@pytest.mark.parametrize("cell", DRY_CELLS, ids=[c[0] for c in DRY_CELLS])
def test_a_fake_mesh_counts_what_gloo_rank_0_runs(runs, cell):
    """The dry run's train cell on a fake (2, 2) mesh in this process (meta
    tensors; ``launch.mesh.fake_mesh``) counts rank 0's work of the same
    cell run on the four gloo ranks (CPU tensors of its shapes and
    layouts, ``sharding_ranks.case_dry_cells``): FLOPs by aten op, the
    kernels' calls and counts, and each collective's calls and bytes, by
    JAX's name."""
    import torch.distributed as dist

    from repro_torch.launch import mesh as mesh_lib

    ranks, _, _ = runs
    want = ranks[0]["dry_cells"][cell]
    with mesh_lib.fake_mesh((2, 2), ("data", "model")) as mesh:
        got = sr.dry_cell_counts(*cell, mesh, fill=False)
    assert not dist.is_initialized()
    assert got["flops_by_op"] == want["flops_by_op"]
    assert got["kernels"] == want["kernels"]
    assert got["collectives"] == want["collectives"]
    assert want["collectives"]["counts"]["all-reduce"] >= 1  # the clip's norm, at least


@pytest.mark.parametrize("cell", DECODE_CELLS, ids=["-".join(map(str, c)) for c in DECODE_CELLS])
def test_decode_on_the_dry_runs_cache_layouts(runs, cell):
    """Decode steps on a (2, 2) mesh of four gloo ranks with the cache laid
    out by ``cache_shardings`` (split positions, blocks, kv heads, Dh, the
    latent, the SSM state) give the run without a mesh's logits within
    ``transformer.logit_tolerance`` (8 bf16 ulps of the largest |logit|:
    the mesh sums attention's partial scores and merges the ranks' softmax
    parts in another order), on every rank; the first layer's cache, whose
    inputs are the same bits, is bit-equal after the steps (each rank wrote
    its own shard), but for mamba2's fp32 SSM state, whose einsums run on a
    rank's two rows where the run without a mesh has four (another
    blocking): within 4 u (u = 2^-24) of its largest element."""
    ranks, _, _ = runs
    got = ranks[0]["decode"][cell]
    assert all(r["decode"][cell]["mesh"][0].shape == got["mesh"][0].shape for r in ranks)
    assert any("model" in s for s in got["specs"]), got["specs"]
    for plain, mesh in zip(got["plain"], got["mesh"]):
        tol = float(ttr.logit_tolerance(torch.as_tensor(plain)).max())
        np.testing.assert_allclose(mesh, plain, rtol=0, atol=tol)
    for r in ranks:
        for a, b in zip(r["decode"][cell]["mesh"], got["mesh"]):
            np.testing.assert_array_equal(a, b)
    ssm = cell[0] in ("mamba2-130m", "zamba2-1.2b")  # their first leaf is the SSM state
    for i, (equal, rel) in enumerate(zip(got["first_layer_equal"], got["first_layer_rel"])):
        assert equal or (ssm and i == 0 and rel <= 4 * U), (i, rel)
