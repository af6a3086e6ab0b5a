"""Port parity, the batched ensemble (``core/ensemble.py``): the
``TestEnsembleCore`` and ``TestDurability`` cases of
``tests/test_ensemble.py`` through both packages (what is compared:
``tests/ensemble_parity.py``), the folded force pass of the kernel
backend (``ops.rcll_force_lanes``: one K1 and one K2 call for all lanes,
each lane bit for bit its solo call), its 32-bit index guard, and the
stacked carry's round trip through numpy and a checkpoint."""
import dataclasses
import os
import time

import numpy as np
import pytest
import torch

import ensemble_parity as ep
import torch_faults
from guard_parity import _bitmatch
from repro.checkpoint.manager import CheckpointManager as JManager
from repro.core import ensemble as jens
from repro.core import health as jhealth
from repro.core import recovery as jrec
from repro_torch.checkpoint.manager import CheckpointManager as TManager
from repro_torch.core import ensemble as tens
from repro_torch.core import health as thealth
from repro_torch.core import interop, rcll
from repro_torch.core import recovery as trec
from repro_torch.core import solver as tsolver
from repro_torch.kernels import cell_pack, ops, rcll_force
from repro_torch.runtime.fault_tolerance import HeartbeatWriter
from test_torch_helpers import one_torch_thread  # noqa: F401  (autouse fixture)

BACKENDS = pytest.mark.parametrize("backends", [ep.XLA, ep.KERNEL], ids=["xla", "kernel"])


# --------------------------------------------------------------------------
# TestEnsembleCore
# --------------------------------------------------------------------------
@BACKENDS
def test_clean_batch_bitmatches_solo_runs(backends):
    """Each lane bit-matches its own solo unguarded run, including across
    a target that is not a multiple of the block length (lanes frozen for
    the block's last 4 steps)."""
    mcfg, outs, stats, rep = ep.run_both(ep.pair(backends, 4), 20, dict(block=8))
    assert [m.status for m in rep.members] == ["healthy"] * 4
    assert all(s.steps == 20 for s in stats)
    _, _, _, ts = ep.pair(backends, 4)
    for s, out in zip(ts, outs):
        assert _bitmatch(out, ep.tsolo(mcfg, s, 20))


@pytest.mark.parametrize("backends", [ep.XLA, ep.KERNEL], ids=["xla", "kernel"])
def test_fault_isolation_b8(backends):
    """B = 8, one member faulted: the faulted lane recovers by a
    lane-masked disarm and replay (bit-matching its clean solo run); the
    other 7 are bit-identical to solo runs and never rolled back."""
    B, bad = 8, 3
    fault = jhealth.FaultSpec("nan_v", step=10)
    pair = ep.pair(backends, B)
    mcfg, outs, stats, rep = ep.run_both(pair, 24, dict(block=8), fault=fault,
                                         fault_members=(bad,))
    ts = pair[3]
    for i in range(B):
        m = rep.members[i]
        if i == bad:
            assert m.status == "recovered" and m.retries == 1
            assert [e.action for e in m.events] == ["disarm"]
        else:
            assert m.status == "healthy" and m.retries == 0 and m.events == []
        assert _bitmatch(outs[i], ep.tsolo(mcfg, ts[i], 24))


@BACKENDS
def test_persistent_fault_quarantines_member_only(backends):
    """A persistent fault defeats the ladder: the member is evicted to a
    solo leg, diverges there too, and is quarantined with the structured
    error at its last healthy step, while the batch stays bit-exact."""
    B, bad = 4, 1
    fault = jhealth.FaultSpec("nan_v", step=10)
    pair = ep.pair(backends, B)
    policy = dict(block=8, disarm_faults=False, max_dt_halvings=1, degrade_records=False)
    mcfg, outs, stats, rep = ep.run_both(pair, 24, policy, fault=fault, fault_members=(bad,))
    m = rep.members[bad]
    assert m.status == "quarantined"
    assert isinstance(m.error, thealth.SimulationDiverged)
    assert m.steps < 24
    assert any(e.action == "halve_dt" for e in m.events)
    for i in range(B):
        if i != bad:
            assert rep.members[i].status == "healthy"
            assert _bitmatch(outs[i], ep.tsolo(mcfg, pair[3][i], 24))


def test_every_top_level_name_has_a_counterpart():
    """Every top-level name of the JAX module exists in the port, but the
    jnp array alias (the port's leaves are torch tensors)."""
    names = {k for k, v in vars(jens).items()
             if getattr(v, "__module__", None) == jens.__name__ or k.isupper()}
    names -= {"Array"}
    assert names and names <= set(vars(tens)), sorted(names - set(vars(tens)))
    assert tens.STATUS_NAMES == jens.STATUS_NAMES and tens.READMIT_BLOCKS == jens.READMIT_BLOCKS
    assert [f.name for f in dataclasses.fields(tens.MemberReport)] == [
        f.name for f in dataclasses.fields(jens.MemberReport)]
    assert [f.name for f in dataclasses.fields(tens.LaneEvent)] == [
        f.name for f in dataclasses.fields(jens.LaneEvent)]


def test_member_config_rejects_conflicting_cadence():
    cj, _, ct, _ = ep.pair(ep.XLA, 1)
    for ens, rec, cfg in ((jens, jrec, cj), (tens, trec, ct)):
        policy = rec.GuardPolicy(block=8)
        with pytest.raises(ValueError, match="rebuild_every"):
            ens.member_config(dataclasses.replace(cfg, rebuild_every=5), policy)
        assert ens.member_config(cfg, policy).rebuild_every == 8
        assert ens.member_config(dataclasses.replace(cfg, rebuild_every=8), policy).fault is None
    with pytest.raises(ValueError, match="rcll"):
        tens.member_config(dataclasses.replace(ct, algo="cell"))


def test_fp16_records_batch_bitmatches_solo_runs():
    """The kernel backend at its default fp16 records (the card's main
    path): every lane bit-matches its solo run, a NaN fault on one lane
    disarmed and replayed included."""
    _, _, ct, ts = ep.pair(ep.KERNEL, 3, fp32=False)
    policy = trec.GuardPolicy(block=8)
    mcfg = tens.member_config(ct, policy)
    outs, _, rep = tens.run_ensemble(mcfg, ts, 16, policy,
                                     fault=thealth.FaultSpec("nan_v", step=10),
                                     fault_members=(1,))
    assert [m.status for m in rep.members] == ["healthy", "recovered", "healthy"]
    for s, out in zip(ts, outs):
        assert _bitmatch(out, ep.tsolo(mcfg, s, 16))


# --------------------------------------------------------------------------
# TestDurability
# --------------------------------------------------------------------------
def test_kill_resume_with_torn_checkpoint_bit_identical(tmp_path):
    """A run stopped after 2 of 4 blocks, its newest checkpoint torn
    after commit, resumes from the previous valid block and finishes
    bit-identical to the uninterrupted run, as JAX's does."""
    cj, js, ct, ts = ep.pair(ep.XLA, 3)
    out = {}
    for name, ens, rec, mgr_cls, cfg, states in (
            ("jax", jens, jrec, JManager, cj, js), ("torch", tens, trec, TManager, ct, ts)):
        policy = rec.GuardPolicy(block=8)
        mcfg = ens.member_config(cfg, policy)
        ref, _, _ = ens.run_ensemble(mcfg, states, 32, policy)
        ck = str(tmp_path / name)
        mgr = mgr_cls(ck, keep=0)
        ens.run_ensemble(mcfg, states, 16, policy, checkpoint=mgr, checkpoint_every=1)
        assert mgr.all_steps() == [1, 2]
        p = os.path.join(ck, "step_00000002", "arrays.npz")
        with open(p, "rb") as f:
            data = f.read()
        with open(p, "wb") as f:
            f.write(data[: len(data) // 2])
        outs, stats, rep = ens.run_ensemble(mcfg, states, 32, policy,
                                            checkpoint=mgr_cls(ck, keep=0),
                                            checkpoint_every=1, resume=True)
        assert rep.resumed_from == 1
        assert all(int(s.steps) == 32 for s in stats)
        out[name] = (mcfg, ref, outs, rep)
    tm, tref, touts, trep = out["torch"]
    for a, b in zip(tref, touts):
        assert _bitmatch(a, b)
    jm, _, jouts, jrep = out["jax"]
    ep.same_reports(jrep, trep)
    for a, b in zip(jouts, touts):
        ep._close_to_jax(jm, a, tm, b, 32)


def test_dead_process_heartbeat_detected_on_resume(tmp_path):
    """A clean predecessor removes its heartbeat ("clean"); a stale
    heartbeat file reads as a dead one, in both packages."""
    from repro.runtime.fault_tolerance import HeartbeatWriter as JWriter

    cj, js, ct, ts = ep.pair(ep.XLA, 2)
    seen = {}
    for name, ens, rec, mgr_cls, writer, cfg, states in (
            ("jax", jens, jrec, JManager, JWriter, cj, js),
            ("torch", tens, trec, TManager, HeartbeatWriter, ct, ts)):
        d = tmp_path / name
        policy = rec.GuardPolicy(block=8)
        mcfg = ens.member_config(cfg, policy)
        mgr = mgr_cls(str(d), keep=0)
        ens.run_ensemble(mcfg, states, 8, policy, checkpoint=mgr, checkpoint_every=1)
        assert not os.path.exists(str(d / "host_0.hb"))
        _, _, rep = ens.run_ensemble(mcfg, states, 16, policy, checkpoint=mgr,
                                     checkpoint_every=1, resume=True, heartbeat_timeout_s=0.01)
        first = (rep.dead_process_detected, rep.predecessor, rep.resumed_from)
        w = writer(str(d), 0)
        w.beat(123)
        old = time.time() - 60
        os.utime(w.path, (old, old))
        _, _, rep = ens.run_ensemble(mcfg, states, 24, policy, checkpoint=mgr,
                                     checkpoint_every=1, resume=True, heartbeat_timeout_s=0.01)
        seen[name] = (first, (rep.dead_process_detected, rep.predecessor, rep.resumed_from))
    assert seen["torch"] == seen["jax"]
    assert seen["torch"] == ((False, "clean", 1), (True, "dead", 2))


# --------------------------------------------------------------------------
# the folded force pass (kernel backend)
# --------------------------------------------------------------------------
def _stale_lanes(records: str, lanes: int = 3):
    """``lanes`` lattice carries (kernel backend) advanced by a random
    fraction of a cell without a rebuild, so the shift column is not
    zero, one of them with a massless particle; stacked."""
    from repro_torch.core.precision import FP32_RECORDS, PrecisionPolicy

    ct, st = torch_faults.lattice(dict(backend="kernel"))
    if records == "fp32":
        ct = dataclasses.replace(ct, policy=FP32_RECORDS)
    else:
        ct = dataclasses.replace(ct, policy=PrecisionPolicy())
    carries = []
    for b, v in enumerate(ep.member_velocities(st.fluid.v.numpy(), lanes, scale=0.05)):
        m = st.fluid.m.clone()
        if b == 2:
            m[5] = 0.0
        c = tsolver.init_persistent(ct, st._replace(fluid=st.fluid._replace(
            v=torch.as_tensor(v), m=m)))
        rng = np.random.default_rng(7 + b)
        dxn = torch.as_tensor(rng.uniform(-0.6, 0.6, c.disp_acc.shape).astype(np.float32))
        rc = rcll.advance(ct.domain, c.st.rc, dxn * max(ct.domain.hc_norm_axes),
                          dtype=ct.policy.coords_dtype)
        carries.append(c._replace(st=c.st._replace(rc=rc)))
    return ct, carries, tens._tree_map(tens._stack, *carries)


@pytest.mark.parametrize("records", ["fp16", "fp32"])
def test_rcll_force_lanes_equals_solo_calls(records, monkeypatch):
    """ops.rcll_force_lanes on the CPU (plain K1 and K2, one call each for
    all lanes) equals B calls of rcll_force_particles bit for bit, on a
    stale binning with non-zero cell shifts and a massless particle."""
    ct, carries, batch = _stale_lanes(records)
    delta = ct.domain.wrap_cell_delta(batch.st.rc.cell_xy - batch.binning.cell_xy)
    assert bool((delta != 0).any())
    calls = {"k1": 0, "k2": 0}
    k1, k2 = cell_pack.cell_tables, rcll_force.rcll_force

    def count(key, fn):
        def run(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return run

    monkeypatch.setattr(cell_pack, "cell_tables", count("k1", k1))
    monkeypatch.setattr(rcll_force, "rcll_force", count("k2", k2))
    drho, acc = tens._force_lanes(ct, batch)
    assert calls == {"k1": 1, "k2": 1}
    for b, c in enumerate(carries):
        d1, a1 = tsolver._force_rhs_kernel(ct, c)
        assert torch.equal(drho[b], d1) and torch.equal(acc[b], a1), b
    assert calls == {"k1": 4, "k2": 4}


def test_batched_step_launches_k1_k2_once_whatever_b(monkeypatch):
    """run_ensemble on the kernel backend calls the K1 and K2 wrappers
    once per batched step: 3 lanes, 16 steps, 16 calls each."""
    calls = {"k1": 0, "k2": 0}
    k1, k2 = cell_pack.cell_tables, rcll_force.rcll_force

    def count(key, fn):
        def run(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return run

    monkeypatch.setattr(cell_pack, "cell_tables", count("k1", k1))
    monkeypatch.setattr(rcll_force, "rcll_force", count("k2", k2))
    ct, st = torch_faults.lattice(dict(backend="kernel"))
    policy = trec.GuardPolicy(block=8)
    _, _, rep = tens.run_ensemble(tens.member_config(ct, policy), [st] * 3, 16, policy)
    assert rep.blocks == 2 and calls == {"k1": 16, "k2": 16}


def test_nb_lanes_folds_lane_offsets():
    ct, _ = torch_faults.lattice()
    nb = ops.nb_with_sentinel(ct.domain, "cpu")
    C = nb.shape[0] - 1
    f = ops.nb_lanes(ct.domain, 3, "cpu")
    assert f.shape == (3 * C + 1, nb.shape[1]) and f.dtype == torch.int32
    for b in range(3):
        rows = f[b * C:(b + 1) * C]
        want = torch.where(nb[:C] == C, 3 * C, nb[:C] + b * C)
        assert torch.equal(rows, want)
    assert bool((f[3 * C] == 3 * C).all())
    assert ops.nb_lanes(ct.domain, 3, "cpu") is f  # cached


def test_lane_index_guard_raises():
    """Folded tables past 32-bit indexing are refused before any work
    (shape-only tensors on the meta device)."""
    ops._check_lane_index_range(4, 1 << 20, 1 << 18, 20, 6)
    with pytest.raises(ValueError, match="32-bit"):
        ops._check_lane_index_range(2048, 1 << 20, 1 << 18, 20, 6)
    with pytest.raises(ValueError, match="32-bit"):
        ops._check_lane_index_range(1 << 12, 1 << 20, 1, 1, 1)
    ct, _ = torch_faults.lattice()
    lanes, n, c, cap, d = 1 << 12, 1 << 20, 1 << 10, 16, 2
    meta = torch.device("meta")
    binning = rcll.cells_lib.CellBinning(
        table=torch.empty((lanes, c, cap), dtype=torch.int32, device=meta),
        counts=torch.empty((lanes, c), dtype=torch.int32, device=meta),
        cell_id=torch.empty((lanes, n), dtype=torch.int32, device=meta),
        cell_xy=torch.empty((lanes, n, d), dtype=torch.int32, device=meta),
        order=torch.empty((lanes, n), dtype=torch.int32, device=meta),
        overflow=torch.empty((lanes,), dtype=torch.int32, device=meta))
    rc = rcll.RCLLState(cell_xy=binning.cell_xy,
                        rel=torch.empty((lanes, n, d), dtype=torch.float16, device=meta))
    f32 = torch.empty((lanes, n), device=meta)
    with pytest.raises(ValueError, match="32-bit"):
        ops.rcll_force_lanes(ct.domain, binning, rc, torch.empty((lanes, n, d), device=meta),
                             f32, f32, scheme=ct.resolved_scheme,
                             records_dtype=torch.float16)


# --------------------------------------------------------------------------
# the stacked carry through numpy and a checkpoint
# --------------------------------------------------------------------------
def _same_carry(a, b) -> bool:
    la, lb = [], []
    tens._tree_map(lambda x, y: la.append((x, y)), a, b)
    for x, y in la:
        if isinstance(x, torch.Tensor):
            if not (x.dtype == y.dtype and torch.equal(x, y)):
                return False
        elif not np.array_equal(np.asarray(x), np.asarray(y)):
            return False
    return True


def test_stacked_carry_numpy_and_checkpoint_roundtrip(tmp_path):
    """A stacked carry (counters np.int64 (B,)) round-trips through
    carry_to_numpy / carry_from_numpy and through a CheckpointManager
    save of {"carry", "meta"}, bit for bit, owning its memory."""
    ct, st = torch_faults.lattice(dict(backend="kernel"))
    policy = trec.GuardPolicy(block=4)
    mcfg = tens.member_config(ct, policy)
    batch = tens._batch_init(mcfg, tens.stack_states([st, st, st]))
    batch, _, _ = tens._ensemble_block(
        mcfg, batch, (np.ones(3, np.float32), np.zeros(3, bool), np.array([1, 1, 0], bool),
                      np.full(3, 8)), 4, policy, None)
    assert batch.steps.dtype == np.int64 and batch.steps.tolist() == [4, 4, 0]
    snap = interop.carry_to_numpy(batch)
    assert snap.steps.dtype == np.int32 and snap.steps.shape == (3,)
    back = interop.carry_from_numpy(snap, "cpu")
    assert back.steps.dtype == np.int64 and back.rebuilds.tolist() == batch.rebuilds.tolist()
    assert _same_carry(back, batch)
    assert not np.shares_memory(snap.st.fluid.v, batch.st.fluid.v.numpy())
    meta = {"dt_scale": np.ones(3, np.float32), "blocks": np.ones((), np.int64)}
    mgr = TManager(str(tmp_path), keep=0)
    mgr.save(1, {"carry": snap, "meta": meta})
    restored, step = mgr.restore({"carry": snap, "meta": meta})
    mgr.close()
    assert step == 1 and int(restored["meta"]["blocks"]) == 1
    assert _same_carry(interop.carry_from_numpy(restored["carry"], "cpu"), batch)


def test_stack_states_rejects_mismatched_members():
    _, st = torch_faults.lattice()
    _, small = torch_faults.lattice(ds=0.1)
    with pytest.raises(ValueError, match="share array shapes"):
        tens.stack_states([st, small])
    with pytest.raises(ValueError, match="share array shapes"):
        tens.stack_states([st, st._replace(v_wall=st.fluid.v)])
    with pytest.raises(ValueError, match="empty"):
        tens.stack_states([])
    batch = tens.stack_states([st, st])
    assert batch.xn.shape == (2,) + tuple(st.xn.shape)
    assert batch.xn.data_ptr() != st.xn.data_ptr()
