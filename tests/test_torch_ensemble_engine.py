"""Port parity, the live lane engine and the sweep service
(``core/ensemble.py`` ``LaneEngine``, ``run_sweep``): the
``TestLaneEngine``, ``TestSweep`` and ``TestGuardReportObs`` cases of
``tests/test_ensemble.py`` through both packages (what is compared:
``tests/ensemble_parity.py``), plus the engine's admission errors, the
drain/resume path and the frozen lane's pass-through."""
import dataclasses
import os

import numpy as np
import pytest
import torch

import ensemble_parity as ep
import faults
import torch_faults
from guard_parity import _bitmatch, _events
from repro.core import ensemble as jens
from repro.core import health as jhealth
from repro.core import recovery as jrec
from repro_torch.core import ensemble as tens
from repro_torch.core import health as thealth
from repro_torch.core import recovery as trec
from test_torch_helpers import one_torch_thread  # noqa: F401  (autouse fixture)


def _lane_events(evs) -> list:
    return [(e.lane, e.kind, e.step, e.action, e.word, tuple(e.checks),
             None if e.events is None else _events(e.events)) for e in evs]


def _drive(ens, eng, states, plan, admit_kw=None):
    """Admit ``plan[:slots]``, then step blocks, admitting the rest as
    lanes free up (in order). Returns (finals {request: state}, the
    event log)."""
    admit_kw = admit_kw or {}
    owner, finals, log_ = {}, {}, []
    queue = list(range(len(plan)))
    while queue and eng.free_lanes:
        r = queue.pop(0)
        owner[eng.admit(states[r], plan[r], **admit_kw.get(r, {}))] = r
    for _ in range(32):
        if not eng.live_lanes:
            break
        evs = eng.step_block()
        log_.append(_lane_events(evs))
        for ev in evs:
            if ev.kind in ("done", "diverged"):
                finals[owner.pop(ev.lane)] = ev.state
        while queue and eng.free_lanes:
            r = queue.pop(0)
            owner[eng.admit(states[r], plan[r], **admit_kw.get(r, {}))] = r
    return finals, log_


# --------------------------------------------------------------------------
# TestLaneEngine
# --------------------------------------------------------------------------
def test_mid_sweep_completion_frees_lane_neighbors_bit_exact():
    """A member finishing mid-sweep retires its lane while two longer
    neighbors keep running; a new request re-admitted into the freed slot
    runs next to them. Every final state bit-matches its solo run, and
    the engine's events equal JAX's."""
    cj, js, ct, ts = ep.pair(ep.XLA, 4)
    plan = (16, 32, 32, 16)
    runs = {}
    for name, ens, rec, cfg, states in (("jax", jens, jrec, cj, js),
                                        ("torch", tens, trec, ct, ts)):
        eng = ens.LaneEngine(cfg, slots=3, policy=rec.GuardPolicy(block=8, snapshot_every=1))
        runs[name] = (eng,) + _drive(ens, eng, states, plan)
    eng, finals, log_ = runs["torch"]
    jeng, jfinals, jlog = runs["jax"]
    assert log_ == jlog and set(finals) == {0, 1, 2, 3}
    assert [e[1] for e in log_[1]] == ["done", "obs", "obs"]  # lane 0 freed mid-sweep
    for r, nsteps in enumerate(plan):
        assert _bitmatch(finals[r], ep.tsolo(eng.cfg, ts[r], nsteps)), r
        ep._close_to_jax(jeng.cfg, jfinals[r], eng.cfg, finals[r], nsteps)


def test_readmission_after_quarantine_starts_from_clean_carry():
    """slots = 1: a poisoned non-disarmable request burns through dt
    backoff into quarantine (diverged event, slot freed); the next tenant
    of that slot starts from a clean carry and bit-matches a solo run."""
    cj, js, ct, ts = ep.pair(ep.XLA, 2)
    runs = {}
    for name, ens, hl, rec, cfg, states in (("jax", jens, jhealth, jrec, cj, js),
                                            ("torch", tens, thealth, trec, ct, ts)):
        eng = ens.LaneEngine(cfg, slots=1, policy=rec.GuardPolicy(
            block=8, snapshot_every=1, max_dt_halvings=1))
        fault = hl.FaultSpec("nan_v", step=4)
        runs[name] = (eng,) + _drive(ens, eng, states, (16, 16),
                                     {0: dict(fault=fault, disarmable=False)})
    eng, finals, log_ = runs["torch"]
    assert log_ == runs["jax"][2]
    diverged = [e for blk in log_ for e in blk if e[1] == "diverged"]
    assert len(diverged) == 1 and "nan_v" in diverged[0][5]
    assert [ev[0] for ev in diverged[0][6]] == ["halve_dt", "quarantine"]
    done = [e for blk in log_ for e in blk if e[1] == "done"]
    assert len(done) == 1 and done[0][0] == 0 and done[0][6] == []
    assert finals[0] is None and eng.free_lanes == [0]
    assert _bitmatch(finals[1], ep.tsolo(eng.cfg, ts[1], 16))


def test_admission_errors_match_jax():
    """EngineFull when every lane is busy, FaultBusy for a second fault
    under an armed live lane, AdmissionError (with the tripped checks) for
    a request whose admission rebuild overflows its capacity."""
    cj, js, ct, ts = ep.pair(ep.XLA, 2)
    seen = {}
    for name, ens, hl, rec, cfg, states, case in (
            ("jax", jens, jhealth, jrec, cj, js, faults.dam_break),
            ("torch", tens, thealth, trec, ct, ts, torch_faults.dam_break)):
        eng = ens.LaneEngine(cfg, slots=2, policy=rec.GuardPolicy(block=8))
        eng.admit(states[0], 16, fault=hl.FaultSpec("nan_v", step=20))
        with pytest.raises(ens.FaultBusy):
            eng.admit(states[1], 16, fault=hl.FaultSpec("nan_v", step=30))
        eng.admit(states[1], 16)
        with pytest.raises(ens.EngineFull):
            eng.admit(states[1], 16)
        dcfg, dst = case()
        small = ens.LaneEngine(dataclasses.replace(dcfg, capacity=2, backend="xla"), slots=1,
                               policy=rec.GuardPolicy(block=8))
        with pytest.raises(ens.AdmissionError) as e:
            small.admit(dst, 8)
        seen[name] = (e.value.word, e.value.checks, e.value.stats["max_cell"],
                      small.free_lanes, eng.live_lanes)
    assert seen["torch"] == seen["jax"]
    assert "cell_overflow" in seen["torch"][1]


def test_drained_lane_resumes_bit_identical(monkeypatch):
    """lane_snapshot's host row, admitted as carry_row into a fresh
    engine, continues bit-identical to the uninterrupted lane; the row is
    a copy that later blocks do not change."""
    _, _, ct, ts = ep.pair(ep.XLA, 2, fp32=False)
    policy = trec.GuardPolicy(block=8)
    eng = tens.LaneEngine(ct, slots=2, policy=policy)
    eng.admit(ts[0], 24)
    lane = eng.admit(ts[1], 24)
    eng.step_block()
    row, meta = eng.lane_snapshot(lane)
    v0 = row.st.fluid.v.copy()
    assert meta["steps_done"] == 8 and meta["target"] == 24
    while eng.live_lanes:
        eng.step_block()
    assert np.array_equal(row.st.fluid.v, v0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):  # no device named, none found
        tens.LaneEngine(ct, slots=1, policy=policy).admit(None, 24, carry_row=row)
    fresh = tens.LaneEngine(ct, slots=1, policy=policy, device="cpu")
    fresh.admit(None, meta["target"], carry_row=row, steps_done=meta["steps_done"])
    out = [e for _ in range(3) for e in fresh.step_block() if e.kind == "done"]
    assert len(out) == 1 and out[0].step == 24
    assert _bitmatch(out[0].state, ep.tsolo(fresh.cfg, ts[1], 24))


def test_frozen_lane_passes_through_bit_for_bit():
    """A retired lane's rows are left as they were by the next blocks
    (the lane select), while its neighbor advances."""
    _, _, ct, ts = ep.pair(ep.KERNEL, 2, fp32=False)
    eng = tens.LaneEngine(ct, slots=2, policy=trec.GuardPolicy(block=4))
    eng.admit(ts[0], 12)
    lane = eng.admit(ts[1], 12)
    eng.step_block()
    eng.retire(lane)
    before = [t.clone() for t in (eng.carry.st.fluid.v[lane], eng.carry.st.fluid.rho[lane],
                                  eng.carry.st.rc.rel[lane], eng.carry.disp_acc[lane])]
    t_before, steps_before = float(eng.carry.st.t[lane]), int(eng.carry.steps[lane])
    eng.step_block()
    after = (eng.carry.st.fluid.v[lane], eng.carry.st.fluid.rho[lane],
             eng.carry.st.rc.rel[lane], eng.carry.disp_acc[lane])
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    assert (float(eng.carry.st.t[lane]), int(eng.carry.steps[lane])) == (t_before, steps_before)
    assert lane == 1 and eng.carry.steps.tolist() == [8, 4]


# --------------------------------------------------------------------------
# TestSweep
# --------------------------------------------------------------------------
def test_buckets_by_config_results_in_request_order(tmp_path):
    """Two dt variants -> two buckets, one batch each; results in request
    order, the manifest written, interleaved bucket members bit-matching
    their solo runs; the reports equal JAX's."""
    cj, js, ct, ts = ep.pair(ep.XLA, 2)
    res = {}
    for name, ens, rec, cfg, states in (("jax", jens, jrec, cj, js),
                                        ("torch", tens, trec, ct, ts)):
        half = dataclasses.replace(cfg, dt=cfg.dt * 0.5)
        reqs = [ens.SweepRequest("a0", cfg, states[0]),
                ens.SweepRequest("b0", half, states[0]),
                ens.SweepRequest("a1", cfg, states[1])]
        res[name] = ens.run_sweep(reqs, 16, rec.GuardPolicy(block=8),
                                  checkpoint_dir=str(tmp_path / name))
    r, rj = res["torch"], res["jax"]
    assert r.names == ["a0", "b0", "a1"] and r.buckets == [[0, 2], [1]]
    assert (r.names, r.buckets, r.counts()) == (rj.names, rj.buckets, rj.counts())
    assert r.counts()["healthy"] == 3 and len(r.reports) == 2
    for a, b in zip(rj.reports, r.reports):
        ep.same_reports(a, b)
    with open(tmp_path / "torch" / "sweep.json") as f, open(tmp_path / "jax" / "sweep.json") as g:
        assert f.read() == g.read()
    assert os.path.isdir(tmp_path / "torch" / "bucket_01")
    mcfg = tens.member_config(ct, trec.GuardPolicy(block=8))
    assert _bitmatch(r.states[0], ep.tsolo(mcfg, ts[0], 16))
    assert _bitmatch(r.states[2], ep.tsolo(mcfg, ts[1], 16))
    for a, b in zip(rj.states, r.states):
        ep._close_to_jax(cj, a, ct, b, 16)


def test_one_fault_per_bucket_enforced():
    cj, js, ct, ts = ep.pair(ep.XLA, 1)
    for ens, hl, rec, cfg, st in ((jens, jhealth, jrec, cj, js[0]),
                                  (tens, thealth, trec, ct, ts[0])):
        reqs = [ens.SweepRequest("m0", cfg, st, fault=hl.FaultSpec("nan_v", step=4)),
                ens.SweepRequest("m1", cfg, st, fault=hl.FaultSpec("nan_v", step=6))]
        with pytest.raises(ValueError, match="one distinct FaultSpec"):
            ens.run_sweep(reqs, 8, rec.GuardPolicy(block=8))


# --------------------------------------------------------------------------
# TestGuardReportObs
# --------------------------------------------------------------------------
def test_dropped_obs_rows_counted():
    """With snapshot_every = 3 the snapshot lags the observations, so a
    trip at step 5 rolls back to step 0 and drops the rows recorded at
    steps 2 and 4 (counted, then replayed), in both packages."""
    cj, _ = faults.lattice()
    ct, st = torch_faults.lattice()
    _, sj = faults.lattice()
    out = []
    for rec, cfg, s, fl in ((jrec, cj, sj, faults), (trec, ct, st, torch_faults)):
        _, _, rep, rows = rec.run_guarded(fl.with_fault(cfg, kind="nan_v", step=5), s, 16,
                                          rec.GuardPolicy(block=8, snapshot_every=3),
                                          observe_every=2)
        out.append((rep.dropped_obs_rows, len(rows), _events(rep.events)))
    assert out[1] == out[0]
    assert out[1][:2] == (2, 16 // 2)
