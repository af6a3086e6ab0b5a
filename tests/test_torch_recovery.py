"""Port parity, the recovery ladder on the list backend: JAX's ``"xla"``
(the JAX tests' CPU default) against the port's ``"xla"``, every
``TestRecovery`` case of ``tests/test_health.py``. Tolerances and what is
compared: ``tests/guard_parity.py``. The kernel backend's cases are in
``test_torch_recovery_kernel.py``."""
import dataclasses

import pytest

import guard_parity as gp
from guard_parity import _bitmatch, _events, _fluid_finite, _guarded_both, _pair, _same_stats
from repro.core import recovery as jrec
from repro_torch.core import health as thealth
from repro_torch.core import recovery as trec
from repro_torch.core import solver as tsolver
from test_torch_helpers import one_torch_thread  # noqa: F401  (autouse fixture)

XLA = ("xla", "xla")


def test_clean_guarded_run_matches_unguarded_bitwise():
    gp.case_clean_guarded_run_matches_unguarded_bitwise(XLA)


def test_nan_fault_disarm_bitmatches_unfaulted():
    gp.case_nan_fault_disarm_bitmatches_unfaulted(XLA)


def test_teleport_fault_recovers():
    gp.case_teleport_fault_recovers(XLA)


def test_cap_regrow_dam_break_bitmatches_unfaulted():
    gp.case_cap_regrow_dam_break_bitmatches_unfaulted(XLA)


def test_window_regrow_bitmatches_regrown_config():
    pair = _pair("lattice", XLA, window=8)
    _, (ot, _, rep) = _guarded_both(pair, 16, dict(block=8))
    _, _, ct, st = pair
    assert rep.regrows >= 1 and any("window_trunc" in e.checks for e in rep.events)
    assert rep.cfg.resolved_window() > 8
    assert _bitmatch(ot, tsolver.simulate(rep.cfg, st, 16))


def test_dt_backoff_water_hammer():
    """An 8x-overscale dt NaNs the dam break unguarded (asserted); the
    guard halves dt until the run completes finite, as JAX does."""
    pair = _pair("dam_break", XLA)
    cj, sj, ct, st = pair
    cj, ct = dataclasses.replace(cj, dt=cj.dt * 8), dataclasses.replace(ct, dt=ct.dt * 8)
    assert not _fluid_finite(tsolver.simulate(ct, st, 40))  # the fault is real
    _, (ot, _, rep) = _guarded_both((cj, sj, ct, st), 40, dict(block=20))
    assert rep.dt_halvings >= 1 and rep.cfg.dt < ct.dt
    assert _fluid_finite(ot)


def test_records_degrade_past_half_anchor_limit():
    """The degrade happens at guard init, before any step: JAX's init
    rung (``_resolve_precision``) gives the event list the port's guarded
    xla and kernel runs must both reproduce."""
    cj, sj, ct, st = _pair("thin_grid", XLA)
    jevents = []
    jrec._resolve_precision(cj, jrec.GuardPolicy(block=4), jevents)
    assert tsolver._resolved_records(ct) == "fp32"  # the solver's silent fallback
    # One step on the kernel backend: its plain version on the CPU sums
    # every slot pair of the 4,400-cell tables.
    for backend, nsteps in (("xla", 4), ("kernel", 1)):
        ot, _, rep, _ = trec.run_guarded(dataclasses.replace(ct, backend=backend), st, nsteps,
                                         trec.GuardPolicy(block=4))
        assert _events(rep.events) == _events(jevents)
        assert rep.records_degraded and rep.cfg.policy.records == "fp32"
        assert rep.events[0].action == "degrade_records"
        assert _fluid_finite(ot)


def test_exhaustion_raises_structured():
    pair = _pair("lattice", XLA, fault=dict(kind="nan_v", step=5))
    cj, sj, ct, st = pair
    kw = dict(block=8, disarm_faults=False, max_dt_halvings=2, degrade_records=False)
    with pytest.raises(thealth.SimulationDiverged) as et:
        trec.run_guarded(ct, st, 16, trec.GuardPolicy(**kw))
    with pytest.raises(Exception) as ej:
        jrec.run_guarded(cj, sj, 16, jrec.GuardPolicy(**kw))
    t, j = et.value, ej.value
    assert (t.step, t.checks, t.word) == (j.step, j.checks, j.word) and t.step == 0
    assert _events(t.events) == _events(j.events)
    assert len(t.events) == 2 and all(ev.action == "halve_dt" for ev in t.events)
    assert t.stats["bad_v"] >= 1 and _same_stats(t.stats, j.stats)
    assert all(_same_stats(a.stats, b.stats) for a, b in zip(t.events, j.events))


def test_acceptance_combo_cap_and_dt():
    pair = _pair("dam_break", XLA)
    cj, sj, ct, st = pair
    cj = dataclasses.replace(cj, capacity=2, dt=cj.dt * 4)
    ct = dataclasses.replace(ct, capacity=2, dt=ct.dt * 4)
    _, (ot, stats, rep) = _guarded_both((cj, sj, ct, st), 40, dict(block=20))
    assert rep.regrows >= 1 and rep.dt_halvings >= 1
    assert _fluid_finite(ot) and stats.steps == 40


@pytest.mark.parametrize("case,replace,fault,steps", [
    ("dam_break", dict(capacity=2), None, 0),
    ("lattice", {}, dict(kind="nan_v", step=12), 10),
])
def test_strict_policy_raises_immediately(case, replace, fault, steps):
    pair = _pair(case, XLA, fault=fault, **replace)
    cj, sj, ct, st = pair
    with pytest.raises(thealth.SimulationDiverged) as et:
        trec.run_guarded(ct, st, 20, trec.GuardPolicy(block=10, strict=True))
    with pytest.raises(Exception) as ej:
        jrec.run_guarded(cj, sj, 20, jrec.GuardPolicy(block=10, strict=True))
    t, j = et.value, ej.value
    assert (t.step, t.checks, t.word) == (j.step, j.checks, j.word)
    assert _same_stats(t.stats, j.stats)
    assert t.step == steps and t.events == []
