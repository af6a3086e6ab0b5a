"""Shared parts of the recovery parity tests (``test_torch_recovery*.py``):
ports of ``tests/test_health.py``'s ``TestRecovery`` and ``TestGuardApi``
cases, each run through the JAX package and through the port from the
same seeded inputs (``tests/faults.py`` and ``tests/torch_faults.py``).

For every case the event list matches JAX's exactly: action, step,
checks, word and the detail string. The stats attached to an event
describe the tripped state, which a blowup reaches by amplifying
rounding differences, so they are compared only where the trip is a NaN
poisoning of a state that agrees up to the fault (integer counts equal,
fp32 reductions within 1e-6 relative: JAX computes them inside its
jitted block). Every bit-identity that JAX asserts within JAX is
asserted within the port, bit for bit. Final states that cross packages
are compared with fp32 records, at ``tests/test_torch_solver.py``'s
fp32-records tolerances (positions and density 1e-6, velocity
nsteps·dt·1e-4): with fp16 records a velocity difference far below one
fp16 quantum can flip the rounding of a stored velocity record, which
that file's fp16 tolerance was derived for taylor_green only.

JAX's ``"xla"`` backend (the JAX tests' CPU default) is held against the
port's ``"xla"``, and JAX's ``"pallas"`` (interpret mode) against the
port's ``"kernel"`` (the plain versions of K1 and K2 on the CPU).
"""
import dataclasses

import numpy as np
import pytest
import torch

import faults
import torch_faults
from repro.core import recovery as jrec
from repro.core import solver as jsolver
from repro_torch.core import recovery as trec
from repro_torch.core import solver as tsolver


def _events(events):
    return [(e.action, int(e.step), tuple(e.checks), int(e.word), e.detail) for e in events]


def _bitmatch(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in [
        (a.fluid.v, b.fluid.v), (a.fluid.rho, b.fluid.rho),
        (a.rc.rel, b.rc.rel), (a.rc.cell_xy, b.rc.cell_xy)])


def _fluid_finite(state) -> bool:
    fl = ~state.fixed
    return bool(torch.isfinite(state.fluid.v[fl]).all() and torch.isfinite(state.fluid.rho[fl]).all())


def _close_to_jax(cj, oj, ct, ot, nsteps):
    """The fp32-records tolerances of tests/test_torch_solver.py."""
    np.testing.assert_allclose(tsolver.positions(ct, ot).numpy(),
                               np.asarray(jsolver.positions(cj, oj)), atol=1e-6)
    np.testing.assert_allclose(ot.fluid.rho.numpy(), np.asarray(oj.fluid.rho), atol=1e-6)
    np.testing.assert_allclose(ot.fluid.v.numpy(), np.asarray(oj.fluid.v),
                               atol=nsteps * ct.dt * 1e-4)


def _same_stats(a: dict, b: dict) -> bool:
    """Equal keys and integer counts; fp32 reductions within 1e-6 relative."""
    return a.keys() == b.keys() and all(
        a[k] == pytest.approx(b[k], rel=1e-6, abs=1e-30) if isinstance(b[k], float)
        else a[k] == b[k] for k in b)


def _pair(case, backends, *, fault=None, **replace):
    """(JAX cfg, JAX state, port cfg, port state) from one case of
    tests/faults.py and its port, with the same config changes."""
    cj, sj = getattr(faults, case)()
    ct, st = getattr(torch_faults, case)()
    cj = dataclasses.replace(cj, backend=backends[0], **replace)
    ct = dataclasses.replace(ct, backend=backends[1], **replace)
    if fault is not None:
        cj, ct = faults.with_fault(cj, **fault), torch_faults.with_fault(ct, **fault)
    return cj, sj, ct, st


def _guarded_both(pair, nsteps, policy_kw):
    cj, sj, ct, st = pair
    oj, statj, rj, _ = jrec.run_guarded(cj, sj, nsteps, jrec.GuardPolicy(**policy_kw))
    ot, statt, rt, _ = trec.run_guarded(ct, st, nsteps, trec.GuardPolicy(**policy_kw))
    assert _events(rt.events) == _events(rj.events)
    assert (rt.blocks, rt.retries, rt.dt_halvings, rt.regrows, rt.records_degraded) == (
        rj.blocks, rj.retries, rj.dt_halvings, rj.regrows, rj.records_degraded)
    assert statt.steps == int(statj.steps) and statt.overflow == bool(statj.overflow)
    return (oj, rj), (ot, statt, rt)


# --------------------------------------------------------------------------
# recovery paths shared by both backend pairs
# --------------------------------------------------------------------------
def case_clean_guarded_run_matches_unguarded_bitwise(backends):
    pair = _pair("lattice", backends)
    _, (ot, stats, rep) = _guarded_both(pair, 16, dict(block=8))
    _, _, ct, st = pair
    assert rep.events == [] and not rep.recovered and stats.steps == 16
    assert _bitmatch(ot, tsolver.simulate(ct, st, 16))


def case_nan_fault_disarm_bitmatches_unfaulted(backends):
    pair = _pair("lattice", backends, fault=dict(kind="nan_v", step=5))
    _, (ot, _, rep) = _guarded_both(pair, 16, dict(block=8))
    _, _, ct, st = pair
    assert [e.action for e in rep.events] == ["disarm"]
    assert any("nan" in c for c in rep.events[0].checks)
    assert _bitmatch(ot, tsolver.simulate(dataclasses.replace(ct, fault=None), st, 16))


def case_teleport_fault_recovers(backends):
    pair = _pair("lattice", backends,
                 fault=dict(kind="teleport", step=5, particle=0, target=7))
    _, (ot, _, rep) = _guarded_both(pair, 16, dict(block=8, rho_dev_limit=0.005))
    _, _, ct, st = pair
    assert rep.recovered and rep.events[0].action == "disarm"
    assert "rho_dev" in rep.events[0].checks
    assert _bitmatch(ot, tsolver.simulate(dataclasses.replace(ct, fault=None), st, 16))


def case_cap_regrow_dam_break_bitmatches_unfaulted(backends):
    """The undersized capacity trips at the init rebuild and one
    demand-sized regrow recovers. The regrown run bit-matches a fresh
    run under the regrown config and the unfaulted run at the robust
    capacity, on both backends: the window search never reads the cell
    table, and the kernel backend's sums over the cell tables (the plain
    version on the CPU) do not depend on the table's width."""
    pair = _pair("dam_break", backends, capacity=2)
    _, (ot, stats, rep) = _guarded_both(pair, 40, dict(block=20))
    _, _, ct, st = pair
    assert rep.regrows >= 1 and any("cell_overflow" in e.checks for e in rep.events)
    assert not stats.overflow
    assert _bitmatch(ot, tsolver.simulate(rep.cfg, st, 40))
    assert _bitmatch(ot, tsolver.simulate(dataclasses.replace(ct, capacity=None), st, 40))
