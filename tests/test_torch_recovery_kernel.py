"""Port parity, the recovery ladder on the slice's main path: JAX's
``"pallas"`` (interpret mode) against the port's ``"kernel"`` (the plain
versions of K1 and K2 on the CPU), the snapshot's ownership of its
memory, and ``Simulation.run(guard=...)``. Tolerances and what is
compared: ``tests/guard_parity.py``."""
import dataclasses

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import faults
import guard_parity as gp
import torch_faults
from guard_parity import _bitmatch, _close_to_jax, _events, _guarded_both, _pair, _same_stats
from repro.core import recovery as jrec
from repro.core.api import Simulation as JSimulation
from repro_torch.core import health as thealth
from repro_torch.core import recovery as trec
from repro_torch.core import solver as tsolver
from repro_torch.core.api import Simulation as TSimulation
from test_torch_helpers import one_torch_thread  # noqa: F401  (autouse fixture)

KERNEL = ("pallas", "kernel")


def test_clean_guarded_run_matches_unguarded_bitwise():
    gp.case_clean_guarded_run_matches_unguarded_bitwise(KERNEL)


def test_nan_fault_disarm_bitmatches_unfaulted():
    gp.case_nan_fault_disarm_bitmatches_unfaulted(KERNEL)


def test_teleport_fault_recovers():
    gp.case_teleport_fault_recovers(KERNEL)


def test_cap_regrow_dam_break_bitmatches_unfaulted():
    gp.case_cap_regrow_dam_break_bitmatches_unfaulted(KERNEL)


def test_recovered_state_matches_jax_fp32_records():
    """A disarmed NaN fault with fp32 records: the recovered final state
    of each package agrees across packages."""
    from repro.core.precision import FP32_RECORDS as J_FP32
    from repro_torch.core.precision import FP32_RECORDS as T_FP32

    cj, sj, ct, st = _pair("lattice", KERNEL, fault=dict(kind="nan_v", step=5))
    pair = (dataclasses.replace(cj, policy=J_FP32), sj,
            dataclasses.replace(ct, policy=T_FP32), st)
    (oj, _), (ot, _, rep) = _guarded_both(pair, 16, dict(block=8))
    assert [e.action for e in rep.events] == ["disarm"]
    _close_to_jax(pair[0], oj, pair[2], ot, 16)


def test_window_fault_inert_on_kernel_backend():
    """``apply_named_fault("window")`` on the kernel backend: no list, no
    truncation, no event, in both packages (JAX's pallas likewise)."""
    pair = _pair("lattice", KERNEL, window=8)
    _, (ot, _, rep) = _guarded_both(pair, 8, dict(block=8))
    _, _, ct, st = pair
    assert rep.events == []
    assert _bitmatch(ot, tsolver.simulate(dataclasses.replace(ct, window=0), st, 8))


def test_snapshot_restores_twice_bit_identical():
    """The snapshot never aliases the carry, which the solver updates in
    place: a block replayed twice from the same snapshot gives the same
    state both times, equal to the unguarded run."""
    ct, st = torch_faults.lattice(dict(backend="kernel"))
    carry = tsolver.init_persistent(ct, st)
    carry = tsolver.run_persistent(ct, carry, 3)
    snap = trec._host_snapshot(carry)
    runs, ptrs = [], set()
    for _ in range(2):
        c = trec._restore(snap, ct, ct, "cpu")
        for t in (c.st.fluid.v, c.st.rc.rel, c.st.rc.cell_xy, c.disp_acc, c.binning.cell_xy):
            ptrs.add(t.data_ptr())  # every restored tensor owns its storage
        runs.append(tsolver.finalize_persistent(ct, tsolver.run_persistent(ct, c, 5)))
    live = (carry.st.fluid.v, carry.st.rc.rel, carry.st.rc.cell_xy, carry.disp_acc)
    assert len(ptrs) == 10 and not ptrs & {t.data_ptr() for t in live}
    assert not np.shares_memory(snap.st.fluid.v, carry.st.fluid.v.numpy())
    assert _bitmatch(runs[0], runs[1])
    assert _bitmatch(runs[0], tsolver.simulate(ct, st, 8))
    assert snap.steps.dtype == np.int32 and int(snap.steps) == 3


def test_restore_after_regrow_keeps_counters():
    """A shape-changing restore keeps the step counter and adds the
    rebuild count, so a step-keyed fault replays at its step."""
    ct, st = torch_faults.lattice(dict(backend="kernel"))
    carry = tsolver.run_persistent(ct, tsolver.init_persistent(ct, st), 4)
    snap = trec._host_snapshot(carry)
    c = trec._restore(snap, ct, dataclasses.replace(ct, capacity=12), "cpu")
    assert c.steps == 4 and c.rebuilds == carry.rebuilds + 1
    assert c.binning.table.shape[1] == 12


class TestGuardApi:
    def test_simulation_run_guard_with_observables(self):
        cj, sj, ct, st = _pair("lattice", ("xla", "xla"), fault=dict(kind="nan_v", step=5))
        jsim, tsim = JSimulation(cfg=cj, state=sj), TSimulation(cfg=ct, state=st)
        rj = jsim.run(16, observe_every=8, guard=True)
        rt = tsim.run(16, observe_every=8, guard=True)
        assert rt.report is not None and rt.report.recovered
        assert _events(rt.report.events) == _events(rj.report.events)
        assert tsim.cfg.fault is None  # escalated config kept for chaining
        assert rt.observables.t.shape == (2,)
        assert torch.isfinite(rt.observables.ekin).all()
        assert bool(torch.all(torch.diff(rt.observables.t) > 0))
        np.testing.assert_allclose(rt.observables.t.numpy(), np.asarray(rj.observables.t))
        assert rt.report.dropped_obs_rows == rj.report.dropped_obs_rows

    def test_rows_of_rolled_back_blocks_are_dropped_and_counted(self):
        """A fault in the second block rolls back past the first row of
        a 4-step observed run: the row is dropped and counted."""
        cj, sj, ct, st = _pair("lattice", ("xla", "xla"), fault=dict(kind="nan_v", step=6))
        pol = dict(block=4, snapshot_every=2)
        rj = JSimulation(cfg=cj, state=sj).run(12, observe_every=4,
                                                guard=jrec.GuardPolicy(**pol))
        rt = TSimulation(cfg=ct, state=st).run(12, observe_every=4,
                                                guard=trec.GuardPolicy(**pol))
        assert rt.report.dropped_obs_rows == rj.report.dropped_obs_rows == 1
        assert _events(rt.report.events) == _events(rj.report.events)
        assert rt.observables.t.shape == (3,)
        a, b = rt.report.to_json(), rj.report.to_json()
        assert all(_same_stats(x.pop("stats"), y.pop("stats"))
                   for x, y in zip(a["events"], b["events"]))
        assert a == b

    def test_guard_requires_rcll(self):
        ct, st = torch_faults.lattice()
        sim = TSimulation(cfg=dataclasses.replace(ct, algo="all"), state=st)
        with pytest.raises(ValueError, match="rcll"):
            sim.run(4, guard=True)

    def test_apply_named_fault(self):
        cj, _ = faults.lattice()
        ct, _ = torch_faults.lattice()
        for name in ("nan", "teleport", "cap", "window", "dt"):
            a = jrec.apply_named_fault(cj, name, 30, 100)
            b = trec.apply_named_fault(ct, name, 30, 100)
            assert (a.capacity, a.window, a.dt) == (b.capacity, b.window, b.dt), name
            fb = None if a.fault is None else thealth.FaultSpec(**dataclasses.asdict(a.fault))
            assert fb == b.fault, name
        assert trec.apply_named_fault(ct, "nan", 30, 100).fault.kind == "nan_v"
        with pytest.raises(ValueError, match="unknown fault"):
            trec.apply_named_fault(ct, "gremlin", 30, 100)

    def test_policy_defaults_and_fields_match_jax(self):
        assert (dataclasses.asdict(trec.GuardPolicy())
                == dataclasses.asdict(jrec.GuardPolicy()))
        pol = jrec.GuardPolicy(block=7, strict=True, rho_dev_limit=0.01)
        assert trec.GuardPolicy(**dataclasses.asdict(pol)) == trec.GuardPolicy(
            block=7, strict=True, rho_dev_limit=0.01)

    def test_rel_quantization_error_fp16_halves_of_cell_ulp(self):
        cj, _ = faults.lattice()
        ct, _ = torch_faults.lattice()
        q16 = trec.rel_quantization_error(ct.domain, torch.float16)
        q32 = trec.rel_quantization_error(ct.domain, torch.float32)
        hc = max(ct.domain.cell_sizes)
        assert q16 == pytest.approx(hc * 0.5 * 2.0**-11)
        assert q32 < q16 / 1000
        assert q16 == jrec.rel_quantization_error(cj.domain, jnp.float16)
        assert q32 == jrec.rel_quantization_error(cj.domain, jnp.float32)

    def test_check_overflow_alias_still_raises_with_overflow(self):
        ct, st = torch_faults.dam_break()
        bad = dataclasses.replace(ct, capacity=2, check_overflow=True)
        with pytest.raises(Exception, match="overflow"):
            tsolver.simulate_stats(bad, st, 4)
