"""Fault-isolated batched ensemble engine: one device, many simulations.

Port of ``repro.core.ensemble``. B same-shape members are stacked into
one batch-leading :class:`solver.PersistentCarry` (every tensor with a
leading lane axis B; the host step counters ``steps`` and ``rebuilds``
as ``np.int64`` (B,) vectors) and advanced by one batched block
(:func:`_ensemble_block`): a rebuild of the lanes that are due at block
entry, ``block`` batched physics steps under per-lane masks, then
``health.check_batch``, one health word and its stats per lane from one
host read a block.

  * On the kernel backend a batched step is ONE K1 and ONE K2 launch for
    all B lanes (``ops.rcll_force_lanes`` folds the lanes into the cell
    axis), where a loop of solo steps would pay the step's host cost B
    times. The ``"reference"`` and ``"xla"`` backends, plain torch, loop
    their force pass over the lanes.
  * Per-member escalation runs the recovery ladder's masked rungs as
    lane vectors (``armed``, ``dt_scale``): a tripped member is rolled
    back to its own last-healthy snapshot row (an in-place row splice;
    the other rows are untouched) and retried with its fault disarmed or
    its dt halved. Config-changing rungs (regrow, record degrade) evict
    the member to a solo ``recovery.run_guarded`` probation leg, after
    which it is re-admitted, finished solo, or quarantined.
  * The guarantee: a member that never trips is bit-identical to its
    solo unguarded run under :func:`member_config`. A frozen lane
    (inactive, or at its target) passes through every step bit for bit
    under the lane select (:func:`_select_members`), and the per-lane dt
    is ``float32(cfg.dt) * dt_scale``, which a healthy lane's 1.0 leaves
    equal to the solo run's ``cfg.dt`` as its steps round it.
  * Durability: the per-member snapshot batch is the checkpoint payload,
    written through ``CheckpointManager`` at block boundaries with the
    lane vectors; ``resume=True`` continues bit-identical to the
    uninterrupted run. The heartbeat writer/monitor and the straggler
    watchdog report a dead predecessor and slow blocks.

The port has no jit: what the JAX module keeps static for recompilation
(the fault slot, ``nsteps``, the policy) is a plain argument here. The
one-FaultSpec-per-engine and per-sweep-bucket rules stay, as behaviour
the serving layer relies on.

Cadence note: the batched block rebuilds at block entry only, so members
run the solver's static cadence ``rebuild_every = policy.block``. With
``skin == 0`` the binning is stale between rebuilds; size a Verlet skin
for the cadence (``cfg.validate_skin`` enforces the geometry).
"""
from __future__ import annotations

import dataclasses
import json
import logging
import os
import time

import numpy as np
import torch

from repro_torch.core import health, rcll, recovery, solver
from repro_torch.core.recovery import GuardPolicy
from repro_torch.runtime.fault_tolerance import (
    HeartbeatMonitor,
    HeartbeatWriter,
    StragglerWatchdog,
)

log = logging.getLogger("repro_torch.ensemble")

# Member status lifecycle (host ints, so they checkpoint as a (B,)
# vector): HEALTHY -> RECOVERED on any in-batch masked-lane recovery;
# EVICTED lanes leave the batch for a solo guarded run (completed at the
# end of the sweep), READMITTED ones splice back in; QUARANTINED is
# terminal.
HEALTHY, RECOVERED, EVICTED, READMITTED, QUARANTINED = range(5)
STATUS_NAMES = ("healthy", "recovered", "evicted", "readmitted",
                "quarantined")


@dataclasses.dataclass
class MemberReport:
    """Per-member outcome of an ensemble run (host-side record)."""

    member: int
    status: str  # one of STATUS_NAMES
    steps: int  # steps of trajectory in the returned final state
    events: list  # in-batch GuardEvents (rollback/disarm/halve_dt/evict)
    retries: int = 0
    dt_halvings: int = 0
    dt_scale: float = 1.0
    solo_report: recovery.GuardReport | None = None  # eviction leg
    error: health.SimulationDiverged | None = None  # quarantine cause


@dataclasses.dataclass
class EnsembleReport:
    """What a batched guarded run did, member by member."""

    cfg: solver.SPHConfig  # the shared (batch) config
    members: list  # list[MemberReport], index == member
    blocks: int = 0  # ensemble blocks executed
    slow_blocks: int = 0  # straggler watchdog trips
    straggler_flagged: bool = False  # persistent straggler
    resumed_from: int | None = None  # checkpoint block index, if resumed
    dead_process_detected: bool = False  # stale heartbeat found at resume
    # How the previous owner of the checkpoint dir exited, judged from its
    # heartbeat file at resume time: "dead" (stale file left behind),
    # "clean" (file removed on exit, checkpoints present), or None (not a
    # resume / nothing to judge).
    predecessor: str | None = None

    @property
    def healthy(self) -> int:
        return sum(1 for m in self.members if m.status == "healthy")

    def counts(self) -> dict:
        out = {name: 0 for name in STATUS_NAMES}
        for m in self.members:
            out[m.status] += 1
        return out


def member_config(cfg: solver.SPHConfig, policy: GuardPolicy | None = None
                  ) -> solver.SPHConfig:
    """The solo-equivalent config of an ensemble member.

    The batched block rebuilds at block entry only, i.e. the static
    cadence ``rebuild_every = policy.block``: healthy members are
    bit-identical to a solo unguarded run under THIS config (also the
    config the eviction path hands to ``run_guarded``). An explicit
    conflicting ``rebuild_every`` is rejected rather than overridden.
    """
    policy = policy or GuardPolicy()
    if cfg.algo != "rcll":
        raise ValueError("ensemble runs require the persistent rcll pipeline")
    if cfg.rebuild_every is not None and cfg.rebuild_every != policy.block:
        raise ValueError(
            f"cfg.rebuild_every={cfg.rebuild_every} conflicts with the "
            f"ensemble cadence policy.block={policy.block}; leave it None "
            "or match the block length"
        )
    return dataclasses.replace(cfg, rebuild_every=policy.block, fault=None)


# --------------------------------------------------------------------------
# batch-leading trees (NamedTuples of tensors, numpy arrays and host ints)
# --------------------------------------------------------------------------
def _tree_map(fn, tree, *rest):
    """``fn`` over the leaves of same-structure trees; None subtrees kept
    (a None where another tree has a leaf is a structure mismatch)."""
    if tree is None:
        if any(r is not None for r in rest):
            raise ValueError("tree structures differ (a field is None in one member only)")
        return None
    if isinstance(tree, tuple):
        vals = [_tree_map(fn, *xs) for xs in zip(tree, *rest, strict=True)]
        return type(tree)(*vals) if hasattr(tree, "_fields") else tuple(vals)
    return fn(tree, *rest)


def _stack(*xs):
    if isinstance(xs[0], torch.Tensor):
        return torch.stack(xs)
    return np.asarray(xs, dtype=np.int64)  # the host step counters


def stack_states(states) -> solver.SPHState:
    """Stack same-shape member states into one batch-leading SPHState
    (fresh tensors: the members' own are never aliased)."""
    states = list(states)
    if not states:
        raise ValueError("empty ensemble")
    try:
        return _tree_map(_stack, *states)
    except (RuntimeError, TypeError, ValueError) as e:
        raise ValueError(
            "ensemble members must share array shapes and tree structure "
            f"(same case family / particle count): {e}"
        ) from e


def _select_members(pred: np.ndarray, a, b):
    """Per-member lane select over batch-leading trees.

    ``pred`` is a host (B,) bool vector; every leaf broadcasts it across
    its trailing axes. Where it is False the output row is ``b``'s row
    bit for bit (a select passes bits through): this is what keeps a
    frozen lane, and masked recovery, invisible to the other members.
    """
    def sel(x, y):
        if isinstance(x, torch.Tensor):
            p = torch.as_tensor(pred, device=x.device)
            return torch.where(p.reshape(p.shape + (1,) * (x.ndim - 1)), x, y)
        return np.where(pred.reshape(pred.shape + (1,) * (np.ndim(x) - 1)), x, y)

    return _tree_map(sel, a, b)


def _lane(tree, i):
    """Row ``i`` of a batch-leading tree (a device carry, whose lane is a
    view of its rows, or a host snapshot)."""
    return _tree_map(lambda x: x[i], tree)


def _splice_lane(carry, i: int, lane):
    """Write one lane (a device carry, or a host snapshot row) into batch
    row ``i`` IN PLACE and return ``carry``. Tensor rows are written by
    ``copy_``, which from host memory has finished reading it when it
    returns; a leaf already in that row's memory is skipped; numpy rows
    (the host counters, a host snapshot's leaves) are assigned."""
    def put(dst, src):
        if not isinstance(dst, torch.Tensor):
            dst[i] = src
            return dst
        row = dst[i]
        if not isinstance(src, torch.Tensor):
            src = torch.from_numpy(np.asarray(src))
        elif src.device == row.device and src.data_ptr() == row.data_ptr():
            return dst
        row.copy_(src)
        return dst

    return _tree_map(put, carry, lane)


def _restore_lane(carry, snap, i: int):
    """Roll lane ``i`` of the batch back to its own snapshot row."""
    return _splice_lane(carry, i, _lane(snap, i))


def _update_snapshot(snap, carry, mask: np.ndarray):
    """Refresh the per-member host snapshot rows where ``mask`` from the
    device carry (only those rows are copied to the host; the snapshot's
    other rows are left as they are)."""
    if not mask.any():
        return snap
    full = bool(mask.all())
    rows = np.nonzero(mask)[0]

    def upd(s, x):
        if isinstance(x, torch.Tensor):
            x = x.detach()
            if not full:
                x = x[torch.as_tensor(rows, device=x.device)]
            h = x.to("cpu", copy=True).numpy()
        else:
            h = np.asarray(x)[rows]
        if full:
            return h.astype(s.dtype, copy=False)
        s[rows] = h
        return s

    return _tree_map(upd, snap, carry)


def _finalize_lane(cfg: solver.SPHConfig, carry, i: int) -> solver.SPHState:
    """Lane ``i`` of the batch in original particle indexing, owning its
    memory (``finalize_persistent`` passes ``t`` through, and the batch's
    ``t`` is the lanes' shared tensor)."""
    st = solver.finalize_persistent(cfg, _lane(carry, i))
    return st._replace(t=st.t.clone())


# --------------------------------------------------------------------------
# the batched block
# --------------------------------------------------------------------------
def _inject(fault, carry, mask: np.ndarray):
    """``health.inject_fault`` on each lane where ``mask`` whose step
    counter matches the fault's step."""
    if fault is None:
        return carry
    for b in np.nonzero(mask & (carry.steps == fault.step))[0]:
        carry = _splice_lane(carry, int(b), health.inject_fault(fault, _lane(carry, int(b))))
    return carry


def _rebuild_lanes(cfg: solver.SPHConfig, carry, due: np.ndarray):
    """``solver._rebuild`` on each due lane, written into its row. The
    kernel backend's folded force pass needs each lane's counts to sum
    to its N: checked here, once per rebuild."""
    for b in np.nonzero(due)[0]:
        carry = _splice_lane(carry, int(b), solver._rebuild(cfg, _lane(carry, int(b))))
    if due.any() and carry.binning is not None:
        n = carry.order.shape[1]
        if not bool(torch.all(carry.binning.counts.sum(dim=1) == n)):
            raise RuntimeError("a lane's cell counts do not sum to its particle count")
    return carry


def _force_lanes(cfg: solver.SPHConfig, carry):
    """(drho (B, N), acc (B, N, d)): one folded K1 + K2 pass on the kernel
    backend, a loop over the lanes on the plain-torch backends."""
    st, fl = carry.st, carry.st.fluid
    if cfg.resolved_backend == "kernel":
        from repro_torch.kernels import ops  # core stays kernel-free at import

        return ops.rcll_force_lanes(
            cfg.domain, carry.binning, st.rc, fl.v, fl.m, fl.rho,
            scheme=cfg.resolved_scheme, records_dtype=cfg.policy.records_dtype,
            m_scale=carry.m_scale, m_table=carry.m_table)
    force = solver._FORCE_BACKENDS[cfg.resolved_backend]
    outs = [force(cfg, _lane(carry, b)) for b in range(carry.order.shape[0])]
    return torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs])


def _physics(cfg: solver.SPHConfig, carry, dt: torch.Tensor, live: np.ndarray):
    """One batched ``solver._physics_step`` (the same ops, each lane with
    its own dt), written into the carry in place where ``live``; frozen
    lanes keep their rows and counters bit for bit."""
    dom, pol = cfg.domain, cfg.policy
    sch = cfg.resolved_scheme
    st, fl = carry.st, carry.st.fluid
    drho, acc = _force_lanes(cfg, carry)
    dt2, dt3 = dt[:, None], dt[:, None, None]
    rho = fl.rho + dt2 * drho
    if cfg.wall_rho_clamp:
        rho = torch.where(st.fixed, torch.clamp(rho, min=sch.rho0), rho)
    bf = sch.body_force_vec(dom.dim, fl.v.device)
    v = fl.v + dt3 * (acc + bf)
    vw = torch.zeros_like(v) if st.v_wall is None else st.v_wall
    fixed = st.fixed[..., None]
    v = torch.where(fixed, vw, v)
    dxn = torch.where(fixed, torch.zeros_like(v), v * dt3 * (2.0 / dom.h_d)).to(torch.float32)
    rc = rcll.advance(dom, st.rc, dxn, dtype=pol.coords_dtype)
    old = (fl.rho, fl.v, st.rc.rel, st.rc.cell_xy, carry.disp_acc, st.t, carry.steps)
    new = (rho, v, rc.rel, rc.cell_xy, carry.disp_acc + dxn, st.t + dt, carry.steps + 1)
    if not live.all():
        new = _select_members(live, new, old)
    for dst, src in zip(old[:5], new[:5]):
        dst.copy_(src)
    return carry._replace(st=st._replace(t=new[5]), steps=new[6])


def _ensemble_block(
    cfg: solver.SPHConfig,
    carry: solver.PersistentCarry,
    lanes,
    nsteps: int,
    policy: GuardPolicy,
    fault,
    observe: bool = False,
):
    """One batched guarded block; the carry is updated in place.

    ``lanes = (dt_scale, armed, active, target)`` are host (B,) vectors,
    so per-member recovery (disarm a fault, halve a dt), admission and
    retirement change only arguments. ``target`` is the per-lane step
    target; frozen members (inactive, or at their target) pass through
    every step bit for bit under the lane select. The order per step is
    ``solver.step_persistent``'s: inject -> rebuild-if-due -> physics,
    and a rebuild can be due only at block entry (members sit on
    block-aligned step counts). ``observe`` also returns one per-lane
    observable row (t, ekin, vmax, rho_err) of (B,) tensors from the
    block-exit state. Returns ``(carry, hw, obs)``.
    """
    dt_scale, armed, active, target = (np.asarray(x) for x in lanes)
    dev = carry.order.device
    dt = torch.from_numpy(np.float32(cfg.dt) * dt_scale.astype(np.float32)).to(dev)

    if carry.flags is not None:
        carry = carry._replace(flags=torch.zeros_like(carry.flags))

    live = active & (carry.steps < target)
    carry = _inject(fault, carry, armed & live)
    due = live & np.array([bool(solver._needs_rebuild(cfg, _lane(carry, b)))
                           for b in range(len(live))])
    carry = _rebuild_lanes(cfg, carry, due)
    for k in range(max(1, nsteps)):
        if k:
            live = active & (carry.steps < target)
            carry = _inject(fault, carry, armed & live)
        if not live.any():
            break  # every lane frozen: the rest of the block passes through
        carry = _physics(cfg, carry, dt, live)

    hw = health.check_batch(
        cfg, carry, rho_dev_limit=policy.rho_dev_limit,
        cfl_limit=policy.cfl_limit, enabled=policy.checks, dt=dt,
    )
    obs = ()
    if observe:
        rows = [health.observe_state(cfg, _lane(carry.st, b)) for b in range(len(live))]
        obs = tuple(torch.stack(col) for col in zip(*rows))
    return carry, hw, obs


def _batch_init(cfg: solver.SPHConfig, states: solver.SPHState):
    """``init_persistent`` of each lane of a stacked state, stacked."""
    lanes = states.xn.shape[0]
    return _tree_map(_stack, *[solver.init_persistent(cfg, _lane(states, b))
                               for b in range(lanes)])


def _batch_check(cfg, carry, policy: GuardPolicy):
    """Step-0 batched health word (init-time overflow)."""
    return health.check_batch(
        cfg, carry, rho_dev_limit=policy.rho_dev_limit,
        cfl_limit=policy.cfl_limit, enabled=policy.checks,
    )


def _batch_finalize(cfg: solver.SPHConfig, carry) -> list:
    """Every lane in original particle indexing (each owns its memory)."""
    return [_finalize_lane(cfg, carry, b) for b in range(carry.order.shape[0])]


def _hw_member(hw, i) -> dict:
    """Host stats dict of member ``i`` of a batched HealthWord."""
    return {
        "vmax": float(hw.vmax[i]),
        "rho_dev": float(hw.rho_dev[i]),
        "cfl": float(hw.cfl[i]),
        "bad_x": int(hw.bad_x[i]),
        "bad_v": int(hw.bad_v[i]),
        "bad_rho": int(hw.bad_rho[i]),
        "max_count": int(hw.max_count[i]),
        "max_cell": int(hw.max_cell[i]),
    }


def _rekey_fault(fault: health.FaultSpec | None, offset: int):
    """Shift a step-keyed fault into a solo run's restarted counter."""
    if fault is None:
        return None
    step = fault.step - offset
    if step < 0:
        return None  # already fired (and was recovered) before eviction
    return dataclasses.replace(fault, step=step)


# Solo probation length (in blocks) before an evicted member is either
# re-admitted to the batch or left to finish solo.
READMIT_BLOCKS = 4


def run_ensemble(
    cfg: solver.SPHConfig,
    states,
    nsteps: int,
    policy: GuardPolicy | None = None,
    *,
    fault: health.FaultSpec | None = None,
    fault_members=(),
    checkpoint=None,
    checkpoint_every: int = 0,
    resume: bool = False,
    heartbeat_timeout_s: float = 60.0,
):
    """Advance B member states ``nsteps`` guarded steps as one batch.

    Returns ``(states, stats, report)``: per-member final SPHStates
    (original indexing), per-member :class:`solver.SimStats`, and the
    :class:`EnsembleReport`. Unlike ``run_guarded`` this never raises
    :class:`SimulationDiverged`: a member that exhausts recovery is
    quarantined (its report carries the structured error and its state
    is returned at its last healthy step) while the rest of the batch
    finishes untouched. The members' states are not modified.

    ``fault`` arms one deterministic FaultSpec on the members listed in
    ``fault_members`` (every member if empty), lane-masked, so disarming
    it recovers ONE member. A fault armed on ``cfg.fault`` is adopted the
    same way.

    ``checkpoint`` (a CheckpointManager) + ``checkpoint_every`` (in
    blocks) persist the per-member snapshot batch and lane vectors at
    block boundaries; ``resume=True`` restores the latest VALID
    checkpoint, and the continuation is bit-identical to the
    uninterrupted run because the snapshot batch is the driver's only
    mutable state. Eviction legs are deferred to the end of the batch
    loop and re-derived from the snapshot, so a crash during (or before)
    them resumes without loss; per-member event lists from before the
    crash are not replayed (statuses and lane vectors are).
    """
    policy = policy or GuardPolicy()
    if cfg.fault is not None and fault is None:
        fault = cfg.fault
    cfg = member_config(cfg, policy)
    states = list(states)
    B = len(states)
    batch0 = stack_states(states)
    del states
    device = batch0.xn.device

    armed0 = np.zeros(B, bool)
    if fault is not None:
        members = tuple(fault_members)
        armed0[list(members) if members else slice(None)] = True

    carry = _batch_init(cfg, batch0)
    del batch0

    # ---- driver state (the checkpoint payload) ------------------------
    snap = recovery._host_snapshot(carry)
    meta = {
        "dt_scale": np.ones(B, np.float32),
        "armed": armed0,
        "active": np.ones(B, bool),
        "halvings": np.zeros(B, np.int32),
        "retries": np.zeros(B, np.int32),
        "status": np.full(B, HEALTHY, np.int32),
        "snap_steps": np.zeros(B, np.int64),
        "blocks": np.zeros((), np.int64),
    }
    events: list[list] = [[] for _ in range(B)]
    errors: dict[int, health.SimulationDiverged] = {}
    solo_reports: dict[int, recovery.GuardReport] = {}
    report = EnsembleReport(cfg=cfg, members=[])

    watchdog = StragglerWatchdog()
    hb = None
    if checkpoint is not None:
        if resume:
            # A heartbeat file with no live writer = the previous sweep
            # process died; a CLEAN exit removes the file
            # (HeartbeatWriter.clear), so "absent with checkpoints
            # present" means the predecessor shut down in good order.
            monitor = HeartbeatMonitor(checkpoint.dir, timeout_s=heartbeat_timeout_s)
            status = monitor.host_status(0)
            if status == "dead":
                report.dead_process_detected = True
                report.predecessor = "dead"
                log.warning(
                    "ensemble: stale heartbeat in %s — previous sweep "
                    "process died; resuming from latest checkpoint",
                    checkpoint.dir,
                )
            elif status == "absent" and checkpoint.latest_step() is not None:
                report.predecessor = "clean"
            restored, ck_step = checkpoint.restore({"carry": snap, "meta": meta})
            if restored is not None:
                snap, meta = restored["carry"], restored["meta"]
                carry = recovery._to_device(snap, device)
                report.resumed_from = int(ck_step)
                log.warning(
                    "ensemble: resumed from checkpoint block %d "
                    "(member steps %s)", int(ck_step),
                    meta["snap_steps"].tolist(),
                )
        hb = HeartbeatWriter(checkpoint.dir, host_id=0)

    dt_scale, armed = meta["dt_scale"], meta["armed"]
    active, halvings = meta["active"], meta["halvings"]
    retries, status = meta["retries"], meta["status"]
    snap_steps = meta["snap_steps"]
    cur_steps = snap_steps.copy()

    def record(i, word, stats, action, detail):
        ev = recovery.GuardEvent(
            step=int(snap_steps[i]), word=int(word),
            checks=health.check_names(int(word)), action=action,
            detail=detail, stats=stats,
        )
        events[i].append(ev)
        log.warning(
            "ensemble member %d tripped %s at step %d: %s — %s",
            i, ev.checks, ev.step, action, detail,
        )
        return ev

    def rollback(i):
        nonlocal carry
        carry = _restore_lane(carry, snap, i)
        cur_steps[i] = snap_steps[i]

    def solo_cfg(i):
        f = _rekey_fault(fault, int(snap_steps[i])) if armed[i] else None
        return dataclasses.replace(cfg, dt=float(cfg.dt * dt_scale[i]), fault=f)

    def solo_state(i):
        lane = recovery._to_device(_lane(snap, i), device)
        return lane, solver.finalize_persistent(cfg, lane)

    def try_readmit(i):
        """Solo probation leg straight after an eviction: if the member
        recovers under shape-compatible rungs only (disarm / dt halve),
        splice it back into the batch at the next block boundary."""
        nonlocal carry, snap
        remaining = int(nsteps - snap_steps[i])
        probe = policy.block * READMIT_BLOCKS
        if probe >= remaining:
            return  # too close to the end: just finish solo
        lane, state_i = solo_state(i)
        try:
            st1, stats1, rep1, _ = recovery.run_guarded(solo_cfg(i), state_i, probe, policy)
        except health.SimulationDiverged as e:
            errors[i] = e
            status[i] = QUARANTINED
            record(i, e.word, e.stats, "quarantine", f"solo probation diverged: {e}")
            return
        if not recovery._dt_equivalent(cfg, rep1.cfg):
            solo_reports[i] = rep1
            log.warning(
                "ensemble member %d: probation recovery changed shapes "
                "(%s); completing solo", i,
                "; ".join(ev.action for ev in rep1.events),
            )
            return
        lane2 = solver.init_persistent(cfg, st1)
        if int(recovery._check(cfg, lane2, policy).word):
            solo_reports[i] = rep1
            return  # still unhealthy under the batch config: stay solo
        new_steps = int(snap_steps[i]) + probe
        lane2 = lane2._replace(
            steps=new_steps, rebuilds=lane2.rebuilds + lane.rebuilds + stats1.rebuilds)
        carry = _splice_lane(carry, i, lane2)
        snap = _splice_lane(snap, i, recovery._host_snapshot(lane2))
        snap_steps[i] = cur_steps[i] = new_steps
        dt_scale[i] = np.float32(rep1.cfg.dt / cfg.dt)
        halvings[i] += rep1.dt_halvings
        armed[i] = bool(rep1.cfg.fault is not None and fault is not None
                        and fault.step >= new_steps)
        status[i], active[i] = READMITTED, True
        solo_reports[i] = rep1
        record(i, 0, {}, "readmit",
               f"solo probation ({probe} steps) recovered with "
               "shape-compatible actions "
               f"[{', '.join(ev.action for ev in rep1.events)}]; "
               f"re-admitted to the batch at step {new_steps}")

    def run_solo(i):
        """Deferred eviction leg: finish the member solo from its last
        healthy snapshot (deterministically re-derivable on resume)."""
        _, state_i = solo_state(i)
        remaining = int(nsteps - snap_steps[i])
        try:
            st, stats, rep, _ = recovery.run_guarded(solo_cfg(i), state_i, remaining, policy)
        except health.SimulationDiverged as e:
            errors[i] = e
            status[i] = QUARANTINED
            record(i, e.word, e.stats, "quarantine", f"solo continuation diverged: {e}")
            return None
        solo_reports[i] = rep
        return st, stats

    # ---- step-0 check: init-time capacity overflow etc. ---------------
    if report.resumed_from is None:
        hw0 = _batch_check(cfg, carry, policy)
        words0 = hw0.word.cpu().numpy()
        for i in np.nonzero(words0)[0]:
            # No step has run, so no masked rung applies: evict. The
            # solo run_guarded regrows capacity (or raises) per member.
            status[i], active[i] = EVICTED, False
            record(i, int(words0[i]), _hw_member(hw0, i), "evict",
                   "init-time health trip; deferring to solo guarded run")

    # ---- batched block loop -------------------------------------------
    target_vec = np.full(B, nsteps, np.int64)
    while np.any(active & (cur_steps < nsteps)):
        stepped = active & (cur_steps < nsteps)
        t0 = time.perf_counter()
        carry, hw, _ = _ensemble_block(
            cfg, carry, (dt_scale, armed, active, target_vec),
            max(1, policy.block), policy, fault)
        words = hw.word.cpu().numpy()  # the one per-block host sync
        wall = time.perf_counter() - t0
        meta["blocks"] += 1
        report.blocks += 1
        if watchdog.observe(wall):
            report.slow_blocks += 1
        report.straggler_flagged = watchdog.flagged
        if hb is not None:
            hb.beat(int(meta["blocks"]))

        steps_np = carry.steps.copy()
        cur_steps[:] = np.where(stepped, steps_np, cur_steps)
        tripped = stepped & (words != 0)

        for i in np.nonzero(tripped)[0]:
            word = int(words[i])
            stats_i = _hw_member(hw, i)
            retries[i] += 1
            if policy.strict:
                errors[i] = health.SimulationDiverged(
                    f"member {i}: health guard (strict) tripped "
                    f"{health.check_names(word)} at step "
                    f"{int(snap_steps[i])}",
                    step=int(snap_steps[i]),
                    checks=health.check_names(word), word=word,
                    stats=stats_i, events=events[i],
                )
                status[i], active[i] = QUARANTINED, False
                record(i, word, stats_i, "quarantine", "strict policy")
                rollback(i)
                continue
            if armed[i] and policy.disarm_faults:
                armed[i] = False
                record(i, word, stats_i, "disarm",
                       f"stripped injected fault for member {i}; "
                       f"replaying block from step {int(snap_steps[i])} "
                       "(lane-masked, no recompile)")
                rollback(i)
                if status[i] == HEALTHY:
                    status[i] = RECOVERED
                continue
            if word & health.NUMERIC_CHECKS and halvings[i] < policy.max_dt_halvings:
                halvings[i] += 1
                dt_scale[i] *= 0.5
                record(i, word, stats_i, "halve_dt",
                       f"member dt scale -> {dt_scale[i]:g} (backoff "
                       f"{int(halvings[i])}/{policy.max_dt_halvings}; "
                       "lane-masked, no recompile)")
                rollback(i)
                if status[i] == HEALTHY:
                    status[i] = RECOVERED
                continue
            # Config-changing rungs (capacity/window regrow, record
            # degrade, dt exhaustion) cannot ride a lane mask: evict,
            # then try to re-admit after a solo probation.
            status[i], active[i] = EVICTED, False
            record(i, word, stats_i, "evict",
                   "masked rungs exhausted or capacity trip; evicting "
                   "member to a solo guarded run")
            rollback(i)
            try_readmit(i)

        healthy = stepped & (words == 0)
        if healthy.any() and int(meta["blocks"]) % max(1, policy.snapshot_every) == 0:
            snap = _update_snapshot(snap, carry, healthy)
            snap_steps[healthy] = steps_np[healthy]
            if (checkpoint is not None and checkpoint_every
                    and int(meta["blocks"]) % checkpoint_every == 0):
                checkpoint.save(int(meta["blocks"]), {"carry": snap, "meta": meta},
                                blocking=False)

    # A failed async save must never be silently dropped: join (and
    # surface any deferred error) before leaving the loop.
    if checkpoint is not None:
        checkpoint.wait()
    if hb is not None:
        # A clean exit removes the heartbeat file: a later resume must be
        # able to tell "predecessor shut down" from "predecessor died".
        hb.clear()

    # ---- deferred eviction legs ---------------------------------------
    solo_out: dict[int, tuple] = {}
    for i in range(B):
        if status[i] == EVICTED:
            out = run_solo(i)
            if out is not None:
                solo_out[i] = out

    # ---- assemble results ---------------------------------------------
    fin = _batch_finalize(cfg, carry)
    out_states, out_stats = [], []
    for i in range(B):
        if i in solo_out:
            st, stats = solo_out[i]
            final_steps = int(nsteps)
        elif status[i] == QUARANTINED:
            # last healthy trajectory point, from the snapshot
            lane, st = solo_state(i)
            stats = solver.SimStats(rebuilds=lane.rebuilds, steps=lane.steps,
                                    overflow=bool(lane.overflow))
            final_steps = int(snap_steps[i])
        else:
            st = fin[i]
            stats = solver.SimStats(rebuilds=int(carry.rebuilds[i]),
                                    steps=int(carry.steps[i]),
                                    overflow=bool(carry.overflow[i]))
            final_steps = int(carry.steps[i])
        out_states.append(st)
        out_stats.append(stats)
        report.members.append(MemberReport(
            member=i, status=STATUS_NAMES[int(status[i])],
            steps=final_steps, events=events[i],
            retries=int(retries[i]), dt_halvings=int(halvings[i]),
            dt_scale=float(dt_scale[i]),
            solo_report=solo_reports.get(i), error=errors.get(i),
        ))
    return out_states, out_stats, report


# --------------------------------------------------------------------------
# Live lane engine: standby-slot admission / retirement over one batch
# --------------------------------------------------------------------------
class EngineFull(RuntimeError):
    """No free lane: the caller should queue or shed the request."""


class FaultBusy(RuntimeError):
    """The engine's one FaultSpec slot is held by live armed lanes;
    admitting a request with a DIFFERENT fault would change it under
    them. The caller should re-queue until the armed lanes drain."""


class AdmissionError(RuntimeError):
    """A request failed its init-time health check (e.g. the admission
    rebuild overflowed an undersized capacity), structured so a server
    can reply with the tripped checks instead of admitting a lane that
    is known-bad before its first step."""

    def __init__(self, word: int, stats: dict):
        checks = health.check_names(word)
        super().__init__(f"request failed init-time health checks {checks}: {stats}")
        self.word = int(word)
        self.checks = checks
        self.stats = dict(stats)


@dataclasses.dataclass
class LaneEvent:
    """One per-lane outcome of a :meth:`LaneEngine.step_block` call."""

    lane: int
    kind: str  # "obs" | "recovered" | "done" | "diverged"
    step: int  # lane step count the event refers to
    obs: dict | None = None  # observable row (kind "obs"/"done")
    action: str | None = None  # recovery rung taken (kind "recovered")
    detail: str = ""
    word: int = 0
    checks: tuple = ()
    stats: dict | None = None
    state: object | None = None  # finalized SPHState (kind "done")
    events: list | None = None  # lane GuardEvents (kind "done"/"diverged")


class LaneEngine:
    """Standby-slot live batch: ``slots`` lanes advanced by one batched
    block, requests admitted and retired at block boundaries.

    The serving counterpart of :func:`run_ensemble`: instead of a fixed
    member list advanced to one shared target, the engine keeps a fixed
    batch WIDTH whose lanes are individually occupied by requests. Free
    lanes sit inactive (every step passes their bits through unchanged),
    :meth:`admit` warm-starts a request on a free lane (solo
    ``init_persistent`` + an in-place row splice; the other rows are
    untouched), and completion, divergence or retirement frees the slot.
    Per-lane step targets ride a (B,) vector, so a 64-step request runs
    next to a half-finished 512-step one.

    Health is the recovery ladder restricted to its MASKED rungs,
    disarm-fault and per-lane dt backoff (rollback to the lane's own
    last-healthy snapshot row). A lane that needs a config-changing rung
    (regrow, record degrade) is reported ``diverged`` with the structured
    word/stats and its slot is freed: a serving layer sheds that request
    rather than reshaping the batch under its neighbors. Healthy lanes
    are bit-identical to solo runs under :func:`member_config`.

    One FaultSpec at a time, re-armable per lane: admitting a different
    spec while armed lanes are live raises :class:`FaultBusy` (re-queue);
    once no lane is armed the spec may be replaced (loud log).

    ``device`` places a batch whose first tenant is a host carry row
    (``admit(carry_row=...)``): None means CUDA, as every entry point of
    the port; a batch started from a state takes the state's device.
    """

    def __init__(self, cfg: solver.SPHConfig, slots: int,
                 policy: GuardPolicy | None = None, *, device=None):
        self.device = device
        self.policy = policy or GuardPolicy()
        self.cfg = member_config(cfg, self.policy)
        self.slots = int(slots)
        if self.slots < 1:
            raise ValueError("LaneEngine needs at least one slot")
        self.fault: health.FaultSpec | None = None
        B = self.slots
        self.carry = None  # batch carry, built at the first admit
        self.snap = None  # per-lane last-healthy host snapshot rows
        self.dt_scale = np.ones(B, np.float32)
        self.armed = np.zeros(B, bool)
        self.disarmable = np.ones(B, bool)
        self.active = np.zeros(B, bool)
        self.target = np.zeros(B, np.int64)
        self.halvings = np.zeros(B, np.int32)
        self.retries = np.zeros(B, np.int32)
        self.snap_steps = np.zeros(B, np.int64)
        self.lane_events: list[list] = [[] for _ in range(B)]
        self.blocks = 0
        # lanes whose snapshot/ladder-meta changed since take_dirty():
        # the continuous per-block checkpoint work list (serve workers)
        self.dirty: set[int] = set()

    # ---- introspection ------------------------------------------------
    @property
    def free_lanes(self) -> list[int]:
        return [i for i in range(self.slots) if not self.active[i]]

    @property
    def live_lanes(self) -> list[int]:
        return [i for i in range(self.slots) if self.active[i]]

    # ---- admission / retirement ---------------------------------------
    def _ensure_batch(self, carry0):
        if self.carry is None:
            self.carry = _tree_map(_stack, *[carry0] * self.slots)
            self.snap = recovery._host_snapshot(self.carry)

    def _set_fault(self, fault: health.FaultSpec | None):
        if fault is None or fault == self.fault:
            return
        if any(self.armed[i] for i in self.live_lanes):
            raise FaultBusy(
                f"engine fault slot holds {self.fault} with armed live "
                f"lanes; cannot admit {fault} under them")
        if self.fault is not None:
            log.warning("lane engine: replacing fault %s -> %s", self.fault, fault)
        self.fault = fault

    def admit(
        self,
        state: solver.SPHState | None,
        nsteps: int,
        *,
        fault: health.FaultSpec | None = None,
        disarmable: bool = True,
        dt_scale: float = 1.0,
        halvings: int = 0,
        carry_row=None,
        steps_done: int = 0,
    ) -> int:
        """Warm-start a request on a free lane; returns the lane index.

        ``state`` is a fresh SPHState (same shapes as every other lane:
        the bucket invariant); ``carry_row`` instead splices a host carry
        snapshot (the drain/resume path: bit-identical continuation from
        a checkpointed lane, ``steps_done`` of its ``nsteps`` already
        taken). ``fault`` arms the engine's FaultSpec on this lane;
        ``disarmable=False`` models a poisoned request payload (the
        disarm rung is skipped and the ladder runs dt backoff straight
        to a structured divergence).

        Raises :class:`EngineFull` (no free lane: queue or shed),
        :class:`FaultBusy` (fault slot held), or :class:`AdmissionError`
        (init-time health trip).
        """
        free = self.free_lanes
        if not free:
            raise EngineFull(f"all {self.slots} lanes busy")
        self._set_fault(fault)
        i = free[0]
        if carry_row is not None:
            device = (self.carry.order.device if self.carry is not None
                      else solver.resolve_device(self.device))
            carry0 = recovery._to_device(carry_row, device)
        else:
            carry0 = solver.init_persistent(self.cfg, state)
            hw0 = recovery._check(self.cfg, carry0, self.policy)
            word0 = int(hw0.word)
            if word0:
                raise AdmissionError(word0, hw0.host_stats())
        self._ensure_batch(carry0)
        self.carry = _splice_lane(self.carry, i, carry0)
        self.snap = _splice_lane(self.snap, i, recovery._host_snapshot(carry0))
        self.snap_steps[i] = int(steps_done)
        self.dt_scale[i] = np.float32(dt_scale)
        self.armed[i] = fault is not None
        self.disarmable[i] = bool(disarmable)
        self.active[i] = True
        self.target[i] = int(nsteps)
        self.halvings[i] = int(halvings)
        self.retries[i] = 0
        self.lane_events[i] = []
        self.dirty.add(i)
        return i

    def retire(self, lane: int):
        """Free a slot (cancellation / deadline expiry). The lane's rows
        stay in the batch as frozen bits until the next admission
        overwrites them: retirement touches no device buffer."""
        self.active[lane] = False
        self.armed[lane] = False
        self.dirty.discard(lane)

    def take_dirty(self) -> list[int]:
        """Drain the set of lanes whose last-healthy snapshot (or ladder
        meta: dt_scale/halvings/armed) moved since the previous call. A
        serving worker checkpoints exactly these lanes after each block,
        so a crash loses at most one block of progress; retired/done
        lanes are dropped from the set."""
        out = sorted(self.dirty)
        self.dirty.clear()
        return out

    def lane_snapshot(self, lane: int):
        """(host carry row, meta) at the lane's last healthy block
        boundary: the drain checkpoint payload, a copy that owns its
        memory. Resume by passing the row back to :meth:`admit` as
        ``carry_row``."""
        return _tree_map(lambda x: np.array(x[lane]), self.snap), {
            "steps_done": int(self.snap_steps[lane]),
            "target": int(self.target[lane]),
            "dt_scale": float(self.dt_scale[lane]),
            "halvings": int(self.halvings[lane]),
            "armed": bool(self.armed[lane]),
            "disarmable": bool(self.disarmable[lane]),
        }

    # ---- the block ----------------------------------------------------
    def _record(self, i, word, stats, action, detail):
        ev = recovery.GuardEvent(
            step=int(self.snap_steps[i]), word=int(word),
            checks=health.check_names(int(word)), action=action,
            detail=detail, stats=stats,
        )
        self.lane_events[i].append(ev)
        log.warning("lane %d tripped %s at step %d: %s — %s",
                    i, ev.checks, ev.step, action, detail)
        return ev

    def _rollback(self, i):
        self.carry = _restore_lane(self.carry, self.snap, i)

    def step_block(self) -> list[LaneEvent]:
        """Advance every live lane one block; returns per-lane events.

        Healthy live lanes yield "obs" (still running), "recovered"
        (masked rung taken, replay scheduled) or "done" (target reached:
        finalized state attached, slot freed); a lane whose masked rungs
        are exhausted yields "diverged" (structured word/checks/stats +
        the lane's event log, slot freed)."""
        if self.carry is None or not self.live_lanes:
            return []
        lanes = (self.dt_scale, self.armed, self.active, self.target)
        self.carry, hw, obs = _ensemble_block(
            self.cfg, self.carry, lanes, max(1, self.policy.block),
            self.policy, self.fault, True,
        )
        self.blocks += 1
        words = hw.word.cpu().numpy()  # the one per-block host sync
        steps = self.carry.steps.copy()
        obs_rows = [o.cpu().numpy() for o in obs]
        live = self.active & (self.snap_steps < self.target)
        healthy = live & (words == 0)
        tripped = live & (words != 0)
        # Refresh healthy snapshots BEFORE processing trips: rollbacks
        # splice from snap rows, which tripped lanes must keep.
        if healthy.any():
            self.snap = _update_snapshot(self.snap, self.carry, healthy)
            self.snap_steps[healthy] = steps[healthy]
            self.dirty.update(int(i) for i in np.nonzero(healthy)[0])
        events: list[LaneEvent] = []
        for i in np.nonzero(tripped)[0]:
            events.append(self._escalate(int(i), int(words[i]), _hw_member(hw, i)))
            # a surviving tripped lane changed ladder meta (dt_scale /
            # halvings / armed): re-checkpoint so a crash replays the
            # same rung instead of re-deriving it from stale meta
            if self.active[int(i)]:
                self.dirty.add(int(i))
        for i in np.nonzero(healthy)[0]:
            i = int(i)
            row = {
                "t": float(obs_rows[0][i]), "ekin": float(obs_rows[1][i]),
                "vmax": float(obs_rows[2][i]),
                "rho_err": float(obs_rows[3][i]),
            }
            if steps[i] >= self.target[i]:
                state = _finalize_lane(self.cfg, self.carry, i)
                events.append(LaneEvent(
                    lane=i, kind="done", step=int(steps[i]), obs=row,
                    state=state, events=self.lane_events[i],
                ))
                self.retire(i)
            else:
                events.append(LaneEvent(lane=i, kind="obs", step=int(steps[i]), obs=row))
        return events

    def _escalate(self, i: int, word: int, stats: dict) -> LaneEvent:
        """The masked rungs of the recovery ladder for one tripped lane."""
        self.retries[i] += 1
        policy = self.policy
        if (self.armed[i] and self.disarmable[i] and policy.disarm_faults
                and not policy.strict):
            self.armed[i] = False
            self._record(i, word, stats, "disarm",
                         "stripped injected fault; replaying block from "
                         f"step {int(self.snap_steps[i])} (lane-masked)")
            self._rollback(i)
            return LaneEvent(lane=i, kind="recovered", step=int(self.snap_steps[i]),
                             action="disarm", word=word, stats=stats)
        if (word & health.NUMERIC_CHECKS and not policy.strict
                and self.halvings[i] < policy.max_dt_halvings):
            self.halvings[i] += 1
            self.dt_scale[i] *= 0.5
            self._record(
                i, word, stats, "halve_dt",
                f"lane dt scale -> {self.dt_scale[i]:g} (backoff "
                f"{int(self.halvings[i])}/{policy.max_dt_halvings})")
            self._rollback(i)
            return LaneEvent(lane=i, kind="recovered", step=int(self.snap_steps[i]),
                             action="halve_dt", word=word, stats=stats)
        detail = ("strict policy" if policy.strict else
                  "masked rungs exhausted (config-changing recovery "
                  "cannot run under live neighbor lanes)")
        self._record(i, word, stats, "quarantine", detail)
        self._rollback(i)  # park the lane rows at its last healthy step
        ev = LaneEvent(
            lane=i, kind="diverged", step=int(self.snap_steps[i]),
            word=word, checks=health.check_names(word), stats=stats,
            detail=detail, events=self.lane_events[i],
        )
        self.retire(i)
        return ev


# --------------------------------------------------------------------------
# Durable sweep service: shape-bucketed batches + per-bucket checkpoints
# --------------------------------------------------------------------------
@dataclasses.dataclass
class SweepRequest:
    """One sweep member: a named (cfg, state) pair, optionally faulted."""

    name: str
    cfg: solver.SPHConfig
    state: solver.SPHState
    fault: health.FaultSpec | None = None


@dataclasses.dataclass
class SweepResult:
    """Per-request outputs (request order) + per-bucket ensemble reports."""

    names: list
    states: list
    stats: list
    members: list  # MemberReport per request
    reports: list  # EnsembleReport per bucket
    buckets: list  # request indices per bucket

    def counts(self) -> dict:
        out = {name: 0 for name in STATUS_NAMES}
        for m in self.members:
            out[m.status] += 1
        return out


def run_sweep(
    requests,
    nsteps: int,
    policy: GuardPolicy | None = None,
    *,
    checkpoint_dir: str | None = None,
    checkpoint_every: int = 1,
    keep: int = 3,
    resume: bool = False,
):
    """Run a sweep of :class:`SweepRequest`s as shape-bucketed ensembles.

    Requests sharing a (normalized) config land in ONE batched
    ``run_ensemble`` call, never one per member. Each bucket checkpoints
    into its own ``<checkpoint_dir>/bucket_<j>`` subdirectory (plus a
    human-readable ``sweep.json`` manifest at the root), so
    ``resume=True`` restarts an interrupted sweep (completed buckets
    replay from their final checkpoint, the interrupted one from its
    latest valid step) and finishes bit-identical to the uninterrupted
    run. Bucket order is the requests' first-appearance order: a resumed
    sweep must present the SAME request list.

    At most one distinct FaultSpec per bucket (the one fault slot of its
    batch); which members it arms is free.
    """
    from repro_torch.checkpoint.manager import CheckpointManager

    policy = policy or GuardPolicy()
    requests = list(requests)
    buckets: dict = {}
    order: list = []
    faults: dict = {}
    for idx, r in enumerate(requests):
        fault = r.fault if r.fault is not None else r.cfg.fault
        key = member_config(r.cfg, policy)
        if key not in buckets:
            buckets[key] = []
            order.append(key)
        buckets[key].append(idx)
        if fault is not None:
            faults[idx] = fault
    for key in order:
        distinct = {faults[i] for i in buckets[key] if i in faults}
        if len(distinct) > 1:
            raise ValueError(
                "at most one distinct FaultSpec per sweep bucket (it is "
                f"the one fault slot of its batch); got {distinct}"
            )

    if checkpoint_dir is not None:
        os.makedirs(checkpoint_dir, exist_ok=True)
        manifest = {
            "nsteps": int(nsteps),
            "buckets": [
                {"dir": f"bucket_{j:02d}",
                 "members": [requests[i].name for i in buckets[key]]}
                for j, key in enumerate(order)
            ],
        }
        with open(os.path.join(checkpoint_dir, "sweep.json"), "w") as f:
            json.dump(manifest, f, indent=2)

    names = [r.name for r in requests]
    states: list = [None] * len(requests)
    stats: list = [None] * len(requests)
    members: list = [None] * len(requests)
    reports: list = []
    bucket_idx: list = []
    for j, key in enumerate(order):
        idxs = buckets[key]
        bucket_idx.append(list(idxs))
        distinct = {faults[i] for i in idxs if i in faults}
        fault = next(iter(distinct)) if distinct else None
        fmembers = tuple(k for k, i in enumerate(idxs) if i in faults)
        ckpt = None
        if checkpoint_dir is not None:
            ckpt = CheckpointManager(os.path.join(checkpoint_dir, f"bucket_{j:02d}"), keep=keep)
        log.info(
            "sweep bucket %d: %d member(s)%s", j, len(idxs),
            f", fault {fault.kind!r} on lanes {fmembers}" if fault else "",
        )
        try:
            outs, st, rep = run_ensemble(
                key, [requests[i].state for i in idxs], nsteps, policy,
                fault=fault, fault_members=fmembers, checkpoint=ckpt,
                checkpoint_every=checkpoint_every, resume=resume,
            )
        finally:
            if ckpt is not None:
                ckpt.close()
        reports.append(rep)
        for k, i in enumerate(idxs):
            states[i] = outs[k]
            stats[i] = st[k]
            members[i] = rep.members[k]
    return SweepResult(
        names=names, states=states, stats=stats, members=members,
        reports=reports, buckets=bucket_idx,
    )
