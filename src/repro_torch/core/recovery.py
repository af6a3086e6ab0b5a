"""Self-healing guarded runner: rollback + escalation over the health word.

Port of ``repro.core.recovery``. The runner advances a persistent carry
in guarded blocks: clear the carry's flags, ``nsteps`` solver steps,
then the health reduction (``health.check_carry``), whose word is the
block's one host read. After every healthy block the carry is copied to
host memory (the rollback point, and what an optional
``CheckpointManager`` saves). A tripped word rolls the run back to the
last healthy snapshot and retries under an escalation ladder:

  1. **disarm**: an armed fault-injection spec is stripped and the block
     replayed clean (the recovered run is bit-identical to one that
     never faulted);
  2. **regrow** (capacity bits): ``capacity`` / ``window`` /
     ``max_neighbors`` re-sized from the tripped carry's observed demand
     (max cell occupancy, ``cells.max_neighborhood_occupancy``), the
     carry rebuilt from the snapshot under the new config;
  3. **halve dt** (numeric bits): bounded backoff; shapes are unchanged,
     so the snapshot restores directly;
  4. **degrade records**: fp16 -> fp32 record rows, at guard init when
     the half-record anchor or the rel-quantization bound trips, and as
     the rung after dt backoff exhausts;
  5. **raise**: a structured :class:`health.SimulationDiverged`.

The kernel backend needs no new build for any rung: K2 takes ``cap`` and
the records dtype at run time.

The carry's tensors are updated in place by the solver, so a snapshot is
a copy on the way out and a restored carry a copy on the way back
(``interop.carry_to_numpy`` / ``carry_from_numpy``): the same snapshot
can restore any number of times.
"""
from __future__ import annotations

import dataclasses
import logging

import numpy as np
import torch

from repro_torch.core import cells as cells_lib
from repro_torch.core import health, interop, solver

log = logging.getLogger("repro_torch.recovery")

SimulationDiverged = health.SimulationDiverged  # re-export


@dataclasses.dataclass(frozen=True)
class GuardPolicy:
    """Escalation policy of a guarded run.

    block:            steps per guarded block (detection granularity and
                      rollback cost; observe_every overrides it).
    checks:           bitmask of enabled health checks (health.ALL_CHECKS).
    rho_dev_limit:    density-deviation trip point |rho/rho0 - 1|.
    cfl_limit:        advective CFL trip point vmax * dt / h.
    max_dt_halvings:  dt backoff budget for numeric trips.
    max_regrows:      capacity/window regrow budget for overflow trips.
    growth:           minimum geometric growth factor per regrow.
    demand_safety:    multiplier on the observed demand when re-sizing.
    degrade_records:  allow the fp16 -> fp32 record fallback.
    quant_frac:       rel-coordinate quantization bound as a fraction of
                      the particle spacing ds (init-time check).
    disarm_faults:    treat an armed FaultSpec as transient (strip it on
                      the first trip and replay).
    strict:           raise on the first tripped word, no recovery.
    snapshot_every:   healthy blocks between host snapshots.
    """

    block: int = 32
    checks: int = health.ALL_CHECKS
    rho_dev_limit: float = health.DEFAULT_RHO_DEV_LIMIT
    cfl_limit: float = health.DEFAULT_CFL_LIMIT
    max_dt_halvings: int = 4
    max_regrows: int = 3
    growth: float = 1.5
    demand_safety: float = 1.25
    degrade_records: bool = True
    quant_frac: float = 0.02
    disarm_faults: bool = True
    strict: bool = False
    snapshot_every: int = 1


@dataclasses.dataclass
class GuardEvent:
    """One detection + recovery action (host-side record)."""

    step: int  # last healthy step count (the rollback point)
    word: int  # tripped-check bitmask
    checks: tuple[str, ...]
    action: str  # "disarm" | "regrow" | "halve_dt" | "degrade_records"
    detail: str
    stats: dict

    def to_json(self) -> dict:
        """Plain-JSON form."""
        return {
            "step": int(self.step),
            "word": int(self.word),
            "checks": list(self.checks),
            "action": self.action,
            "detail": self.detail,
            "stats": {k: (float(v) if isinstance(v, float) else int(v))
                      for k, v in (self.stats or {}).items()},
        }


@dataclasses.dataclass
class GuardReport:
    """What a guarded run did: escalations taken and the final config."""

    cfg: solver.SPHConfig  # final (possibly escalated) config
    events: list
    blocks: int = 0
    retries: int = 0
    dt_halvings: int = 0
    regrows: int = 0
    records_degraded: bool = False
    # Observable rows of rolled-back blocks, dropped (counted, not silent).
    dropped_obs_rows: int = 0

    @property
    def recovered(self) -> bool:
        return bool(self.events)

    def to_json(self) -> dict:
        """Plain-JSON form; drops ``cfg`` for the fields a client can act on."""
        return {
            "recovered": self.recovered,
            "blocks": int(self.blocks),
            "retries": int(self.retries),
            "dt_halvings": int(self.dt_halvings),
            "regrows": int(self.regrows),
            "records_degraded": bool(self.records_degraded),
            "final_dt": float(self.cfg.dt),
            "dropped_obs_rows": int(self.dropped_obs_rows),
            "events": [e.to_json() for e in self.events],
        }


def _check(cfg: solver.SPHConfig, carry: solver.PersistentCarry,
           policy: GuardPolicy) -> health.HealthWord:
    return health.check_carry(cfg, carry, rho_dev_limit=policy.rho_dev_limit,
                              cfl_limit=policy.cfl_limit, enabled=policy.checks)


def _guarded_block(cfg: solver.SPHConfig, carry: solver.PersistentCarry, nsteps: int,
                   policy: GuardPolicy, observe: bool):
    """One guarded block: clear the flags, step, reduce health.

    Clearing the accumulated flags at block entry gives the word
    per-block semantics; the init-time flags are read by the step-0
    check before the first block runs.
    """
    if carry.flags is not None:
        carry = carry._replace(flags=torch.zeros_like(carry.flags))
    carry = solver.run_persistent(cfg, carry, nsteps)
    hw = _check(cfg, carry, policy)
    row = health.observe_state(cfg, carry.st) if observe else ()
    return carry, hw, row


_host_snapshot = interop.carry_to_numpy
_to_device = interop.carry_from_numpy


def _dt_equivalent(a: solver.SPHConfig, b: solver.SPHConfig) -> bool:
    """True when ``b`` differs from ``a`` only in dt / fault, i.e. the
    snapshot's carry shapes, dtypes and packing remain valid under b."""
    return dataclasses.replace(a, dt=b.dt, fault=b.fault) == b


def _restore(snap, snap_cfg: solver.SPHConfig, cfg: solver.SPHConfig, device):
    """Rebuild a carry for ``cfg`` on ``device`` from a host snapshot.

    Shape-preserving escalations (dt halve, disarm) restore the exact
    carry; shape-changing ones (regrow, records degrade) unpack the
    snapshot to an SPHState and re-init the persistent pipeline under
    the new config, keeping the step counter and adding the rebuild
    count, so step-keyed fault injection stays aligned.
    """
    carry = _to_device(snap, device)
    if _dt_equivalent(snap_cfg, cfg):
        return carry
    state = solver.finalize_persistent(snap_cfg, carry)
    fresh = solver.init_persistent(cfg, state)
    return fresh._replace(steps=int(snap.steps),
                          rebuilds=fresh.rebuilds + int(snap.rebuilds))


def rel_quantization_error(domain, coords_dtype) -> float:
    """Worst-case physical position error of storing rel coords in
    ``coords_dtype``: half an ulp at |rel| ~ 1 across the largest cell
    (one rel unit = cell_size / 2)."""
    ulp = torch.finfo(coords_dtype).eps  # 2^-nmant
    return float(max(domain.cell_sizes)) * 0.5 * ulp * 0.5


def _resolve_precision(cfg, policy, events):
    """Init-time precision guard: degrades the record layout loudly when
    the half-record cell-anchor limit or the rel quantization bound
    trips (``solver._resolved_records``'s fallback is silent)."""
    if not policy.degrade_records or cfg.policy.records == "fp32":
        return cfg, False
    reasons = []
    if solver._resolved_records(cfg) != cfg.policy.records:
        reasons.append(
            f"grid max(ncells)={max(cfg.domain.ncells)} exceeds the "
            "half-record cell-anchor range (fused.HALF_CELL_LIMIT)"
        )
    q = rel_quantization_error(cfg.domain, cfg.policy.coords_dtype)
    if q > policy.quant_frac * cfg.ds:
        reasons.append(
            f"rel-coordinate quantization {q:.3g} exceeds "
            f"{policy.quant_frac:.0%} of ds={cfg.ds:.3g} "
            "(note: stored coords keep the policy dtype; full-width "
            "records stop the error compounding through the force pass)"
        )
    if not reasons:
        return cfg, False
    detail = "; ".join(reasons)
    log.warning("health guard: degrading records %s -> fp32 at init (%s)",
                cfg.policy.records, detail)
    events.append(GuardEvent(step=0, word=0, checks=(), action="degrade_records",
                             detail=detail, stats={}))
    return dataclasses.replace(cfg, policy=cfg.policy.with_records("fp32")), True


def _regrown_capacity(cfg: solver.SPHConfig, policy: GuardPolicy, occupancy: int,
                      n: int) -> int:
    """The regrow rung's cell capacity: the observed max occupancy times
    the demand safety, and at least ``growth`` times the current one."""
    return max(int(np.ceil(policy.demand_safety * occupancy)),
               int(np.ceil(policy.growth * cfg.cap(n))))


def apply_named_fault(cfg: solver.SPHConfig, name: str, nsteps: int,
                      n_particles: int) -> solver.SPHConfig:
    """Arm one of the named fault injections on a config: "nan" and
    "teleport" arm a FaultSpec a third of the way in; "cap", "window" and
    "dt" corrupt the config itself (undersized cell capacity, undersized
    search window, overscale timestep)."""
    step = max(1, nsteps // 3)
    if name == "nan":
        return dataclasses.replace(cfg, fault=health.FaultSpec("nan_v", step=step))
    if name == "teleport":
        return dataclasses.replace(cfg, fault=health.FaultSpec(
            "teleport", step=step, particle=0, target=max(1, n_particles // 2)))
    if name == "cap":
        return dataclasses.replace(cfg, capacity=2)
    if name == "window":
        return dataclasses.replace(cfg, window=8)
    if name == "dt":
        return dataclasses.replace(cfg, dt=cfg.dt * 8.0)
    raise ValueError(f"unknown fault {name!r}; one of nan, teleport, cap, window, dt")


def run_guarded(cfg: solver.SPHConfig, state: solver.SPHState, nsteps: int,
                policy: GuardPolicy | None = None, *, observe_every: int = 0,
                checkpoint=None, checkpoint_every: int = 0):
    """Advance ``nsteps`` guarded steps from ``state`` (left unchanged).

    Returns ``(state, stats, report, obs_rows)``: the final SPHState in
    original indexing, the run's SimStats, the :class:`GuardReport`, and
    (t, ekin, vmax, rho_err) rows of device scalars, one per healthy
    block, when ``observe_every > 0``. Raises :class:`SimulationDiverged`
    when the policy is exhausted. ``checkpoint`` (a CheckpointManager)
    saves the healthy host snapshot every ``checkpoint_every`` blocks,
    keyed by the carry's step counter.
    """
    if cfg.algo != "rcll":
        raise ValueError("run_guarded requires the persistent rcll pipeline")
    policy = policy or GuardPolicy()
    events: list[GuardEvent] = []
    cfg, degraded = _resolve_precision(cfg, policy, events)
    if policy.strict and degraded:
        _raise_exhausted(events[-1], 0, events, policy)

    block = observe_every if observe_every > 0 else max(1, policy.block)
    halvings = regrows = blocks = retries = 0
    dropped_rows = 0
    obs_rows: list[tuple] = []  # (steps_done_after_block, row)
    device = state.xn.device

    carry = solver.init_persistent(cfg, state)
    snap, snap_cfg, snap_steps = _host_snapshot(carry), cfg, 0
    steps_done = 0

    def escalate(hw, tripped_carry, fault_possible=True):
        """Pick a recovery action, log it, return the restored carry."""
        nonlocal cfg, halvings, regrows, retries, degraded
        word = int(hw.word)
        checks = health.check_names(word)
        stats = hw.host_stats()
        if policy.strict:
            _raise_strict(word, checks, stats, snap_steps, events, policy)
        retries += 1
        # No step has run at the step-0 check, so an armed fault cannot
        # be the cause there: don't spend the disarm rung on it.
        if fault_possible and cfg.fault is not None and policy.disarm_faults:
            action, detail = "disarm", (
                f"stripped injected fault {cfg.fault.kind!r}; replaying "
                f"block from step {snap_steps}"
            )
            cfg = dataclasses.replace(cfg, fault=None)
        elif word & health.CAPACITY_CHECKS and regrows < policy.max_regrows:
            action = "regrow"
            changes = []
            s = policy.demand_safety
            n = int(tripped_carry.order.shape[0])
            if word & health.CELL_OVERFLOW:
                cap_new = _regrown_capacity(cfg, policy, int(hw.max_cell), n)
                changes.append(f"capacity {cfg.cap(n)} -> {cap_new}")
                cfg = dataclasses.replace(cfg, capacity=cap_new)
            if word & health.WINDOW_TRUNC:
                # Size window AND max_neighbors from the exact demand
                # bound: no particle has more candidates than its
                # 3^dim-neighborhood occupancy.
                nb = int(cells_lib.max_neighborhood_occupancy(
                    cfg.domain, tripped_carry.binning.counts))
                k = cfg.max_neighbors
                if cfg.window is not None:
                    w_new = max(int(np.ceil(s * nb)),
                                int(np.ceil(policy.growth * cfg.resolved_window())))
                    changes.append(f"window {cfg.resolved_window()} -> {w_new}")
                    cfg = dataclasses.replace(cfg, window=w_new)
                if int(hw.max_count) > k:
                    changes.append(f"max_neighbors {k} -> {nb}")
                    cfg = dataclasses.replace(cfg, max_neighbors=nb)
            regrows += 1
            detail = (", ".join(changes) + f" (regrow {regrows}/"
                      f"{policy.max_regrows}; shapes change: recompiling)")
        elif word & health.NUMERIC_CHECKS:
            if halvings < policy.max_dt_halvings:
                halvings += 1
                action, detail = "halve_dt", (
                    f"dt {cfg.dt:.3e} -> {cfg.dt / 2:.3e} "
                    f"(backoff {halvings}/{policy.max_dt_halvings})"
                )
                cfg = dataclasses.replace(cfg, dt=cfg.dt / 2.0)
            elif (policy.degrade_records and not degraded
                  and cfg.policy.records != "fp32"):
                degraded = True
                action, detail = "degrade_records", (
                    f"records {cfg.policy.records} -> fp32 after dt "
                    "backoff exhausted (shapes change: recompiling)"
                )
                cfg = dataclasses.replace(cfg, policy=cfg.policy.with_records("fp32"))
            else:
                _raise_exhausted_trip(word, checks, stats, snap_steps, events, policy,
                                      halvings, regrows)
        else:
            _raise_exhausted_trip(word, checks, stats, snap_steps, events, policy,
                                  halvings, regrows)
        events.append(GuardEvent(step=snap_steps, word=word, checks=checks, action=action,
                                 detail=detail, stats=stats))
        log.warning(
            "health guard tripped %s at step %d (vmax=%.3g rho_dev=%.3g cfl=%.3g): %s — %s",
            checks, snap_steps, stats["vmax"], stats["rho_dev"], stats["cfl"], action, detail)
        return _restore(snap, snap_cfg, cfg, device)

    # Step-0 check: an undersized capacity overflows at the init rebuild.
    hw = _check(cfg, carry, policy)
    while int(hw.word):
        carry = escalate(hw, carry, fault_possible=False)
        hw = _check(cfg, carry, policy)
    snap, snap_cfg = _host_snapshot(carry), cfg

    observe = observe_every > 0
    while steps_done < nsteps:
        n = min(block, nsteps - steps_done)
        carry, hw, row = _guarded_block(cfg, carry, n, policy, observe)
        blocks += 1
        if int(hw.word):
            carry = escalate(hw, carry)
            steps_done = snap_steps
            kept = [r for r in obs_rows if r[0] <= snap_steps]
            dropped_rows += len(obs_rows) - len(kept)
            obs_rows = kept
            continue
        steps_done += n
        if observe:
            obs_rows.append((steps_done, row))
        if blocks % max(1, policy.snapshot_every) == 0:
            snap, snap_cfg, snap_steps = _host_snapshot(carry), cfg, steps_done
            if checkpoint is not None and checkpoint_every and blocks % checkpoint_every == 0:
                checkpoint.save(int(snap.steps), snap)

    # Surface a deferred async-save error before returning.
    if checkpoint is not None:
        checkpoint.wait()
    stats = solver.SimStats(rebuilds=carry.rebuilds, steps=carry.steps,
                            overflow=bool(carry.overflow))
    out = solver.finalize_persistent(cfg, carry)
    report = GuardReport(cfg=cfg, events=events, blocks=blocks, retries=retries,
                         dt_halvings=halvings, regrows=regrows, records_degraded=degraded,
                         dropped_obs_rows=dropped_rows)
    return out, stats, report, [r for _, r in obs_rows]


def _raise_strict(word, checks, stats, step, events, policy):
    raise SimulationDiverged(
        f"health guard (strict) tripped {checks} at step {step}: stats={stats}",
        step=step, checks=checks, word=word, stats=stats, events=events,
    )


def _raise_exhausted(event, step, events, policy):
    raise SimulationDiverged(
        f"health guard: strict policy forbids recovery action "
        f"{event.action!r} ({event.detail})",
        step=step, checks=event.checks, word=event.word, events=events,
    )


def _raise_exhausted_trip(word, checks, stats, step, events, policy, halvings, regrows):
    raise SimulationDiverged(
        f"simulation diverged at step {step}: checks={checks} "
        f"stats={stats}; recovery exhausted (dt halvings "
        f"{halvings}/{policy.max_dt_halvings}, regrows "
        f"{regrows}/{policy.max_regrows})",
        step=step, checks=checks, word=word, stats=stats, events=events,
    )
