"""Simulation health word and deterministic fault injection.

Port of ``repro.core.health``:

  * a small bitmask of health checks (non-finite x/v/rho, density
    deviation beyond the weak-compressibility bound, vmax*dt/h CFL
    violation, neighbor-window truncation, cell-capacity overflow);
  * :func:`check_carry`, one reduction over the persistent carry into a
    :class:`HealthWord` of device scalars (the bitmask plus the
    offending-field stats); nothing is read to the host until the
    guarded-block runner reads the word at a block boundary;
  * :class:`FaultSpec` + :func:`inject_fault`, the deterministic fault
    hook of the recovery tests (``SPHConfig.fault``);
  * :class:`SimulationDiverged`, the structured failure raised when a
    recovery policy is exhausted.

The escalation machinery that consumes the word lives in
``core/recovery.py``; this module imports nothing from the solver.

The port's flag word is int32 (JAX's is uint32): the bits reach only
``1 << 6``. The carry's step counter is a host int, so a fault's trip
is decided on the host.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

NAN_X = 1 << 0  # non-finite relative coordinates
NAN_V = 1 << 1  # non-finite velocity component
NAN_RHO = 1 << 2  # non-finite density
RHO_DEV = 1 << 3  # |rho/rho0 - 1| beyond the weak-compressibility bound
CFL = 1 << 4  # vmax * dt / h beyond the advective CFL bound
WINDOW_TRUNC = 1 << 5  # neighbor list truncated (window or K budget)
CELL_OVERFLOW = 1 << 6  # cell table dropped particles (capacity)

ALL_CHECKS = NAN_X | NAN_V | NAN_RHO | RHO_DEV | CFL | WINDOW_TRUNC | CELL_OVERFLOW
#: The bits that dt backoff can plausibly cure (numeric blowups).
NUMERIC_CHECKS = NAN_X | NAN_V | NAN_RHO | RHO_DEV | CFL
#: The bits cured by regrowing capacities.
CAPACITY_CHECKS = WINDOW_TRUNC | CELL_OVERFLOW

CHECK_NAMES = (
    (NAN_X, "nan_x"),
    (NAN_V, "nan_v"),
    (NAN_RHO, "nan_rho"),
    (RHO_DEV, "rho_dev"),
    (CFL, "cfl"),
    (WINDOW_TRUNC, "window_trunc"),
    (CELL_OVERFLOW, "cell_overflow"),
)

# Default thresholds: the WCSPH design point is |drho/rho0| ~ (v/c0)^2
# (~1% at Ma 0.1), so 25% is divergence; a healthy acoustic-CFL run sits
# at vmax*dt/h ~ 0.025, so 0.5 means velocities blew up ~20x.
DEFAULT_RHO_DEV_LIMIT = 0.25
DEFAULT_CFL_LIMIT = 0.5


def check_names(word: int) -> tuple[str, ...]:
    """Names of the set bits of a host health word."""
    return tuple(name for bit, name in CHECK_NAMES if word & bit)


class SimulationDiverged(RuntimeError):
    """A guarded run exhausted its recovery policy (or a strict check hit).

    step: last healthy step count (the rollback point), checks: names of
    the tripped checks, word: the raw bitmask, stats: offending-field
    stats at detection, events: the recovery actions attempted before
    giving up.
    """

    def __init__(self, message: str, *, step: int | None = None,
                 checks: tuple[str, ...] = (), word: int = 0,
                 stats: dict | None = None, events: list | None = None):
        super().__init__(message)
        self.step = step
        self.checks = tuple(checks)
        self.word = int(word)
        self.stats = dict(stats or {})
        self.events = list(events or [])


class HealthWord(NamedTuple):
    """The health reduction: bitmask + offending-field stats, as device
    scalars. Stats mask non-finite entries out, so they stay meaningful
    under NaN poisoning (the non-finite counts carry that signal)."""

    word: torch.Tensor  # () int32 tripped-check bitmask
    vmax: torch.Tensor  # () fp32 max fluid |v| (finite entries only)
    rho_dev: torch.Tensor  # () fp32 max fluid |rho/rho0 - 1| (finite only)
    cfl: torch.Tensor  # () fp32 vmax * dt / h
    bad_x: torch.Tensor  # () int32 particles with non-finite coordinates
    bad_v: torch.Tensor  # () int32 particles with non-finite velocity
    bad_rho: torch.Tensor  # () int32 particles with non-finite density
    max_count: torch.Tensor  # () int32 max neighbor count seen
    max_cell: torch.Tensor  # () int32 max cell occupancy at last rebuild

    def host_stats(self) -> dict:
        """The stats as a plain host dict (for logs / SimulationDiverged)."""
        return {
            "vmax": float(self.vmax),
            "rho_dev": float(self.rho_dev),
            "cfl": float(self.cfl),
            "bad_x": int(self.bad_x),
            "bad_v": int(self.bad_v),
            "bad_rho": int(self.bad_rho),
            "max_count": int(self.max_count),
            "max_cell": int(self.max_cell),
        }


def _bit(cond: torch.Tensor, bit: int) -> torch.Tensor:
    return torch.where(cond, bit, 0).to(torch.int32)


def fold_flag(flags: torch.Tensor | None, cond: torch.Tensor, bit: int):
    """OR ``bit`` into an accumulated int32 flag word where ``cond``."""
    if flags is None:
        return None
    return flags | _bit(cond, bit).to(flags.dtype)


def check_carry(cfg, carry, *, rho_dev_limit: float = DEFAULT_RHO_DEV_LIMIT,
                cfl_limit: float = DEFAULT_CFL_LIMIT, enabled: int = ALL_CHECKS,
                dt: torch.Tensor | float | None = None) -> HealthWord:
    """One health reduction over a persistent carry (no host read).

    Numeric checks read the packed state; the overflow checks fold the
    carry's accumulated ``flags`` (set at rebuild time, so an overflow in
    any rebuild of the block is seen) with the live neighbor-list and
    binning sentinels. ``enabled`` masks the final word. ``dt`` overrides
    ``cfg.dt`` in the CFL term. ``cfg``/``carry`` are duck-typed.
    """
    st = carry.st
    fl = st.fluid
    fluid = ~st.fixed

    x_fin = torch.all(torch.isfinite(st.rc.rel), dim=-1)
    v_fin = torch.all(torch.isfinite(fl.v), dim=-1)
    rho_fin = torch.isfinite(fl.rho)
    bad_x = torch.sum(~x_fin).to(torch.int32)
    bad_v = torch.sum(~v_fin).to(torch.int32)
    bad_rho = torch.sum(~rho_fin).to(torch.int32)

    # Mask before the max: torch.max propagates NaN.
    v2 = torch.sum(fl.v.to(torch.float32) ** 2, dim=-1)
    zero = torch.zeros((), dtype=torch.float32, device=v2.device)
    vmax = torch.sqrt(torch.max(torch.where(fluid & v_fin, v2, zero)))
    rho0 = cfg.resolved_scheme.rho0
    dev = torch.abs(fl.rho.to(torch.float32) / rho0 - 1.0)
    rho_dev = torch.max(torch.where(fluid & rho_fin, dev, zero))
    cfl = vmax * ((cfg.dt if dt is None else dt) / cfg.h)

    nl = carry.nl
    k = nl.mask.shape[1]
    win_bad = torch.any(nl.count > k)
    if nl.trunc is not None:
        win_bad = win_bad | nl.trunc
    max_count = torch.max(nl.count).to(torch.int32)
    if carry.binning is not None:
        cell_bad = carry.binning.overflow > 0
        max_cell = torch.max(carry.binning.counts).to(torch.int32)
    else:
        cell_bad = torch.zeros((), dtype=torch.bool, device=v2.device)
        max_cell = torch.zeros((), dtype=torch.int32, device=v2.device)

    word = (_bit(bad_x > 0, NAN_X) | _bit(bad_v > 0, NAN_V) | _bit(bad_rho > 0, NAN_RHO)
            | _bit(rho_dev > rho_dev_limit, RHO_DEV) | _bit(cfl > cfl_limit, CFL)
            | _bit(win_bad, WINDOW_TRUNC) | _bit(cell_bad, CELL_OVERFLOW))
    if carry.flags is not None:
        word = word | carry.flags.to(torch.int32)
    word = word & enabled
    return HealthWord(word=word, vmax=vmax, rho_dev=rho_dev, cfl=cfl, bad_x=bad_x,
                      bad_v=bad_v, bad_rho=bad_rho, max_count=max_count, max_cell=max_cell)


def _lane(tree, b: int):
    """Lane ``b`` of a batch-leading tree (NamedTuples of tensors; None
    and host values pass through)."""
    if isinstance(tree, torch.Tensor):
        return tree[b]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_lane(v, b) for v in tree))
    return tree


def check_batch(cfg, carry, *, rho_dev_limit: float = DEFAULT_RHO_DEV_LIMIT,
                cfl_limit: float = DEFAULT_CFL_LIMIT, enabled: int = ALL_CHECKS,
                dt: torch.Tensor | None = None) -> HealthWord:
    """:func:`check_carry` over a stacked carry whose every tensor has a
    leading batch axis: a :class:`HealthWord` of (B,) vectors, one word
    and its stats per lane, so a batch costs one host read. ``dt`` is an
    optional (B,) per-lane timestep. Loops over the lanes."""
    kw = dict(rho_dev_limit=rho_dev_limit, cfl_limit=cfl_limit, enabled=enabled)
    lanes = carry.order.shape[0]
    words = [check_carry(cfg, _lane(carry, b), dt=None if dt is None else dt[b], **kw)
             for b in range(lanes)]
    return HealthWord(*(torch.stack(col) for col in zip(*words)))


def observe_state(cfg, st):
    """One observable row (t, ekin, vmax, rho_err) over fluid particles,
    as device scalars (nothing is read to the host)."""
    fl = st.fluid
    fluid = ~st.fixed
    w = fluid.to(torch.float32)
    v2 = torch.sum(fl.v * fl.v, dim=-1)
    rho0 = cfg.resolved_scheme.rho0
    zero = torch.zeros_like(v2)
    return (
        st.t,
        0.5 * torch.sum(w * fl.m * v2),
        torch.sqrt(torch.max(torch.where(fluid, v2, zero))),
        torch.max(torch.where(fluid, torch.abs(fl.rho / rho0 - 1.0), zero)),
    )


# --------------------------------------------------------------------------
# Deterministic fault injection
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """A deterministic fault, armed via ``SPHConfig.fault``.

    It fires when the carry's step counter equals ``step``, and again on
    every rolled-back retry that replays that step (a persistent fault);
    the recovery policy's ``disarm_faults`` models the transient kind by
    stripping the spec after the first trip.

    kinds:
      "nan_v":    poison velocity component 0 of packed particle
                  ``particle`` with NaN.
      "teleport": move packed particle ``particle`` next to packed
                  particle ``target`` and give it the apparent velocity
                  of the jump (``vkick``), so the overlap detonates the
                  density through the relative motion.
    """

    kind: str
    step: int
    particle: int = 0
    target: int = 1
    vkick: float = 8.0

    def __post_init__(self):
        if self.kind not in ("nan_v", "teleport"):
            raise ValueError(f"unknown fault kind {self.kind!r}")


def inject_fault(fault: FaultSpec, carry):
    """Apply ``fault`` to the carry when its step counter matches.

    Indices are in packed order (deterministic for a fixed trajectory; a
    rollback restores the same packing, so retries replay the same
    fault). The fields it changes are copied, never written in place.
    """
    if carry.steps != fault.step:
        return carry
    st, fl = carry.st, carry.st.fluid
    p = fault.particle
    v = fl.v.clone()
    if fault.kind == "nan_v":
        v[p, 0] = float("nan")
        return carry._replace(st=st._replace(fluid=fl._replace(v=v)))
    # teleport: adopt the target's cell + relative coords plus an offset
    # in the steep region of the kernel gradient (added in the storage
    # dtype), and spike the accumulated displacement so the Verlet
    # criterion rebuilds in this step: the overlap must enter the tables.
    rc = st.rc
    q = fault.target
    rel = rc.rel.clone()
    rel[p] = rc.rel[q] + torch.tensor(0.2, dtype=rc.rel.dtype)
    cxy = rc.cell_xy.clone()
    cxy[p] = rc.cell_xy[q]
    disp = carry.disp_acc.clone()
    disp[p] = 1.0
    v[p, 0] = fault.vkick
    return carry._replace(
        st=st._replace(rc=rc._replace(rel=rel, cell_xy=cxy), fluid=fl._replace(v=v)),
        disp_acc=disp,
    )
