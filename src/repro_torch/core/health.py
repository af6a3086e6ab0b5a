"""Simulation health bits, the observable row and the divergence error.

Port of the parts of ``repro.core.health`` the unguarded persistent
pipeline uses. The in-scan health word, fault injection and the
recovery ladder are ROADMAP Queue 1 item 6.
"""
from __future__ import annotations

import torch

NAN_X = 1 << 0  # non-finite relative coordinates
NAN_V = 1 << 1  # non-finite velocity component
NAN_RHO = 1 << 2  # non-finite density
RHO_DEV = 1 << 3  # |rho/rho0 - 1| beyond the weak-compressibility bound
CFL = 1 << 4  # vmax * dt / h beyond the advective CFL bound
WINDOW_TRUNC = 1 << 5  # neighbor list truncated (window or K budget)
CELL_OVERFLOW = 1 << 6  # cell table dropped particles (capacity)

# The capacity bits, reported by the strict overflow check.
CAPACITY_CHECKS = WINDOW_TRUNC | CELL_OVERFLOW


class SimulationDiverged(RuntimeError):
    """A run failed a strict check (``SPHConfig.check_overflow``).

    step: last healthy step count, checks: names of the tripped checks,
    word: the raw bitmask, stats: offending-field stats, events: the
    recovery actions attempted before giving up.
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


def fold_flag(flags: torch.Tensor | None, cond: torch.Tensor, bit: int):
    """OR ``bit`` into an accumulated int32 flag word where ``cond``."""
    if flags is None:
        return None
    return flags | torch.where(cond, bit, 0).to(flags.dtype)


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
