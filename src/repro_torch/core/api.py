"""Public simulation facade: ``Simulation`` + sampled ``Observables``.

Port of ``repro.core.api``:

    sim = Simulation.from_case("taylor_green", ds=1/32)   # on CUDA
    res = sim.run(nsteps=600, observe_every=20)
    res.observables.ekin  # (S,) tensor on the simulation's device

Observable rows (t, ekin, vmax, rho_err over fluid particles) are
computed on the device every ``observe_every`` steps and stacked when
the run returns; none is read to the host during the run.
"""
from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple

import torch

from repro_torch.core import cases as cases_lib
from repro_torch.core import solver
from repro_torch.core.health import observe_state


class Observables(NamedTuple):
    """Time series of diagnostics, one row per sample."""

    t: torch.Tensor  # (S,) fp32 simulation time at the sample
    ekin: torch.Tensor  # (S,) fp32 total fluid kinetic energy
    vmax: torch.Tensor  # (S,) fp32 max fluid |v|
    rho_err: torch.Tensor  # (S,) fp32 max fluid |rho/rho0 - 1|


class SimResult(NamedTuple):
    state: solver.SPHState  # final state, original particle indexing
    stats: solver.SimStats
    observables: Observables | None


@dataclasses.dataclass
class Simulation:
    """Stateful front end to one (SPHConfig, SPHState) pair; ``run``
    advances the held state and returns a :class:`SimResult`."""

    cfg: solver.SPHConfig
    state: solver.SPHState
    case: object | None = None  # the case that built this, if any

    @classmethod
    def from_case(cls, name_or_case, device=None, **overrides) -> "Simulation":
        """Build from a registered case name (or a case instance) on
        ``device`` — CUDA when None; raises if CUDA is missing then."""
        case = (
            cases_lib.build_case(name_or_case, **overrides)
            if isinstance(name_or_case, str)
            else name_or_case
        )
        cfg, state = case.build(device=solver.resolve_device(device))
        return cls(cfg=cfg, state=state, case=case)

    @property
    def n_particles(self) -> int:
        return int(self.state.xn.shape[0])

    def run(self, nsteps: int, observe_every: int = 0, guard=None) -> SimResult:
        """Advance ``nsteps`` steps; sample observables every ``observe_every``.

        ``observe_every=0`` disables sampling (exactly
        ``solver.simulate_stats``). Otherwise the run takes ``nsteps``
        rounded DOWN to a whole number of sample blocks (at least one).
        ``guard`` (the health guard) is not ported yet.
        """
        if guard:
            raise NotImplementedError(
                "guard= is not ported yet: ROADMAP Queue 1 item 6 (health "
                "guard and recovery)"
            )
        cfg = self.cfg
        if observe_every <= 0:
            out, stats = solver.simulate_stats(cfg, self.state, nsteps)
            self.state = out
            return SimResult(out, stats, None)
        every = min(observe_every, nsteps)
        nblocks = max(1, nsteps // every)
        carry = solver.init_persistent(cfg, self.state)
        rows = []
        for _ in range(nblocks):
            carry = solver.run_persistent(cfg, carry, every)
            rows.append(observe_state(cfg, carry.st))
        obs = Observables(*(torch.stack(col) for col in zip(*rows)))
        stats = solver.SimStats(rebuilds=carry.rebuilds, steps=carry.steps,
                                overflow=bool(carry.overflow))
        out = solver.finalize_persistent(cfg, carry)
        self.state = out
        return SimResult(out, stats, obs)

    def run_timed(self, nsteps: int, observe_every: int = 0,
                  guard=None) -> tuple[SimResult, float]:
        """``run`` twice (the first warms up the kernels and allocator)
        and report steps/sec of the second; returns its SimResult."""
        dev = self.state.xn.device
        self.run(nsteps, observe_every, guard=guard)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        res = self.run(nsteps, observe_every, guard=guard)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt_wall = time.perf_counter() - t0
        return res, res.stats.steps / dt_wall
