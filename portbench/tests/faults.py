"""Faults planted in the timed path, each through a ``monkeypatch``
(pytest's): the step returns its state unchanged; half of the particles'
rates are left out; a velocity is altered where it is produced, or left
NaN; the density rate (the continuity sum with its delta-SPH term) is dropped;
delta-SPH is switched off; a rebuild after the first pack swaps two
particles' velocities.
The CPU tests plant them at a tiny size, ``control.py --fault`` at the
cell's own."""
from __future__ import annotations

import dataclasses


def _solver():
    from repro_torch.core import solver

    return solver


def unchanged(monkeypatch):
    solver = _solver()
    monkeypatch.setattr(solver, "_physics_step",
                        lambda cfg, carry, dt=None: carry._replace(steps=carry.steps + 1))


def _wrap_force(monkeypatch, edit):
    solver = _solver()
    force = solver._FORCE_BACKENDS["kernel"]

    def faulty(cfg, carry):
        drho, acc = force(cfg, carry)
        edit(drho, acc)
        return drho, acc

    monkeypatch.setitem(solver._FORCE_BACKENDS, "kernel", faulty)


def half_left_out(monkeypatch):
    def edit(drho, acc):
        n = drho.shape[0] // 2
        drho[n:] = 0.0
        acc[n:] = 0.0

    _wrap_force(monkeypatch, edit)


def density_rate_dropped(monkeypatch):
    _wrap_force(monkeypatch, lambda drho, acc: drho.zero_())


def answer_altered(monkeypatch):
    solver = _solver()
    step = solver._physics_step

    def altered(cfg, carry, dt=None):
        out = step(cfg, carry, dt)
        v = out.st.fluid.v
        v[v.norm(dim=1).argmax()] *= 1.01
        return out

    monkeypatch.setattr(solver, "_physics_step", altered)


def state_not_finite(monkeypatch):
    """A step leaves a NaN velocity, as a run that diverges does."""
    solver = _solver()
    step = solver._physics_step

    def diverged(cfg, carry, dt=None):
        out = step(cfg, carry, dt)
        out.st.fluid.v[0] = float("nan")
        return out

    monkeypatch.setattr(solver, "_physics_step", diverged)


def delta_sph_off(monkeypatch):
    from portbench import program

    make = program.make_config

    def no_delta(conf, work):
        cfg = make(conf, work)
        return dataclasses.replace(cfg, scheme=dataclasses.replace(cfg.scheme, delta=0.0))

    monkeypatch.setattr(program, "make_config", no_delta)


def rebuild_swaps(monkeypatch):
    """Every rebuild but the first pack's swaps two velocities."""
    solver = _solver()
    rebuild = solver._rebuild
    calls = [0]

    def swapped(cfg, carry):
        out = rebuild(cfg, carry)
        calls[0] += 1
        if calls[0] == 1:
            return out
        v = out.st.fluid.v
        speed = v.norm(dim=1)
        i, j = int(speed.argmax()), int(speed.argmin())
        v[[i, j]] = v[[j, i]]
        return out

    monkeypatch.setattr(solver, "_rebuild", swapped)


ALL = {f.__name__: f for f in (unchanged, half_left_out, answer_altered,
                               density_rate_dropped, state_not_finite, delta_sph_off,
                               rebuild_swaps)}
