"""The port's counterparts of ``tests/faults.py``: the same small CPU
(cfg, state) pairs, built by ``repro_torch`` from the same numpy inputs,
so each health-guard test can run one input through both packages.
Torch only (no JAX)."""
from __future__ import annotations

import dataclasses
import itertools

import numpy as np

from repro_torch.core import cases as cases_lib
from repro_torch.core import health, solver
from repro_torch.core.domain import Domain


def lattice(cfg_kw=None, *, ds=0.05, h=0.1, seed=0, vel=0.05, device="cpu"):
    """Periodic unit-box lattice with small random velocities (~400
    particles), as ``faults.lattice``."""
    dom = Domain(lo=(0.0, 0.0), hi=(1.0, 1.0), h=h, periodic=(True, True))
    xs = np.arange(ds / 2, 1.0, ds)
    x = np.array(list(itertools.product(xs, xs)))
    n = len(x)
    rng = np.random.default_rng(seed)
    v = vel * rng.standard_normal((n, 2)).astype(np.float32)
    m = np.full(n, ds * ds, np.float32)
    rho = np.ones(n, np.float32)
    cfg = solver.SPHConfig(domain=dom, ds=ds, dt=1e-3, algo="rcll", max_neighbors=64,
                           **(cfg_kw or {}))
    return cfg, solver.init_state(cfg, x, v, m, rho, device=device)


def dam_break(device="cpu", **case_kw):
    """Coarse dam break (~300 particles incl. walls), as ``faults.dam_break``."""
    return cases_lib.build_case("dam_break", ds=0.1, **case_kw).build(device=device)


def thin_grid(ncells_x=2200, ds=0.05, h=0.1, cfg_kw=None, device="cpu"):
    """The long thin aperiodic domain past the fp16 half-record anchor
    limit (2^11 cells), as ``faults.thin_grid``."""
    hi_x = ncells_x * 2 * h
    dom = Domain(lo=(0.0, 0.0), hi=(hi_x, 3 * h), h=h, periodic=(False, False))
    xs = np.arange(ds / 2, 10 * h, ds)
    ys = np.arange(ds / 2, 3 * h, ds)
    x = np.array(list(itertools.product(xs, ys)))
    n = len(x)
    cfg = solver.SPHConfig(domain=dom, ds=ds, dt=1e-4, algo="rcll", max_neighbors=64,
                           **(cfg_kw or {}))
    rho = np.ones(n, np.float32)
    m = np.full(n, ds * ds, np.float32)
    return cfg, solver.init_state(cfg, x, np.zeros((n, 2)), m, rho, device=device)


def with_fault(cfg, **fault_kw):
    return dataclasses.replace(cfg, fault=health.FaultSpec(**fault_kw))
