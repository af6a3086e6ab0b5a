"""The system under test: the port's SPH main path (``repro_torch``), driven
as its users drive it. Everything the benchmark asks of the program goes
through this file: the configuration, the persistent pipeline's entry
points, its counters and the spans around its layers.

    carry = solver.init_persistent(cfg, solver.init_state(cfg, ...))
    carry = solver.step_persistent(cfg, carry)   # the window, step by step
    state = solver.finalize_persistent(cfg, carry)
"""
from __future__ import annotations

import contextlib
import dataclasses
import math

import torch

from repro_torch.core import cases, solver
from repro_torch.kernels import _build, cell_pack, rcll_force

#: The fields of a state the comparison reads, in the program's packed order.
STEP_FIELDS = ("cell", "rel", "v", "rho", "order")
START_FIELDS = STEP_FIELDS + ("m", "kind")


def build_library():
    """The kernel library, built with nvcc on first use into the
    checkout's ``build/repro_torch/``; (path, seconds the build took)."""
    lib = _build.library()
    return str(lib.path), lib.build_seconds


def make_config(conf: dict, work: dict) -> solver.SPHConfig:
    """The program's configuration: the registered case's domain, time
    step and scheme at the configuration's spacing, with the cell's
    ``cell_factor`` and Verlet skin (in search radii). Raises where the
    case disagrees with what the configuration's file states."""
    case = cases.build_case(conf["case"], ds=conf["ds"], **conf["case_args"])
    sch = case.scheme()
    ph = conf["physics"]
    stated = {"dt": ph["dt"], "c0": ph["c0"], "rho0": ph["rho0"], "eos": ph["eos"],
              "mu": ph["mu"], "alpha": ph["alpha"], "delta": ph["delta"],
              "h": ph["h_over_ds"] * conf["ds"]}
    found = {"dt": case.dt, "c0": sch.c0, "rho0": sch.rho0, "eos": sch.eos,
             "mu": sch.mu if sch.viscosity == "morris" else 0.0, "alpha": sch.alpha,
             "delta": sch.delta, "h": case.h}
    if sch.eos == "tait":
        stated["gamma"], found["gamma"] = ph["gamma"], sch.gamma
    for key, want in stated.items():
        got = found[key]
        if got != want and not (isinstance(want, float) and math.isclose(got, want, rel_tol=1e-12)):
            raise ValueError(f"{conf['name']}: the case's {key} is {got!r}, the file states {want!r}")
    dom = case.domain()
    if tuple(dom.lo) != tuple(conf["box"]["lo"]) or tuple(dom.hi) != tuple(conf["box"]["hi"]):
        raise ValueError(f"{conf['name']}: the case's box {dom.lo}-{dom.hi} is not the file's")
    dom = dataclasses.replace(dom, cell_factor=work["cell_factor"])
    policy = dataclasses.replace(case.policy, **conf["policy"])
    body = tuple(ph["body_force"])
    return solver.SPHConfig(
        domain=dom, ds=conf["ds"], dt=case.dt, rho0=sch.rho0, c0=sch.c0,
        mu=found["mu"], body_force=body, max_neighbors=case.max_neighbors,
        policy=policy, scheme=sch, wall_rho_clamp=ph["wall_rho_clamp"],
        skin=work["skin_radii"] * 2.0 * case.h, backend="kernel")


def start(cfg: solver.SPHConfig, inputs: dict, device):
    """init_state from the harness's inputs, then init_persistent (the
    first pack)."""
    state = solver.init_state(cfg, inputs["x"], inputs["v"], inputs["m"], inputs["rho"],
                              kind=inputs["kind"], device=device)
    return solver.init_persistent(cfg, state)


def step(cfg: solver.SPHConfig, carry):
    return solver.step_persistent(cfg, carry)


def rebuild(cfg: solver.SPHConfig, carry):
    """One rebuild of the carry, as a step makes when its skin is spent."""
    return solver._rebuild(cfg, carry)


def finish(cfg: solver.SPHConfig, carry) -> dict:
    """finalize_persistent: the state back in the inputs' order."""
    st = solver.finalize_persistent(cfg, carry)
    return {"cell": st.rc.cell_xy, "rel": st.rc.rel, "v": st.fluid.v, "rho": st.fluid.rho,
            "m": st.fluid.m, "kind": st.kind}


def fields(carry, names=STEP_FIELDS) -> dict:
    """The carry's per-particle tensors the comparison reads."""
    st = carry.st
    every = {"cell": st.rc.cell_xy, "rel": st.rc.rel, "v": st.fluid.v, "rho": st.fluid.rho,
             "order": carry.order, "m": st.fluid.m, "kind": st.kind}
    return {k: every[k] for k in names}


def counters(carry) -> dict:
    """The program's own counts: rebuilds and steps of the carry, whether a
    cell table overflowed, and K1/K2 launches since the process began."""
    return {"rebuilds": carry.rebuilds, "steps": carry.steps,
            "overflow": bool(carry.overflow),
            "k1_launches": cell_pack.cell_tables.launches,
            "k2_launches": rcll_force.rcll_force.launches}


@contextlib.contextmanager
def layer_spans(prefix: str = "portbench."):
    """``record_function`` spans around the rebuild (``solver._rebuild``)
    and the force pass (``solver._physics_step``), which step_persistent
    calls by name; restored on exit."""
    wrapped = {}

    def span(name, fn):
        def inner(*args, **kw):
            with torch.profiler.record_function(prefix + name):
                return fn(*args, **kw)
        return inner

    for name, attr in (("rebuild", "_rebuild"), ("physics", "_physics_step")):
        wrapped[attr] = getattr(solver, attr)
        setattr(solver, attr, span(name, wrapped[attr]))
    try:
        yield
    finally:
        for attr, fn in wrapped.items():
            setattr(solver, attr, fn)
