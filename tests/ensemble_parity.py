"""Shared parts of the ensemble parity tests (``test_torch_ensemble*.py``):
ports of ``tests/test_ensemble.py``, each case run through the JAX
package and through the port from the same seeded inputs
(``tests/faults.py`` and ``tests/torch_faults.py``, member velocities
perturbed as that file's ``_members`` does).

For every case the member reports match JAX's exactly (status, retries,
dt halvings, dt scale, steps and each event's action, step, checks, word
and detail). Final states that cross packages are compared with fp32
records at ``tests/guard_parity.py``'s tolerances. Every bit-identity
that JAX asserts within JAX (a member against its solo run, a resume
against the uninterrupted run) is asserted within the port, bit for bit.

JAX's ``"xla"`` is held against the port's ``"xla"``, and JAX's
``"pallas"`` (interpret mode) against the port's ``"kernel"`` (the plain
versions of K1 and K2 on the CPU, the lanes folded into one call each).
"""
import dataclasses

import numpy as np
import jax.numpy as jnp
import torch

import faults
import torch_faults
from guard_parity import _close_to_jax, _events
from repro.core import ensemble as jens
from repro.core import recovery as jrec
from repro.core.precision import FP32_RECORDS as J_FP32
from repro_torch.core import ensemble as tens
from repro_torch.core import health as thealth
from repro_torch.core import recovery as trec
from repro_torch.core import solver as tsolver
from repro_torch.core.precision import FP32_RECORDS as T_FP32

XLA = ("xla", "xla")
KERNEL = ("pallas", "kernel")


def member_velocities(v: np.ndarray, B: int, scale: float = 0.01) -> list:
    """B member velocity arrays: #0 unperturbed, the rest with seeded
    perturbations (tests/test_ensemble.py's ``_members``)."""
    out = []
    for i in range(B):
        vi = np.array(v)
        if i:
            rng = np.random.default_rng(100 + i)
            vi = vi + scale * rng.standard_normal(vi.shape).astype(vi.dtype)
        out.append(vi)
    return out


def pair(backends, B, *, fp32=True, **replace):
    """(JAX cfg, JAX member states, port cfg, port member states) of the
    lattice on the given backend pair, with fp32 records unless asked
    otherwise, and the same config changes."""
    cj, sj = faults.lattice()
    ct, st = torch_faults.lattice()
    cj = dataclasses.replace(cj, backend=backends[0], **replace,
                             **({"policy": J_FP32} if fp32 else {}))
    ct = dataclasses.replace(ct, backend=backends[1], **replace,
                             **({"policy": T_FP32} if fp32 else {}))
    vs = member_velocities(np.asarray(sj.fluid.v), B)
    js = [sj._replace(fluid=sj.fluid._replace(v=jnp.asarray(v))) for v in vs]
    ts = [st._replace(fluid=st.fluid._replace(v=torch.as_tensor(v))) for v in vs]
    return cj, js, ct, ts


tsolo = tsolver.simulate  # a member's solo unguarded run: (mcfg, state, nsteps)


def _member(m) -> tuple:
    return (m.status, m.retries, m.dt_halvings, m.dt_scale, m.steps, _events(m.events))


def same_reports(rj, rt) -> None:
    """The two packages' ensemble reports agree member by member."""
    assert [_member(m) for m in rt.members] == [_member(m) for m in rj.members]
    assert (rt.blocks, rt.resumed_from, rt.predecessor, rt.dead_process_detected) == (
        rj.blocks, rj.resumed_from, rj.predecessor, rj.dead_process_detected)
    assert rt.counts() == rj.counts() and rt.healthy == rj.healthy


def run_both(pair_, nsteps, policy_kw, **kw):
    """run_ensemble in both packages on one pair; returns the port's
    (mcfg, outs, stats, report) after checking the reports agree and the
    final states cross packages within tolerance."""
    cj, js, ct, ts = pair_
    jkw, tkw = dict(kw), dict(kw)
    if kw.get("fault") is not None:
        jkw["fault"] = kw["fault"]
        tkw["fault"] = thealth.FaultSpec(**dataclasses.asdict(kw["fault"]))
    jp, tp = jrec.GuardPolicy(**policy_kw), trec.GuardPolicy(**policy_kw)
    jm, tm = jens.member_config(cj, jp), tens.member_config(ct, tp)
    oj, sj, rj = jens.run_ensemble(jm, js, nsteps, jp, **jkw)
    ot, st, rt = tens.run_ensemble(tm, ts, nsteps, tp, **tkw)
    same_reports(rj, rt)
    assert [s.steps for s in st] == [int(s.steps) for s in sj]
    for a, b, m in zip(oj, ot, rt.members):
        _close_to_jax(jm, a, tm, b, m.steps)
    return tm, ot, st, rt
