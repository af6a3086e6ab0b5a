"""Port parity, the slice end to end: ``simulate_stats`` of the port (on
the CPU, through the plain versions of K1/K2) against the JAX package's
``backend="pallas"`` (Pallas in interpret mode), from bit-identical
initial states.

Tolerances:
  * fp32 records: the ``tests/test_fused_force.py:353-355`` tolerances
    (positions 1e-6, density 1e-6). Velocity: jitted XLA contracts fp32
    multiply-adds, so one force pass agrees only to the
    ``rounding_bound`` of the pair sums, ~1e-5·|acc| with |acc| ~ 5 for
    taylor_green (c0 = 10); over ``nsteps`` steps of ``dt`` that is
    nsteps·dt·1e-4, which replaces :354's 1e-7 (set for a Poiseuille
    flow moving at |v| ~ 1e-2, not taylor_green's |v| ~ 1).
  * skinned dam break: the ``:481`` tolerance (1e-4) with equal rebuild
    counts.
  * fp16 records: the same quantization in both packages (v → fp16,
    m/mean(m) → fp16), so the fp32-records bound applies plus the
    half-width mass normalizer, which the port takes in float64 (one
    fp32 ulp, 6e-8 relative, on every force): nsteps·dt·(1e-4 +
    6e-8·|acc|max) on v. Positions: 1e-6 plus one storage quantum of the
    fp16 cell-relative coordinate (hc/2 · 2^-10): a velocity difference
    inside its bound may flip one rounding of the stored coordinate,
    which moves that particle by exactly one quantum.

chip_smoke.py's kernel-vs-plain run on the card (phase 5) holds fp32
records to the fp32-records tolerances here and fp16 records to the
fp16-records position and density tolerances; its fp16 velocity limit is
set from readings (see the phase).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import cases as jcases
from repro.core import solver as jsolver
from repro.core.precision import FP32_RECORDS as J_FP32
from repro_torch.core import api as tapi
from repro_torch.core import cases as tcases
from repro_torch.core import solver as tsolver
from repro_torch.core.precision import FP32_RECORDS as T_FP32
from test_torch_helpers import one_torch_thread  # noqa: F401  (autouse fixture)


def _run_both(name, nsteps, j_kw, t_kw):
    cj, sj = jcases.build_case(name, backend="pallas", **j_kw).build()
    ct, st = tcases.build_case(name, **t_kw).build(device="cpu")
    oj, statj = jsolver.simulate_stats(cj, sj, nsteps)
    ot, statt = tsolver.simulate_stats(ct, st, nsteps)
    out = {
        "pos": (np.asarray(jsolver.positions(cj, oj)), tsolver.positions(ct, ot).numpy()),
        "v": (np.asarray(oj.fluid.v), ot.fluid.v.numpy()),
        "rho": (np.asarray(oj.fluid.rho), ot.fluid.rho.numpy()),
    }
    return cj, out, (int(statj.rebuilds), statt.rebuilds), (bool(statj.overflow), statt.overflow)


def test_taylor_green_fp32_records_matches_jax():
    nsteps = 10
    cfg, out, rebuilds, overflow = _run_both(
        "taylor_green", nsteps, dict(ds=1 / 16, policy=J_FP32), dict(ds=1 / 16, policy=T_FP32))
    assert rebuilds[0] == rebuilds[1] and overflow == (False, False)
    np.testing.assert_allclose(out["pos"][1], out["pos"][0], atol=1e-6)
    np.testing.assert_allclose(out["rho"][1], out["rho"][0], atol=1e-6)
    np.testing.assert_allclose(out["v"][1], out["v"][0], atol=nsteps * cfg.dt * 1e-4)


def test_taylor_green_default_fp16_records_matches_jax():
    nsteps = 10
    cfg, out, rebuilds, _ = _run_both(
        "taylor_green", nsteps, dict(ds=1 / 16), dict(ds=1 / 16))
    assert rebuilds[0] == rebuilds[1]
    acc_max = 10.0  # |acc| <= 5.6 on this state (c0² ∇ρ/ρ); 2x margin
    quantum = max(cfg.domain.cell_sizes) / 2 * 2.0**-10
    np.testing.assert_allclose(out["pos"][1], out["pos"][0], atol=1e-6 + quantum)
    np.testing.assert_allclose(out["rho"][1], out["rho"][0], atol=1e-6)
    np.testing.assert_allclose(
        out["v"][1], out["v"][0], atol=nsteps * cfg.dt * (1e-4 + 6e-8 * acc_max))


def test_skinned_dam_break_matches_jax_with_rebuilds():
    """The dynamic dam break of tests/test_fused_force.py:460: Verlet
    skin, dropped-column start, stale-binning steps between rebuilds."""
    ds = 0.1
    radius = 2.0 * tcases.build_case("dam_break", ds=ds).h
    kw = dict(ds=ds, cell_factor=1.5, skin=0.125 * radius, v0=1.0)
    _, out, rebuilds, overflow = _run_both(
        "dam_break", 40, dict(kw, policy=J_FP32, max_neighbors=64), dict(kw, policy=T_FP32))
    assert rebuilds[0] == rebuilds[1] and rebuilds[1] >= 2, rebuilds
    assert overflow == (False, False)
    np.testing.assert_allclose(out["pos"][1], out["pos"][0], atol=1e-4)


def test_observed_run_matches_simulate_and_chained_segments():
    kw = dict(ds=0.1, cell_factor=1.5, v0=1.0, skin=0.25 * 2.0 * 1.2 * 0.1)
    cfg, st = tcases.build_case("dam_break", **kw).build(device="cpu")
    want, stats = tsolver.simulate_stats(cfg, st, 24)
    sim = tapi.Simulation.from_case("dam_break", device="cpu", **kw)
    res = sim.run(24, observe_every=8)
    assert res.observables.ekin.shape == (3,) and torch.all(torch.isfinite(res.observables.ekin))
    assert res.stats == stats and sim.state is res.state
    carry = tsolver.init_persistent(cfg, st)
    for _ in range(3):
        carry = tsolver.run_persistent(cfg, carry, 8)
    got = tsolver.finalize_persistent(cfg, carry)
    for a, b in [(res.state, want), (got, want)]:
        assert torch.equal(a.fluid.v, b.fluid.v) and torch.equal(a.fluid.rho, b.fluid.rho)
        assert torch.equal(a.rc.rel, b.rc.rel) and torch.equal(a.rc.cell_xy, b.rc.cell_xy)
    # the input state is left untouched by the in-place carry updates
    cfg2, st2 = tcases.build_case("dam_break", **kw).build(device="cpu")
    assert torch.equal(st.fluid.v, st2.fluid.v) and torch.equal(st.rc.rel, st2.rc.rel)


def test_static_rebuild_cadence():
    """``rebuild_every`` (the Poiseuille case's knob) replaces the skin
    criterion: the init pack plus one rebuild every 3 steps."""
    cfg, st = tcases.build_case("poiseuille", ds=0.1, Lx=0.8, rebuild_every=3).build(device="cpu")
    _, stats = tsolver.simulate_stats(cfg, st, 7)
    assert (stats.rebuilds, stats.steps) == (3, 7)
    cfg0 = dataclasses.replace(cfg, rebuild_every=None)  # skin 0: every step moves
    assert tsolver.simulate_stats(cfg0, st, 7)[1].rebuilds == 7


def test_unported_options_raise():
    cfg, st = tcases.build_case("taylor_green", ds=1 / 16).build(device="cpu")
    for be, item in [("reference", "item 4b"), ("xla", "item 5")]:
        with pytest.raises(NotImplementedError, match=item):
            tsolver.simulate(dataclasses.replace(cfg, backend=be), st, 1)
    with pytest.raises(ValueError, match="unknown backend"):
        tsolver.simulate(dataclasses.replace(cfg, backend="pallas"), st, 1)
    with pytest.raises(NotImplementedError, match="algo"):
        tsolver.simulate(dataclasses.replace(cfg, algo="cell"), st, 1)
    sim = tapi.Simulation.from_case("taylor_green", device="cpu", ds=1 / 16)
    with pytest.raises(NotImplementedError, match="item 6"):
        sim.run(2, guard=True)


def test_check_overflow_raises_on_undersized_cells():
    cfg, st = tcases.build_case("taylor_green", ds=1 / 16, check_overflow=True).build(device="cpu")
    from repro_torch.core.health import SimulationDiverged
    with pytest.raises(SimulationDiverged, match="overflow"):
        tsolver.simulate_stats(dataclasses.replace(cfg, capacity=2), st, 1)
    _, stats = tsolver.simulate_stats(cfg, st, 1)
    assert stats.overflow is False
