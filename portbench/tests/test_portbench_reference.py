"""The plain reference against the port's plain CPU path at a tiny size:
the port's own steps (K1/K2's plain versions on CPU tensors) read under
each cell's limits, the control (every stated precision one step lower)
over them, and the reference's decoding of the program's state agrees
with the program's own."""
from __future__ import annotations

import pytest
import torch

from portbench import bench, program
from portbench.reference import compare, wcsph
from portbench.tests import tiny

CELLS = ("tg-4m-rebuild", "dam-4m-skin", "tg-4m-skin")


def _steps(cell: str, count: int = 3):
    work = bench.cell(cell)
    conf = tiny.config(work["config"])
    cfg = program.make_config(conf, work)
    inputs = bench.make_inputs(conf, 7, "cpu")
    carry = program.start(cfg, {k: v.clone() for k, v in inputs.items()}, "cpu")
    pairs = []
    for _ in range(count):
        before = {k: v.clone() for k, v in program.fields(carry).items()}
        carry = program.step(cfg, carry)
        pairs.append((before, {k: v.clone() for k, v in program.fields(carry).items()}))
    return work, conf, cfg, inputs, carry, pairs


@pytest.mark.parametrize("cell", CELLS)
def test_reference_step_agrees_with_the_ports_cpu_path(cell):
    work, conf, cfg, inputs, carry, pairs = _steps(cell)
    geom = wcsph.Geometry.from_config(conf, work["cell_factor"])
    ph = wcsph.Physics.from_config(conf)
    policy = conf["policy"]
    wall = inputs["kind"] != 0
    worst, control = {}, {}
    for before, after in pairs:
        b, a = compare.by_id(geom, before), compare.by_id(geom, after)
        args = (b["x"], b["v"], b["rho"], inputs["m"], wall)
        x, v, rho, n_pairs = wcsph.step(ph, geom, wcsph.Precision.stated(policy), *args)
        assert n_pairs > 10 * inputs["m"].shape[0]
        for k, val in compare.step_gaps(geom, b, a, (x, v, rho)).items():
            worst[k] = max(worst.get(k, 0.0), val)
        xc, vc, rc, _ = wcsph.step(ph, geom, wcsph.Precision.lowered(policy), *args)
        for k, val in compare.step_gaps(geom, b, {"x": xc, "v": vc, "rho": rc},
                                        (x, v, rho)).items():
            control[k] = max(control.get(k, 0.0), val)
    limits = work["limits"]
    assert all(worst[k] <= limits[k] for k in worst), (worst, limits)
    assert all(control[k] > limits[k] for k in control), (control, limits)


def test_the_reference_decodes_the_programs_state_as_the_program_does():
    from repro_torch.core import solver

    work, conf, cfg, inputs, carry, _ = _steps("dam-4m-skin", 2)
    geom = wcsph.Geometry.from_config(conf, work["cell_factor"])
    ours = compare.by_id(geom, program.fields(carry))["x"]
    theirs = solver.positions(cfg, solver.finalize_persistent(cfg, carry), torch.float64)
    assert torch.allclose(ours, theirs, rtol=0, atol=1e-12)


def test_pair_count_is_the_lattice_neighbourhood():
    conf = tiny.config("taylor_green_4m")
    geom = wcsph.Geometry.from_config(conf, 1.0)
    x = bench.make_inputs(conf, 3, "cpu")["x"].double()
    # a regular lattice at h = 1.2 ds: 20 neighbours inside 2h = 2.4 ds
    assert wcsph.count_pairs(geom, x) == 20 * x.shape[0]
