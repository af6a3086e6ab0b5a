"""Whole runs of a cell at a tiny size on the CPU, the check for
a CUDA device skipped: a sound run is correct; the control in the program's
place, and each fault the cells can have planted in the timed path
(``faults.py``), make ``correct`` come out false. (A cell on one chip has no
exchange between chips to leave out.)"""
from __future__ import annotations

import time

import pytest

from portbench import bench
from portbench.tests import faults, tiny


def _run(cell: str, seed: int = 2147483659, control: bool = False) -> dict:
    work = bench.cell(cell)
    conf = tiny.config(work["config"])
    out = bench.run(cell, seed, 0.3, False, device="cpu", t0=time.perf_counter(),
                    conf=conf, control=control)
    out["correct"] = bench.verdict(out["checks"], work["limits"])[0]
    return out


def test_a_sound_run_is_correct_and_the_control_is_not():
    out = _run("tg-4m-rebuild", control=True)
    assert out["correct"], out["checks"]
    assert out["samples"] == 4 and out["ctx"].steps >= 3
    assert not bench.verdict(out["control"], bench.cell("tg-4m-rebuild")["limits"])[0]


@pytest.mark.parametrize("fault", ["unchanged", "half_left_out", "answer_altered",
                                   "density_rate_dropped", "state_not_finite",
                                   "rebuild_swaps"])
@pytest.mark.parametrize("cell", ["tg-4m-rebuild", "dam-4m-skin"])
def test_a_fault_in_the_timed_path_makes_the_run_incorrect(cell, fault, monkeypatch):
    faults.ALL[fault](monkeypatch)
    assert not _run(cell)["correct"]


def test_the_dam_without_delta_sph_is_incorrect(monkeypatch):
    faults.delta_sph_off(monkeypatch)
    out = _run("dam-4m-skin")
    assert not out["correct"], out["checks"]
