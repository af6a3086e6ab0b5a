"""The least time the chip could take for a piece of work, and the work
that a step of the problem and its force pass need.

Peaks: NVIDIA H100 SXM data sheet, dense rates, at its 700 W limit:
67 TFLOP/s in fp32 outside the tensor cores, 3.35 TB/s of HBM3.
"""
from __future__ import annotations

import json
from pathlib import Path

PEAK_FP32_OPS_PER_S = 67e12
PEAK_BYTES_PER_S = 3.35e12

_BYTES = {"fp64": 8, "fp32": 4, "fp16": 2, "bf16": 2}
_PAIR_OPS = json.loads((Path(__file__).with_name("pair_ops.json")).read_text())


def least_seconds(ops: float, nbytes: float) -> float:
    """The larger of the operations at the fp32 peak and the bytes at the
    memory peak."""
    return max(ops / PEAK_FP32_OPS_PER_S, nbytes / PEAK_BYTES_PER_S)


def pair_ops(physics: dict) -> int:
    """fp32 operations of one ordered pair inside the support, for the
    terms this configuration's physics has."""
    ops = _PAIR_OPS["geometry"] + _PAIR_OPS["continuity"] + _PAIR_OPS["pressure"]
    if physics["mu"]:
        ops += _PAIR_OPS["morris"]
    if physics["alpha"]:
        ops += _PAIR_OPS["artificial_viscosity"]
    if physics["delta"]:
        ops += _PAIR_OPS["delta_sph"]
    return ops


def force_bytes_per_particle(conf: dict) -> int:
    """The force pass's inputs read once and outputs written once: the
    relative coordinates, the velocity and mass records, 1/rho; drho and
    the acceleration."""
    d, pol = len(conf["box"]["lo"]), conf["policy"]
    rec, phys = _BYTES[pol["records"]], _BYTES[pol["physics"]]
    return d * _BYTES[pol["coords"]] + d * rec + rec + phys + phys + d * phys


def state_bytes_per_particle(conf: dict) -> int:
    """One particle's state at the stated storage dtypes: its int32 cell
    and relative coordinates, velocity, density, mass and int8 kind."""
    d, pol = len(conf["box"]["lo"]), conf["policy"]
    phys = _BYTES[pol["physics"]]
    return d * 4 + d * _BYTES[pol["coords"]] + d * phys + phys + phys + 1


def step_least_seconds(conf: dict, n: int, pairs: float, steps: int, rebuilds: int) -> float:
    """The least time of ``steps`` steps of which ``rebuilds`` rebuilt: the
    state read and written once a step, once more on a rebuild (the
    permutation), and the pair operations, each step bounded by the
    larger of its operations and its bytes."""
    state = 2 * n * state_bytes_per_particle(conf)
    ops = pairs * pair_ops(conf["physics"])
    return ((steps - rebuilds) * least_seconds(ops, state)
            + rebuilds * least_seconds(ops, 2 * state))


def force_least_seconds(conf: dict, n: int, pairs: float) -> float:
    """The least time of one force pass."""
    return least_seconds(pairs * pair_ops(conf["physics"]),
                         n * force_bytes_per_particle(conf))
