"""The comparison that decides ``correct``: the program's states against
the plain reference, by particle id.

A state is read in the program's output format (integer cell, relative
coordinate, velocity, density, and ``order``: packed position -> the
particle's id in the inputs) and decoded by the reference's own
geometry. Each number is a widest gap over all particles:

  * ``start_x_ds``: the first packed state's positions against the
    inputs, in particle spacings (what storing them as fp16 relative
    coordinates may move them);
  * ``fields_changed``: particles whose velocity, density, mass or kind
    in the first packed state, or mass or kind in the finalized state,
    differ in value from the inputs (an exact comparison);
  * ``step_v_share``: over the sampled steps, the velocity gap to the
    reference's step, as a share of the step's largest velocity change;
  * ``step_rho_share``: the density gap, as a share of the step's
    largest density change (the continuity sum with its delta-SPH term,
    times dt);
  * ``step_x_ds``: the position gap, in particle spacings.
"""
from __future__ import annotations

import torch

from portbench.reference import wcsph

def by_id(geom: wcsph.Geometry, f: dict) -> dict:
    """Fields in the program's packed order, put in id order (float64
    positions decoded from cell and rel)."""
    order = f["order"].long()
    out = {"x": torch.empty((order.shape[0], len(geom.lo)), dtype=torch.float64,
                            device=order.device)}
    out["x"][order] = geom.decode(f["cell"], f["rel"])
    for k in ("v", "rho", "m", "kind"):
        if k in f:
            t = torch.empty_like(f[k])
            t[order] = f[k]
            out[k] = t
    return out


#: The numbers of a sampled step.
STEP_NUMBERS = ("step_v_share", "step_rho_share", "step_x_ds")


def finite(f: dict) -> bool:
    """Whether positions, velocities and densities are all finite (the
    reference's search bins positions, and cannot bin what is not)."""
    return all(bool(torch.isfinite(f[k]).all()) for k in ("x", "v", "rho"))


def _gap(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    d = (a.double() - b.double()).abs()
    return d if d.dim() == 1 else d.norm(dim=-1)


def _max(t: torch.Tensor) -> float:
    """The largest entry; inf where any is not finite."""
    return float(t.max()) if bool(torch.isfinite(t).all()) else float("inf")


def step_gaps(geom: wcsph.Geometry, before: dict, out: dict, ref: tuple) -> dict:
    """One step's numbers: ``before`` and ``out`` in id order (``out`` as
    the program, or the control, left it), ``ref`` the reference's
    (x, v, rho) from ``before``."""
    x_r, v_r, rho_r = ref
    dv = _gap(v_r, before["v"]).max()
    drho = _gap(rho_r, before["rho"]).max()
    x_gap = geom.min_image(out["x"] - x_r).norm(dim=-1)
    return {
        "step_v_share": _max(_gap(out["v"], v_r)) / max(float(dv), 1e-300),
        "step_rho_share": _max(_gap(out["rho"], rho_r)) / max(float(drho), 1e-300),
        "step_x_ds": _max(x_gap) / geom.ds,
    }


def start_gaps(geom: wcsph.Geometry, first: dict, inputs: dict) -> dict:
    """The first packed state (in id order) against the inputs."""
    x_gap = geom.min_image(first["x"] - inputs["x"].double()).norm(dim=-1)
    return {"start_x_ds": _max(x_gap) / geom.ds,
            "fields_changed": changed(first, inputs, ("v", "rho", "m", "kind"))}


def changed(a: dict, b: dict, keys) -> int:
    """Particles whose fields ``keys`` differ in value (NaN differs)."""
    bad = torch.zeros(b["m"].shape[0], dtype=torch.bool, device=b["m"].device)
    for k in keys:
        d = a[k] != b[k]
        bad |= d if d.dim() == 1 else d.any(-1)
    return int(bad.sum())
