"""Dam break (Monaghan 1994; DualSPHysics, arXiv:1110.3711): a water
column against the left wall of an open-topped tank with no-slip dummy
walls (``layers`` particle rows) on the left, right and floor.

The column starts in hydrostatic balance under the Tait EOS,
rho = rho0 (1 + gamma rho0 g (H - y) / (rho0 c0^2))^(1/gamma), and
falling at ``v0`` (the dropped-column start). The seed jitters each
fluid particle's lattice position by up to ``jitter`` ds on each axis;
walls stay on their lattice.
"""
from __future__ import annotations

import torch

from portbench.inputs import lattice


def make(conf: dict, seed: int, device) -> dict:
    f, ph, ds = conf["fluid"], conf["physics"], conf["ds"]
    fluid = lattice.grid(f["column_lo"], f["column_hi"], ds, device)
    gen = torch.Generator(device=device).manual_seed(seed)
    fluid = fluid + (2.0 * torch.rand(fluid.shape, generator=gen, dtype=torch.float64,
                                      device=device) - 1.0) * (f["jitter"] * ds)
    wall = lattice.walls(f["tank_lo"], f["tank_hi"], ds, f["wall_layers"],
                         [tuple(s) for s in f["wall_sides"]], device)
    x = torch.cat([fluid, wall])
    nf, n = fluid.shape[0], x.shape[0]
    kind = torch.zeros(n, dtype=torch.int8, device=device)
    kind[nf:] = 1
    rho0, c0, gamma, g = ph["rho0"], ph["c0"], ph["gamma"], -ph["body_force"][1]
    p_h = rho0 * g * (f["column_hi"][1] - x[:, 1]).clamp(min=0.0)
    rho = rho0 * (1.0 + gamma * p_h / (rho0 * c0 * c0)) ** (1.0 / gamma)
    rho[nf:] = rho0
    v = torch.zeros((n, 2), dtype=torch.float64, device=device)
    v[:nf, 1] = -conf["case_args"]["v0"]
    return {"x": x.float(), "v": v.float(), "rho": rho.float(),
            "m": torch.full((n,), rho0 * ds * ds, dtype=torch.float32, device=device),
            "kind": kind}
