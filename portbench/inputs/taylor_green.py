"""Taylor-Green vortex (Taylor & Green 1937) on a fully periodic box.

The seed draws a phase offset (x0, y0) of the field, which keeps it an
exact solution of the Navier-Stokes equations with the same energy:
    u =  U sin(k(x - x0)) cos(k(y - y0)),  v = -U cos(k(x - x0)) sin(k(y - y0)),
    p = -rho0 U^2 / 4 (cos 2k(x - x0) + cos 2k(y - y0)),  rho = rho0 + p / c0^2
(the linear EOS's density), k = 2 pi / L, on the lattice of spacing ds.
"""
from __future__ import annotations

import math

import torch

from portbench.inputs import lattice


def make(conf: dict, seed: int, device) -> dict:
    f, ph, ds = conf["fluid"], conf["physics"], conf["ds"]
    x = lattice.grid(f["lo"], f["hi"], ds, device)
    gen = torch.Generator(device=device).manual_seed(seed)
    span = f["hi"][0] - f["lo"][0]
    phase = torch.rand(2, generator=gen, dtype=torch.float64, device=device) * span
    k = 2.0 * math.pi / span
    kx, ky = k * (x[:, 0] - phase[0]), k * (x[:, 1] - phase[1])
    u = f["U"]
    v = u * torch.stack([torch.sin(kx) * torch.cos(ky), -torch.cos(kx) * torch.sin(ky)], -1)
    p = -ph["rho0"] * u * u / 4.0 * (torch.cos(2 * kx) + torch.cos(2 * ky))
    rho = ph["rho0"] + p / (ph["c0"] * ph["c0"])
    n = x.shape[0]
    return {"x": x.float(), "v": v.float(), "rho": rho.float(),
            "m": torch.full((n,), ph["rho0"] * ds * ds, dtype=torch.float32, device=device),
            "kind": torch.zeros(n, dtype=torch.int8, device=device)}
