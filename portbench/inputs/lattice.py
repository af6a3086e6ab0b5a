"""Regular particle lattices, made on the device in float64."""
from __future__ import annotations

import torch


def grid(lo, hi, ds: float, device) -> torch.Tensor:
    """(N, d) nodes at ds/2 + k ds inside [lo, hi) on each axis, row-major
    in axis order."""
    axes = [torch.arange(l + ds / 2, h, ds, dtype=torch.float64, device=device)
            for l, h in zip(lo, hi)]
    mesh = torch.meshgrid(*axes, indexing="ij")
    return torch.stack([g.reshape(-1) for g in mesh], dim=-1)


def walls(lo, hi, ds: float, layers: int, sides, device) -> torch.Tensor:
    """Wall particles: the lattice over the box padded by ``layers`` rows
    on each walled (axis, side), outside the open box itself."""
    pad_lo, pad_hi = list(lo), list(hi)
    for axis, side in sides:
        if side == 0:
            pad_lo[axis] -= layers * ds
        else:
            pad_hi[axis] += layers * ds
    pts = grid(pad_lo, pad_hi, ds, device)
    eps = 1e-9 * ds
    lo_t = torch.tensor(lo, dtype=torch.float64, device=device)
    hi_t = torch.tensor(hi, dtype=torch.float64, device=device)
    inside = ((pts > lo_t + eps) & (pts < hi_t - eps)).all(-1)
    return pts[~inside]
