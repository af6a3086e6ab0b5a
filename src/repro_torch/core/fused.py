"""Half-record mass normalizer (the part of ``repro.core.fused`` the
kernel backend needs; the fused XLA sweep itself is ROADMAP Queue 1
item 5)."""
from __future__ import annotations

import torch


def mass_scale(m: torch.Tensor) -> torch.Tensor:
    """Normalizer for the half-record mass column: mean |m|, >= 1e-30.

    SPH masses ~rho0·ds^dim fall into fp16's subnormal range at fine ds;
    every pair term is linear in m, so the record stores m/scale and the
    force outputs are multiplied by scale once. The mean is taken in
    float64 and rounded to fp32 once, so it does not depend on the
    device's summation order.
    """
    s = torch.mean(torch.abs(m).to(torch.float64)).to(torch.float32)
    return torch.clamp(s, min=1e-30)
