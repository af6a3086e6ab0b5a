"""SPH state and the pair primitives of the WCSPH right-hand side.

Port of the parts of ``repro.core.sph`` that the force pass uses: the
fluid state, the linear Tait EOS (also in reciprocal-density form) and
the pressure / Morris-viscosity pair coefficients. The gather-path
gradient operators wait for the ``reference`` backend (ROADMAP Queue 1).
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class FluidState(NamedTuple):
    """Per-particle physical state (high-precision tier)."""

    v: torch.Tensor  # (N, d) velocity
    rho: torch.Tensor  # (N,) density
    m: torch.Tensor  # (N,) constant particle mass


def eos_tait(rho: torch.Tensor, rho0: float, c0: float) -> torch.Tensor:
    """Linearized weakly-compressible EOS p = c0^2 (rho - rho0)."""
    return c0 * c0 * (rho - rho0)


def eos_tait_por2_inv(inv_rho: torch.Tensor, rho0: float, c0: float) -> torch.Tensor:
    """p/ρ² of the linear Tait EOS from the reciprocal density:
    c0²(1/ρ − ρ0/ρ²), division-free given 1/ρ."""
    return c0 * c0 * (inv_rho - rho0 * inv_rho * inv_rho)


def pressure_pair_coef(mj, por2_i, por2_j):
    """m_j (p_i/ρ_i² + p_j/ρ_j²), the symmetric pressure-term coefficient."""
    return mj * (por2_i + por2_j)


def viscosity_pair_coef_inv(mj, x_dot_gw, inv_i, inv_j, r2, *, h: float, mu: float):
    """Morris-viscosity pair coefficient from reciprocal densities."""
    return mj * (2.0 * mu) * x_dot_gw * inv_i * inv_j / (r2 + 0.01 * h * h)
