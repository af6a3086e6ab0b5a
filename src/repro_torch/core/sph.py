"""SPH state, gradient operators and the pair primitives of the WCSPH
right-hand side.

Port of ``repro.core.sph``: the fluid state, the linear Tait EOS (also in
reciprocal-density form), the pressure / Morris-viscosity pair
coefficients, and the gradient operators over explicit neighbor lists
(Eq. 2 and Appendix A5) that the NNPS path and its oracles use. The
gather-path governing equations wait for the ``reference`` backend
(ROADMAP Queue 1 item 4b).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import bspline


def grad_w(disp: torch.Tensor, r: torch.Tensor, h: float, dim: int,
           mask: torch.Tensor) -> torch.Tensor:
    """∂W_ij/∂x_i = (dW/dr)(x_i - x_j)/r, masked, (N, K, d); disp = x_i - x_j."""
    g = bspline.dw_over_r(r, h, dim)[..., None] * disp
    return torch.where(mask[..., None], g, torch.zeros_like(g))


def guard_den(den: torch.Tensor, eps: float) -> torch.Tensor:
    """``den`` with magnitudes at or below ``eps`` replaced by ±eps (its sign)."""
    sign_eps = torch.where(den >= 0, eps, -eps).to(den.dtype)
    return torch.where(torch.abs(den) > eps, den, sign_eps)


def gradient_standard(f: torch.Tensor, vol: torch.Tensor, nl_idx: torch.Tensor,
                      gw: torch.Tensor) -> torch.Tensor:
    """Standard SPH gradient (Eq. 2): Σ_j V_j f_j ∂W/∂x, (N, d)."""
    idx = nl_idx.long()
    return torch.sum((vol[idx] * f[idx])[..., None] * gw, dim=1)


def gradient_normalized(f: torch.Tensor, x: torch.Tensor, nl_idx: torch.Tensor,
                        nl_mask: torch.Tensor, gw: torch.Tensor,
                        eps: float = 1e-12) -> torch.Tensor:
    """First-order consistent, volume-free gradient (Appendix Eq. A5):
    Σ_j (f_j - f_i) ∂W/∂x_a over Σ_j (x_j - x_i)_a ∂W/∂x_a, per axis."""
    idx = nl_idx.long()
    df = (f[idx] - f[:, None]) * nl_mask
    dx = (x[idx] - x[:, None, :]) * nl_mask[..., None]
    num = torch.sum(df[..., None] * gw, dim=1)
    den = torch.sum(dx * gw, dim=1)
    return num / guard_den(den, eps)


def gradient_normalized_pairs(f: torch.Tensor, disp: torch.Tensor, r: torch.Tensor,
                              nl_idx: torch.Tensor, nl_mask: torch.Tensor, h: float,
                              dim: int, eps: float = 1e-12) -> torch.Tensor:
    """The A5 gradient from pair displacements (disp = x_i - x_j, decoded
    by Eq. 7 on the RCLL path, where positions are never absolute)."""
    gw = grad_w(disp, r, h, dim, nl_mask)
    df = (f[nl_idx.long()] - f[:, None]) * nl_mask
    num = torch.sum(df[..., None] * gw, dim=1)
    den = torch.sum((-disp) * nl_mask[..., None] * gw, dim=1)
    return num / guard_den(den, eps)


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
