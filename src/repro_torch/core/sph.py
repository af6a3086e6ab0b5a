"""SPH state, gradient operators and the pair primitives of the WCSPH
right-hand side.

Port of ``repro.core.sph``: the fluid state, the linear Tait EOS (also in
reciprocal-density form), the pressure / Morris-viscosity pair
coefficients, the gradient operators over explicit neighbor lists (Eq. 2
and Appendix A5), and the gather-path governing equations (Eq. 4) over
(N, K) pair arrays that the ``reference`` backend and the absolute algos
use.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import bspline

alpha_d = bspline.alpha_d
bspline_w = bspline.w
bspline_dw_dr = bspline.dw_dr


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


class PairFields(NamedTuple):
    """Pair quantities gathered once per step from the neighbor list.

    dv: (N, K, d) v_i - v_j.  mj: (N, K) neighbor mass, 0 where ~mask.
    """

    dv: torch.Tensor
    mj: torch.Tensor


def gather_pair_fields(v: torch.Tensor, m: torch.Tensor, nl_idx: torch.Tensor,
                       nl_mask: torch.Tensor) -> PairFields:
    """Gather the velocity/mass pair terms shared by continuity and momentum."""
    idx = nl_idx.long()
    mj = m[idx]
    return PairFields(dv=v[:, None, :] - v[idx],
                      mj=torch.where(nl_mask, mj, torch.zeros_like(mj)))


def continuity_rhs_pairs(pf: PairFields, gw: torch.Tensor) -> torch.Tensor:
    """Dρ_i/Dt = Σ_j m_j (v_i - v_j)·∂W_ij/∂x_i (Eq. 4, first row)."""
    return torch.sum(pf.mj * torch.sum(pf.dv * gw, dim=-1), dim=-1)


def pressure_pair_coef(mj, por2_i, por2_j):
    """m_j (p_i/ρ_i² + p_j/ρ_j²), the symmetric pressure-term coefficient."""
    return mj * (por2_i + por2_j)


def viscosity_pair_coef_inv(mj, x_dot_gw, inv_i, inv_j, r2, *, h: float, mu: float):
    """Morris-viscosity pair coefficient from reciprocal densities."""
    return mj * (2.0 * mu) * x_dot_gw * inv_i * inv_j / (r2 + 0.01 * h * h)


def viscosity_pair_coef(mj, x_dot_gw, rho_i, rho_j, r2, *, h: float, mu: float):
    """Morris-viscosity pair coefficient (multiplies v_i - v_j); x_dot_gw =
    (x_i - x_j)·∇W, and 0.01 h² is Morris' denominator guard."""
    return mj * (2.0 * mu) * x_dot_gw / (rho_i * rho_j * (r2 + 0.01 * h * h))


def momentum_rhs_terms(dv, mj, por2_i, por2_j, rho_i, rho_j, gw, disp, r2, *,
                       h: float, mu: float) -> torch.Tensor:
    """Dv_i/Dt pair sums (pressure + Morris viscosity) over the K axis of
    pair-shaped arrays (dv, gw, disp (..., K, d); the rest (..., K) or
    broadcastable)."""
    acc_p = -torch.sum(pressure_pair_coef(mj, por2_i, por2_j)[..., None] * gw, dim=-2)
    x_dot_gw = torch.sum(disp * gw, dim=-1)
    coef = viscosity_pair_coef(mj, x_dot_gw, rho_i, rho_j, r2, h=h, mu=mu)
    return acc_p + torch.sum(coef[..., None] * dv, dim=-2)


def momentum_rhs_pairs(pf: PairFields, rho: torch.Tensor, p: torch.Tensor,
                       nl_idx: torch.Tensor, gw: torch.Tensor, disp: torch.Tensor,
                       r: torch.Tensor, *, h: float, mu: float,
                       body_force: torch.Tensor) -> torch.Tensor:
    """Dv_i/Dt from pre-gathered pair fields (pressure + Morris viscosity
    + body force); rho and p are gathered here once."""
    idx = nl_idx.long()
    p_over_rho2 = p / (rho * rho)
    acc = momentum_rhs_terms(
        pf.dv, pf.mj, p_over_rho2[:, None], p_over_rho2[idx], rho[:, None], rho[idx],
        gw, disp, r * r, h=h, mu=mu)
    return acc + body_force


def continuity_rhs(st: FluidState, nl_idx: torch.Tensor, nl_mask: torch.Tensor,
                   gw: torch.Tensor) -> torch.Tensor:
    """Eq. 4 continuity from the state and the list."""
    return continuity_rhs_pairs(gather_pair_fields(st.v, st.m, nl_idx, nl_mask), gw)


def momentum_rhs(st: FluidState, p: torch.Tensor, nl_idx: torch.Tensor,
                 nl_mask: torch.Tensor, gw: torch.Tensor, disp: torch.Tensor,
                 r: torch.Tensor, *, h: float, mu: float,
                 body_force: torch.Tensor) -> torch.Tensor:
    """Dv_i/Dt: pressure gradient -Σ m_j (p_i/ρ_i² + p_j/ρ_j²) ∇W, Morris
    viscosity Σ m_j (μ_i + μ_j)(x_ij·∇W) / (ρ_i ρ_j (r² + 0.01 h²)) v_ij,
    and the body force."""
    pf = gather_pair_fields(st.v, st.m, nl_idx, nl_mask)
    return momentum_rhs_pairs(pf, st.rho, p, nl_idx, gw, disp, r, h=h, mu=mu,
                              body_force=body_force)


def energy_rhs(st: FluidState, p: torch.Tensor, nl_idx: torch.Tensor,
               nl_mask: torch.Tensor, gw: torch.Tensor) -> torch.Tensor:
    """De_i/Dt = 1/2 Σ m_j (p_i/ρ_i² + p_j/ρ_j²)(v_i - v_j)·∇W (Eq. 4)."""
    idx = nl_idx.long()
    por2 = p / (st.rho * st.rho)
    mj = st.m[idx]
    mj = torch.where(nl_mask, mj, torch.zeros_like(mj))
    dv = st.v[:, None, :] - st.v[idx]
    return 0.5 * torch.sum(mj * (por2[:, None] + por2[idx]) * torch.sum(dv * gw, dim=-1),
                           dim=1)


def density_summation(st: FluidState, nl_idx: torch.Tensor, nl_mask: torch.Tensor,
                      r: torch.Tensor, h: float, dim: int) -> torch.Tensor:
    """ρ_i = Σ_j m_j W_ij including the self term (for (re)initialization)."""
    w = bspline_w(r, h, dim)
    mj = st.m[nl_idx.long()]
    mj = torch.where(nl_mask, mj, torch.zeros_like(mj))
    self_w = bspline_w(torch.zeros_like(st.m), h, dim) * st.m
    return torch.sum(mj * w, dim=1) + self_w
