"""Pluggable physics schemes: the declarative pair-term layer.

Port of ``repro.core.scheme``. A :class:`Scheme` is a frozen dataclass of
floats and strings; every pair term goes through one of two momentum
channels (the ∇W channel: pressure + Monaghan artificial viscosity; the
dv channel: Morris viscosity) or the continuity channel (delta-SPH).
Densities enter as reciprocals. The plain force version calls these
methods directly; the CUDA kernel repeats their arithmetic in the same
order (``csrc/rcll_force.cu``).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import sph

EOS_KINDS = ("linear", "tait")
VISCOSITY_KINDS = ("morris", "none")


@dataclasses.dataclass(frozen=True)
class Scheme:
    """Static description of the SPH physics terms of one simulation.

    c0 / rho0: speed of sound and reference density. eos: "linear"
    (p = c0²(ρ − ρ0)) or "tait" (p = B[(ρ/ρ0)^γ − 1], B = c0²ρ0/γ).
    viscosity: "morris" (dynamic viscosity ``mu``) or "none". alpha:
    Monaghan artificial viscosity (0 disables). delta: delta-SPH density
    diffusion (0 disables). body_force: constant acceleration, () = 0.
    """

    c0: float
    rho0: float = 1.0
    eos: str = "linear"
    gamma: float = 7.0
    viscosity: str = "morris"
    mu: float = 0.0
    alpha: float = 0.0
    delta: float = 0.0
    body_force: tuple[float, ...] = ()

    def __post_init__(self):
        if self.eos not in EOS_KINDS:
            raise ValueError(f"unknown eos {self.eos!r}; one of {EOS_KINDS}")
        if self.viscosity not in VISCOSITY_KINDS:
            raise ValueError(
                f"unknown viscosity {self.viscosity!r}; one of {VISCOSITY_KINDS}")

    # ---- per-particle EOS -------------------------------------------------
    def pressure(self, rho: torch.Tensor) -> torch.Tensor:
        if self.eos == "linear":
            return sph.eos_tait(rho, self.rho0, self.c0)
        B = self.c0 * self.c0 * self.rho0 / self.gamma
        return B * ((rho / self.rho0) ** self.gamma - 1.0)

    def por2_inv(self, inv_rho: torch.Tensor) -> torch.Tensor:
        """p/ρ² from the reciprocal density."""
        if self.eos == "linear":
            return sph.eos_tait_por2_inv(inv_rho, self.rho0, self.c0)
        B = self.c0 * self.c0 * self.rho0 / self.gamma
        ratio = self.rho0 * inv_rho  # ρ0/ρ
        return B * (ratio ** -self.gamma - 1.0) * inv_rho * inv_rho

    # ---- pair-term channels ----------------------------------------------
    @property
    def has_dv_term(self) -> bool:
        return self.viscosity == "morris" and self.mu != 0.0

    @property
    def has_av_term(self) -> bool:
        return self.alpha != 0.0

    @property
    def has_delta_term(self) -> bool:
        return self.delta != 0.0

    def gradw_pair_coef(self, mj, por2_i, por2_j, inv_i, inv_j, dv_dot_disp,
                        r2, *, h: float):
        """Coefficient of ∇W in the momentum sum: acc -= Σ C ∇W
        (pressure + Monaghan viscosity where dv·dx < 0)."""
        coef = sph.pressure_pair_coef(mj, por2_i, por2_j)
        if self.has_av_term:
            mu_ij = dv_dot_disp / (r2 + 0.01 * h * h)
            rho_bar_inv = 2.0 * inv_i * inv_j / (inv_i + inv_j)
            pi_ij = -self.alpha * self.c0 * h * mu_ij * rho_bar_inv
            coef = coef + mj * torch.where(
                dv_dot_disp < 0.0, pi_ij, torch.zeros_like(pi_ij))
        return coef

    def dv_pair_coef(self, mj, x_dot_gw, inv_i, inv_j, r2, *, h: float):
        """Coefficient of (v_i − v_j) in the momentum sum (Morris)."""
        return sph.viscosity_pair_coef_inv(
            mj, x_dot_gw, inv_i, inv_j, r2, h=h, mu=self.mu)

    def drho_pair_term(self, mj, inv_i, inv_j, x_dot_gw, r2, *, h: float):
        """delta-SPH continuity term in reciprocal form."""
        rho_diff = (inv_i - inv_j) / (inv_i * inv_j)  # ρ_j − ρ_i
        return (2.0 * self.delta * h * self.c0) * mj * inv_j * rho_diff * (
            -x_dot_gw
        ) / (r2 + 0.01 * h * h)

    def body_force_vec(self, dim: int, device) -> torch.Tensor:
        bf = self.body_force or (0.0,) * dim
        if len(bf) != dim:
            raise ValueError(
                f"body_force {self.body_force} has {len(bf)} components; "
                f"domain is {dim}-D")
        return torch.tensor(bf, dtype=torch.float32, device=device)


def wcsph(c0: float, rho0: float = 1.0, mu: float = 0.0,
          body_force: tuple[float, ...] = ()) -> Scheme:
    """Linear EOS + Morris viscosity as a Scheme."""
    return Scheme(c0=c0, rho0=rho0, eos="linear", viscosity="morris", mu=mu,
                  body_force=tuple(body_force))
