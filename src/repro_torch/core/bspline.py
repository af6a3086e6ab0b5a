"""Cubic B-spline SPH kernel (paper Eq. 3).

Port of ``repro.core.bspline``: the plain force version and the CUDA
kernel (``csrc/rcll_force.cu``) evaluate the same expressions. Powers are
written as products to match JAX's ``integer_pow`` (``R**3`` is
``R * (R * R)``), and Python-scalar subexpressions keep JAX's order so
they fold in double exactly as there.
"""
from __future__ import annotations

import math

import torch

#: The kernel support radius in units of h: W(r) = 0 for r >= SUPPORT * h.
SUPPORT = 2.0


def alpha_d(dim: int, h: float) -> float:
    """Normalization factor of the cubic B-spline (paper Eq. 3)."""
    if dim == 1:
        return 1.0 / h
    if dim == 2:
        return 15.0 / (7.0 * math.pi * h * h)
    if dim == 3:
        return 3.0 / (2.0 * math.pi * h**3)
    raise ValueError(dim)


def w(r: torch.Tensor, h: float, dim: int) -> torch.Tensor:
    """Kernel value W(R, h), R = r/h (paper Eq. 3)."""
    R = r / h
    a = alpha_d(dim, h)
    w1 = 2.0 / 3.0 - R * R + 0.5 * (R * (R * R))
    t = 2.0 - R
    w2 = t * (t * t) / 6.0
    zero = torch.zeros_like(R)
    return a * torch.where(R < 1.0, w1, torch.where(R < 2.0, w2, zero))


def dw_dr(r: torch.Tensor, h: float, dim: int) -> torch.Tensor:
    """dW/dr; exactly 0 for r >= 2h and at r = 0."""
    R = r / h
    a = alpha_d(dim, h) / h
    d1 = -2.0 * R + 1.5 * R * R
    t = 2.0 - R
    d2 = -0.5 * (t * t)
    zero = torch.zeros_like(R)
    return a * torch.where(R < 1.0, d1, torch.where(R < 2.0, d2, zero))


def dw_over_r(r: torch.Tensor, h: float, dim: int) -> torch.Tensor:
    """(dW/dr) / r with the r -> 0 guard: dW/dx_a = dw_over_r(r) * disp_a."""
    rsafe = torch.where(r > 1e-12, r, torch.ones_like(r))
    return dw_dr(r, h, dim) / rsafe
