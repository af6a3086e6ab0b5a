"""Domain specification and coordinate normalization (paper Eqs. 5-6).

Port of ``repro.core.domain``. Coordinates are normalized twice: Eq. (5)
maps absolute coordinates to [-1, 1] over the longest span h_d, Eq. (6)
re-expresses them relative to their cell center in units of half a cell.
Cell sizes are per axis (exact tiling on periodic axes, ceil on wall
axes). Every function takes an explicit dtype and builds its constants
on the device of its input tensor.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.precision import NNPS_STORE


def _const(values, dtype, device) -> torch.Tensor:
    return torch.tensor(values, dtype=dtype, device=device)


@dataclasses.dataclass(frozen=True)
class Domain:
    """Static description of the simulation box.

    lo / hi: physical bounds per axis. h: smoothing length (search radius
    2h). cell_factor: target cell size in search radii (>= 1).
    periodic: per-axis periodic wrap flags.
    """

    lo: tuple[float, ...]
    hi: tuple[float, ...]
    h: float
    cell_factor: float = 1.0
    periodic: tuple[bool, ...] = ()

    def __post_init__(self):
        if not self.periodic:
            object.__setattr__(self, "periodic", (False,) * self.dim)
        if not len(self.lo) == len(self.hi) == len(self.periodic):
            raise ValueError("lo, hi and periodic need one entry per axis")
        if self.cell_factor < 1.0:
            raise ValueError(f"cell_factor must be >= 1, got {self.cell_factor}")
        for a, p in enumerate(self.periodic):
            if p and self.ncells[a] < 3:
                raise ValueError(
                    f"periodic axis {a} needs >= 3 cells (span "
                    f"{self.spans[a]}, radius {self.radius}); the 3-cell "
                    "neighborhood would alias otherwise"
                )

    # ---- static geometry -------------------------------------------------
    @property
    def dim(self) -> int:
        return len(self.lo)

    @property
    def spans(self) -> tuple[float, ...]:
        return tuple(h - l for l, h in zip(self.lo, self.hi))

    @property
    def h_d(self) -> float:
        """Maximum domain span (the paper's h_d, Eq. 5)."""
        return max(self.spans)

    @property
    def radius(self) -> float:
        """Physical search radius 2h."""
        return 2.0 * self.h

    @property
    def radius_norm(self) -> float:
        """Search radius in normalized coordinates (length L -> 2L/h_d)."""
        return 2.0 * self.radius / self.h_d

    @property
    def ncells(self) -> tuple[int, ...]:
        """Cells per axis: floor on periodic axes, ceil on wall axes."""
        target = self.cell_factor * self.radius
        out = []
        for s, p in zip(self.spans, self.periodic):
            if p:
                out.append(max(1, int(np.floor(s / target + 1e-9))))
            else:
                out.append(max(1, int(np.ceil(s / target - 1e-9))))
        return tuple(out)

    @property
    def cell_sizes(self) -> tuple[float, ...]:
        """Physical cell edge per axis (>= search radius)."""
        target = self.cell_factor * self.radius
        return tuple(
            s / n if p else target
            for s, n, p in zip(self.spans, self.ncells, self.periodic)
        )

    @property
    def ncells_total(self) -> int:
        return int(np.prod(self.ncells))

    @property
    def hc_norm_axes(self) -> tuple[float, ...]:
        """Cell edges in normalized coordinates (the paper's h_c, per axis)."""
        return tuple(2.0 * c / self.h_d for c in self.cell_sizes)

    @property
    def hc_ref(self) -> float:
        """Reference (minimum) normalized cell edge."""
        return min(self.hc_norm_axes)

    @property
    def cell_weights(self) -> tuple[float, ...]:
        """O(1) anisotropy weights w_a = hc_a / hc_ref."""
        ref = self.hc_ref
        return tuple(c / ref for c in self.hc_norm_axes)

    @property
    def origin_norm(self) -> tuple[float, ...]:
        """Normalized lower corner of the cell grid."""
        lo = np.asarray(self.lo)
        hi = np.asarray(self.hi)
        return tuple((2.0 * lo - (hi + lo)) / self.h_d)

    # ---- Eq. (5): absolute -> normalized [-1, 1] --------------------------
    def normalize(self, x: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
        """x' = (2 x0 - (xmax + xmin)) / h_d  (paper Eq. 5), per axis."""
        lo = _const(self.lo, dtype, x.device)
        hi = _const(self.hi, dtype, x.device)
        hd = _const(self.h_d, dtype, x.device)
        x = x.to(dtype)
        return (2.0 * x - (hi + lo)) / hd

    def denormalize(self, xn: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
        lo = _const(self.lo, dtype, xn.device)
        hi = _const(self.hi, dtype, xn.device)
        hd = _const(self.h_d, dtype, xn.device)
        return (xn.to(dtype) * hd + (hi + lo)) / 2.0

    # ---- Eq. (6): normalized absolute -> cell-relative [-1, 1] -----------
    def cell_center_norm(
        self, cell_coords: torch.Tensor, dtype=torch.float32
    ) -> torch.Tensor:
        org = _const(self.origin_norm, dtype, cell_coords.device)
        hc = _const(self.hc_norm_axes, dtype, cell_coords.device)
        return org + (cell_coords.to(dtype) + 0.5) * hc

    def to_relative(
        self, xn: torch.Tensor, cell_coords: torch.Tensor, dtype=NNPS_STORE
    ) -> torch.Tensor:
        """x = 2 (x' - x'_cc) / h_c (paper Eq. 6), subtracted in fp32 and
        stored at ``dtype``."""
        cc = self.cell_center_norm(cell_coords, dtype=torch.float32)
        hc = _const(self.hc_norm_axes, torch.float32, xn.device)
        rel = 2.0 * (xn.to(torch.float32) - cc) / hc
        return rel.to(dtype)

    def from_relative(
        self, rel: torch.Tensor, cell_coords: torch.Tensor, dtype=torch.float32
    ) -> torch.Tensor:
        """Inverse of Eq. (6): x' = x'_cc + x * h_c / 2."""
        cc = self.cell_center_norm(cell_coords, dtype=dtype)
        hc = _const(self.hc_norm_axes, dtype, rel.device)
        return cc + rel.to(dtype) * (hc / 2.0)

    # ---- cell arithmetic ---------------------------------------------------
    def cell_coords_of(self, xn: torch.Tensor) -> torch.Tensor:
        """Integer cell coordinates of normalized positions (clipped)."""
        org = _const(self.origin_norm, torch.float32, xn.device)
        hc = _const(self.hc_norm_axes, torch.float32, xn.device)
        c = torch.floor((xn.to(torch.float32) - org) / hc)
        n = _const(self.ncells, torch.int32, xn.device)
        return torch.clamp(c.to(torch.int32), min=torch.zeros_like(n), max=n - 1)

    def flat_cell_id(self, cell_coords: torch.Tensor) -> torch.Tensor:
        """Row-major flatten of per-axis cell coordinates (int32)."""
        n = self.ncells
        flat = cell_coords[..., 0].to(torch.int32)
        for a in range(1, self.dim):
            flat = flat * n[a] + cell_coords[..., a].to(torch.int32)
        return flat

    def wrap_cell_delta(self, delta: torch.Tensor) -> torch.Tensor:
        """Minimum-image wrap of integer cell-coordinate deltas (periodic
        axes), with floor-mod semantics."""
        n = np.asarray(self.ncells, dtype=np.int32)
        half = _const((n // 2).tolist(), torch.int32, delta.device)
        nn = _const(n.tolist(), torch.int32, delta.device)
        per = _const(self.periodic, torch.bool, delta.device)
        wrapped = torch.remainder(delta + half, nn) - half
        return torch.where(per, wrapped, delta).to(torch.int32)


def lattice_positions(domain: Domain, ds: float, jitter: float = 0.0,
                      seed: int = 0) -> np.ndarray:
    """Regular particle lattice with optional jitter (numpy, host-side)."""
    axes = [np.arange(lo + ds / 2, hi, ds) for lo, hi in zip(domain.lo, domain.hi)]
    grid = np.meshgrid(*axes, indexing="ij")
    x = np.stack([g.ravel() for g in grid], axis=-1).astype(np.float64)
    if jitter > 0.0:
        rng = np.random.default_rng(seed)
        x = x + rng.uniform(-jitter * ds, jitter * ds, size=x.shape)
    return x
