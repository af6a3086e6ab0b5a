"""Persistent RCLL state: the paper's Eqs. (6)-(8).

Port of the persistent-pipeline part of ``repro.core.rcll``. State per
particle is ``cell_xy`` (N, d) int32 plus ``rel`` (N, d) in the storage
dtype (fp16). Eq. (8): rel += 2·dx/h_c accumulated in fp32, then
migrate: shift the cell by floor((rel + 1)/2) and re-center rel.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import cells as cells_lib
from repro_torch.core.domain import Domain
from repro_torch.core.precision import NNPS_STORE


class RCLLState(NamedTuple):
    cell_xy: torch.Tensor  # (N, d) int32
    rel: torch.Tensor  # (N, d) low-precision storage dtype


def init_state(domain: Domain, xn: torch.Tensor, dtype=NNPS_STORE) -> RCLLState:
    """One-time transform from normalized absolute coordinates (Eqs. 5-6)."""
    cell_xy = domain.cell_coords_of(xn)
    rel = domain.to_relative(xn, cell_xy, dtype=dtype)
    return RCLLState(cell_xy=cell_xy, rel=rel)


def to_normalized(domain: Domain, state: RCLLState, dtype=torch.float32) -> torch.Tensor:
    """Decode back to normalized absolute coordinates (high precision)."""
    return domain.from_relative(state.rel, state.cell_xy, dtype=dtype)


def _migrate(domain: Domain, cell_xy: torch.Tensor, rel_hi: torch.Tensor, dtype):
    """Re-center relative coords into [-1, 1], shifting cell indices.

    Non-periodic exits clamp to the boundary cell and pin rel at the
    NEAR edge (clip the un-recentered value), never teleporting the
    particle to the boundary cell's far edge.
    """
    dev = rel_hi.device
    shift = torch.floor((rel_hi + 1.0) * 0.5).to(torch.int32)
    rel_new = rel_hi - 2.0 * shift.to(rel_hi.dtype)
    cell_new = cell_xy + shift
    n = torch.tensor(domain.ncells, dtype=torch.int32, device=dev)
    per = torch.tensor(domain.periodic, dtype=torch.bool, device=dev)
    wrapped = torch.where(per, torch.remainder(cell_new, n), cell_new)
    clamped = torch.clamp(wrapped, min=torch.zeros_like(n), max=n - 1)
    rel_out = torch.where(
        wrapped == clamped, rel_new, torch.clamp(rel_hi, -1.0, 1.0)
    )
    return clamped, rel_out.to(dtype)


def advance(domain: Domain, state: RCLLState, dxn: torch.Tensor, *,
            dtype=NNPS_STORE) -> RCLLState:
    """Eq. (8): advance relative coordinates by a normalized displacement
    ``dxn`` (N, d), accumulated in fp32 and stored at ``dtype``."""
    rel_hi = state.rel.to(torch.float32)
    hc = torch.tensor(domain.hc_norm_axes, dtype=torch.float32, device=dxn.device)
    incr = 2.0 * dxn.to(torch.float32) / hc
    rel_hi = rel_hi + incr
    cell_xy, rel = _migrate(domain, state.cell_xy, rel_hi, dtype)
    return RCLLState(cell_xy=cell_xy, rel=rel)


class PackedState(NamedTuple):
    """RCLL state physically reordered by flat cell id, plus the packing
    (order/inverse permutations and the binning of the packed arrays)."""

    rc: RCLLState
    packing: cells_lib.CellPacking


def pack_state(domain: Domain, state: RCLLState, capacity: int,
               prev: cells_lib.CellBinning | None = None) -> PackedState:
    """Spatially sort an RCLL state by flat cell id (counting-sort pack
    when ``prev`` describes the current order)."""
    cell_id = domain.flat_cell_id(state.cell_xy)
    packing = cells_lib.pack_particles(
        domain, cell_id, state.cell_xy, capacity, prev=prev
    )
    rc = RCLLState(cell_xy=packing.binning.cell_xy, rel=packing.pack(state.rel))
    return PackedState(rc=rc, packing=packing)
