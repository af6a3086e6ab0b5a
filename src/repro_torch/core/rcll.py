"""Persistent RCLL state: the paper's Eqs. (6)-(8).

Port of ``repro.core.rcll``. State per particle is ``cell_xy`` (N, d)
int32 plus ``rel`` (N, d) in the storage dtype (fp16). Eq. (8): rel +=
2·dx/h_c accumulated in fp32, then migrate: shift the cell by
floor((rel + 1)/2) and re-center rel. Eq. (7) decodes a pair's physical
displacement from the two relative coordinates and the exact integer
cell delta (:func:`decode_pair_disp`). :func:`advance_ef` is Eq. (8)
with the storage rounding carried forward (error feedback), and
:func:`packed_neighbors` the table-free window search on the packed
state.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import cells as cells_lib
from repro_torch.core import nnps
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


def advance_ef(domain: Domain, state: RCLLState, dxn: torch.Tensor,
               carry: torch.Tensor, *, dtype=NNPS_STORE) -> tuple[RCLLState, torch.Tensor]:
    """Eq. (8) with error feedback: the fp32 rounding error of storing rel
    at ``dtype`` is carried (``carry`` (N, d) fp32, zeros at t = 0) and
    re-added next step, so the quantization is unbiased and positions
    track the exact trajectory to fp32 accuracy. Returns (state, carry)."""
    dev = dxn.device
    rel_hi = state.rel.to(torch.float32) + carry
    hc = torch.tensor(domain.hc_norm_axes, dtype=torch.float32, device=dev)
    rel_hi = rel_hi + 2.0 * dxn.to(torch.float32) / hc
    shift = torch.floor((rel_hi + 1.0) * 0.5).to(torch.int32)
    rel_new = rel_hi - 2.0 * shift.to(torch.float32)
    cell_new = state.cell_xy + shift
    n = torch.tensor(domain.ncells, dtype=torch.int32, device=dev)
    per = torch.tensor(domain.periodic, dtype=torch.bool, device=dev)
    wrapped = torch.where(per, torch.remainder(cell_new, n), cell_new)
    clamped = torch.clamp(wrapped, min=torch.zeros_like(n), max=n - 1)
    # Pin escapers at the near edge (see _migrate).
    rel_exact = torch.where(wrapped == clamped, rel_new, torch.clamp(rel_hi, -1.0, 1.0))
    rel_stored = rel_exact.to(dtype)
    return (RCLLState(cell_xy=clamped, rel=rel_stored),
            rel_exact - rel_stored.to(torch.float32))


class PackedState(NamedTuple):
    """RCLL state physically reordered by flat cell id, plus the packing
    (order/inverse permutations and the binning of the packed arrays)."""

    rc: RCLLState
    packing: cells_lib.CellPacking


def pack_state(domain: Domain, state: RCLLState, capacity: int,
               prev: cells_lib.CellBinning | None = None) -> PackedState:
    """Spatially sort an RCLL state by flat cell id (counting-sort pack
    when ``prev`` describes the current order: ``kernels/cell_sort.py``,
    whose kernels run it on the card)."""
    if prev is None:
        cell_id = domain.flat_cell_id(state.cell_xy)
        packing = cells_lib.pack_particles(domain, cell_id, state.cell_xy, capacity)
        rel = packing.pack(state.rel)
    else:
        from repro_torch.kernels import cell_sort  # core stays kernel-free at import

        packing, rel = cell_sort.repack(domain, state.cell_xy, state.rel, capacity, prev)
    return PackedState(rc=RCLLState(cell_xy=packing.binning.cell_xy, rel=rel), packing=packing)


def packed_neighbors(domain: Domain, pstate: PackedState, *, dtype=NNPS_STORE,
                     compute_dtype=None, k: int, include_self: bool = False,
                     radius_cell: float | None = None, window: int | None = None,
                     ds: float | None = None, chunk: int = 0) -> nnps.NeighborList:
    """Neighbor search on the packed arrays (packed indexing): the
    table-free merged-window search (:func:`nnps.rcll_neighbors_windows`),
    whose invalid slots hold exactly the dummy id N.

    window: merged candidate budget per particle over the whole 3^dim
    neighborhood; by default :func:`nnps.auto_window` from ``ds`` when
    given, else from the table's capacity. Unlike the dense table, the
    window search never drops particles at per-cell capacity: coverage
    is bounded by the merged budget only, and truncation is flagged.
    """
    cap = pstate.packing.binning.table.shape[1]
    if window is None:
        window = nnps.auto_window(domain, ds=ds, capacity=cap)
    return nnps.rcll_neighbors_windows(
        domain, pstate.rc.rel, pstate.rc.cell_xy, pstate.packing.binning.counts,
        dtype=dtype, compute_dtype=compute_dtype, k=k, window=window,
        include_self=include_self, radius_cell=radius_cell, chunk=chunk)


def neighbors(domain: Domain, state: RCLLState, *, dtype=NNPS_STORE, k: int,
              capacity: int | None = None, include_self: bool = False,
              radius_cell: float | None = None
              ) -> tuple[nnps.NeighborList, cells_lib.CellBinning]:
    """Search neighbors from the state (unpacked order); also returns the
    binning."""
    n = state.rel.shape[0]
    capacity = capacity or cells_lib.default_capacity(domain, n)
    cell_id = domain.flat_cell_id(state.cell_xy)
    binning = cells_lib.bin_by_cell_id(domain, cell_id, state.cell_xy, capacity)
    nl = nnps.rcll_neighbors(domain, state.rel, state.cell_xy, dtype=dtype, k=k,
                             binning=binning, include_self=include_self,
                             radius_cell=radius_cell)
    return nl, binning


def pair_r2_cell(domain: Domain, state: RCLLState, nl: nnps.NeighborList, *,
                 dtype=NNPS_STORE, compute_dtype=None) -> torch.Tensor:
    """Eq. (7) squared pair distances (reference-cell units) for ``nl``,
    in the arithmetic of :func:`nnps.rcll_neighbors`, so a radius filter
    on them reproduces a fresh search's decisions bit for bit."""
    cdt = compute_dtype or dtype
    idx = nl.idx.long()
    rel = state.rel.to(dtype)
    delta = domain.wrap_cell_delta(state.cell_xy[:, None, :] - state.cell_xy[idx])
    w = torch.tensor(domain.cell_weights, dtype=torch.float32, device=rel.device)
    return nnps.rcll_r2_cell_units(rel[:, None, :], rel[idx], delta, w, dtype=cdt)


def decode_pair_disp(domain: Domain, rel_i: torch.Tensor, rel_j: torch.Tensor,
                     delta: torch.Tensor, dtype=torch.float32
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Eq. (7) reconstruction of the physical pair displacement x_i - x_j.

    Per axis: half the relative payload difference plus the integer cell
    delta I - J (min-image wrapped), at ``dtype``, then cell units to
    normalized to physical units. Returns (disp (..., d), r (...,)).
    """
    du = (rel_i.to(dtype) - rel_j.to(dtype)) * 0.5 + delta.to(dtype)
    hc = torch.tensor(domain.hc_norm_axes, dtype=dtype, device=du.device)
    disp_phys = (du * hc) * (domain.h_d / 2.0)
    r = torch.sqrt(nnps._sum_last(disp_phys * disp_phys))
    return disp_phys, r


def pair_displacements(domain: Domain, state: RCLLState, nl: nnps.NeighborList,
                       dtype=torch.float32) -> tuple[torch.Tensor, torch.Tensor]:
    """Physical displacements x_i - x_j (N, K, d) and distances (N, K) of
    the pairs in ``nl``, decoded at ``dtype`` by :func:`decode_pair_disp`."""
    idx = nl.idx.long()
    delta = domain.wrap_cell_delta(state.cell_xy[:, None, :] - state.cell_xy[idx])
    return decode_pair_disp(domain, state.rel[:, None, :], state.rel[idx], delta, dtype=dtype)
