"""Static-capacity background-cell binning and the cell-packed layout.

Port of ``repro.core.cells``. ``bin_by_cell_id`` bins a state in its own
order (the table holds original particle ids; the NNPS path), and
``gather_candidates`` reads each particle's 3^d-cell candidate ids from
that table. For the persistent pipeline particles
are stably sorted by flat cell id (the paper's xy-sort locality
optimization), after which cell c's occupants are exactly the packed ids
``starts[c] .. starts[c] + counts[c] - 1`` and the ``(C, cap)`` cell
table is pure arithmetic. A rebuild re-sorts with an O(3^d N) counting
sort that reuses the previous packed order; a host-side check falls back
to a stable argsort when a particle out-ran its 3^d neighborhood (the
permutation is identical either way). On the card ``kernels/cell_sort.py``
runs the counting sort, with this path as its plain version.

Integer state (cell ids, counts, tables, permutations) is int32, as in
the JAX package; indexing converts to int64 where torch needs it.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.domain import Domain


class CellBinning(NamedTuple):
    """Binning of N particles into the background grid.

    table:    (C, cap) int32 particle ids, -1 padded.
    counts:   (C,) int32 occupancy (may exceed cap; see ``overflow``).
    cell_id:  (N,) int32 flat cell id per particle.
    cell_xy:  (N, dim) int32 per-axis cell coordinates per particle.
    order:    (N,) int32 spatial sort permutation.
    overflow: () int32 number of particles the table dropped.
    """

    table: torch.Tensor
    counts: torch.Tensor
    cell_id: torch.Tensor
    cell_xy: torch.Tensor
    order: torch.Tensor
    overflow: torch.Tensor


def neighbor_cell_offsets(dim: int) -> np.ndarray:
    """All 3^dim offsets in {-1,0,1}^dim (static, host-side)."""
    grids = np.meshgrid(*([np.array([-1, 0, 1])] * dim), indexing="ij")
    return np.stack([g.ravel() for g in grids], axis=-1).astype(np.int32)


def bin_particles(domain: Domain, xn: torch.Tensor, capacity: int) -> CellBinning:
    """Assign particles (normalized coords ``xn``, fp32 or wider) to
    cells; binning is an integer decision and never runs low-precision."""
    cell_xy = domain.cell_coords_of(xn)
    cell_id = domain.flat_cell_id(cell_xy)
    return bin_by_cell_id(domain, cell_id, cell_xy, capacity)


def _table_from_sorted(n_total: int, sorted_cid: torch.Tensor, values: torch.Tensor,
                       capacity: int):
    """Scatter cell-sorted per-particle ``values`` into the (C, cap) table.

    Each particle's slot is its rank within its cell; entries past
    ``capacity`` go to a scratch row that is sliced off. Returns
    (table, counts, overflow).
    """
    npart = sorted_cid.shape[0]
    dev = sorted_cid.device
    cid = sorted_cid.long()
    counts = torch.bincount(cid, minlength=n_total).to(torch.int32)
    slot = torch.arange(npart, dtype=torch.int32, device=dev) - exclusive_cumsum(counts)[cid]
    keep = slot < capacity
    overflow = torch.sum(~keep).to(torch.int32)
    safe_cid = torch.where(keep, cid, n_total)
    safe_slot = torch.where(keep, slot, 0).long()
    table = torch.full((n_total + 1, capacity), -1, dtype=torch.int32, device=dev)
    table[safe_cid, safe_slot] = values.to(torch.int32)
    return table[:n_total], counts, overflow


def bin_by_cell_id(domain: Domain, cell_id: torch.Tensor, cell_xy: torch.Tensor,
                   capacity: int) -> CellBinning:
    """Bin from a precomputed cell assignment (the RCLL state's own cell
    coordinates, never recomputed from absolute positions). The stable
    sort by cell id is the paper's spatial sort; the table holds the
    original particle ids."""
    order = torch.argsort(cell_id, stable=True).to(torch.int32)
    table, counts, overflow = _table_from_sorted(
        domain.ncells_total, cell_id[order.long()], order, capacity)
    return CellBinning(table=table, counts=counts, cell_id=cell_id, cell_xy=cell_xy,
                       order=order, overflow=overflow)


def candidate_cells(domain: Domain, cell_xy: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Flat ids of each particle's 3^dim neighborhood cells.

    Returns (nb_flat (N, 3^dim) int32, nb_valid (N, 3^dim) bool): periodic
    axes wrap, out-of-range cells on wall axes are invalid.
    """
    dev = cell_xy.device
    offs = torch.as_tensor(neighbor_cell_offsets(domain.dim), device=dev)
    nb = cell_xy[:, None, :] + offs[None, :, :]
    n = torch.tensor(domain.ncells, dtype=torch.int32, device=dev)
    per = torch.tensor(domain.periodic, dtype=torch.bool, device=dev)
    wrapped = torch.where(per, torch.remainder(nb, n), nb)
    valid = torch.all((wrapped >= 0) & (wrapped < n), dim=-1)
    clipped = torch.clamp(wrapped, min=torch.zeros_like(n), max=n - 1)
    return _flat_of(domain, clipped).to(torch.int32), valid


def gather_candidates(domain: Domain, binning: CellBinning) -> tuple[torch.Tensor, torch.Tensor]:
    """Candidate particle ids from each particle's 3^dim cell neighborhood.

    Returns (cand (N, 3^dim·cap) int32, invalid -> 0; mask (N, 3^dim·cap)
    bool, slot occupied and cell valid).
    """
    nb_flat, nb_valid = candidate_cells(domain, binning.cell_xy)
    cand = binning.table[nb_flat.long()]
    mask = (cand >= 0) & nb_valid[:, :, None]
    npart = binning.cell_id.shape[0]
    cand = torch.where(mask, cand, torch.zeros_like(cand))
    return cand.reshape(npart, -1), mask.reshape(npart, -1)


class CellPacking(NamedTuple):
    """Spatial-sort permutation plus the binning of the packed arrays.

    order:   (N,) int32, packed position -> original particle id.
    inverse: (N,) int32, original particle id -> packed position.
    binning: CellBinning over the PACKED arrays (its table holds packed
             ids; its own ``order`` is the identity).
    """

    order: torch.Tensor
    inverse: torch.Tensor
    binning: CellBinning

    def pack(self, x: torch.Tensor) -> torch.Tensor:
        """Reorder a per-particle array (original -> packed indexing)."""
        return x[self.order.long()]


def inverse_permutation(order: torch.Tensor) -> torch.Tensor:
    """Inverse of a permutation given as an int32 index array."""
    n = order.shape[0]
    inv = torch.zeros((n,), dtype=torch.int32, device=order.device)
    inv[order.long()] = torch.arange(n, dtype=torch.int32, device=order.device)
    return inv


def exclusive_cumsum(counts: torch.Tensor) -> torch.Tensor:
    """Exclusive prefix sum of per-cell counts: packed start of each cell."""
    zero = torch.zeros((1,), dtype=torch.int32, device=counts.device)
    return torch.cat([zero, torch.cumsum(counts, 0).to(torch.int32)[:-1]])


def _packed_table(n_total: int, counts: torch.Tensor, capacity: int):
    """(C, cap) table of consecutive packed ids — no sort, no scatter.

    Returns (table, starts, overflow).
    """
    starts = exclusive_cumsum(counts)
    slot = torch.arange(capacity, dtype=torch.int32, device=counts.device)[None, :]
    occ = slot < torch.clamp(counts, max=capacity)[:, None]
    table = torch.where(occ, starts[:, None] + slot, torch.full_like(slot, -1))
    overflow = torch.clamp(counts - capacity, min=0).sum().to(torch.int32)
    return table, starts, overflow


def _flat_of(domain: Domain, coords: torch.Tensor) -> torch.Tensor:
    flat = coords[..., 0]
    for a in range(1, domain.dim):
        flat = flat * domain.ncells[a] + coords[..., a]
    return flat


def _counting_sort_positions(
    domain: Domain,
    cell_id: torch.Tensor,  # (N,) flat cell id per particle, current order
    cell_xy: torch.Tensor,  # (N, d) per-axis cell coords
    prev_cell_id: torch.Tensor,  # (N,) previous flat cell id (non-decreasing)
    prev_counts: torch.Tensor,  # (C,) previous per-cell occupancy
    prev_cell_xy: torch.Tensor,  # (N, d) previous per-axis cell coords
) -> torch.Tensor:
    """Stable counting-sort positions: bincount → exclusive scan → rank.

    The slot of every particle under a stable sort by ``cell_id`` — the
    permutation of ``argsort(cell_id, stable=True)`` — from (a) an
    arrival histogram over the 3^d migration offsets (whole earlier
    runs sending particles to the same cell) and (b) a within-run
    exclusive prefix count per offset.

    PRECONDITION (checked by the caller): per-axis min-image cell deltas
    all in {-1, 0, 1}.
    """
    dim = domain.dim
    m = 3**dim
    c_total = domain.ncells_total
    dev = cell_id.device
    offs = torch.as_tensor(neighbor_cell_offsets(dim), device=dev)  # (m, d)
    delta = domain.wrap_cell_delta(cell_xy - prev_cell_xy)  # (N, d)
    o = delta[:, 0] + 1
    for a in range(1, dim):
        o = o * 3 + (delta[:, a] + 1)
    d_hist = torch.bincount(
        (cell_id * m + o).long(), minlength=c_total * m
    ).to(torch.int32).reshape(c_total, m)
    src = cell_xy[:, None, :] - offs[None, :, :]  # (N, m, d)
    n_ax = torch.tensor(domain.ncells, dtype=torch.int32, device=dev)
    per = torch.tensor(domain.periodic, dtype=torch.bool, device=dev)
    wrapped = torch.where(per, torch.remainder(src, n_ax), src)
    valid = torch.all((wrapped >= 0) & (wrapped < n_ax), dim=-1)  # (N, m)
    clipped = torch.clamp(wrapped, min=torch.zeros_like(n_ax), max=n_ax - 1)
    src_flat = _flat_of(domain, clipped)
    g = prev_cell_id
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    before = torch.sum(
        torch.where(valid & (src_flat < g[:, None]), d_hist[cell_id.long()], zero),
        dim=1,
    ).to(torch.int32)
    seg_start = exclusive_cumsum(prev_counts)[g.long()].long()  # (N,)
    within = torch.zeros_like(cell_id)
    for k in range(m):
        hit = o == k
        mk = hit.to(torch.int32)
        ex = torch.cumsum(mk, 0).to(torch.int32) - mk  # exclusive prefix
        within = within + torch.where(hit, ex - ex[seg_start], zero)
    starts_new = exclusive_cumsum(d_hist.sum(dim=1).to(torch.int32))
    return starts_new[cell_id.long()] + before + within


def _argsort_positions(cell_id: torch.Tensor) -> torch.Tensor:
    """Oracle path: stable-argsort positions (new packed slot of each row)."""
    order = torch.argsort(cell_id, stable=True).to(torch.int32)
    return inverse_permutation(order)


def pack_particles(
    domain: Domain,
    cell_id: torch.Tensor,
    cell_xy: torch.Tensor,
    capacity: int,
    prev: CellBinning | None = None,
) -> CellPacking:
    """Spatially sort particles by flat cell id and bin the sorted set.

    ``prev=None`` stable-argsorts. With ``prev`` — the binning of the
    order the inputs are currently in — the sort is the counting-sort
    pack, unless some particle moved more than one cell per axis since
    then: that check is read on the host (one sync per rebuild) and
    selects the argsort oracle instead. The permutation is identical
    either way.
    """
    npart = cell_id.shape[0]
    dev = cell_id.device
    if prev is None:
        pos = _argsort_positions(cell_id)
    else:
        delta = domain.wrap_cell_delta(cell_xy - prev.cell_xy)
        adjacent = bool(torch.max(torch.abs(delta)) <= 1) if npart else True
        if adjacent:
            pos = _counting_sort_positions(
                domain, cell_id, cell_xy, prev.cell_id, prev.counts, prev.cell_xy
            )
        else:
            pos = _argsort_positions(cell_id)
    inverse = pos
    order = torch.zeros((npart,), dtype=torch.int32, device=dev)
    order[pos.long()] = torch.arange(npart, dtype=torch.int32, device=dev)
    counts = torch.bincount(
        cell_id.long(), minlength=domain.ncells_total
    ).to(torch.int32)
    table, _, overflow = _packed_table(domain.ncells_total, counts, capacity)
    ol = order.long()
    binning = CellBinning(
        table=table,
        counts=counts,
        cell_id=cell_id[ol],
        cell_xy=cell_xy[ol],
        order=torch.arange(npart, dtype=torch.int32, device=dev),
        overflow=overflow,
    )
    return CellPacking(order=order, inverse=inverse, binning=binning)


def to_cell_major(binning: CellBinning, x: torch.Tensor, fill=0) -> torch.Tensor:
    """Gather a per-particle array into the (C, cap, ...) layout; empty
    slots hold ``fill``."""
    safe = torch.clamp(binning.table, min=0).long()
    occ = binning.table >= 0
    out = x[safe]
    shape = occ.shape + (1,) * (out.ndim - 2)
    return torch.where(occ.reshape(shape), out, torch.full_like(out, fill))


def from_cell_major(binning: CellBinning, table_vals: torch.Tensor) -> torch.Tensor:
    """Gather per-particle values back out of a (C, cap, ...) table.

    Inverse of :func:`to_cell_major` for occupied slots; particles the
    table dropped (overflow) read slot 0.
    """
    n = binning.cell_id.shape[0]
    flat = table_vals.reshape((-1,) + tuple(table_vals.shape[2:]))
    ids = binning.table.reshape(-1)
    occ = ids >= 0
    tpos = torch.arange(ids.shape[0], device=ids.device)
    slot_of = torch.zeros((n,), dtype=torch.int64, device=ids.device)
    slot_of[ids[occ].long()] = tpos[occ]
    return flat[slot_of]


def _shifted_zero(grid: torch.Tensor, off: int, axis: int) -> torch.Tensor:
    """Shift ``grid`` so out[i] = grid[i + off] along ``axis``, zero-filled."""
    if off == 0:
        return grid
    out = torch.zeros_like(grid)
    n = grid.shape[axis]
    if off > 0:
        out.narrow(axis, 0, n - off).copy_(grid.narrow(axis, off, n - off))
    else:
        out.narrow(axis, -off, n + off).copy_(grid.narrow(axis, 0, n + off))
    return out


def max_neighborhood_occupancy(domain: Domain, counts: torch.Tensor) -> torch.Tensor:
    """Max over cells of the total 3^dim-neighborhood occupancy (a device
    scalar): the exact per-particle candidate-demand bound of the merged-
    window search, and an upper bound on any particle's true neighbor
    count. The health guard's regrow sizes ``window`` and
    ``max_neighbors`` from it."""
    grid = counts.reshape(tuple(domain.ncells))
    total = torch.zeros_like(grid)
    for off in neighbor_cell_offsets(domain.dim):
        g = grid
        for a, o in enumerate(off):
            if o == 0:
                continue
            if domain.periodic[a]:
                g = torch.roll(g, -int(o), dims=a)
            else:
                g = _shifted_zero(g, int(o), axis=a)
        total = total + g
    return torch.max(total)


def default_capacity(domain: Domain, n_particles: int, safety: float = 3.0) -> int:
    """Per-cell capacity estimate: mean occupancy x safety, >= 4."""
    mean = n_particles / max(1, domain.ncells_total)
    cap = int(np.ceil(mean * safety)) + 2
    return max(4, cap)


def dense_capacity(domain: Domain, ds: float, safety: float = 1.5) -> int:
    """Per-cell capacity for a close-packed region at lattice spacing ds."""
    edge = max(domain.cell_sizes) / ds + 1.0
    return max(4, int(np.ceil(edge**domain.dim * safety)))


def robust_capacity(domain: Domain, ds: float, n_particles: int) -> int:
    """The per-cell capacity rule for solver configs: the larger of the
    domain-mean and the close-packed estimates."""
    return max(default_capacity(domain, n_particles), dense_capacity(domain, ds))
