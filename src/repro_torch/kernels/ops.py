"""Wrappers around the port's kernels and the cell-table packing they need.

Port of ``repro.kernels.ops``. The kernels consume cell-major tables
``(C+1, F, cap)``; row C is a sentinel empty cell that out-of-domain
neighborhood slots point at.

  * The force pass: the persistent pipeline's arrays are cell-sorted, so
    the per-step tiles are built by one sweep of the cell-pack kernel
    (K1) from two record slabs — a 16-bit ``[rel | shift | v]`` slab and
    an fp32 ``[1/ρ | ...]`` slab — and consumed by the force kernel (K2).
  * The NNPS path: :func:`pack_cells` gathers a binning's particles into
    the tables, and the neighbor lists (K4), the dense adjacency (K5) and
    the fused A5 gradient (K3) come back per particle.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core import cells as cells_lib
from repro_torch.core import fused
from repro_torch.core import nnps as nnps_lib
from repro_torch.core import rcll as rcll_lib
from repro_torch.core import scheme as scheme_lib
from repro_torch.core import sph, tracing
from repro_torch.core.domain import Domain
from repro_torch.core.precision import NNPS_STORE
from repro_torch.kernels import cell_pack, nnps_pairwise, rcll_force, sph_gradient


def cell_neighbor_ids(domain: Domain) -> np.ndarray:
    """(C, M) int32 flat neighbor-cell ids per cell; invalid -> sentinel C."""
    ncells = np.asarray(domain.ncells)
    C = int(np.prod(ncells))
    dim = domain.dim
    offs = cells_lib.neighbor_cell_offsets(dim)  # (M, d)
    coords = np.stack(
        np.meshgrid(*[np.arange(n) for n in ncells], indexing="ij"), -1
    ).reshape(C, dim)
    nb = coords[:, None, :] + offs[None, :, :]  # (C, M, d)
    per = np.asarray(domain.periodic)
    wrapped = np.where(per, nb % ncells, nb)
    valid = np.all((wrapped >= 0) & (wrapped < ncells), axis=-1)
    clipped = np.clip(wrapped, 0, ncells - 1)
    flat = clipped[..., 0]
    for a in range(1, dim):
        flat = flat * ncells[a] + clipped[..., a]
    return np.where(valid, flat, C).astype(np.int32)


def nb_with_sentinel(domain: Domain, device) -> torch.Tensor:
    """(C+1, M) int32 neighbor-cell ids; the sentinel row points at itself.

    Depends only on the Domain, so it is built once per (domain, device)
    and kept (a small bounded cache) instead of once per step.
    """
    return _nb_table(domain, str(torch.device(device)))


@functools.lru_cache(maxsize=8)
def _nb_table(domain: Domain, device: str) -> torch.Tensor:
    nb = cell_neighbor_ids(domain)
    nb = np.concatenate([nb, np.full((1, nb.shape[1]), nb.shape[0], nb.dtype)])
    return torch.as_tensor(nb, device=device)


def nb_lanes(domain: Domain, lanes: int, device) -> torch.Tensor:
    """(B·C+1, M) int32 neighbor-cell ids of ``lanes`` lanes folded into
    the cell axis: lane b's cells are rows b·C .. b·C + C - 1 with ids
    ``nb + b·C``, and every out-of-domain slot (the sentinel C) points at
    the one shared sentinel row B·C. Cached per (domain, B, device)."""
    return _nb_lanes_table(domain, int(lanes), str(torch.device(device)))


@functools.lru_cache(maxsize=8)
def _nb_lanes_table(domain: Domain, lanes: int, device: str) -> torch.Tensor:
    nb = cell_neighbor_ids(domain)
    c = nb.shape[0]
    shift = (np.arange(lanes, dtype=np.int64) * c)[:, None, None]
    folded = np.where(nb[None] == c, lanes * c, nb[None] + shift).reshape(lanes * c, -1)
    folded = np.concatenate([folded, np.full((1, nb.shape[1]), lanes * c)])
    return torch.as_tensor(folded.astype(np.int32), device=device)


def unpack_per_particle(table: torch.Tensor, binning: cells_lib.CellBinning) -> torch.Tensor:
    """Gather per-particle values out of a (C+1, cap, ...) table -> (N, ...)."""
    return cells_lib.from_cell_major(binning, table[: binning.table.shape[0]])


def _typed_row_table(binning: cells_lib.CellBinning, f: torch.Tensor, dtype,
                     fill: float = 0.0) -> torch.Tensor:
    """(C+1, cap) cell-major table of a per-particle scalar at ``dtype``."""
    ft = cells_lib.to_cell_major(binning, f.to(dtype), fill=fill)
    return torch.cat([ft, torch.full((1, ft.shape[1]), fill, dtype=ft.dtype,
                                     device=ft.device)])


def _row_table(binning: cells_lib.CellBinning, f: torch.Tensor,
               fill: float = 0.0) -> torch.Tensor:
    """(C+1, cap) f32 cell-major table of a per-particle scalar field;
    ``fill`` in empty slots and the sentinel row."""
    return _typed_row_table(binning, f, torch.float32, fill)


def pack_cells(binning: cells_lib.CellBinning, rel: torch.Tensor, *fields: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor, list[torch.Tensor]]:
    """Gather per-particle data into cell-major tables with the sentinel row.

    Returns (rel_table (C+1, d, cap) in rel's dtype, occ (C+1, cap) f32,
    one (C+1, cap) f32 table per field, zero in empty slots).
    """
    cap = binning.table.shape[1]
    d = rel.shape[1]
    dev = rel.device
    occ = torch.cat([(binning.table >= 0).to(torch.float32),
                     torch.zeros((1, cap), dtype=torch.float32, device=dev)])
    rel_t = cells_lib.to_cell_major(binning, rel).transpose(1, 2)
    rel_t = torch.cat([rel_t, torch.zeros((1, d, cap), dtype=rel.dtype, device=dev)])
    return rel_t.contiguous(), occ, [_row_table(binning, f) for f in fields]


def _nnps_args(domain: Domain, binning: cells_lib.CellBinning, rel: torch.Tensor, *fields):
    rel_t, occ, tables = pack_cells(binning, rel, *fields)
    kw = dict(weights=tuple(domain.cell_weights),
              r_cell=nnps_lib.rcll_radius_cell_units(domain))
    return rel_t, occ, tables, nb_with_sentinel(domain, rel.device), kw


def rcll_adjacency_cells(domain: Domain, binning: cells_lib.CellBinning, rel: torch.Tensor,
                         *, compute_dtype=torch.float32) -> tuple[torch.Tensor, torch.Tensor]:
    """The dense cell-blocked adjacency through K5.

    Returns (adj (C+1, M, cap, cap) f32, counts per particle (N,) f32).
    """
    rel_t, occ, _, nb, kw = _nnps_args(domain, binning, rel)
    adj, cnt = nnps_pairwise.rcll_adjacency(rel_t, occ, nb, compute_dtype=compute_dtype, **kw)
    return adj, unpack_per_particle(cnt, binning)


def rcll_neighbor_lists(domain: Domain, binning: cells_lib.CellBinning, rel: torch.Tensor,
                        *, k: int, radius_cell: float | None = None, nnps_dtype=NNPS_STORE,
                        compute_dtype=None) -> nnps_lib.NeighborList:
    """Per-particle neighbor lists through K4, in the indexing of
    ``binning.table``'s entries (original ids for ``bin_by_cell_id``).

    ``rel`` is stored at ``nnps_dtype``; ``compute_dtype`` defaults to
    fp32, with which fp16 storage decodes exactly. The lists hold the
    first K hits in (neighbor cell, slot) order, the order of
    :func:`nnps.rcll_neighbors`; ``count`` is the true count.
    """
    rel_t, occ, _, nb, kw = _nnps_args(domain, binning, rel.to(nnps_dtype))
    if radius_cell is not None:
        kw["r_cell"] = float(radius_cell)
    ids_t = torch.cat([binning.table, torch.full((1, binning.table.shape[1]), -1,
                                                 dtype=torch.int32, device=rel.device)])
    ids_out, cnt = nnps_pairwise.rcll_neighbor_list_tables(
        rel_t, occ, ids_t, nb, k_slots=k, compute_dtype=compute_dtype or torch.float32, **kw)
    idx = unpack_per_particle(ids_out, binning)
    count = unpack_per_particle(cnt, binning).to(torch.int32)
    return nnps_lib.NeighborList(idx=torch.clamp(idx, min=0), mask=idx >= 0, count=count)


def rcll_gradient_particles(domain: Domain, binning: cells_lib.CellBinning, rel: torch.Tensor,
                            f: torch.Tensor, *, nnps_dtype=NNPS_STORE,
                            eps: float = 1e-12) -> torch.Tensor:
    """Per-particle A5 gradient (N, d) through the fused kernel K3."""
    rel_t, occ, (f_t,), nb, kw = _nnps_args(domain, binning, rel, f)
    num, den = sph_gradient.rcll_gradient(
        rel_t, f_t, occ, nb, hc_phys=tuple(domain.cell_sizes), h=domain.h, dim=domain.dim,
        nnps_dtype=nnps_dtype, **kw)
    return unpack_per_particle((num / sph.guard_den(den, eps)).transpose(1, 2), binning)


def occupied_counts(binning: cells_lib.CellBinning) -> torch.Tensor:
    """(C+1,) int32 occupied slots per row of the binning's tables: its
    per-cell count clamped to cap, and 0 for the sentinel row."""
    counts = binning.counts.clamp(max=binning.table.shape[1]).to(torch.int32)
    return torch.cat([counts, counts.new_zeros(1)])


def mass_table(binning: cells_lib.CellBinning, m: torch.Tensor, records_dtype,
               m_scale: torch.Tensor | None = None) -> torch.Tensor:
    """(C+1, cap) static cell-major mass table for the force kernel.

    Built once per rebuild; half-width layouts store ``m / m_scale``.
    """
    if records_dtype.itemsize == 2:
        if m_scale is None:
            m_scale = fused.mass_scale(m)
        m = m.to(torch.float32) / m_scale
    return _typed_row_table(binning, m, records_dtype)


def rcll_force_particles(
    domain: Domain,
    binning: cells_lib.CellBinning,
    rc: rcll_lib.RCLLState,  # CURRENT state, packed indexing
    v: torch.Tensor,  # (N, d) f32
    m: torch.Tensor,  # (N,) f32
    rho: torch.Tensor,  # (N,) f32 current density
    *,
    scheme: scheme_lib.Scheme,
    records_dtype=torch.float32,
    m_scale: torch.Tensor | None = None,
    m_table: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The full SPH pair RHS through K1 (cell pack) and K2 (force).

    Returns (drho (N,), acc (N, d)); body force and wall handling are
    per-particle terms applied by the caller.

    REQUIRES the persistent pipeline's packed binning. Between Verlet
    rebuilds the binning is stale: a migrated particle still occupies
    its old slot, and the decode stays exact by streaming the int16 cell
    shift ``cell_now - cell_stale`` (minimum-image wrapped) next to the
    raw rel. Each field rides the slab of its own width: rel keeps its
    storage bits (fp16 in the 16-bit slab, fp32 coords in the fp32
    slab), the shift is always int16, v follows the records dtype.
    """
    d = rc.rel.shape[1]
    dev = rc.rel.device
    delta = domain.wrap_cell_delta(rc.cell_xy - binning.cell_xy)
    half = records_dtype.itemsize == 2
    if not half:
        m_scale = torch.ones((), dtype=torch.float32, device=dev)
    elif m_scale is None:
        m_scale = fused.mass_scale(m)
    if m_table is None:
        m_table = mass_table(binning, m, records_dtype, m_scale)

    rel_half = rc.rel.dtype.itemsize == 2
    cols16 = [delta.to(torch.int16)]
    cols32 = [(1.0 / rho).to(torch.float32)[:, None]]
    fill32 = [1.0 / scheme.rho0]
    if rel_half:
        cols16.insert(0, rc.rel.view(torch.int16))
    else:
        cols32.append(rc.rel.to(torch.float32))
        fill32 += [0.0] * d
    if half:
        cols16.append(v.to(records_dtype).view(torch.int16))
    else:
        cols32.append(v.to(torch.float32))
        fill32 += [0.0] * d
    starts = cells_lib.exclusive_cumsum(binning.counts)
    t16, t32, _ = cell_pack.cell_tables(
        torch.cat(cols16, dim=1).contiguous(),
        torch.cat(cols32, dim=1).contiguous(),
        starts,
        binning.counts.contiguous(),
        torch.tensor(fill32, dtype=torch.float32, device=dev),
        cap=binning.table.shape[1],
    )
    o16 = d if rel_half else 0  # 16-bit slab offset past rel
    o32 = 1 + (0 if rel_half else d)  # fp32 slab offset past inv, rel
    if rel_half:
        rel_t = t16[:, :d].contiguous().view(rc.rel.dtype)
    else:
        rel_t = t32[:, 1:1 + d].contiguous()
    shift_t = t16[:, o16:o16 + d].contiguous()
    if half:
        v_t = t16[:, o16 + d:o16 + 2 * d].contiguous().view(records_dtype)
    else:
        v_t = t32[:, o32:o32 + d].contiguous()
    inv_t = t32[:, 0].contiguous()
    drho_t, acc_t = rcll_force.rcll_force(
        rel_t, shift_t, v_t, m_table, inv_t, nb_with_sentinel(domain, dev),
        hc_phys=tuple(domain.cell_sizes),
        h=domain.h,
        dim=domain.dim,
        scheme=scheme,
        counts=occupied_counts(binning),
    )
    with tracing.span("rcll.unpack"):
        drho = unpack_per_particle(drho_t, binning)
        acc = unpack_per_particle(acc_t.transpose(1, 2), binning)
    return drho * m_scale, acc * m_scale


def _check_lane_index_range(lanes: int, n: int, c_total: int, cap: int, width: int) -> None:
    """Raise ValueError when the folded tables of ``lanes`` lanes would
    pass the kernels' 32-bit indexing: ``(B·C + 1)·F·cap`` table
    elements or ``B·N`` rows at or past 2^31 (``width`` is the widest
    table's F)."""
    if (lanes * c_total + 1) * width * cap > 2**31 - 1 or lanes * n > 2**31 - 1:
        raise ValueError(
            f"{lanes} lanes of N = {n}, C = {c_total}, cap = {cap}, F = {width} pass the "
            "kernels' 32-bit indexing; run fewer lanes a batch")


def _lane_rows(binning: cells_lib.CellBinning, starts: torch.Tensor) -> torch.Tensor:
    """(B, N) int64 flat slot of each lane's particle in the folded (B·C,
    cap) tables: row ``b·C + cell_id``, slot its rank in the cell. A
    particle the table dropped (overflow) reads its lane's cell 0, slot
    0, as :func:`cells.from_cell_major` reads a lane's slot 0."""
    lanes, n = binning.cell_id.shape
    c_total, cap = binning.table.shape[1:]
    dev = starts.device
    base = (torch.arange(lanes, device=dev) * c_total)[:, None]
    cid = binning.cell_id.long() + base
    slot = torch.arange(lanes * n, device=dev).reshape(lanes, n) - starts.long()[cid]
    return torch.where(slot < cap, cid * cap + slot, base * cap)


def rcll_force_lanes(
    domain: Domain,
    binning: cells_lib.CellBinning,  # every field with a leading lane axis B
    rc: rcll_lib.RCLLState,  # (B, N, d) CURRENT state, packed indexing per lane
    v: torch.Tensor,  # (B, N, d) f32
    m: torch.Tensor,  # (B, N) f32
    rho: torch.Tensor,  # (B, N) f32
    *,
    scheme: scheme_lib.Scheme,
    records_dtype=torch.float32,
    m_scale: torch.Tensor | None = None,  # (B,) f32
    m_table: torch.Tensor | None = None,  # (B, C+1, cap)
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`rcll_force_particles` for B same-shape lanes through ONE K1
    and ONE K2 launch, the lanes folded into the cell axis.

    Each lane's packed rows are cell-sorted, so the stacked ``(B, N, F)``
    record slabs viewed as ``(B·N, F)`` are cell-sorted lane after lane,
    and the exclusive cumsum of the flattened ``(B·C,)`` counts starts
    lane b's cells at ``b·N + local``: K1 writes ``(B·C+1, F, cap)``
    tables whose last row is the one shared sentinel, and K2 reads lane
    b's neighbor cells through :func:`nb_lanes`. REQUIRES each lane's
    counts to sum to its N (the caller checks it once per rebuild).

    Returns (drho (B, N), acc (B, N, d)), each lane's bit for bit those
    of :func:`rcll_force_particles` on that lane alone: K2 walks each
    row's neighbor cells in ``nb`` order and its slots in slot order, and
    the plain versions reduce per row over the slot axis, so no sum
    reaches across lanes.
    """
    lanes, n, d = rc.rel.shape
    c_total, cap = binning.table.shape[1:]
    rel_half = rc.rel.dtype.itemsize == 2
    half = records_dtype.itemsize == 2
    f16 = d * (1 + int(rel_half) + int(half))
    f32 = 1 + d * (int(not rel_half) + int(not half))
    _check_lane_index_range(lanes, n, c_total, cap, max(f16, f32, d))
    dev = rc.rel.device
    delta = domain.wrap_cell_delta(rc.cell_xy - binning.cell_xy)
    if not half:
        m_scale = torch.ones((lanes,), dtype=torch.float32, device=dev)
    elif m_scale is None:
        m_scale = torch.stack([fused.mass_scale(m[b]) for b in range(lanes)])
    if m_table is None:
        m_table = torch.stack([
            mass_table(cells_lib.CellBinning(*(f[b] for f in binning)), m[b],
                       records_dtype, m_scale[b]) for b in range(lanes)])

    cols16 = [delta.to(torch.int16)]
    cols32 = [(1.0 / rho).to(torch.float32)[..., None]]
    fill32 = [1.0 / scheme.rho0]
    if rel_half:
        cols16.insert(0, rc.rel.view(torch.int16))
    else:
        cols32.append(rc.rel.to(torch.float32))
        fill32 += [0.0] * d
    if half:
        cols16.append(v.to(records_dtype).view(torch.int16))
    else:
        cols32.append(v.to(torch.float32))
        fill32 += [0.0] * d
    counts = binning.counts.reshape(lanes * c_total).contiguous()
    starts = cells_lib.exclusive_cumsum(counts)
    t16, t32, _ = cell_pack.cell_tables(
        torch.cat(cols16, dim=-1).reshape(lanes * n, f16).contiguous(),
        torch.cat(cols32, dim=-1).reshape(lanes * n, f32).contiguous(),
        starts,
        counts,
        torch.tensor(fill32, dtype=torch.float32, device=dev),
        cap=cap,
    )
    o16 = d if rel_half else 0
    o32 = 1 + (0 if rel_half else d)
    if rel_half:
        rel_t = t16[:, :d].contiguous().view(rc.rel.dtype)
    else:
        rel_t = t32[:, 1:1 + d].contiguous()
    shift_t = t16[:, o16:o16 + d].contiguous()
    if half:
        v_t = t16[:, o16 + d:o16 + 2 * d].contiguous().view(records_dtype)
    else:
        v_t = t32[:, o32:o32 + d].contiguous()
    inv_t = t32[:, 0].contiguous()
    m_t = torch.cat([m_table[:, :c_total].reshape(lanes * c_total, cap),
                     m_table[0, c_total:]])
    occupied = torch.cat([counts.clamp(max=cap).to(torch.int32), counts.new_zeros(1)])
    drho_t, acc_t = rcll_force.rcll_force(
        rel_t, shift_t, v_t, m_t, inv_t, nb_lanes(domain, lanes, dev),
        hc_phys=tuple(domain.cell_sizes),
        h=domain.h,
        dim=domain.dim,
        scheme=scheme,
        counts=occupied,
    )
    pos = _lane_rows(binning, starts)
    drho = drho_t[:lanes * c_total].reshape(-1)[pos] * m_scale[:, None]
    acc = (acc_t[:lanes * c_total].transpose(1, 2).reshape(-1, d)[pos]
           * m_scale[:, None, None])
    return drho, acc
