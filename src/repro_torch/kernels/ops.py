"""Wrappers around the port's kernels: cell-table packing for the force pass.

Port of the force-pass half of ``repro.kernels.ops``. The kernels consume
cell-major tables ``(C+1, F, cap)``; row C is a sentinel empty cell that
out-of-domain neighborhood slots point at. Because the persistent
pipeline's arrays are cell-sorted, the per-step tiles are built by one
sweep of the cell-pack kernel (K1) from two record slabs — a 16-bit
``[rel | shift | v]`` slab and an fp32 ``[1/ρ | ...]`` slab — and consumed
by the force kernel (K2).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core import cells as cells_lib
from repro_torch.core import fused
from repro_torch.core import rcll as rcll_lib
from repro_torch.core import scheme as scheme_lib
from repro_torch.core.domain import Domain
from repro_torch.kernels import cell_pack, rcll_force


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


def unpack_per_particle(table: torch.Tensor, binning: cells_lib.CellBinning) -> torch.Tensor:
    """Gather per-particle values out of a (C+1, cap, ...) table -> (N, ...)."""
    return cells_lib.from_cell_major(binning, table[: binning.table.shape[0]])


def _typed_row_table(binning: cells_lib.CellBinning, f: torch.Tensor, dtype,
                     fill: float = 0.0) -> torch.Tensor:
    """(C+1, cap) cell-major table of a per-particle scalar at ``dtype``."""
    ft = cells_lib.to_cell_major(binning, f.to(dtype), fill=fill)
    return torch.cat([ft, torch.full((1, ft.shape[1]), fill, dtype=ft.dtype,
                                     device=ft.device)])


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
    )
    drho = unpack_per_particle(drho_t, binning) * m_scale
    acc = unpack_per_particle(acc_t.transpose(1, 2), binning) * m_scale
    return drho, acc
