"""Cell-pair tile math shared by the plain versions of the RCLL kernels.

Port of ``repro.kernels.tiling``; the CUDA kernels carry the same math
in ``csrc/tiling.cuh``. Tiles may have leading batch dimensions:
``(..., d, cap)`` in, ``(..., cap_i, cap_j)`` out.
"""
from __future__ import annotations

import torch

from repro_torch.core.nnps import const


def tile_r2_cell(
    rel_i: torch.Tensor,  # (..., d, cap) self-cell relative coords
    rel_j: torch.Tensor,  # (..., d, cap) neighbor-cell relative coords
    off_k,  # (d,) neighborhood offset (j_cell - i_cell), small integers
    weights: tuple,  # (d,) anisotropy weights hc_a / hc_ref
    dtype,
) -> torch.Tensor:
    """Eq. (7) squared distances in reference-cell units, (..., cap_i, cap_j).

    The NNPS tier: every op rounds to ``dtype`` (fp16 is the paper's
    arithmetic), in this order: du = (r_i - r_j)·0.5, du = (du - off)·w,
    d2 += du·du, axis by axis. The weights round to ``dtype`` once from
    double. The CUDA kernels use the explicitly rounded intrinsics in the
    same order, so their decisions equal these bit for bit.
    """
    d = rel_i.shape[-2]
    dev = rel_i.device
    ri = rel_i.to(dtype)
    rj = rel_j.to(dtype)
    half = const(0.5, dtype, dev)
    d2 = None
    for a in range(d):
        du = (ri[..., a, :, None] - rj[..., a, None, :]) * half
        du = (du - const(float(off_k[a]), dtype, dev)) * const(weights[a], dtype, dev)
        d2 = du * du if d2 is None else d2 + du * du
    return d2


def tile_phys_disp(
    rel_i: torch.Tensor,  # (..., d, cap) self-cell relative coords (any float dtype)
    rel_j: torch.Tensor,  # (..., d, cap)
    off_k,  # (d,) neighborhood offset, small integers
    hc_phys: tuple,  # (d,) physical cell edges
) -> tuple[list[torch.Tensor], torch.Tensor]:
    """Physics-tier (fp32) pair displacement x_i - x_j per axis, and r²:
    ``((rel_i - rel_j)/2 - off) * hc``, the tile form of
    ``rcll.decode_pair_disp``."""
    return tile_phys_disp_shifted(rel_i, rel_j, None, None, off_k, hc_phys)


def tile_occ_pair(occ_i: torch.Tensor, occ_j: torch.Tensor) -> torch.Tensor:
    """(..., cap_i, cap_j) bool: both slots occupied."""
    return (occ_i[..., :, None] > 0) & (occ_j[..., None, :] > 0)


def tile_self_mask(cap: int, device=None) -> torch.Tensor:
    """(cap, cap) bool identity: the self pair of a self-cell tile."""
    return torch.eye(cap, dtype=torch.bool, device=device)


def tile_pair_mask(occ_i: torch.Tensor, occ_j: torch.Tensor, is_self_cell: torch.Tensor,
                   cap: int) -> torch.Tensor:
    """Occupancy mask with the self pair (same cell, same slot) removed;
    ``is_self_cell`` is a bool per leading tile index."""
    self_pair = is_self_cell[..., None, None] & tile_self_mask(cap, occ_i.device)
    return tile_occ_pair(occ_i, occ_j) & ~self_pair


def tile_phys_disp_shifted(
    rel_i: torch.Tensor,  # (..., d, cap) raw storage-dtype relative coords
    rel_j: torch.Tensor,  # (..., d, cap)
    shift_i: torch.Tensor | None,  # (..., d, cap) int16 cell shift (cell_now - cell_stale)
    shift_j: torch.Tensor | None,  # (..., d, cap); None: no shift
    off_k,  # (d,) neighborhood offset (j_cell - i_cell), small integers
    hc_phys: tuple,  # (d,) physical cell edges
) -> tuple[list[torch.Tensor], torch.Tensor]:
    """Shift-anchored fp32 pair displacement x_i - x_j per axis, and r².

    The stale-binning re-anchor ``rel' = rel + 2·shift`` happens in
    fp32; the decode is ``((rel'_i - rel'_j)/2 - off) * hc``.
    """
    d = rel_i.shape[-2]
    disp = []
    r2 = None
    for a in range(d):
        ri = rel_i[..., a, :].to(torch.float32)
        rj = rel_j[..., a, :].to(torch.float32)
        if shift_i is not None:
            ri = ri + 2.0 * shift_i[..., a, :].to(torch.float32)
            rj = rj + 2.0 * shift_j[..., a, :].to(torch.float32)
        du = (ri[..., :, None] - rj[..., None, :]) * 0.5 - float(off_k[a])
        dx = du * hc_phys[a]
        disp.append(dx)
        r2 = dx * dx if r2 is None else r2 + dx * dx
    return disp, r2
