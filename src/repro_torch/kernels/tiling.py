"""Cell-pair tile math shared by the plain versions of the RCLL kernels.

Port of ``repro.kernels.tiling.tile_phys_disp_shifted``; the CUDA kernel
carries the same decode in ``csrc/tiling.cuh``. Tiles may have leading
batch dimensions: ``(..., d, cap)`` in, ``(..., cap_i, cap_j)`` out.
"""
from __future__ import annotations

import torch


def tile_phys_disp_shifted(
    rel_i: torch.Tensor,  # (..., d, cap) raw storage-dtype relative coords
    rel_j: torch.Tensor,  # (..., d, cap)
    shift_i: torch.Tensor,  # (..., d, cap) int16 cell shift (cell_now - cell_stale)
    shift_j: torch.Tensor,  # (..., d, cap)
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
        ri = rel_i[..., a, :].to(torch.float32) + 2.0 * shift_i[..., a, :].to(torch.float32)
        rj = rel_j[..., a, :].to(torch.float32) + 2.0 * shift_j[..., a, :].to(torch.float32)
        du = (ri[..., :, None] - rj[..., None, :]) * 0.5 - float(off_k[a])
        dx = du * hc_phys[a]
        disp.append(dx)
        r2 = dx * dx if r2 is None else r2 + dx * dx
    return disp, r2
