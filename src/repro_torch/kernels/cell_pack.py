"""K1: one-sweep cell-major packing of cell-sorted rows.

Replaces the Pallas kernel ``repro/kernels/cell_pack.py::cell_tables``
with the hand-written CUDA kernel ``csrc/cell_pack.cu``. The persistent
pipeline's arrays are cell-sorted, so cell c's tile is the contiguous
row slice ``starts[c] .. starts[c] + counts[c] - 1``: one block per cell
copies it from a 16-bit slab and an fp32 slab, masks slots past the
occupancy, transposes to ``(F, cap)`` and emits the packed-id table.

On the H100 the kernel is bound by bytes: it reads the two row slabs
once and writes the three tables once (about 17 MB read and 73 MB
written per step for 2-D fp16 records at N = 1,048,576), with no
arithmetic. The simple design (one block per cell, strided row reads)
leaves vector loads and several-cells-per-block on the table; see the
note in the CUDA source.

:func:`cell_tables` launches the kernel for CUDA tensors and takes the
plain version :func:`cell_tables_ref` only for CPU tensors; the outputs
are bit-identical. ``cell_tables.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build


def cell_tables_ref(
    rows16: torch.Tensor,  # (N, F16) int16 cell-sorted 16-bit record rows
    rows32: torch.Tensor,  # (N, F32) f32 cell-sorted fp32 rows
    starts: torch.Tensor,  # (C,) int32 exclusive cumsum of counts
    counts: torch.Tensor,  # (C,) int32 per-cell occupancy
    fill32: torch.Tensor,  # (F32,) f32 empty-slot fill per fp32 column
    *,
    cap: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`cell_tables` (gather formulation).

    Returns ``(t16 (C+1, F16, cap) int16, t32 (C+1, F32, cap) f32,
    ids (C+1, cap) int32)``; row C is the sentinel empty cell.
    """
    n = rows16.shape[0]
    dev = rows16.device
    starts_s = torch.cat([starts.to(torch.int32),
                          torch.full((1,), n, dtype=torch.int32, device=dev)])
    counts_s = torch.cat([counts.to(torch.int32),
                          torch.zeros((1,), dtype=torch.int32, device=dev)])
    slot = torch.arange(cap, dtype=torch.int32, device=dev)[None, :]
    ids = starts_s[:, None] + slot  # (C+1, cap)
    occ = slot < counts_s[:, None]
    safe = torch.clamp(ids, 0, max(n - 1, 0)).long()
    t16 = torch.where(occ[..., None], rows16[safe], torch.zeros((), dtype=rows16.dtype, device=dev))
    t32 = torch.where(occ[..., None], rows32[safe], fill32[None, None, :])
    return (
        t16.transpose(1, 2).contiguous(),
        t32.transpose(1, 2).contiguous(),
        torch.where(occ, ids, torch.full_like(ids, -1)),
    )


@functools.cache
def _entry():
    fn = _build.library().lib.repro_cell_tables
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def cell_tables(
    rows16: torch.Tensor,
    rows32: torch.Tensor,
    starts: torch.Tensor,
    counts: torch.Tensor,
    fill32: torch.Tensor,
    *,
    cap: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-sweep cell-major tables from cell-sorted rows (see module doc).

    CPU tensors take :func:`cell_tables_ref`; CUDA tensors launch the
    kernel or raise.
    """
    dev = rows16.device
    if dev.type == "cpu":
        return cell_tables_ref(rows16, rows32, starts, counts, fill32, cap=cap)
    if dev.type != "cuda":
        raise ValueError(f"cell_tables runs on cuda or cpu tensors, got {dev}")
    n, f16 = rows16.shape
    f32 = rows32.shape[1]
    c_total = starts.shape[0]
    _check(rows16, "rows16", torch.int16, (n, f16), dev)
    _check(rows32, "rows32", torch.float32, (n, f32), dev)
    _check(starts, "starts", torch.int32, (c_total,), dev)
    _check(counts, "counts", torch.int32, (c_total,), dev)
    _check(fill32, "fill32", torch.float32, (f32,), dev)
    if cap < 1 or f16 < 1 or f32 < 1:
        raise ValueError(f"cap, F16 and F32 must be >= 1, got {cap}, {f16}, {f32}")
    t16 = torch.empty((c_total + 1, f16, cap), dtype=torch.int16, device=dev)
    t32 = torch.empty((c_total + 1, f32, cap), dtype=torch.float32, device=dev)
    ids = torch.empty((c_total + 1, cap), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _entry()(
            rows16.data_ptr(), rows32.data_ptr(), starts.data_ptr(),
            counts.data_ptr(), fill32.data_ptr(), t16.data_ptr(),
            t32.data_ptr(), ids.data_ptr(), n, c_total, f16, f32, cap, stream,
        )
    _build.check_rc(rc, "cell_tables")
    _WRAPPER.launches += 1
    return t16, t32, ids


cell_tables.launches = 0
# The counter lives on this function object even if the module attribute
# is rebound (e.g. by a harness that wraps the wrapper).
_WRAPPER = cell_tables
