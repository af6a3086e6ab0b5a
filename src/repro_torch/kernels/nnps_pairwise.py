"""K4 and K5: cell-blocked RCLL neighbor search over cell tables.

Replace the Pallas kernels ``repro/kernels/nnps_pairwise.py``
``rcll_neighbor_list_tables`` (K4) and ``rcll_adjacency`` (K5) with the
hand-written CUDA kernels in ``csrc/nnps_pairwise.cu``. Both walk the
same structure as the force pass: per self cell c, the 3^d neighbor
cells k of ``nb_ids`` in order, and per (c, k) tile of cap x cap pairs
the Eq. (7) decision in reference-cell units (``tiling.tile_r2_cell``,
every op rounded to the compute dtype) under the occupancy mask with the
self pair removed.

  * K4 emits each slot's neighbor ids compacted in (k, j) order into a
    K-wide row, -1 padded, and the TRUE hit count (which may exceed K:
    overflow is detected from it, never from the written slots);
  * K5 emits the dense {0,1} adjacency (C+1, M, cap, cap) f32 and the
    per-slot counts.

Inputs: ``rel (C+1, d, cap)`` in the storage dtype (fp16, bf16, fp32),
``occ (C+1, cap)`` f32 {0,1}, ``ids (C+1, cap)`` int32 (K4), ``nb_ids
(C+1, M)`` int32; row C is the sentinel empty cell. Compute dtype fp32
(default: fp16 storage decodes exactly) or fp16 (the paper's arithmetic).

On the H100 both are bound by bytes: K5 writes 4·M·cap² bytes per cell
(2.6 GB at the paper's N = 1,048,576 in 2-D), K4 4·cap·K (0.70 GB at K =
48), most of them zeros or -1 padding. The decision is ~10 operations
per pair. Both decide only pairs of occupied slots and stream their
output as 16-byte streaming stores. In K5 a warp owns a self cell and a
group of 32 self slots (:func:`adjacency_groups`) and keeps each row's
hits as bit masks (:func:`adjacency_regions`). K4 gives
one thread to each occupied self slot of :data:`LIST_CELLS` consecutive
cells, which walks the neighbors' occupied slots (their occupancy as bit
words from a first pass, :func:`staging_scratch`) and appends each hit
(its neighbor tile and slot, in 16 bits) to its row of a shared-memory
stage (:func:`list_stride`); the block writes the rows of its empty
slots before the walk and its staged rows, each hit's id gathered, after
it, as 16-byte streaming stores (:func:`list_regions`).

:func:`rcll_neighbor_list_tables` and :func:`rcll_adjacency` launch the
kernels for CUDA tensors and take the plain versions (``*_ref``) only for
CPU tensors; decisions, ids and counts are bit-identical. Each wrapper
counts its launches in ``.launches``.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.core import cells as cells_lib
from repro_torch.core.nnps import const
from repro_torch.kernels import _build, tiling
from repro_torch.kernels.rcll_force import _check

_REL_KIND = {torch.float16: 0, torch.bfloat16: 1, torch.float32: 2}
_COMPUTE_KIND = {torch.float16: 0, torch.float32: 1}

#: Peak bytes of pair intermediates per chunk of the plain versions.
REF_CHUNK_BYTES = 2 * 10**9


def _chunks(c1: int, cap: int, per_pair: int):
    step = max(1, REF_CHUNK_BYTES // (cap * cap * per_pair))
    return (slice(c0, min(c1, c0 + step)) for c0 in range(0, c1, step))


def _tile_decision(rel, occ, nb_ids, sl, k, offs, weights, r_cell, dtype):
    """(b, cap, cap) bool neighbor decisions of tile k for the cells ``sl``
    (Pallas: ``tile_r2_cell <= r2_cell`` and ``tile_pair_mask``)."""
    nbk = nb_ids[sl, k].long()
    d2 = tiling.tile_r2_cell(rel[sl], rel[nbk], offs[k], weights, dtype)
    ok = d2 <= const(float(r_cell) ** 2, dtype, rel.device)
    rows = torch.arange(sl.start, sl.stop, device=rel.device)
    return ok & tiling.tile_pair_mask(occ[sl], occ[nbk], nbk == rows, rel.shape[2])


def rcll_adjacency_ref(rel: torch.Tensor, occ: torch.Tensor, nb_ids: torch.Tensor, *,
                       weights: tuple, r_cell: float, compute_dtype=torch.float32
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`rcll_adjacency`: (adj (C+1, M, cap,
    cap) f32 {0,1}, counts (C+1, cap) f32), tile by tile in k order."""
    c1, d, cap = rel.shape
    m = nb_ids.shape[1]
    offs = cells_lib.neighbor_cell_offsets(d)
    adj = torch.empty((c1, m, cap, cap), dtype=torch.float32, device=rel.device)
    counts = torch.zeros((c1, cap), dtype=torch.float32, device=rel.device)
    for sl in _chunks(c1, cap, 16 * d):
        for k in range(m):
            ok = _tile_decision(rel, occ, nb_ids, sl, k, offs, weights, r_cell,
                                compute_dtype)
            adj[sl, k] = ok.to(torch.float32)
            counts[sl] += ok.sum(dim=2).to(torch.float32)
    return adj, counts


def rcll_neighbor_list_tables_ref(rel: torch.Tensor, occ: torch.Tensor, ids: torch.Tensor,
                                  nb_ids: torch.Tensor, *, weights: tuple, r_cell: float,
                                  k_slots: int, compute_dtype=torch.float32
                                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`rcll_neighbor_list_tables`: per slot
    the neighbor ids in (k, j) order, -1 padded to ``k_slots``, and the
    true counts. Hits of tile k land at a running prefix past the hits of
    tiles 0..k-1 (a scatter into a K+1-wide row whose last column takes
    the hits past K and is dropped)."""
    c1, d, cap = rel.shape
    m = nb_ids.shape[1]
    dev = rel.device
    offs = cells_lib.neighbor_cell_offsets(d)
    out = torch.full((c1, cap, k_slots + 1), -1, dtype=torch.int32, device=dev)
    counts = torch.zeros((c1, cap), dtype=torch.int64, device=dev)
    for sl in _chunks(c1, cap, 16 * d + 24):
        for k in range(m):
            ok = _tile_decision(rel, occ, nb_ids, sl, k, offs, weights, r_cell,
                                compute_dtype)
            target = counts[sl][:, :, None] + torch.cumsum(ok, dim=2) - 1
            target = torch.where(ok & (target < k_slots), target, k_slots)
            ids_j = ids[nb_ids[sl, k].long()][:, None, :].expand(ok.shape)
            out[sl] = out[sl].scatter(2, target, ids_j)
            counts[sl] += ok.sum(dim=2)
    return out[:, :, :k_slots].contiguous(), counts.to(torch.float32)


def kernel_params(*, weights: tuple, r_cell: float, compute_dtype):
    """The kernels' run-time parameters: the weights and r_cell² rounded
    once from double to the compute dtype on the host (as the plain
    version rounds them); the keep-the-self-pair flag (0), K4's padding id
    (-1) and K4's count-at-K flag (0, the true counts). A check can plant
    a fault through them without touching the source."""
    np_dt = np.float16 if compute_dtype == torch.float16 else np.float32
    w = [float(np_dt(x)) for x in weights] + [0.0] * (3 - len(weights))
    fparams = w + [float(np_dt(float(r_cell) ** 2))]
    return (ctypes.c_float * 4)(*fparams), (ctypes.c_int * 3)(0, -1, 0)


#: K4's faults that :func:`planted_params` plants.
FAULTS = ("pad_zero", "count_at_k")


def planted_params(fault: str):
    """A stand-in for :func:`kernel_params` with one of K4's faults
    planted: the lists padded with 0 instead of -1, or each count
    saturated at K. A check rebinds ``kernel_params`` to it, and must then
    fail; K5 reads neither field."""
    if fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}, not in {FAULTS}")
    clean = kernel_params

    def faulty(**kw):
        f, i = clean(**kw)
        i[FAULTS.index(fault) + 1] = 0 if fault == "pad_zero" else 1
        return f, i

    return faulty


#: Warps of a K5 block (``kAdjWarps`` in the CUDA source).
ADJ_WARPS = 8


def adjacency_groups(cap: int) -> int:
    """Warps of K5 per self cell: one for each group of 32 self slots."""
    return -(-cap // 32)


def adjacency_regions(c1: int, m: int, cap: int):
    """Yield (first element, length) of each contiguous region of the
    flat ``(C+1)·M·cap²`` output that one K5 warp writes, as the kernel
    computes them: at cap <= 32 a self cell's whole ``M·cap²`` region; at
    larger caps, per tile k, the group's rows of that tile."""
    groups = adjacency_groups(cap)
    for item in range(c1 * groups):
        c, g = divmod(item, groups)
        if groups == 1:
            yield c * m * cap * cap, m * cap * cap
            continue
        i0 = 32 * g
        for k in range(m):
            yield ((c * m + k) * cap + i0) * cap, min(32, cap - i0) * cap


#: Cells of a K4 block, its threads (one work row, an occupied self slot,
#: each a batch) and the shared memory its stage may take (``kListCells``,
#: ``kListThreads``, ``kListStageBytes`` in the CUDA source).
LIST_CELLS = 16
LIST_THREADS = 128
LIST_STAGE_BYTES = 24 * 1024


def list_stride(k_slots: int) -> int:
    """Hits a row of K4's stage holds (2 bytes each: the neighbor tile and
    slot, whose id the write-out gathers): K rounded up to a multiple of 4,
    then to an odd multiple of 4, so that a row's 4-hit reads are aligned
    and neighboring rows start on different banks; 0 (the unstaged path,
    each thread writing its own row) when the block's stage would pass
    :data:`LIST_STAGE_BYTES`."""
    stride = -(-k_slots // 4) * 4
    if stride % 8 == 0:
        stride += 4
    return stride if 2 * LIST_THREADS * stride <= LIST_STAGE_BYTES else 0


def staging_scratch(c1: int, cap: int, device, records: bool = False) -> list[torch.Tensor]:
    """Scratch of the staging pass K3 and K4 run first: each row's
    occupancy bit words and, with ``records``, each slot's record
    (coordinates and a payload, 16 bytes at most) for one load a slot."""
    out = [torch.empty((c1, -(-cap // 32)), dtype=torch.int32, device=device)]
    if records:
        out.append(torch.empty((c1, cap, 4), dtype=torch.int32, device=device))
    return out


def list_regions(c1: int, cap: int, k_slots: int):
    """Yield (first element, length) of each contiguous region of the
    flat ``(C+1)·cap·K`` output that one K4 block writes, as the kernel
    computes them: the rows of its :data:`LIST_CELLS` cells."""
    for c0 in range(0, c1, LIST_CELLS):
        yield c0 * cap * k_slots, min(LIST_CELLS, c1 - c0) * cap * k_slots


@functools.cache
def _entries():
    lib = _build.library().lib
    lists = lib.repro_rcll_neighbor_lists
    lists.argtypes = ([ctypes.c_int] * 3 + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                      + [ctypes.c_void_p] * 3)
    lists.restype = ctypes.c_int
    adj = lib.repro_rcll_adjacency
    adj.argtypes = ([ctypes.c_int] * 3 + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                    + [ctypes.c_void_p] * 3)
    adj.restype = ctypes.c_int
    return lists, adj


def check_inputs(rel, occ, nb_ids, compute_dtype):
    """Validate the tile inputs the CUDA kernels take; returns (C+1, d, cap, M)."""
    dev = rel.device
    c1, d, cap = rel.shape
    m = 3**d
    if d not in (2, 3):
        raise ValueError(f"rel has {d} axes (2 or 3 supported)")
    if not 1 <= cap <= 1024:
        raise ValueError(f"cap must be in [1, 1024], got {cap}")
    if compute_dtype not in _COMPUTE_KIND:
        raise ValueError(f"compute dtype {compute_dtype} not supported by the kernel "
                         f"(one of {tuple(_COMPUTE_KIND)})")
    _check(rel, "rel", tuple(_REL_KIND), (c1, d, cap), dev)
    _check(occ, "occ", (torch.float32,), (c1, cap), dev)
    _check(nb_ids, "nb_ids", (torch.int32,), (c1, m), dev)
    return c1, d, cap, m


def rcll_neighbor_list_tables(rel: torch.Tensor, occ: torch.Tensor, ids: torch.Tensor,
                              nb_ids: torch.Tensor, *, weights: tuple, r_cell: float,
                              k_slots: int, compute_dtype=torch.float32
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """K4: per-slot neighbor ids (C+1, cap, K) int32 compacted in (k, j)
    order, -1 padded, and true counts (C+1, cap) f32.

    CPU tensors take :func:`rcll_neighbor_list_tables_ref`; CUDA tensors
    launch the kernel or raise.
    """
    dev = rel.device
    kw = dict(weights=weights, r_cell=r_cell, k_slots=k_slots, compute_dtype=compute_dtype)
    if dev.type == "cpu":
        return rcll_neighbor_list_tables_ref(rel, occ, ids, nb_ids, **kw)
    if dev.type != "cuda":
        raise ValueError(f"rcll_neighbor_list_tables runs on cuda or cpu tensors, got {dev}")
    c1, d, cap, m = check_inputs(rel, occ, nb_ids, compute_dtype)
    _check(ids, "ids", (torch.int32,), (c1, cap), dev)
    if k_slots < 1:
        raise ValueError(f"k_slots must be >= 1, got {k_slots}")
    out = torch.empty((c1, cap, k_slots), dtype=torch.int32, device=dev)
    counts = torch.empty((c1, cap), dtype=torch.float32, device=dev)
    (words,) = staging_scratch(c1, cap, dev)
    fparams, iparams = kernel_params(weights=weights, r_cell=r_cell, compute_dtype=compute_dtype)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _entries()[0](
            d, _REL_KIND[rel.dtype], _COMPUTE_KIND[compute_dtype],
            rel.data_ptr(), occ.data_ptr(), ids.data_ptr(), nb_ids.data_ptr(),
            out.data_ptr(), counts.data_ptr(), words.data_ptr(), c1, cap, m, k_slots,
            list_stride(k_slots), ctypes.addressof(fparams), ctypes.addressof(iparams), stream,
        )
    _build.check_rc(rc, "rcll_neighbor_list_tables")
    _LISTS.launches += 1
    return out, counts


def rcll_adjacency(rel: torch.Tensor, occ: torch.Tensor, nb_ids: torch.Tensor, *,
                   weights: tuple, r_cell: float, compute_dtype=torch.float32
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """K5: adjacency (C+1, M, cap, cap) f32 {0,1} and counts (C+1, cap) f32.

    CPU tensors take :func:`rcll_adjacency_ref`; CUDA tensors launch the
    kernel or raise.
    """
    dev = rel.device
    if dev.type == "cpu":
        return rcll_adjacency_ref(rel, occ, nb_ids, weights=weights, r_cell=r_cell,
                                  compute_dtype=compute_dtype)
    if dev.type != "cuda":
        raise ValueError(f"rcll_adjacency runs on cuda or cpu tensors, got {dev}")
    c1, d, cap, m = check_inputs(rel, occ, nb_ids, compute_dtype)
    adj = torch.empty((c1, m, cap, cap), dtype=torch.float32, device=dev)
    counts = torch.empty((c1, cap), dtype=torch.float32, device=dev)
    fparams, iparams = kernel_params(weights=weights, r_cell=r_cell, compute_dtype=compute_dtype)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _entries()[1](
            d, _REL_KIND[rel.dtype], _COMPUTE_KIND[compute_dtype],
            rel.data_ptr(), occ.data_ptr(), nb_ids.data_ptr(), adj.data_ptr(),
            counts.data_ptr(), c1, cap, m, adjacency_groups(cap),
            ctypes.addressof(fparams), ctypes.addressof(iparams), stream,
        )
    _build.check_rc(rc, "rcll_adjacency")
    _ADJ.launches += 1
    return adj, counts


def check_against_plain(kernel: str, args: tuple, kw: dict) -> dict:
    """Launch K4 (``kernel="K4"``) or K5 (``"K5"``) and its plain version
    on the same inputs and require every output to be bit-identical.
    Raises AssertionError; returns the number of hits, ``max_abs_err``
    (0.0) and, for K4, the number of counts past K (``past_k``)."""
    fn, ref, parts = {
        "K4": (rcll_neighbor_list_tables, rcll_neighbor_list_tables_ref, ("ids", "counts")),
        "K5": (rcll_adjacency, rcll_adjacency_ref, ("adj", "counts")),
    }[kernel]
    out_k = fn(*args, **kw)
    out_r = ref(*args, **kw)
    for part, a, b in zip(parts, out_k, out_r):
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"{kernel} {part}: {a.shape}/{a.dtype} vs {b.shape}/{b.dtype}")
        if not torch.equal(a, b):
            raise AssertionError(f"{kernel} {part} disagrees with its plain version in "
                                 f"{int((a != b).sum())} entries")
    res = {"hits": int(out_r[1].sum()), "max_abs_err": 0.0}
    if kernel == "K4":
        res["past_k"] = int((out_r[1] > kw["k_slots"]).sum())
    return res


rcll_neighbor_list_tables.launches = 0
rcll_adjacency.launches = 0
# The counters live on these function objects even if the module
# attributes are rebound (e.g. by a harness that wraps the wrappers).
_LISTS = rcll_neighbor_list_tables
_ADJ = rcll_adjacency
