"""The rebuild's counting-sort pack as hand-written CUDA kernels.

Replaces no Pallas kernel: the JAX package's counting sort
(``repro/core/cells.py::_counting_sort_positions``) is plain jnp. The port
carried it over as about 60 small PyTorch ops and 14 host syncs a rebuild;
:func:`repack_ref` keeps that path (``cells.pack_particles`` given ``prev``,
then the packing applied to ``rel``) as the plain version.

:func:`repack` re-sorts a state that is in the order of its previous pack
(``prev``: that pack's binning) by flat cell id, stably: the permutation of
``torch.argsort(cell_id, stable=True)``, with every output of the plain
version bit for bit. A first kernel gives each particle its migration code
and raises a device flag where a particle moved more than one cell per axis;
the wrapper reads the flag (the pack's one host read), then launches the
pack (``csrc/cell_sort.cu``: count, scan, table and scatter kernels) or takes
the argsort oracle (``cells.pack_particles`` without ``prev``), as the plain
version does.

On the H100 the pack is bound by bytes: it reads the current and previous
cell coordinates, the previous cell ids and counts and ``rel`` once, and
writes the permutation, its inverse, the counts, the (C, cap) table and the
packed cell ids, coordinates and ``rel`` once (about 282 MB at 4.19M
particles in 727,609 cells of 20 slots). A thread a new cell counts the
particles its 3^d source cells' runs send it, over 1-byte codes held in
L2; a thread a particle then writes it at its position, which is close to
its index, so the stores coalesce. No atomics.

``repack.launches`` counts packs made by the kernels, ``repack.fallbacks``
rebuilds on the card that took the argsort oracle.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import cells
from repro_torch.core.domain import Domain
from repro_torch.kernels import _build

#: Cells (and particles) a block (``kThreads`` in the CUDA source).
SORT_THREADS = 256

#: Faults a check can plant through :func:`planted_params` (the run-time
#: ``fault`` argument of ``repro_cell_sort_pack``).
FAULTS = ("run_reversed", "seam_order")


def repack_ref(domain: Domain, cell_xy: torch.Tensor, rel: torch.Tensor, capacity: int,
               prev: cells.CellBinning) -> tuple[cells.CellPacking, torch.Tensor]:
    """Plain PyTorch version of :func:`repack`: the counting-sort branch
    of ``cells.pack_particles`` (its argsort oracle where a particle moved
    more than one cell), and ``rel`` in the packed order."""
    packing = cells.pack_particles(domain, domain.flat_cell_id(cell_xy), cell_xy, capacity,
                                   prev=prev)
    return packing, packing.pack(rel)


def kernel_params() -> int:
    """The kernel's run-time ``fault`` argument: 0, a correct kernel."""
    return 0


def planted_params(fault: str):
    """A stand-in for :func:`kernel_params` with ``fault`` planted: each
    run walked backwards (the particles of one run bound for one cell in
    reverse), or a periodic axis's sources left in offset order across the
    seam. A check rebinds ``kernel_params`` to it, and must then fail."""
    if fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}, not in {FAULTS}")
    return lambda: FAULTS.index(fault) + 1


@functools.cache
def _entries():
    lib = _build.library().lib
    codes, pack = lib.repro_cell_sort_codes, lib.repro_cell_sort_pack
    codes.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    pack.argtypes = [ctypes.c_void_p] * 19 + [ctypes.c_int] * 12 + [ctypes.c_void_p]
    codes.restype = pack.restype = ctypes.c_int
    return codes, pack


def _check(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if dtype is not None and t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _geometry(domain: Domain) -> list[int]:
    """c_total, dim, cells per axis and periodic flags (1 and 0 past a 2-D
    domain's axes)."""
    pad = 3 - domain.dim
    return ([domain.ncells_total, domain.dim] + list(domain.ncells) + [1] * pad
            + [int(p) for p in domain.periodic] + [0] * pad)


def repack(domain: Domain, cell_xy: torch.Tensor, rel: torch.Tensor, capacity: int,
           prev: cells.CellBinning) -> tuple[cells.CellPacking, torch.Tensor]:
    """Stable re-sort by flat cell id of a state in the order of its
    previous pack ``prev`` (see module doc): (packing, ``rel`` packed).

    CPU tensors take :func:`repack_ref`; CUDA tensors launch the kernels
    (or, with a far mover, the argsort oracle) or raise.
    """
    dev = cell_xy.device
    if dev.type == "cpu":
        return repack_ref(domain, cell_xy, rel, capacity, prev)
    if dev.type != "cuda":
        raise ValueError(f"repack runs on cuda or cpu tensors, got {dev}")
    n, dim, c_total = cell_xy.shape[0], domain.dim, domain.ncells_total
    _check(cell_xy, "cell_xy", torch.int32, (n, dim), dev)
    _check(rel, "rel", None, (n, dim), dev)
    _check(prev.cell_xy, "prev.cell_xy", torch.int32, (n, dim), dev)
    _check(prev.cell_id, "prev.cell_id", torch.int32, (n,), dev)
    _check(prev.counts, "prev.counts", torch.int32, (c_total,), dev)
    if dim not in (2, 3) or capacity < 1 or rel.element_size() not in (2, 4):
        raise ValueError(f"dim 2 or 3, capacity >= 1 and 2- or 4-byte rel, got {dim}, "
                         f"{capacity}, {rel.dtype}")
    if max(n * dim, c_total * capacity) >= 2**31:
        raise ValueError("the kernels index particles and table slots below 2^31")
    geo = _geometry(domain)
    codes_fn, pack_fn = _entries()
    code = torch.empty((n,), dtype=torch.uint8, device=dev)
    run_start = torch.empty((c_total,), dtype=torch.int32, device=dev)
    far = torch.zeros((1,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = codes_fn(cell_xy.data_ptr(), prev.cell_xy.data_ptr(), prev.cell_id.data_ptr(),
                      code.data_ptr(), run_start.data_ptr(), far.data_ptr(), n, *geo, stream)
        _build.check_rc(rc, "cell_sort codes")
        if bool(far.item()):  # the pack's one host read
            _WRAPPER.fallbacks += 1
            packing = cells.pack_particles(domain, domain.flat_cell_id(cell_xy), cell_xy,
                                           capacity)
            return packing, packing.pack(rel)
        blocks = -(-c_total // SORT_THREADS)
        i32 = dict(dtype=torch.int32, device=dev)
        counts = torch.empty((c_total,), **i32)
        before = torch.empty((3**dim, c_total), **i32)
        starts = torch.empty((c_total,), **i32)
        block_sum = torch.empty((blocks,), **i32)
        block_over = torch.empty((blocks,), **i32)
        overflow = torch.empty((), **i32)
        order = torch.empty((n,), **i32)
        inverse = torch.empty((n,), **i32)
        cell_id = torch.empty((n,), **i32)
        packed_xy = torch.empty((n, dim), **i32)
        packed_rel = torch.empty_like(rel)
        table = torch.empty((c_total, capacity), **i32)
        identity = torch.empty((n,), **i32)
        ptrs = (code, run_start, prev.counts, prev.cell_id, cell_xy, rel, counts, before, starts,
                block_sum, block_over, overflow, order, inverse, cell_id, packed_xy, packed_rel,
                table, identity)
        rc = pack_fn(*(t.data_ptr() for t in ptrs), n, *geo, capacity,
                     dim * rel.element_size(), kernel_params(), stream)
    _build.check_rc(rc, "cell_sort pack")
    _WRAPPER.launches += 1
    binning = cells.CellBinning(table=table, counts=counts, cell_id=cell_id, cell_xy=packed_xy,
                                order=identity, overflow=overflow)
    return cells.CellPacking(order=order, inverse=inverse, binning=binning), packed_rel


def outputs(packing: cells.CellPacking, rel: torch.Tensor) -> dict:
    """Every output of a pack by name, as :func:`check_against_plain`
    compares them."""
    b = packing.binning
    return {"order": packing.order, "inverse": packing.inverse, "table": b.table,
            "counts": b.counts, "cell_id": b.cell_id, "cell_xy": b.cell_xy,
            "binning.order": b.order, "overflow": b.overflow, "rel": rel}


def _bits(t: torch.Tensor) -> torch.Tensor:
    """Floating tensors as their bits, so equality is bitwise."""
    if t.is_floating_point():
        return t.view(torch.int16 if t.element_size() == 2 else torch.int32)
    return t


def check_against_plain(domain: Domain, cell_xy: torch.Tensor, rel: torch.Tensor,
                        capacity: int, prev: cells.CellBinning) -> dict:
    """Run :func:`repack` and its plain version on the same inputs and
    require every output to be bit-identical. Raises AssertionError;
    returns ``max_abs_err`` (0.0)."""
    out_k = outputs(*repack(domain, cell_xy, rel, capacity, prev))
    out_r = outputs(*repack_ref(domain, cell_xy, rel, capacity, prev))
    for name, a in out_k.items():
        b = out_r[name]
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"pack {name}: {a.shape}/{a.dtype} vs {b.shape}/{b.dtype}")
        if not torch.equal(_bits(a), _bits(b)):
            raise AssertionError(f"pack {name} disagrees with its plain version in "
                                 f"{int((_bits(a) != _bits(b)).sum())} entries")
    return {"max_abs_err": 0.0}


repack.launches = 0
repack.fallbacks = 0
# The counters live on this function object even if the module attribute
# is rebound (e.g. by a harness that wraps the wrapper).
_WRAPPER = repack
