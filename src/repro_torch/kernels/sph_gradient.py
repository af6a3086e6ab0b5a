"""K3: fused RCLL neighbor search and A5 normalized gradient.

Replaces the Pallas kernel ``repro/kernels/sph_gradient.py::rcll_gradient``
with the hand-written CUDA kernel ``csrc/sph_gradient.cu``. It fuses the
paper's two profiled kernels (NNPS and gradient approximation, Table 6):
per (self cell, neighbor cell) tile the Eq. (7) decision runs in the NNPS
dtype (``tiling.tile_r2_cell``, fp16 by default, every op rounded), and
the accepted pairs feed the fp32 physics tier at once: the decoded
displacement, the B-spline dW/dr / r, and the sums

    num_a = Σ_j (f_j − f_i) ∂W/∂x_a,   den_a = Σ_j −disp_a ∂W/∂x_a

over the 3^d neighborhood, so no adjacency ever reaches device memory.
``ops.rcll_gradient_particles`` divides them (eps-guarded).

Inputs (row C the sentinel empty cell): ``rel (C+1, d, cap)`` in the
storage dtype, ``f`` and ``occ (C+1, cap)`` f32, ``nb_ids (C+1, M)``
int32. Outputs ``num``, ``den (C+1, d, cap)`` f32.

Its least time on the H100 is close to even between bytes and
operations: at the paper's 1M-particle 2-D case ~0.11 GB move against
~13 operations per decided pair and ~40 per accepted pair (1.4e9), and
the bytes win by a little (``chip_smoke.py`` ``k3_work``; PERF.md). The
kernel decides only pairs of occupied slots: a first pass turns each
row's occupancy mask into bit words and packs each occupied slot's
coordinates and f for one load (:func:`nnps_pairwise.staging_scratch`),
and the second gives one thread to each occupied self slot of 32
consecutive cells (:func:`work_rows`), which walks the neighbors'
occupied slots tile by tile; empty self slots are written as zeros.

:func:`rcll_gradient` launches the kernel for CUDA tensors and takes the
plain version :func:`rcll_gradient_ref` only for CPU tensors. Their
decisions are identical; the fp32 sums agree within
:func:`rounding_bound` (nvcc contracts the physics tier's multiply-adds).
``rcll_gradient.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.core import bspline
from repro_torch.core import cells as cells_lib
from repro_torch.core.precision import NNPS_STORE
from repro_torch.kernels import _build, tiling
from repro_torch.kernels.nnps_pairwise import (_COMPUTE_KIND, _REL_KIND, _tile_decision,
                                               check_inputs, staging_scratch)
from repro_torch.kernels.rcll_force import _check

#: Peak bytes of pair intermediates per chunk of the plain version.
REF_CHUNK_BYTES = 2 * 10**9


def rcll_gradient_ref(rel: torch.Tensor, f: torch.Tensor, occ: torch.Tensor,
                      nb_ids: torch.Tensor, *, weights: tuple, r_cell: float, hc_phys: tuple,
                      h: float, dim: int, nnps_dtype=NNPS_STORE, abs_sums: bool = False):
    """Plain PyTorch version of :func:`rcll_gradient`: (num, den), each
    (C+1, d, cap) f32, tile by tile in k order. With ``abs_sums`` it also
    returns the sums of the terms' magnitudes, Σ_j |(f_j − f_i) ∂W/∂x_a|
    and Σ_j |disp_a ∂W/∂x_a|, for :func:`rounding_bound`."""
    c1, d, cap = rel.shape
    m = nb_ids.shape[1]
    dev = rel.device
    offs = cells_lib.neighbor_cell_offsets(d)
    outs = [torch.zeros((c1, d, cap), dtype=torch.float32, device=dev)
            for _ in range(4 if abs_sums else 2)]
    step = max(1, REF_CHUNK_BYTES // (cap * cap * 4 * (3 * d + 6)))
    for c0 in range(0, c1, step):
        sl = slice(c0, min(c1, c0 + step))
        for k in range(m):
            nbk = nb_ids[sl, k].long()
            # the decisions of K4 and K5's plain versions, in the NNPS dtype
            ok = _tile_decision(rel, occ, nb_ids, sl, k, offs, weights, r_cell, nnps_dtype)
            disp, r2 = tiling.tile_phys_disp(rel[sl], rel[nbk], offs[k], hc_phys)
            coef = ok.to(torch.float32) * bspline.dw_over_r(torch.sqrt(r2), h, dim)
            df = f[nbk][:, None, :] - f[sl][:, :, None]
            for a in range(d):
                gw = coef * disp[a]
                terms = [df * gw, -disp[a] * gw]
                if abs_sums:
                    terms += [torch.abs(t) for t in terms]
                for out, t in zip(outs, terms):
                    out[sl, a] += torch.sum(t, dim=-1)
    return tuple(outs)


def rounding_bound(abs_sum: torch.Tensor, dim: int) -> torch.Tensor:
    """Kernel-vs-plain tolerance from the magnitude sums of
    :func:`rcll_gradient_ref`, as for K2 (``rcll_force.rounding_bound``):
    both sum n = 3^dim · cap fp32 terms in different orders, each with a
    few contracted roundings, so |Δ| <= 4 (n + 16) 2^-24 Σ|parts|. The
    decisions are identical, so no pair enters one sum and not the other.
    ``abs_sum`` carries the cap dimension last.
    """
    n = 3**dim * abs_sum.shape[-1]
    return 4.0 * (n + 16) * 2.0**-24 * abs_sum


#: Limit on ‖kernel − plain‖₂ / ‖plain‖₂ of num and of den over occupied
#: slots. Readings on an H100 (PERF.md): at most 1.4e-7 on random clouds
#: and 1.1e-7 at the paper's 1M-particle case; a cell edge 1% off gives
#: 1.5e-2 or more and a flipped sign of f_j − f_i gives 2.
NORMWISE_LIMIT = 1e-5


def check_against_plain(args: tuple, kw: dict) -> dict:
    """Launch K3 and its plain version on the same inputs (CUDA tensors):
    every element within :func:`rounding_bound`, and num and den each
    within :data:`NORMWISE_LIMIT` normwise over occupied slots. Raises
    AssertionError; returns ``max_abs_err`` (occupied slots),
    ``max_ratio`` (error over bound) and ``normwise``."""
    out_k = rcll_gradient(*args, **kw)
    out_r = rcll_gradient_ref(*args, **kw, abs_sums=True)
    occ = (args[2] > 0)[:, None, :].expand_as(out_r[0])
    res = {"max_abs_err": 0.0, "max_ratio": 0.0, "normwise": 0.0}
    for name, k, r, s in (("num", out_k[0], out_r[0], out_r[2]),
                          ("den", out_k[1], out_r[1], out_r[3])):
        if not bool(torch.isfinite(k).all()):
            raise AssertionError(f"K3 {name}: non-finite values")
        err = torch.abs(k - r)
        ratio = float((err / rounding_bound(s, kw["dim"]).clamp_min(1e-30)).max())
        normwise = float(torch.linalg.vector_norm(err[occ])
                         / torch.linalg.vector_norm(r[occ]).clamp_min(1e-30))
        res["max_abs_err"] = max(res["max_abs_err"], float(err[occ].max()))
        res["max_ratio"] = max(res["max_ratio"], ratio)
        res["normwise"] = max(res["normwise"], normwise)
        if ratio > 1.0 or normwise > NORMWISE_LIMIT:
            raise AssertionError(
                f"K3 {name} disagrees with its plain version: max err/bound {ratio:.3g}, "
                f"normwise {normwise:.3g} (limit {NORMWISE_LIMIT:g})")
    return res


#: Cells of a block of the gradient pass (``kCellsPerBlock`` in the source).
CELLS_PER_BLOCK = 32


def occupancy_words(occ: torch.Tensor) -> np.ndarray:
    """(C+1, ceil(cap / 32)) uint32: bit s of word q of row c is slot
    32 q + s occupied, as the kernel's first pass and its ballots form
    them."""
    c1, cap = occ.shape
    bits = np.zeros((c1, -(-cap // 32) * 32), np.uint64)
    bits[:, :cap] = (occ > 0).cpu().numpy()
    weights = np.uint64(1) << np.arange(32, dtype=np.uint64)
    return (bits.reshape(c1, -1, 32) * weights).sum(axis=2).astype(np.uint32)


def work_rows(occ: torch.Tensor) -> list:
    """(cell, slot) of each work row of the gradient pass, in the order
    the kernel numbers them, by its arithmetic: block by block of
    :data:`CELLS_PER_BLOCK` consecutive rows, the exclusive scan of the
    cells' popcounts, the cell of work row w the last one whose start is
    <= w, and its slot the rank-th set bit of the cell's words."""
    words = occupancy_words(occ)
    rows = []
    for c0 in range(0, words.shape[0], CELLS_PER_BLOCK):
        block = words[c0:c0 + CELLS_PER_BLOCK]
        counts = [sum(bin(int(x)).count("1") for x in row) for row in block]
        starts = np.concatenate([[0], np.cumsum(counts)])
        for wr in range(int(starts[-1])):
            ci = int(np.searchsorted(starts[:-1], wr, side="right")) - 1
            rank, q = wr - int(starts[ci]), 0
            while rank >= bin(int(block[ci, q])).count("1"):
                rank -= bin(int(block[ci, q])).count("1")
                q += 1
            word = int(block[ci, q])
            for _ in range(rank):
                word &= word - 1
            rows.append((c0 + ci, 32 * q + (word & -word).bit_length() - 1))
    return rows


#: The faults :func:`planted_params` plants in the walk.
FAULTS = ("skip_last_occupied", "hole_as_end")


def walk_params():
    """The walk's run-time fault flags, both 0: the last occupied slot of
    each neighbor row skipped, and a row's first empty slot taken as its
    end (:func:`planted_params` sets one without touching the source)."""
    return (ctypes.c_int * 2)(0, 0)


def planted_params(fault: str):
    """A stand-in for :func:`walk_params` with ``fault`` planted. A check
    rebinds ``walk_params`` to it, and must then fail (a prefix-occupied
    table, as the binning packs, cannot show ``hole_as_end``)."""
    if fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}, not in {FAULTS}")
    clean = walk_params

    def faulty():
        flags = clean()
        flags[FAULTS.index(fault)] = 1
        return flags

    return faulty


def kernel_params(*, weights: tuple, r_cell: float, hc_phys: tuple, h: float, dim: int,
                  nnps_dtype):
    """The kernel's run-time parameters: weights and r_cell² rounded once
    from double to the NNPS dtype on the host (as the plain version rounds
    them), the cell edges, h, alpha_d/h, and the sign of f_j − f_i (+1;
    a check can plant −1 without touching the source)."""
    np_dt = np.float16 if nnps_dtype == torch.float16 else np.float32
    pad = [0.0] * (3 - len(weights))
    fparams = ([float(np_dt(x)) for x in weights] + pad
               + [float(np_dt(float(r_cell) ** 2))]
               + list(hc_phys) + pad
               + [h, bspline.alpha_d(dim, h) / h, 1.0])
    return (ctypes.c_float * len(fparams))(*fparams)


@functools.cache
def _entry():
    fn = _build.library().lib.repro_rcll_gradient
    fn.argtypes = ([ctypes.c_int] * 3 + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3
                   + [ctypes.c_void_p] * 3)
    fn.restype = ctypes.c_int
    return fn


def rcll_gradient(rel: torch.Tensor, f: torch.Tensor, occ: torch.Tensor, nb_ids: torch.Tensor,
                  *, weights: tuple, r_cell: float, hc_phys: tuple, h: float, dim: int,
                  nnps_dtype=NNPS_STORE) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused search and A5 sums: (num, den), each (C+1, d, cap) f32.

    CPU tensors take :func:`rcll_gradient_ref`; CUDA tensors launch the
    kernel or raise.
    """
    dev = rel.device
    kw = dict(weights=weights, r_cell=r_cell, hc_phys=hc_phys, h=h, dim=dim,
              nnps_dtype=nnps_dtype)
    if dev.type == "cpu":
        return rcll_gradient_ref(rel, f, occ, nb_ids, **kw)
    if dev.type != "cuda":
        raise ValueError(f"rcll_gradient runs on cuda or cpu tensors, got {dev}")
    c1, d, cap, m = check_inputs(rel, occ, nb_ids, nnps_dtype)
    if d != dim:
        raise ValueError(f"rel has {d} axes; dim is {dim}")
    _check(f, "f", (torch.float32,), (c1, cap), dev)
    num = torch.empty((c1, d, cap), dtype=torch.float32, device=dev)
    den = torch.empty((c1, d, cap), dtype=torch.float32, device=dev)
    words, recs = staging_scratch(c1, cap, dev, records=True)
    fparams = kernel_params(**kw)
    iparams = walk_params()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _entry()(
            d, _REL_KIND[rel.dtype], _COMPUTE_KIND[nnps_dtype],
            rel.data_ptr(), f.data_ptr(), occ.data_ptr(), nb_ids.data_ptr(),
            num.data_ptr(), den.data_ptr(), words.data_ptr(), recs.data_ptr(), c1, cap, m,
            ctypes.addressof(fparams), ctypes.addressof(iparams), stream,
        )
    _build.check_rc(rc, "rcll_gradient")
    _WRAPPER.launches += 1
    return num, den


rcll_gradient.launches = 0
# The counter lives on this function object even if the module attribute
# is rebound (e.g. by a harness that wraps the wrapper).
_WRAPPER = rcll_gradient
