"""Nearest-neighbor particle search (NNPS): all-list, cell-list and RCLL.

Port of ``repro.core.nnps``. Three searches, as in the paper:

  * ``all_list_*``  - O(N^2) brute force, any dtype;
  * ``cell_list_*`` - background-cell candidates and *absolute*
                      normalized coordinates in the search dtype (the
                      paper's approach II when the dtype is fp16);
  * ``rcll_*``      - background-cell candidates and *cell-relative*
                      coordinates stored in the search dtype (approach
                      III, the paper's contribution), over a dense
                      (C, cap) cell table or, on cell-sorted arrays,
                      table-free over merged index windows
                      (:func:`rcll_neighbors_windows`, the production
                      rebuild search of the list backends).

Coordinates are stored in ``dtype`` and differences and squares are
computed in it; each elementwise op rounds to it, as eager JAX does. A
sum over the 2-3 axes accumulates left to right in fp32 (fp64 for fp64)
and rounds once at the end, which is what XLA's reduce does for fp16,
bf16 and fp32 inputs (:func:`_sum_last`); the port reproduces it so that
its decisions equal the JAX package's bit for bit.

RCLL distances are in reference-cell units (Eq. 7 over the constant
h_c/2): du = (x_i - x_j)/2 + (I - J), r² = Σ (w_a du_a)², neighbor iff
r² <= r_cell². Periodic axes take the minimum image of the integer cell
delta, which is exact.

Outputs are fixed-width lists (idx, mask, count): ``count`` is the true
count and may exceed the width K, which ``NeighborList.overflowed`` flags.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import cells as cells_lib
from repro_torch.core.domain import Domain
from repro_torch.core.precision import NNPS_STORE

_INT32_MAX = 2**31 - 1


class NeighborList(NamedTuple):
    """Fixed-width neighbor list.

    idx:   (N, K) int32 neighbor particle ids (garbage where ~mask).
    mask:  (N, K) bool valid-slot flags.
    count: (N,) int32 true neighbor count (may exceed K -> overflow).
    trunc: () bool, window searches only: some particle's merged
           candidate total exceeded the window budget (its true count is
           then unknown; the ``k + 1`` count sentinel folds it into
           ``overflowed``). None for searches without a window budget.
    """

    idx: torch.Tensor
    mask: torch.Tensor
    count: torch.Tensor
    trunc: torch.Tensor | None = None

    @property
    def overflowed(self) -> torch.Tensor:
        return torch.any(self.count > self.mask.shape[1])


def const(x: float, dtype, device=None) -> torch.Tensor:
    """A Python float as a 0-d tensor of ``dtype``, rounded once from
    double as numpy rounds it (JAX's ``jnp.asarray(x, dtype)``)."""
    if dtype == torch.float16:
        x = float(np.float16(x))
    return torch.tensor(x, dtype=dtype, device=device)


def _sum_last(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis as XLA reduces it: left to right in fp32
    (fp64 for fp64 inputs), rounded once to the input dtype."""
    acc_dt = torch.float64 if x.dtype == torch.float64 else torch.float32
    acc = x[..., 0].to(acc_dt)
    for a in range(1, x.shape[-1]):
        acc = acc + x[..., a].to(acc_dt)
    return acc.to(x.dtype)


def select_k(cand: torch.Tensor, ok: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The first k entries of ``cand`` where ``ok`` holds, per row.

    A stable descending sort of the 0/1 flags orders each row's valid
    candidates first, in candidate order, then the invalid ones in
    candidate order: the positions ``lax.top_k`` gives the JAX package
    (ties to the lowest index), so ids agree even in masked slots.
    ``torch.topk`` promises no tie order. Returns (idx (N, k) int32,
    mask (N, k) bool), padded with 0 / False past the row width.
    """
    kk = min(k, cand.shape[1])
    pos = torch.sort(ok.to(torch.uint8), dim=1, descending=True, stable=True).indices[:, :kk]
    idx = torch.gather(cand, 1, pos).to(torch.int32)
    mask = torch.gather(ok, 1, pos)
    if kk < k:
        idx = torch.nn.functional.pad(idx, (0, k - kk))
        mask = torch.nn.functional.pad(mask, (0, k - kk))
    return idx, mask


def min_image(diff: torch.Tensor, wrap_span: torch.Tensor | None) -> torch.Tensor:
    """Minimum-image wrap of coordinate differences (..., d); a span of 0
    leaves that axis alone, None leaves all."""
    if wrap_span is None:
        return diff
    span = wrap_span.to(diff.dtype)
    wrapped = diff - torch.round(diff / torch.where(span > 0, span, torch.ones_like(span))) * span
    return torch.where(span > 0, wrapped, diff)


def wrap_span_norm(domain: Domain, device=None) -> torch.Tensor | None:
    """Per-axis periodic spans in normalized (Eq. 5) units; None if none."""
    if not any(domain.periodic):
        return None
    spans = [(2.0 * s / domain.h_d) if p else 0.0
             for s, p in zip(domain.spans, domain.periodic)]
    return torch.tensor(spans, dtype=torch.float32, device=device)


def _pairwise_r2(a: torch.Tensor, b: torch.Tensor, wrap_span: torch.Tensor | None) -> torch.Tensor:
    """Squared distances between row sets a (N, d) and b (M, d), in a.dtype."""
    diff = min_image(a[:, None, :] - b[None, :, :], wrap_span)
    return _sum_last(diff * diff)


def _all_list_rows(x_lo, lo, hi, r2, wrap, include_self):
    ok = _pairwise_r2(x_lo[lo:hi], x_lo, wrap) <= r2
    if not include_self:
        rows = torch.arange(lo, hi, device=x_lo.device)
        ok = ok & (rows[:, None] != torch.arange(x_lo.shape[0], device=x_lo.device)[None, :])
    return ok


def all_list_neighbors(xn: torch.Tensor, radius_norm: float, *, dtype=torch.float32, k: int,
                       domain: Domain | None = None, include_self: bool = False,
                       block: int = 2048) -> NeighborList:
    """Brute-force search on normalized absolute coordinates stored at
    ``dtype``, ``block`` rows at a time."""
    n = xn.shape[0]
    dev = xn.device
    x_lo = xn.to(dtype)
    r = const(radius_norm, dtype, dev)
    wrap = wrap_span_norm(domain, dev) if domain is not None else None
    ids = torch.arange(n, dtype=torch.int32, device=dev)
    out = []
    for lo in range(0, n, block):
        ok = _all_list_rows(x_lo, lo, min(n, lo + block), r * r, wrap, include_self)
        idx, mask = select_k(ids[None, :].expand(ok.shape), ok, k)
        out.append((idx, mask, ok.sum(dim=1).to(torch.int32)))
    return NeighborList(*(torch.cat(parts) for parts in zip(*out)))


def all_list_count(xn: torch.Tensor, radius_norm: float, *, dtype=torch.float32,
                   domain: Domain | None = None, include_self: bool = False,
                   block: int = 1024) -> torch.Tensor:
    """Count-only all-list search, ``block`` rows at a time."""
    n = xn.shape[0]
    x_lo = xn.to(dtype)
    r = const(radius_norm, dtype, xn.device)
    wrap = wrap_span_norm(domain, xn.device) if domain is not None else None
    return torch.cat([
        _all_list_rows(x_lo, lo, min(n, lo + block), r * r, wrap, include_self)
        .sum(dim=1).to(torch.int32) for lo in range(0, n, block)])


def cell_list_neighbors(domain: Domain, xn: torch.Tensor, *, dtype=torch.float32, k: int,
                        capacity: int | None = None,
                        binning: cells_lib.CellBinning | None = None,
                        include_self: bool = False) -> NeighborList:
    """Cell-candidate search on absolute normalized coordinates.

    The binning is an fp32 integer decision; only the distance filter
    runs in ``dtype`` (approach II when it is fp16).
    """
    n = xn.shape[0]
    dev = xn.device
    if binning is None:
        capacity = capacity or cells_lib.default_capacity(domain, n)
        binning = cells_lib.bin_particles(domain, xn, capacity)
    cand, cmask = cells_lib.gather_candidates(domain, binning)
    x_lo = xn.to(dtype)
    diff = min_image(x_lo[:, None, :] - x_lo[cand.long()], wrap_span_norm(domain, dev))
    d2 = _sum_last(diff * diff)
    r = const(domain.radius_norm, dtype, dev)
    ok = cmask & (d2 <= r * r)
    if not include_self:
        ok = ok & (cand != torch.arange(n, dtype=torch.int32, device=dev)[:, None])
    idx, mask = select_k(cand, ok, k)
    return NeighborList(idx, mask, ok.sum(dim=1).to(torch.int32))


def rcll_r2_cell_units(rel_i: torch.Tensor, rel_j: torch.Tensor, cell_delta: torch.Tensor,
                       weights: torch.Tensor | None = None, *, dtype=NNPS_STORE) -> torch.Tensor:
    """Eq. (7) in reference-cell units from relative coords (..., d) and
    the exact integer cell delta I - J (min-image wrapped by the caller).

    ``dtype`` is the arithmetic dtype: fp16 is the paper's A100 mode, fp32
    removes the arithmetic rounding of the subtract and halve.
    """
    rel_i = rel_i.to(dtype)
    rel_j = rel_j.to(dtype)
    du = (rel_i - rel_j) * const(0.5, dtype, rel_i.device) + cell_delta.to(dtype)
    if weights is not None:
        du = du * weights.to(dtype)
    return _sum_last(du * du)


def rcll_radius_cell_units(domain: Domain) -> float:
    """Search radius in reference-cell units (1/cell_factor when square)."""
    return float(domain.radius_norm / domain.hc_ref)


def rcll_neighbors(domain: Domain, rel: torch.Tensor, cell_xy: torch.Tensor, *,
                   dtype=NNPS_STORE, compute_dtype=None, k: int,
                   capacity: int | None = None,
                   binning: cells_lib.CellBinning | None = None,
                   include_self: bool = False,
                   radius_cell: float | None = None) -> NeighborList:
    """RCLL search from stored relative coordinates and integer cell
    coordinates.

    rel: (N, d) cell-relative coordinates in [-1, 1], stored at ``dtype``.
    compute_dtype: arithmetic dtype of Eq. (7), ``dtype`` by default.
    radius_cell: search radius in reference-cell units (at most one cell
      edge); the kernel-support radius by default.
    """
    n = rel.shape[0]
    dev = rel.device
    cdt = compute_dtype or dtype
    if binning is None:
        capacity = capacity or cells_lib.default_capacity(domain, n)
        binning = cells_lib.bin_by_cell_id(domain, domain.flat_cell_id(cell_xy), cell_xy,
                                           capacity)
    cand, cmask = cells_lib.gather_candidates(domain, binning)
    cl = cand.long()
    delta = domain.wrap_cell_delta(cell_xy[:, None, :] - cell_xy[cl])
    w = torch.tensor(domain.cell_weights, dtype=torch.float32, device=dev)
    rel = rel.to(dtype)
    d2 = rcll_r2_cell_units(rel[:, None, :], rel[cl], delta, w, dtype=cdt)
    if radius_cell is None:
        radius_cell = rcll_radius_cell_units(domain)
    rcell = const(radius_cell, cdt, dev)
    ok = cmask & (d2 <= rcell * rcell)
    if not include_self:
        ok = ok & (cand != torch.arange(n, dtype=torch.int32, device=dev)[:, None])
    idx, mask = select_k(cand, ok, k)
    return NeighborList(idx, mask, ok.sum(dim=1).to(torch.int32))


#: Rows per chunk of the window search: each chunk's (chunk, window)
#: candidate intermediates are evaluated at once instead of (N, window)
#: slabs.
SEARCH_CHUNK = 4096


def auto_window(domain: Domain, ds: float | None = None, capacity: int | None = None,
                safety: float = 1.25) -> int:
    """Static merged-candidate budget for :func:`rcll_neighbors_windows`.

    With the particle spacing ``ds``: the lattice count of a 3^dim-cell
    block, prod_a (3 hc_a / ds + 1), times ``safety`` (independent of how
    much of the domain the fluid fills). Without it: ceil(4/3 ·
    3^(dim-1)) · capacity. Truncation is always flagged (the ``k + 1``
    count sentinel), so an underestimate surfaces as overflow.
    """
    if ds is not None:
        est = 1.0
        for c in domain.cell_sizes:
            est *= 3.0 * c / ds + 1.0
        return max(8, int(np.ceil(safety * est)))
    if capacity is None:
        raise ValueError("auto_window needs ds or capacity")
    return max(8, int(np.ceil(4 / 3 * 3 ** (domain.dim - 1))) * capacity)


def _bits_dtype(dtype):
    """Signed integer carrier of a storage dtype's bit width (int16 /
    int32): the port's stand-in for JAX's u16 / u32 search row, read
    back through ``.view()`` and, for a 16-bit cell coordinate, ``& 0xFFFF``."""
    size = dtype.itemsize
    if size == 2:
        return torch.int16
    if size == 4:
        return torch.int32
    raise ValueError(f"unsupported search storage dtype {dtype}")


def rcll_neighbors_windows(domain: Domain, rel: torch.Tensor, cell_xy: torch.Tensor,
                           counts: torch.Tensor, *, dtype=NNPS_STORE, compute_dtype=None,
                           k: int, window: int, radius_cell: float | None = None,
                           include_self: bool = False, chunk: int = 0) -> NeighborList:
    """Table-free RCLL search over cell-SORTED particle arrays.

    rel, cell_xy: (N, d) cell-sorted state; counts: (C,) per-cell
    occupancy of the sorted arrays. Packed ids are contiguous per cell
    (and row-major cell order makes runs of last-axis-adjacent cells
    contiguous), so a particle's candidates are 3^(d-1) contiguous id
    ranges (3^d single cells when the last axis is periodic, where the
    seam breaks contiguity). The ranges are merged into one front-packed
    block of ``window`` slots: slot t maps to run r(t) and candidate id
    ``begin_r + t - B_r`` (B_r the exclusive prefix of run lengths), so
    no (C, cap) table and no candidate-id gather exists.

    Each candidate costs one gather of a bit-packed search row [rel bits
    (d) | last-axis cell (banded runs)]; lead-axis cell deltas are
    per-run constants. Eq. (7) runs in ``compute_dtype`` in the same
    order as :func:`rcll_r2_cell_units`, per axis accumulated op by op.
    Valid candidates are compacted by an ascending sort of ids keyed to
    the dummy id N where invalid, so ``idx`` is ascending and DUMMY-PADDED
    (invalid slots hold N). A particle whose neighborhood holds more
    than ``window`` candidates gets the ``k + 1`` count sentinel and sets
    ``trunc``.

    Rows are independent, so the chunks (``chunk`` rows, ``SEARCH_CHUNK``
    when 0, equalized as the JAX package equalizes them) run as a Python
    loop and the last one is left short rather than padded: the result
    is the same at every chunking.
    """
    n, dim = rel.shape
    dev = rel.device
    cdt = compute_dtype or dtype
    starts = cells_lib.exclusive_cumsum(counts).long()
    counts_l = counts.long()
    nc = domain.ncells
    ncy = nc[-1]
    if radius_cell is None:
        radius_cell = rcll_radius_cell_units(domain)
    rcell = const(radius_cell, cdt, dev)
    r2 = rcell * rcell
    w = np.asarray(domain.cell_weights)

    # Runs: contiguous 3-cell bands on an aperiodic last axis, single
    # cells otherwise (every axis' delta then known per run).
    banded = not domain.periodic[-1]
    if banded:
        offs = (cells_lib.neighbor_cell_offsets(dim - 1)
                if dim > 1 else np.zeros((1, 0), np.int32))
    else:
        offs = cells_lib.neighbor_cell_offsets(dim)
    nrun = offs.shape[0]
    naxes = offs.shape[1]  # axes with a statically known delta
    per = torch.tensor(domain.periodic[:naxes], dtype=torch.bool, device=dev)
    n_ax = torch.tensor(nc[:naxes], dtype=torch.int32, device=dev)
    cy = cell_xy[:, -1]

    begins, lengths = [], []
    for off in offs:
        if naxes:
            nb = cell_xy[:, :naxes] + torch.as_tensor(off, dtype=torch.int32, device=dev)
            wrapped = torch.where(per, torch.remainder(nb, n_ax), nb)
            valid = torch.all((wrapped >= 0) & (wrapped < n_ax), dim=-1)
            nb = torch.clamp(wrapped, min=torch.zeros_like(n_ax), max=n_ax - 1)
            flat = nb[..., 0]
            for a in range(1, naxes):
                flat = flat * nc[a] + nb[..., a]
        else:
            valid = torch.ones((n,), dtype=torch.bool, device=dev)
            flat = torch.zeros_like(cy)
        if banded:
            ylo = torch.clamp(cy - 1, 0, ncy - 1)
            yhi = torch.clamp(cy + 1, 0, ncy - 1)
            c_lo = flat * ncy + ylo if dim > 1 else ylo
            c_hi = flat * ncy + yhi if dim > 1 else yhi
        else:
            c_lo = c_hi = flat
        begin = starts[c_lo.long()]
        end = starts[c_hi.long()] + counts_l[c_hi.long()]
        begins.append(begin.to(torch.int32))
        lengths.append(torch.where(valid, end - begin, 0).to(torch.int32))
    begin = torch.stack(begins, dim=1)  # (N, R)
    # Exclusive prefix of run lengths: bounds[:, r] = merged-slot base of run r.
    bounds = torch.cat([torch.zeros((n, 1), dtype=torch.int32, device=dev),
                        torch.cumsum(torch.stack(lengths, dim=1), dim=1).to(torch.int32)],
                       dim=1)  # (N, R + 1)
    total = bounds[:, -1]

    # Statically known per-run deltas I - J = -off (exact min image: a
    # periodic axis has >= 3 cells).
    dlt = torch.as_tensor(-offs.astype(np.float32), device=dev)  # (R, naxes)
    dlt_c = [dlt[:, a].to(cdt) for a in range(naxes)]

    # Bit-packed search row [rel bits (d) | last-axis cell (banded)].
    bits = _bits_dtype(dtype)
    rel_lo = rel.to(dtype)
    cols = [rel_lo.view(bits)]
    if banded:
        limit = 2**16 - 1 if bits == torch.int16 else 2**32 - 1
        if ncy >= limit:
            raise ValueError(
                f"last axis has {ncy} cells; the packed search row caps it at {limit}")
        cy_bits = torch.where(cy > 32767, cy - 65536, cy) if bits == torch.int16 else cy
        cols.append(cy_bits.to(bits)[:, None])
    srow = torch.cat(cols, dim=1)
    half = const(0.5, cdt, dev)
    wc = [const(float(w[a]), cdt, dev) for a in range(dim)]
    t = torch.arange(window, dtype=torch.int32, device=dev)[None, :]  # (1, S)

    def body(lo, hi):
        b, bb, tot = begin[lo:hi], bounds[lo:hi], total[lo:hi]
        ri, cyi = rel_lo[lo:hi], cy[lo:hi]
        c = hi - lo
        # Source run of merged slot t: r = #(runs whose base <= t).
        rsel = torch.zeros((c, window), dtype=torch.int32, device=dev)
        for r in range(1, nrun):
            rsel = rsel + (t >= bb[:, r:r + 1]).to(torch.int32)
        rl = rsel.long()
        ids = torch.gather(b, 1, rl) + t - torch.gather(bb[:, :nrun], 1, rl)
        okw = t < tot[:, None]
        idsc = torch.clamp(ids, 0, n - 1)
        sj = srow[idsc.long()]  # ONE row gather: (c, S, d [+1])
        rjc = sj[..., :dim].view(dtype).to(cdt)
        ric = ri.to(cdt)
        d2 = torch.zeros((c, window), dtype=cdt, device=dev)
        for a in range(naxes):  # per-run constant deltas
            du = (ric[:, a:a + 1] - rjc[..., a]) * half + dlt_c[a][rl]
            du = du * wc[a]
            d2 = d2 + du * du
        if banded:  # last axis: exact integer cell delta, gathered
            cyj = sj[..., dim].to(torch.int32)
            if bits == torch.int16:
                cyj = cyj & 0xFFFF
            dy = (cyi[:, None] - cyj).to(cdt)
            du = (ric[:, dim - 1:dim] - rjc[..., dim - 1]) * half + dy
            du = du * wc[dim - 1]
            d2 = d2 + du * du
        ok = okw & (d2 <= r2)
        if not include_self:
            rows = torch.arange(lo, hi, dtype=torch.int32, device=dev)
            ok = ok & (idsc != rows[:, None])
        count = ok.sum(dim=1).to(torch.int32)
        count = torch.where(tot > window, torch.clamp(count, min=k + 1), count)
        # Keyed-sort compaction: ascending ids first, dummy id N padding.
        key = torch.sort(torch.where(ok, idsc, n), dim=1).values
        if window < k:
            key = torch.nn.functional.pad(key, (0, k - window), value=n)
        idx = key[:, :k]
        return idx, idx < n, count, tot > window

    chunk = chunk if chunk > 0 else SEARCH_CHUNK
    nchunk = -(-n // max(1, min(n, chunk)))
    csize = max(1, -(-n // nchunk))
    parts = [body(lo, min(n, lo + csize)) for lo in range(0, n, csize)]
    idx, mask, count, trow = (torch.cat(p) for p in zip(*parts))
    return NeighborList(idx, mask, count, trunc=torch.any(trow))


def refilter(nl: NeighborList, d2: torch.Tensor, r2) -> NeighborList:
    """Narrow a (skin-inflated) list to the pairs with d2 <= r2; ``d2``
    must come from the search's own arithmetic. idx stays uncompacted."""
    ok = nl.mask & (d2 <= r2)
    return NeighborList(idx=nl.idx, mask=ok, count=ok.sum(dim=1).to(torch.int32))


def reference_neighbors(domain: Domain, xn: torch.Tensor, *, k: int,
                        include_self: bool = False, dtype=torch.float64) -> NeighborList:
    """Ground-truth determinations: the cell-list search at ``dtype``
    (fp64 by default; pass coordinates of at least that precision)."""
    return cell_list_neighbors(domain, xn, dtype=dtype, k=k, include_self=include_self)


def _canon(nl: NeighborList, k: int) -> torch.Tensor:
    vals = torch.where(nl.mask, nl.idx, torch.full_like(nl.idx, _INT32_MAX))
    vals = torch.nn.functional.pad(vals, (0, k - vals.shape[1]), value=_INT32_MAX)
    return torch.sort(vals, dim=1).values


def neighbor_sets_equal(a: NeighborList, b: NeighborList) -> torch.Tensor:
    """Per particle: identical neighbor sets (order-insensitive) and counts."""
    k = a.idx.shape[1]
    return torch.all(_canon(a, k) == _canon(b, k), dim=1) & (a.count == b.count)


def _in_rows(x: torch.Tensor, sorted_rows: torch.Tensor) -> torch.Tensor:
    """Per row: is each entry of x among that row's (sorted) entries?"""
    pos = torch.searchsorted(sorted_rows, x).clamp(max=sorted_rows.shape[1] - 1)
    return torch.gather(sorted_rows, 1, pos) == x


def count_wrong_determinations(truth: NeighborList, test: NeighborList) -> torch.Tensor:
    """Total |symmetric difference| of the neighbor sets over all
    particles: every missed and every spurious neighbor counts once (the
    paper's count of incorrect neighbor determinations)."""
    k = max(truth.idx.shape[1], test.idx.shape[1])
    a, b = _canon(truth, k), _canon(test, k)
    missed = (a != _INT32_MAX) & ~_in_rows(a, b)
    spurious = (b != _INT32_MAX) & ~_in_rows(b, a)
    return missed.sum() + spurious.sum()
