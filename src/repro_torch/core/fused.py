"""Fused cell-blocked WCSPH force pass (the ``backend="xla"`` sweep).

Port of ``repro.core.fused``. The reference step (``backend="reference"``)
materializes every pair intermediate as (N, K) arrays and gathers each
neighbor field separately; this sweep evaluates the same sums with two
changes:

**One record gather per sweep.** A particle's inputs are packed into one
record row, so a sweep gathers ``rec[idx]`` once. Two layouts, chosen by
``PrecisionPolicy.records``:

  * ``"fp32"`` (the accuracy oracle): ``[q | v | m | 1/ρ | p/ρ²]`` with
    ``q = I + x/2`` the position in per-axis cell units (exact in fp32:
    the integer cell coordinate and the halved fp16 payload both are);
  * ``"fp16"`` / ``"bf16"`` (the half-width production layout): one
    16-bit row ``[I | rel | v | m]`` plus one fp32 ``1/ρ`` gather; m is
    stored divided by :func:`mass_scale` and the outputs are multiplied
    by it once; p/ρ² is recomputed per pair from 1/ρ. fp16 rows are plain
    fp16 values; bf16 rows mix three layouts in int16 columns (u16 cell |
    fp16 rel bits | bf16 v, m bits), read back through ``.view()`` and
    ``& 0xFFFF``. Both decode to the same fp32 values as the fp32 row,
    so the only difference from the oracle is the v/m quantization.

**Chunked reduction.** The cell-sorted rows are swept in chunks
(:func:`resolve_chunk`) by a Python loop; a short last chunk is padded
with the dummy rows, whose terms are exactly zero. Invalid neighbor
slots point at the dummy record row N (m = 0, density positive), so no
per-pair mask exists: every term carries m_j, and dW/dr vanishes beyond
2h and at r = 0.

Continuity and momentum are both evaluated at the current state (the
explicit WCSPH scheme), which is what allows one pass.
"""
from __future__ import annotations

import torch

from repro_torch.core import bspline, rcll
from repro_torch.core import scheme as scheme_lib
from repro_torch.core.domain import Domain
from repro_torch.core.nnps import NeighborList
from repro_torch.core.precision import dtype_of

#: Default rows per chunk of the sweep (the JAX package's value).
DEFAULT_CHUNK = 8192

#: Up to this row count the sweep runs as one chunk.
SINGLE_CHUNK_MAX = 12288

#: Largest per-axis cell count whose integer coordinates the half-record
#: coordinate column holds exactly (fp16 integers are exact through 2^11;
#: bf16 rows carry the cell as an unsigned 16-bit value).
HALF_CELL_LIMIT = {torch.float16: 1 << 11, torch.bfloat16: 1 << 16}


def resolve_chunk(n: int, chunk: int = 0) -> int:
    """Rows per chunk: ``chunk`` (0 = one chunk up to SINGLE_CHUNK_MAX
    rows, DEFAULT_CHUNK above), equalized: the requested size fixes the
    number of chunks, and the smallest size that covers n in that many
    is returned (n = 8455 at 4096 gives 3 chunks of 2819)."""
    if chunk <= 0:
        chunk = n if n <= SINGLE_CHUNK_MAX else DEFAULT_CHUNK
    c = max(1, min(n, chunk))
    nchunk = -(-n // c)
    return -(-n // nchunk)


def _chunk_rows(x: torch.Tensor, nchunk: int, chunk: int, pad_row: torch.Tensor) -> torch.Tensor:
    """Pad axis 0 to nchunk*chunk with ``pad_row`` rows and reshape to
    (nchunk, chunk, ...)."""
    pad = nchunk * chunk - x.shape[0]
    if pad:
        x = torch.cat([x, pad_row.expand((pad,) + tuple(x.shape[1:]))], dim=0)
    return x.reshape((nchunk, chunk) + tuple(x.shape[1:]))


def _map_chunks(body, row_args: tuple, pad_rows: tuple, n: int, chunk: int):
    """Run ``body`` over row chunks of every tensor in ``row_args`` and
    concatenate the per-row results (a tuple of tensors, (n, ...)).

    A short last chunk is padded with the caller's ``pad_rows`` (one per
    row arg; the force pass pads ids with the dummy index N and records
    with the dummy record, so pad rows evaluate to exact zeros); the pad
    is sliced off.
    """
    chunk = resolve_chunk(n, chunk)
    nchunk = -(-n // chunk)
    if nchunk == 1:
        return body(row_args)
    chunked = [_chunk_rows(a, nchunk, chunk, p) for a, p in zip(row_args, pad_rows)]
    outs = [body(tuple(c[i] for c in chunked)) for i in range(nchunk)]
    return tuple(torch.cat(parts)[:n] for parts in zip(*outs))


def cell_coords_f32(rc: rcll.RCLLState) -> torch.Tensor:
    """(N, d) fp32 positions in per-axis cell units: q = I + x/2 (exact)."""
    return rc.cell_xy.to(torch.float32) + rc.rel.to(torch.float32) * 0.5


def _pair_geometry(domain: Domain, q_i, q_j):
    """Physical pair displacement, squared distance and (dW/dr)/r from
    cell-unit coordinates.

    disp_a = (q_i - q_j)_a · hc_a. A periodic axis takes the minimum
    image as a select: true pairs sit in adjacent cells, so |du| > span/2
    only across the seam, where one ±span correction is exact.
    """
    du = q_i - q_j
    cols = []
    for a, (per, ncell, hc) in enumerate(zip(domain.periodic, domain.ncells,
                                             domain.cell_sizes)):
        da = du[..., a]
        if per:
            span, half = float(ncell), ncell / 2.0
            da = da - span * (da > half).to(torch.float32) \
                + span * (da < -half).to(torch.float32)
        cols.append(da * hc)
    disp = torch.stack(cols, dim=-1)
    r2 = torch.sum(disp * disp, dim=-1)
    coef = bspline.dw_over_r(torch.sqrt(r2), domain.h, domain.dim)
    return disp, r2, coef


def _pair_rhs(domain: Domain, q_i, q_j, v_i, v_j, mj, por2_i, por2_j, inv_i, inv_j, *,
              scheme: scheme_lib.Scheme):
    """(drho, acc) pair sums over the trailing K axis.

    The one arithmetic body both record layouts decode into: the shared
    scalar coefficient coef = (dW/dr)/r is folded first (∇W_a = coef ·
    disp_a), then the scheme's ∇W channel (pressure + artificial
    viscosity), its dv channel (Morris) and its continuity channel
    (delta-SPH), each skipped when the scheme disables it.
    """
    disp, r2, coef = _pair_geometry(domain, q_i, q_j)
    dv = v_i - v_j
    dv_dot_disp = torch.sum(dv * disp, dim=-1)
    drho = torch.sum(mj * coef * dv_dot_disp, dim=-1)
    if scheme.has_delta_term:
        drho = drho + torch.sum(
            scheme.drho_pair_term(mj, inv_i, inv_j, coef * r2, r2, h=domain.h), dim=-1)
    gc = scheme.gradw_pair_coef(
        mj, por2_i, por2_j, inv_i, inv_j, dv_dot_disp, r2, h=domain.h) * coef
    if scheme.has_dv_term:
        vc = scheme.dv_pair_coef(mj, coef * r2, inv_i, inv_j, r2, h=domain.h)
        acc = torch.sum(vc[..., None] * dv - gc[..., None] * disp, dim=-2)
    else:
        acc = -torch.sum(gc[..., None] * disp, dim=-2)
    return drho, acc


def _records(rc: rcll.RCLLState, v: torch.Tensor, m: torch.Tensor,
             *extra: torch.Tensor) -> torch.Tensor:
    """(N+1, 2d+1+len(extra)) fp32 rows [q | v | m | extra...]; row N is
    the dummy (m = 0, extras 1.0 so densities stay positive)."""
    cols = [cell_coords_f32(rc), v.to(torch.float32), m.to(torch.float32)[:, None]]
    cols += [e.to(torch.float32)[:, None] for e in extra]
    rec = torch.cat(cols, dim=1)
    dummy = torch.zeros((1, rec.shape[1]), dtype=torch.float32, device=rec.device)
    dummy[0, 2 * v.shape[1] + 1:] = 1.0
    return torch.cat([rec, dummy], dim=0)


def mass_scale(m: torch.Tensor) -> torch.Tensor:
    """Normalizer for the half-record mass column: mean |m|, >= 1e-30.

    SPH masses ~rho0·ds^dim fall into fp16's subnormal range at fine ds;
    every pair term is linear in m, so the record stores m/scale and the
    force outputs are multiplied by scale once. The mean is taken in
    float64 and rounded to fp32 once, so it does not depend on the
    device's summation order.
    """
    s = torch.mean(torch.abs(m).to(torch.float64)).to(torch.float32)
    return torch.clamp(s, min=1e-30)


def _u16_bits(x: torch.Tensor) -> torch.Tensor:
    """Non-negative integers below 2^16 as the int16 carrying their u16 bits."""
    return torch.where(x > 32767, x - 65536, x).to(torch.int16)


def _records_half(rc: rcll.RCLLState, v: torch.Tensor, m: torch.Tensor,
                  records_dtype) -> torch.Tensor:
    """(N+1, 3d+1) half-width rows [I | rel | v | m]; ``m`` arrives
    divided by :func:`mass_scale`; row N is all zero (m = 0).

    fp16: one plain fp16 tensor (the cell coordinate as an exact fp16
    value). bf16: int16 bit columns, [u16 cell | fp16 rel bits | bf16 v,
    m bits] (rel stays fp16: bf16 would quantize the coordinate).
    """
    d = rc.rel.shape[1]
    dev = rc.rel.device
    if records_dtype == torch.float16:
        rec = torch.cat([rc.cell_xy.to(torch.float16), rc.rel.to(torch.float16),
                         v.to(torch.float16), m.to(torch.float16)[:, None]], dim=1)
        pad = torch.zeros((1, 3 * d + 1), dtype=torch.float16, device=dev)
    else:
        rec = torch.cat([_u16_bits(rc.cell_xy), rc.rel.to(torch.float16).view(torch.int16),
                         v.to(records_dtype).view(torch.int16),
                         m.to(records_dtype).view(torch.int16)[:, None]], dim=1)
        pad = torch.zeros((1, 3 * d + 1), dtype=torch.int16, device=dev)
    return torch.cat([rec, pad], dim=0)


def _sanitized_idx(nl: NeighborList, n: int) -> torch.Tensor:
    """Neighbor ids with invalid slots redirected to the dummy row N."""
    return torch.where(nl.mask, nl.idx, n)


def force_rhs(domain: Domain, rc: rcll.RCLLState, nl: NeighborList, v: torch.Tensor,
              m: torch.Tensor, rho: torch.Tensor, *, c0: float | None = None,
              rho0: float = 1.0, chunk: int = 0, mu: float = 0.0, records: str = "fp32",
              idx_dummy: torch.Tensor | None = None,
              scheme: scheme_lib.Scheme | None = None,
              m_scale: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """The SPH pair right-hand side in one cell-blocked pass.

    rc, v (N, d), m, rho (N,) are the packed (cell-sorted) state and nl
    its list in packed indexing. Returns (drho (N,), acc (N, d)): the
    continuity sum and the momentum sum of ``scheme`` at the current
    state; body force and walls are the caller's. ``c0``/``rho0``/``mu``
    build the linear-EOS + Morris scheme when ``scheme`` is omitted.
    ``records`` picks the row layout; ``idx_dummy`` optionally gives the
    ids already redirected to N (a window-search list is); ``m_scale``
    optionally gives the precomputed :func:`mass_scale`.
    """
    if scheme is None:
        if c0 is None:
            raise ValueError("pass either scheme= or the legacy c0=")
        scheme = scheme_lib.wcsph(c0, rho0, mu)
    rho0 = scheme.rho0
    d = domain.dim
    n = rc.rel.shape[0]
    dev = rc.rel.device
    rdt = dtype_of(records)
    half = rdt.itemsize == 2
    if half and max(domain.ncells) >= HALF_CELL_LIMIT[rdt]:
        raise ValueError(
            "half-width records store cell coordinates in 16-bit rows "
            f"(exact through {HALF_CELL_LIMIT[rdt]} cells per axis for "
            f"records={records!r}); grid {domain.ncells} exceeds that — use "
            "records='fp32'")
    idx = _sanitized_idx(nl, n) if idx_dummy is None else idx_dummy
    idx = idx.long()
    # Both layouts carry the reciprocal density: N divisions, none per pair.
    inv = (1.0 / rho).to(torch.float32)
    ids_pad = torch.full((idx.shape[1],), n, dtype=torch.int64, device=dev)

    if not half:
        rec = _records(rc, v, m, inv, scheme.por2_inv(inv))
        rec[n, 2 * d + 2] = 0.0  # dummy p/ρ² (1/ρ stays 1)

        def body(args):
            idx_c, rec_i = args
            rec_j = rec[idx_c]  # ONE gather: (chunk, K, 2d+3)
            return _pair_rhs(
                domain,
                rec_i[:, None, :d], rec_j[..., :d],
                rec_i[:, None, d:2 * d], rec_j[..., d:2 * d],
                rec_j[..., 2 * d],  # m_j: 0 on the dummy row
                rec_i[:, None, 2 * d + 2], rec_j[..., 2 * d + 2],
                rec_i[:, None, 2 * d + 1], rec_j[..., 2 * d + 1],
                scheme=scheme)

        return _map_chunks(body, (idx, rec[:n]), (ids_pad, rec[n]), n, chunk)

    if m_scale is None:
        m_scale = mass_scale(m)
    rec16 = _records_half(rc, v, m.to(torch.float32) / m_scale, rdt)
    # Dummy 1/ρ = 1/ρ0: p/ρ² decodes to ~0 and denominators stay positive.
    inv32 = torch.cat([inv, torch.full((1,), 1.0 / rho0, dtype=torch.float32, device=dev)])
    plain = rdt == torch.float16

    def decode(r16):
        """One upconvert of the gathered rows -> (q, v, m) in fp32."""
        if plain:
            r32 = r16.to(torch.float32)
        else:  # bf16: [u16 cell | f16 rel bits | bf16 v m bits]
            r32 = torch.cat([
                (r16[..., :d].to(torch.int32) & 0xFFFF).to(torch.float32),
                r16[..., d:2 * d].view(torch.float16).to(torch.float32),
                r16[..., 2 * d:].view(rdt).to(torch.float32),
            ], dim=-1)
        q = r32[..., :d] + r32[..., d:2 * d] * 0.5
        return q, r32[..., 2 * d:3 * d], r32[..., 3 * d]

    def body(args):
        idx_c, r16_i, inv_i = args
        r16_j = rec16[idx_c]  # ONE half-width gather: (chunk, K, 3d+1)
        inv_j = inv32[idx_c]  # the single fp32 pair field
        q_i, v_i, _ = decode(r16_i)
        q_j, v_j, m_j = decode(r16_j)
        return _pair_rhs(
            domain, q_i[:, None, :], q_j, v_i[:, None, :], v_j, m_j,
            scheme.por2_inv(inv_i)[:, None], scheme.por2_inv(inv_j),
            inv_i[:, None], inv_j, scheme=scheme)

    drho, acc = _map_chunks(body, (idx, rec16[:n], inv32[:n]),
                            (ids_pad, rec16[n], inv32[n]), n, chunk)
    return drho * m_scale, acc * m_scale  # undo the mass normalization


def record_bytes_per_pair(d: int, records: str = "fp32") -> int:
    """Record bytes gathered per neighbor pair: one (2d+3)-column fp32
    row, or one (3d+1)-column 16-bit row plus the fp32 1/ρ gather."""
    if dtype_of(records).itemsize == 2:
        return (3 * d + 1) * 2 + 4
    return (2 * d + 3) * 4


def estimate_hbm_bytes_per_step(n: int, k: int, d: int, fused: bool = True,
                                records: str = "fp32") -> int:
    """Back-of-envelope pair traffic of one physics step.

    Fused: one id read per pair, the record gather and O(N) per-particle
    traffic (record build, self rows, outputs). Gather (reference) path:
    ~(6d + 9) (N, K) fp32 arrays written and read back, plus ~6 scalar
    neighbor gathers.
    """
    nk = n * k
    if fused:
        rec = record_bytes_per_pair(d, records)
        return nk * 4 + nk * rec + n * (2 * rec + (d + 1) * 4)
    round_trips = 2 * (6 * d + 9)
    gathers = nk * (2 * d + 3 + d) * 4
    return nk * round_trips * 4 + gathers
