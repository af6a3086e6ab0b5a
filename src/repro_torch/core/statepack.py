"""Fused per-particle state permutation (the rebuild's record-row trick).

Port of ``repro.core.statepack``. Every per-particle field is bit-packed
into one contiguous int32 row buffer, permuted by a single row gather and
unbundled back to its dtype. torch's uint32/uint16 support is thin, so
the columns are int32 and every conversion is a ``.view()`` bitcast or an
integer widening that truncates back exactly:

  * 4-byte dtypes (f32 / i32): one bitcast column per component;
  * 2-byte dtypes (f16 / bf16 / i16): the 16 bits zero-extended;
  * 1-byte dtypes (bool / i8 / u8): the byte zero-extended.
"""
from __future__ import annotations

import torch


def _ncols(x: torch.Tensor) -> int:
    """int32 columns a field occupies (one per trailing component)."""
    comps = 1
    for s in x.shape[1:]:
        comps *= s
    return comps


def _to_i32_cols(x: torch.Tensor) -> torch.Tensor:
    """(N, comps) int32 view of a per-particle field (exact)."""
    flat = x.reshape(x.shape[0], -1)
    size = x.dtype.itemsize
    if size == 4:
        return flat.view(torch.int32)
    if size == 2:
        return flat.view(torch.int16).to(torch.int32) & 0xFFFF
    if size == 1:
        if x.dtype == torch.bool:
            return flat.to(torch.int32)
        return flat.view(torch.uint8).to(torch.int32)
    raise ValueError(f"unsupported statepack dtype {x.dtype}")


def _from_i32_cols(cols: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`_to_i32_cols` for a field shaped/typed as ``like``."""
    shape = (cols.shape[0],) + tuple(like.shape[1:])
    cols = cols.contiguous()
    size = like.dtype.itemsize
    if size == 4:
        out = cols.view(like.dtype)
    elif size == 2:
        out = cols.to(torch.int16).view(like.dtype)
    elif size == 1:
        if like.dtype == torch.bool:
            out = cols != 0
        else:
            out = cols.to(torch.uint8).view(like.dtype)
    else:
        raise ValueError(f"unsupported statepack dtype {like.dtype}")
    return out.reshape(shape)


def permute_fields(fields: tuple, perm: torch.Tensor) -> tuple:
    """Permute every per-particle tensor in ``fields`` by one row gather.

    ``None`` entries pass through. Bit-for-bit equal to
    ``tuple(f[perm] for f in fields)``.
    """
    present = [f for f in fields if f is not None]
    if not present:
        return fields
    buf = torch.cat([_to_i32_cols(f) for f in present], dim=1)
    buf = buf[perm.long()]
    out, col = [], 0
    for f in fields:
        if f is None:
            out.append(None)
            continue
        c = _ncols(f)
        out.append(_from_i32_cols(buf[:, col:col + c], f))
        col += c
    return tuple(out)
