"""Anchored mixed-precision arrays: the RCLL decomposition, generalized.

Port of ``repro.core.anchored``. RCLL stores ``position = cell_center +
h_c/2 * residual(fp16)`` with the residual normalized to [-1, 1]; the
same decomposition applies to any memory-bound tensor whose values are
locally clustered:

    value = anchor(block, fp32) + scale(block, fp32) * residual(lo)

with the residual normalized into [-1, 1] per block. The port uses it for
RCLL-KV, the block-anchored quantized KV cache of LM decode
(``models.attention.AnchoredKVCache``, kernel K6).

Residual dtypes: fp16 / bf16 / int8 (symmetric, 127 levels).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.precision import NNPS_STORE


class Anchored(NamedTuple):
    """Block-anchored representation of an array.

    The blocked axis is folded as (..., nblocks, block_size, trailing...).
    anchor/scale have block_size dim of 1 (broadcastable).
    """

    anchor: torch.Tensor  # fp32, (..., nblocks, 1, ...)
    scale: torch.Tensor  # fp32, (..., nblocks, 1, ...)
    residual: torch.Tensor  # lo dtype, (..., nblocks, block_size, ...)
    axis: int  # original blocked axis
    orig_len: int  # original length along axis (for unpadding)


def _to_blocks(x: torch.Tensor, axis: int, block: int) -> tuple[torch.Tensor, int]:
    n = x.shape[axis]
    pad = (-n) % block
    if pad:
        # edge padding keeps padded entries inside the data range, so they
        # never inflate the per-block scale (zero padding would wreck blocks
        # whose data sits far from zero)
        last = x.narrow(axis, n - 1, 1)
        x = torch.cat([x, last.expand(*x.shape[:axis], pad, *x.shape[axis + 1:])], dim=axis)
    shape = list(x.shape)
    shape[axis:axis + 1] = [shape[axis] // block, block]
    return x.reshape(shape), n


def quantize_residual(dev: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    """``dev / scale`` in the residual dtype: int8 as round(127 r) (half to
    even, as ``jnp.round``) clipped to [-127, 127], floats by a cast."""
    resid = dev / scale
    if dtype == torch.int8:
        return torch.clamp(torch.round(resid * 127.0), -127, 127).to(torch.int8)
    return resid.to(dtype)


def dequantize_residual(resid: torch.Tensor) -> torch.Tensor:
    """The residual as fp32 in [-1, 1] (int8 levels times 1/127)."""
    if resid.dtype == torch.int8:
        return resid.float() * (1.0 / 127.0)
    return resid.float()


def encode(x: torch.Tensor, *, block: int, axis: int = -1, dtype=NNPS_STORE,
           eps: float = 1e-30) -> Anchored:
    """Encode x into anchor + scaled low-precision residual.

    anchor = per-block mean, scale = per-block max|x - anchor| (so the
    residual exactly spans [-1, 1], as the paper's Eqs. 5-6 normalize).
    """
    axis = axis % x.dim()
    xb, orig_len = _to_blocks(x.float(), axis, block)
    bax = axis + 1  # the within-block axis after the reshape
    anchor = torch.mean(xb, dim=bax, keepdim=True)
    dev = xb - anchor
    scale = torch.clamp_min(torch.amax(torch.abs(dev), dim=bax, keepdim=True), eps)
    return Anchored(anchor, scale, quantize_residual(dev, scale, dtype), axis, orig_len)


def decode(a: Anchored, dtype=torch.float32) -> torch.Tensor:
    """Reconstruct the original array (high precision)."""
    resid = a.residual.float() / 127.0 if a.residual.dtype == torch.int8 else a.residual.float()
    xb = a.anchor + a.scale * resid
    shape = list(xb.shape)
    shape[a.axis:a.axis + 2] = [shape[a.axis] * shape[a.axis + 1]]
    return xb.reshape(shape).narrow(a.axis, 0, a.orig_len).to(dtype)


def quantization_error_bound(a: Anchored) -> torch.Tensor:
    """Per-block worst-case absolute reconstruction error."""
    if a.residual.dtype == torch.int8:
        step = 1.0 / 127.0
    else:
        step = torch.finfo(a.residual.dtype).eps
    return a.scale * step

