"""Anchored gradient compression for data-parallel all-reduce.

Port of the local half of ``repro.optim.compress``: the paper's
decomposition applied to gradients. Per 256-element block, gradient =
anchor (fp32 mean) + scale (fp32) * residual (int8). A data-parallel
all-reduce then moves ~4x fewer bytes.

Error feedback: the quantization error is carried to the next step
(Seide et al. / 1-bit SGD), making the compression unbiased in the long
run.

``compress`` / ``decompress`` are pure local transforms.
``all_reduce_compressed``, the collective over a named mesh axis, goes
with the sharding slice.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

BLOCK = 256


class Compressed(NamedTuple):
    anchor: torch.Tensor  # (nblk,) fp32 per-block mean
    scale: torch.Tensor  # (nblk,) fp32
    resid: torch.Tensor  # (nblk, BLOCK) int8
    n: int  # original length


def compress(g: torch.Tensor, carry: torch.Tensor | None = None):
    """Quantize a flat fp32 gradient; returns (Compressed, new_carry).
    Rounding is to nearest even, as ``jnp.round``."""
    flat = g.reshape(-1).float()
    if carry is not None:
        flat = flat + carry.reshape(-1)
    n = flat.shape[0]
    pad = (-n) % BLOCK
    x = F.pad(flat, (0, pad)).reshape(-1, BLOCK)
    anchor = torch.mean(x, dim=1)
    dev = x - anchor[:, None]
    scale = torch.clamp_min(torch.amax(torch.abs(dev), dim=1), 1e-30)
    resid = torch.clamp(torch.round(dev / scale[:, None] * 127.0), -127, 127)
    err = dev - resid * (scale[:, None] / 127.0)  # quantization error
    new_carry = err.reshape(-1)[:n].reshape(g.shape)
    return Compressed(anchor, scale, resid.to(torch.int8), n), new_carry


def decompress(c: Compressed, shape) -> torch.Tensor:
    x = c.anchor[:, None] + c.resid.float() * (c.scale[:, None] / 127.0)
    return x.reshape(-1)[:c.n].reshape(shape)


def compression_ratio(shape) -> float:
    n = int(np.prod(shape))
    nblk = -(-n // BLOCK)
    raw = 4 * n
    packed = nblk * (4 + 4 + BLOCK)
    return raw / packed
