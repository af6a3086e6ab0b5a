"""Anchored gradient compression for data-parallel all-reduce.

Port of the local half of ``repro.optim.compress``: the paper's
decomposition applied to gradients. Per 256-element block, gradient =
anchor (fp32 mean) + scale (fp32) * residual (int8). A data-parallel
all-reduce then moves ~4x fewer bytes.

Error feedback: the quantization error is carried to the next step
(Seide et al. / 1-bit SGD), making the compression unbiased in the long
run.

``compress`` / ``decompress`` are pure local transforms.
``all_reduce_compressed`` is the collective over a process group (or one
axis of a mesh), JAX's over a named axis inside ``shard_map``.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist
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


def _group(group_or_mesh_dim):
    """A process group from a group, a one-dimensional ``DeviceMesh``, or
    (mesh, axis name)."""
    if isinstance(group_or_mesh_dim, tuple):
        mesh, axis = group_or_mesh_dim
        return mesh.get_group(axis)
    if hasattr(group_or_mesh_dim, "get_group"):
        return group_or_mesh_dim.get_group()
    return group_or_mesh_dim


def all_reduce_compressed(g: torch.Tensor, group_or_mesh_dim, carry: torch.Tensor | None = None):
    """Mean-all-reduce of this rank's gradient ``g`` over a process group
    (or a mesh axis, ``(mesh, name)``), int8 on the wire: every rank of the
    group calls it. Returns (mean, new_carry) in JAX's layout (``g``'s
    shape).

    Two collectives, JAX's: a tiny fp32 MAX all-reduce of the per-block
    deviation scales first, so every rank quantizes its residuals against
    the same scale, then the residuals summed exactly in int32 beside an
    fp32 sum of the per-block anchors. Each rank's quantization error is
    its new carry (error feedback)."""
    group = _group(group_or_mesh_dim)
    size = dist.get_world_size(group)
    flat = g.reshape(-1).float()
    if carry is not None:
        flat = flat + carry.reshape(-1)
    n = flat.shape[0]
    pad = (-n) % BLOCK
    x = F.pad(flat, (0, pad)).reshape(-1, BLOCK)
    anchor = torch.mean(x, dim=1)
    dev = x - anchor[:, None]
    scale = torch.amax(torch.abs(dev), dim=1)
    dist.all_reduce(scale, op=dist.ReduceOp.MAX, group=group)  # shared per-block scale
    scale = torch.clamp_min(scale, 1e-30)
    resid = torch.clamp(torch.round(dev / scale[:, None] * 127.0), -127, 127)
    err = dev - resid * (scale[:, None] / 127.0)
    new_carry = err.reshape(-1)[:n].reshape(g.shape)
    resid_sum = resid.to(torch.int32)  # the int8 payload, summed exactly in int32
    dist.all_reduce(resid_sum, op=dist.ReduceOp.SUM, group=group)
    anchor_sum = anchor.clone()
    dist.all_reduce(anchor_sum, op=dist.ReduceOp.SUM, group=group)
    total = anchor_sum[:, None] + resid_sum.float() * (scale[:, None] / 127.0)
    mean = (total / size).reshape(-1)[:n].reshape(g.shape)
    return mean, new_carry
