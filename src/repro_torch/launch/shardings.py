"""Sharding assignment for step-function inputs/outputs.

Port of ``repro.launch.shardings`` over the port's trees: parameter dicts
with JAX's keys, ``optim.adamw.OptState`` and the caches' NamedTuples.
Each function returns a tree of the port's ``partitioning.NamedSharding``
(a mesh and a ``PartitionSpec``, with a DTensor ``placements`` view), on a
``DeviceMesh`` or an ``AbstractMesh``.

Parameters go through ``models.partitioning``'s rules (TP on "model",
FSDP on "data" for large models). Batches shard their leading axis over
the DP axes. Caches use a shape heuristic (works uniformly across the
five cache types): batch axis over DP if divisible, else the longest
sequence-like axis over "data"; a heads-like axis over "model" when it
divides.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models import partitioning as pt
from repro_torch.models.partitioning import P, NamedSharding


def dp_axes(mesh) -> tuple:
    return ("pod", "data") if "pod" in pt.axis_names(mesh) else ("data",)


def dp_size(mesh) -> int:
    sizes = pt.axis_sizes(mesh)
    return math.prod(sizes[a] for a in dp_axes(mesh))


def replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def batch_shardings(mesh, batch_abs):
    """Leading axis of every batch leaf -> DP axes (must divide)."""
    dp = dp_axes(mesh)

    def per_leaf(x):
        if len(x.shape) >= 1 and x.shape[0] % dp_size(mesh) == 0:
            return NamedSharding(mesh, P(dp, *([None] * (len(x.shape) - 1))))
        return replicated(mesh)

    return pt.tree_map(per_leaf, batch_abs)


def cache_shardings(mesh, cache_abs, batch: int, seq_len: int):
    """Heuristic per-leaf cache sharding (see module docstring).

    Cache leaves are (n_layers, B, ...) stacked. Axis 1 is batch.
    """
    dp = dp_axes(mesh)
    dpn = dp_size(mesh)
    model_n = pt.axis_sizes(mesh)["model"]

    def per_leaf(x):
        shape = tuple(x.shape)
        nd = len(shape)
        spec = [None] * nd
        if nd >= 2 and shape[1] == batch and batch % dpn == 0:
            spec[1] = dp
        elif nd >= 3:
            # batch too small: shard the sequence-like axis over data
            for ax in range(2, nd):
                if shape[ax] >= seq_len // 2 and shape[ax] % dpn == 0:
                    spec[ax] = dp
                    break
        # heads-like axis on model (first remaining axis that divides and
        # looks like heads: small-ish, divisible)
        for ax in range(2, nd):
            if spec[ax] is None and 1 < shape[ax] <= 4096 and shape[ax] % model_n == 0:
                spec[ax] = "model"
                break
        return NamedSharding(mesh, P(*spec))

    return pt.tree_map(per_leaf, cache_abs)


def param_shardings(mesh, params_abs, *, fsdp: bool):
    return pt.tree_shardings(params_abs, mesh, fsdp=fsdp)


def opt_shardings(mesh, opt_abs, p_shardings):
    """Optimizer moments shard exactly like their parameters."""
    from repro_torch.optim.adamw import OptState, tree_map

    return OptState(step=replicated(mesh),
                    mu=tree_map(lambda _, s: s, opt_abs.mu, p_shardings),
                    nu=tree_map(lambda _, s: s, opt_abs.nu, p_shardings))


def distribute(tree, shardings):
    """Each tensor of ``tree`` laid out on its ``NamedSharding`` in
    ``shardings`` (the same structure; a single sharding applies to every
    leaf): ``torch.distributed.tensor.distribute_tensor``, a collective
    every rank of the mesh runs, which takes rank 0's values (a replicated
    leaf is broadcast, a sharded one scattered). The DTensors share the
    tensors' storage where no move is needed (one rank, replicated)."""
    from torch.distributed.tensor import distribute_tensor

    def put(t, s):
        if t is None:
            return None
        return distribute_tensor(t, s.mesh, s.placements(t.dim()))

    if isinstance(shardings, NamedSharding):
        return pt.tree_map(lambda t: put(t, shardings), tree)
    return _zip_map(put, tree, shardings)


def constrain(tree, shardings):
    """Each DTensor of ``tree`` redistributed to its ``NamedSharding`` in
    ``shardings`` (the same structure; a single sharding applies to every
    leaf), as JAX's ``out_shardings`` lay a jitted step's outputs out;
    nothing moves where a leaf has its placements already."""
    def put(t, s):
        if t is None:
            return None
        if not pt.is_dtensor(t):  # made inside the step, the same on every rank
            t = pt.from_replica(t, s.mesh)
        return pt.redistribute_to(t, s.mesh, s.placements(t.dim()))

    if isinstance(shardings, NamedSharding):
        return pt.tree_map(lambda t: put(t, shardings), tree)
    return _zip_map(put, tree, shardings)


def lay_out(tree, shardings):
    """Each tensor of ``tree`` as a DTensor on its ``NamedSharding`` in
    ``shardings`` (the same structure; a single sharding applies to every
    leaf) with no collective and no copy: this rank's shard of its
    placements, a new tensor of its local shape (``torch.chunk``'s) on the
    tensor's device, uninitialized. For the dry run's meta tensors, where
    :func:`distribute` would run a scatter of nothing."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    def put(t, s):
        if t is None:
            return None
        pl = s.placements(t.dim())
        local, _ = compute_local_shape_and_global_offset(t.shape, s.mesh, pl)
        return DTensor.from_local(torch.empty(local, dtype=t.dtype, device=t.device), s.mesh,
                                  pl, run_check=False, shape=t.shape, stride=t.stride())

    if isinstance(shardings, NamedSharding):
        return pt.tree_map(lambda t: put(t, shardings), tree)
    return _zip_map(put, tree, shardings)


def _zip_map(fn, tree, other):
    if isinstance(tree, dict):
        return {k: _zip_map(fn, v, other[k]) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_zip_map(fn, a, b) for a, b in zip(tree, other)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_zip_map(fn, a, b) for a, b in zip(tree, other))
    return fn(tree, other)
