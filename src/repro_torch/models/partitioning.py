"""Sharding rules: logical param/activation axes -> mesh PartitionSpecs,
and PartitionSpecs -> DTensor placements.

Port of ``repro.models.partitioning``. Parallelism mapping:
  * batch        -> ("pod", "data")   pure DP across pods and the data axis
  * TP           -> "model"           heads / ffn-hidden / vocab / experts
  * FSDP (ZeRO-3)-> "data"            parameter+optimizer sharding for big
                                      models, on top of TP

Everything here is *mesh-shape agnostic*: specs reference axis names. The
spec functions take a ``torch.distributed.device_mesh.DeviceMesh`` whose
``mesh_dim_names`` are the axes, or an :class:`AbstractMesh` (a shape and
axis names, no devices), as JAX's take a ``Mesh`` or an ``AbstractMesh``.

Where JAX has an ambient mesh (``jax.set_mesh``) and lowers
``with_sharding_constraint``, the port has :func:`use_mesh`, a context
manager that sets :func:`current_mesh` for its length, and DTensors: under
a mesh, :func:`act` is ``x.redistribute(mesh, placements(mesh, spec))``.
With no mesh every ``act*`` returns its input, the same tensor, so a run
without a mesh computes what it did before this module existed. Under a
mesh a plain tensor reaching ``act`` raises: the hint would be lost.

A spec entry naming several mesh axes, ``("pod", "data")``, shards its
tensor dimension over each of them in mesh order (pod-major, as JAX).
An axis the mesh lacks is dropped, as ``constrain`` drops it. A dimension
that does not divide its axes' size is sharded unevenly (``torch.chunk``'s
sizes: the last ranks may hold fewer rows or none), where GSPMD pads.
"""
from __future__ import annotations

import contextlib
import math
import re
from typing import Any

import torch

Array = Any


class PartitionSpec(tuple):
    """JAX's ``PartitionSpec``: one entry per tensor dimension, each None,
    a mesh axis name or a tuple of names (a tuple of one name is that
    name, as JAX normalizes it). ``P("data", None) == ("data", None)``, so
    a spec compares equal to JAX's entry by entry."""

    def __new__(cls, *entries):
        return super().__new__(cls, (e[0] if isinstance(e, tuple) and len(e) == 1 else e
                                     for e in entries))

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


class AbstractMesh:
    """A mesh's shape and axis names without devices (JAX's
    ``jax.sharding.AbstractMesh``): the spec functions and the shardings of
    ``launch.shardings`` accept it wherever they accept a ``DeviceMesh``."""

    def __init__(self, shape: tuple, axis_names: tuple):
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {shape} and axes {axis_names} differ in length")
        self.axis_sizes = tuple(int(n) for n in shape)
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)

    def __repr__(self):
        return f"AbstractMesh({self.shape})"


def axis_names(mesh) -> tuple:
    """The mesh's axis names, for a ``DeviceMesh`` or an :class:`AbstractMesh`."""
    if isinstance(mesh, AbstractMesh):
        return mesh.axis_names
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("a DeviceMesh needs mesh_dim_names to take PartitionSpecs")
    return tuple(names)


def axis_sizes(mesh) -> dict:
    """{axis name: size} (JAX's ``mesh.shape``)."""
    if isinstance(mesh, AbstractMesh):
        return mesh.shape
    return dict(zip(axis_names(mesh), mesh.shape))


_MESH: list = []


def is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def current_mesh():
    """The mesh :func:`use_mesh` set, or None."""
    return _MESH[-1] if _MESH else None


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` :func:`current_mesh` for the length of the block (JAX's
    ``jax.set_mesh``, scoped); the previous one comes back after."""
    _MESH.append(mesh)
    try:
        yield mesh
    finally:
        _MESH.pop()


def mesh_axis(name: str) -> bool:
    m = current_mesh()
    return m is not None and name in axis_names(m)


def batch_axes():
    """The DP axes present on the current mesh ('pod' only if multi-pod)."""
    if mesh_axis("pod"):
        return ("pod", "data")
    return "data"


def fix_spec(mesh, spec) -> PartitionSpec:
    """``spec`` with the axis names ``mesh`` lacks dropped (``constrain``'s
    ``fix``)."""
    names = axis_names(mesh)

    def fix(entry):
        if entry is None:
            return None
        if isinstance(entry, tuple):
            kept = tuple(e for e in entry if e in names)
            return kept if kept else None
        return entry if entry in names else None

    return P(*(fix(e) for e in spec))


def placements(mesh, spec, ndim: int | None = None) -> list:
    """DTensor placements of ``spec`` on ``mesh``, one per mesh dimension:
    ``Shard(d)`` on each mesh axis that entry d names, ``Replicate()`` on
    the others. An entry naming several axes shards its dimension over
    them in mesh order; an entry listing them in another order raises (a
    DTensor shards the mesh's dimensions outermost first). Absent axes are
    dropped; an axis named twice raises. ``ndim``, where given, is the
    tensor's rank, which the spec must not exceed."""
    from torch.distributed.tensor import Replicate, Shard

    names = axis_names(mesh)
    spec = fix_spec(mesh, spec)
    if ndim is not None and len(spec) > ndim:
        raise ValueError(f"spec {spec} has more entries than the tensor's {ndim} dims")
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry} is not in the mesh's axis order {names}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"mesh axis {names[i]!r} named twice in {spec}")
            out[i] = Shard(d)
    return out


def constrain(x: Array, spec: PartitionSpec | None) -> Array:
    """``x`` redistributed to ``spec`` on the current mesh (JAX's
    ``with_sharding_constraint``); the same tensor without a mesh or a
    spec. Under a mesh ``x`` must be a DTensor on it."""
    m = current_mesh()
    if m is None or spec is None:
        return x
    return redistribute_to(x, m, placements(m, spec, x.dim()))


def redistribute_to(x, m, target) -> Array:
    """``x`` on ``m`` with ``target`` placements; ``x`` itself where it has
    them, or differs from them only on mesh dimensions of size 1, where
    every placement but ``Partial`` holds the whole tensor (no autograd
    node: a tensor read in several places then sums its gradients in the
    order it does without a mesh, and a (1, 1) mesh redistributes
    nothing)."""
    if all(c == t or (m.size(i) == 1 and not c.is_partial())
           for i, (c, t) in enumerate(zip(_placements_of(x, m), target, strict=True))):
        return x
    return x.redistribute(m, target)


def seq_whole(x: Array) -> Array:
    """An activation (B, L, ...) with its sequence whole on every rank and
    its batch over DP: where ``act_seq``'s carry enters a layer body, a
    shared block or the logits, or the encoder's output enters the
    cross-attention: their products fold (B, L) into rows, forward and
    backward, which DTensor in torch 2.11 refuses with L sharded. The carry
    between layers, which remat keeps, stays sequence-sharded; the identity
    without a mesh."""
    if current_mesh() is None:
        return x
    return act(x, "batch", *([None] * (x.dim() - 1)))


def contract_whole(x: Array) -> Array:
    """``x`` about to be contracted over its last axis (the row-parallel
    products: an MLP's ``w_down``, attention's ``wo``, mamba2's
    ``out_proj``): under a mesh, its last axis gathered whole on every
    rank (its other axes keep their layout), so the product sums each
    output in one order, as without a mesh. GSPMD sums per-shard partial
    products instead; in bf16 those round differently at every model
    degree, and the MoE routers downstream would pick other experts near
    ties. The identity without a mesh."""
    m = current_mesh()
    if m is None:
        return x
    from torch.distributed.tensor import Replicate, Shard

    d = x.dim() - 1
    keep = [Replicate() if p.is_partial() or (isinstance(p, Shard) and p.dim == d) else p
            for p in _placements_of(x, m)]
    return redistribute_to(x, m, keep)


def column_parallel(x: Array, w: Array, heads: int = 0) -> Array:
    """``x @ w`` for a column-parallel weight ``w`` (d, n), whose output
    JAX's hints put on "model": q/k/v, gate/up, ``in_proj``, MLA's ``wq_b``
    and ``wkv_b``, the unembedding. With ``heads`` the output's last axis
    comes split into (heads, n / heads). Under a mesh each model rank
    multiplies its own rows (batch over DP) by its own columns only, a
    head's columns at a time (``torch.chunk``'s share of the heads, or of
    the n columns, as a DTensor ``Shard`` splits them), and the output has
    that axis on "model": the product is split over "model" as GSPMD
    splits it. Each output element is the unsharded product's, one sum
    over x's last axis in one order, so the forward is bit-equal to the
    run without a mesh. Backward, x's gradient is the sum over "model" of
    the ranks' parts and w's is gathered from the ranks' columns."""
    unit = (heads, w.shape[-1] // heads) if heads else (w.shape[-1],)
    if current_mesh() is None:
        out = x @ w
        return out.reshape(*out.shape[:-1], *unit) if heads else out
    rows = ("batch",) + (None,) * (x.dim() - 1)
    w_spec = (None, "model") + (None,) * (len(unit) - 1)
    if heads:
        w = whole_dims(w, (1,), unless_divides=heads)

    def local(xl, wl):
        out = xl @ wl.reshape(wl.shape[0], math.prod(wl.shape[1:]))
        return out.reshape(*out.shape[:-1], *wl.shape[1:])

    return on_local(local, (x, w.reshape(w.shape[0], *unit)), (rows, w_spec),
                    (rows[:-1] + w_spec[1:],), (tuple(x.shape[:-1]) + unit,),
                    partial={0: ("model",), 1: ("batch",)})


def whole_dims(x: Array, dims: tuple, unless_divides: int = 0) -> Array:
    """DTensor ``x`` with the mesh axes that shard any of ``dims``
    replicated (an all-gather over them), its other placements kept;
    with ``unless_divides`` only those axes whose size does not divide it.
    Before a reshape that splits a sharded dimension into (n, rest): DTensor
    refuses the view unless n divides over the axis (``torch.chunk``'s
    shards of the flat dimension would cut the n units), where GSPMD pads."""
    m = current_mesh()
    if m is None or not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard

    keep = [Replicate() if isinstance(p, Shard) and p.dim in dims
            and not (unless_divides and unless_divides % m.size(i) == 0) else p
            for i, p in enumerate(x.placements)]
    return redistribute_to(x, m, keep)


def vocab_split(vocab: int) -> bool:
    """Whether :func:`act_vocab` puts logits of ``vocab`` entries on
    "model" (the current mesh has that axis and its size divides them)."""
    spec = act_vocab_spec((1, vocab))
    return spec is not None and spec[-1] is not None


def row_parallel(x: Array, w: Array) -> Array:
    """``x @ w`` for a row-parallel weight ``w`` (attention's ``wo``, an
    MLP's ``w_down``, mamba2's ``out_proj``), whose input JAX's hints put
    on "model": under a mesh, x's last axis gathered whole on every rank
    (:func:`contract_whole`), then each rank multiplies its own rows
    (batch over DP) by its whole copy of ``w``. So the product is split
    over DP only, and each model rank repeats it: the price of summing
    every output in the unsharded run's order."""
    if current_mesh() is None:
        return x @ w
    return replica_product(contract_whole(x), w)


def replica_product(x: Array, w: Array) -> Array:
    """``x @ w`` with ``w`` whole on every rank: under a mesh each rank
    multiplies its own rows (batch over DP, the rest of x whole) by its
    whole copy of ``w`` (gathered where FSDP or TP split it), so the
    product is split over DP only. The low-rank and small products whose
    weight JAX's rules leave unsplit on "model", or whose output no hint
    splits: MLA's ``wq_a``/``wkv_a``, vlm's ``w_patch``, an unembedding
    whose vocab "model" does not divide, the hybrid's shared ``w_down``;
    and :func:`row_parallel`'s. DTensor's own matmul rule would plan the
    backward's weight gradient over a batch flattened into rows, which
    took minutes a product on a 2 x 16 x 16 mesh."""
    if current_mesh() is None:
        return x @ w
    rows = ("batch",) + (None,) * (x.dim() - 1)
    return on_local(lambda xl, wl: xl @ wl, (x, w), (rows, ()), (rows,),
                    (tuple(x.shape[:-1]) + (w.shape[-1],),), partial={1: ("batch",)})


def write_positions(dst: Array, idx: Array, val: Array, keep: Array | None = None) -> None:
    """``dst[b, idx[b]] = val[b]`` for every row b, IN PLACE: one position a
    row of ``dst`` (B, L, ...) from ``val`` (B, ...) at ``idx`` (B,) (the
    decode caches' writes); with ``keep`` (B,) bool, rows where it is false
    keep what they hold. Under a mesh ``dst`` is a DTensor and each rank
    writes its own shard (DTensor has no in-place rule for ``index_put_``
    on a sharded tensor): ``val`` is laid out as ``dst`` is (its rows and
    trailing dims; whole over the axes that split ``dst``'s positions),
    ``idx`` and ``keep`` by ``dst``'s rows, and where ``dst``'s positions
    are split (a 500k-token cache over DP, an anchored cache's blocks over
    "model") only the rank whose shard holds ``idx[b]`` writes it (a
    ``where`` on the others: no branch, no host read)."""
    if current_mesh() is None or not is_dtensor(dst):
        rows = torch.arange(dst.shape[0], device=dst.device)
        if keep is not None:
            val = torch.where(keep.reshape(-1, *([1] * (val.dim() - 1))), val, dst[rows, idx])
        dst[rows, idx] = val
        return
    shape, off = local_offset(dst)
    vl = local_as(val, dst, {d: d - (d > 1) for d in range(dst.dim()) if d != 1})
    il = local_as(idx, dst, {0: 0}).long() - off[1]
    inside = (il >= 0) & (il < shape[1])
    if keep is not None:
        inside = inside & local_as(keep, dst, {0: 0})
    dl = dst.to_local()
    rows = torch.arange(dl.shape[0], device=dl.device)
    il = il.clamp(0, shape[1] - 1)
    dl[rows, il] = torch.where(inside.reshape(-1, *([1] * (vl.dim() - 1))), vl.to(dl.dtype),
                               dl[rows, il])


def split_axes(x: Array, dim: int) -> list:
    """The mesh dimensions (indices) of size > 1 that shard dimension
    ``dim`` of DTensor ``x``, in mesh order."""
    from torch.distributed.tensor import Shard

    m = x.device_mesh
    return [i for i, p in enumerate(x.placements)
            if isinstance(p, Shard) and p.dim == dim and m.size(i) > 1]


def local_offset(x: Array) -> tuple:
    """(local shape, global offset) of this rank's shard of DTensor ``x``."""
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    return compute_local_shape_and_global_offset(x.shape, x.device_mesh, x.placements)


def local_as(x: Array, like: Array, dims: dict) -> torch.Tensor:
    """This rank's tensor of DTensor (or replicated plain tensor) ``x`` laid
    out to match DTensor ``like``: ``dims`` maps a dimension of ``like`` to
    the dimension of ``x`` that goes with it; each mesh axis that shards
    one of those dimensions of ``like`` shards ``x``'s there, and ``x`` is
    whole over every other axis."""
    m = like.device_mesh
    if not is_dtensor(x):
        x = from_replica(x, m)
    return redistribute_to(x, m, _matched(like, dims)).to_local()


def _matched(like: Array, dims: dict) -> list:
    """Placements that shard dimension ``dims[d]`` wherever ``like``'s
    shard its dimension d, and replicate everywhere else."""
    from torch.distributed.tensor import Replicate, Shard

    return [Shard(dims[p.dim]) if isinstance(p, Shard) and p.dim in dims else Replicate()
            for p in like.placements]


def reduce_over(t: torch.Tensor, m, axes, op: str = "sum") -> torch.Tensor:
    """Plain tensor ``t`` (each rank's part) reduced (``op`` "sum" or
    "max") over the mesh dimensions ``axes`` of ``m``: one functional
    all-reduce a dimension of size > 1, so the dry run's counter sees each."""
    from torch.distributed import _functional_collectives as funcol

    for i in axes:
        if m.size(i) > 1:
            t = funcol.wait_tensor(funcol.all_reduce(t, op, (m, i)))
    return t


def wrap_like(t: torch.Tensor, like: Array, dims: dict, shape) -> Array:
    """Plain tensor ``t``, this rank's part of a tensor of global ``shape``,
    as a DTensor on ``like``'s mesh, sharded as :func:`local_as` lays one
    out (``dims`` as there)."""
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(t, like.device_mesh, _matched(like, dims), run_check=False,
                              shape=torch.Size(shape), stride=_global_stride(t, shape))


def from_replica(t: torch.Tensor, m):
    """A plain tensor that is the same on every rank as a replicated DTensor."""
    from torch.distributed.tensor import DTensor, Replicate

    return DTensor.from_local(t, m, [Replicate()] * m.ndim, run_check=False)


def _placements_of(x, m) -> tuple:
    if not is_dtensor(x):
        raise TypeError(f"a sharding hint under mesh {m} got a plain {type(x).__name__} of "
                        f"shape {tuple(x.shape)}: the activation would not be laid out")
    return x.placements


def act_spec(*axes) -> PartitionSpec:
    """The spec :func:`act` constrains to: 'batch' expands to the DP axes."""
    return P(*(batch_axes() if a == "batch" else a for a in axes))


def act(x: Array, *axes) -> Array:
    """Constrain an activation; 'batch' expands to the DP axes."""
    return constrain(x, act_spec(*axes))


def act_vocab_spec(shape) -> PartitionSpec | None:
    """:func:`act_vocab`'s spec for logits of ``shape``, None without a mesh."""
    m = current_mesh()
    if m is None:
        return None
    nd = len(shape)
    if "model" in axis_names(m) and shape[-1] % axis_sizes(m)["model"] == 0:
        return act_spec("batch", *([None] * (nd - 2)), "model")
    return act_spec("batch", *([None] * (nd - 1)))


def act_vocab(x: Array) -> Array:
    """Constrain logits (B, L, V): vocab on "model" only when divisible
    (several assigned vocabs - 49155/50280/51866/92544 - are not)."""
    return constrain(x, act_vocab_spec(tuple(x.shape)))


def act_seq_spec(shape, seq_axis: int = 1) -> PartitionSpec | None:
    """:func:`act_seq`'s spec for an activation of ``shape``, None without a
    mesh or without a "model" axis."""
    m = current_mesh()
    if m is None or "model" not in axis_names(m):
        return None
    nd = len(shape)
    if shape[seq_axis] % axis_sizes(m)["model"] != 0:
        return act_spec("batch", *([None] * (nd - 1)))
    spec = ["batch"] + [None] * (nd - 1)
    spec[seq_axis] = "model"
    return act_spec(*spec)


def act_seq(x: Array, seq_axis: int = 1) -> Array:
    """Sequence-parallel constraint for inter-layer activations
    (B, L, d): batch over DP, sequence over "model". Cuts the per-layer
    remat carry by the TP degree; attention re-gathers K/V internally.
    Replicated over "model" when L doesn't divide it."""
    return constrain(x, act_seq_spec(tuple(x.shape), seq_axis))


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def on_replicas(fn, *args):
    """``fn(*args)``; under a mesh, with every DTensor among ``args``
    (nested in dicts and tuples too) brought whole to each rank
    (``Replicate()`` on every mesh axis) and handed to ``fn`` as its local
    tensor, and every tensor ``fn`` returns made a replicated DTensor
    again. For the steps DTensor has no sharding rule for, or that must
    see every row at once (the MoE's sort, scatter and capacity drops):
    each rank computes the same whole result, so a gradient that flows
    back through it is whole (replicated) on every rank too. Such a step
    is not split at all: every rank does the whole batch's work."""
    m = current_mesh()
    if m is None:
        return fn(*args)
    from torch.distributed.tensor import DTensor, Replicate

    rep = [Replicate()] * m.ndim

    def local(t):
        if isinstance(t, DTensor):
            return t.redistribute(m, rep).to_local()
        return t

    def wrap(t):
        if isinstance(t, torch.Tensor) and not isinstance(t, DTensor):
            return DTensor.from_local(t, m, rep, run_check=False)
        return t

    return tree_map(wrap, fn(*tree_map(local, args)))


def _global_stride(local: torch.Tensor, shape) -> tuple:
    """Dense strides of ``shape`` in the order of ``local``'s strides."""
    order = sorted(range(local.dim()), key=lambda d: (-local.stride(d), d))
    stride, acc = [0] * len(shape), 1
    for d in reversed(order):
        stride[d] = acc
        acc *= shape[d]
    return tuple(stride)


def on_local(fn, args: tuple, specs: tuple, out_specs: tuple, out_shapes: tuple,
             partial: dict | None = None):
    """``fn(*args)``; under a mesh, on each rank's own part: each DTensor
    ``args[i]`` laid out by ``specs[i]`` (axes as :func:`act` takes them;
    ``()`` whole on every rank) and handed to ``fn`` as its local tensor;
    ``partial[i]`` names the axes (as ``specs``) over which ``args[i]``'s
    gradient is each rank's part, summed over them (the axes along which a
    rank computes only some of the rows or heads that read it); ``fn``'s
    output tensors become DTensors laid out by ``out_specs`` with global
    shapes ``out_shapes``. For the steps DTensor (torch 2.11) has no rule
    for, or that it would not split as JAX does: the embedding's gather
    and MLA's attention by heads, mamba2's conv and SSD by rows, the
    column-parallel products (:func:`column_parallel`). Each rank runs the
    unsharded ops on its rows or heads, so each row or head comes out as
    it does without a mesh. A plain tensor among ``args`` must be one
    whole on every rank (spec ``()``)."""
    m = current_mesh()
    if m is None:
        return fn(*args)
    from torch.distributed.tensor import DTensor, Partial

    partial = partial or {}
    names = axis_names(m)
    local = []
    for i, (a, spec) in enumerate(zip(args, specs)):
        if not is_dtensor(a):
            if any(e is not None for e in fix_spec(m, act_spec(*spec))):
                raise TypeError(f"on_local under mesh {m} got a plain {type(a).__name__} of "
                                f"shape {tuple(a.shape)} for spec {spec}: its rank's part "
                                "is unknown")
            local.append(a)
            continue
        a = redistribute_to(a, m, placements(m, act_spec(*spec), a.dim()))
        axes = [names.index(n) for e in act_spec(*partial.get(i, ())) if e is not None
                for n in (e if isinstance(e, tuple) else (e,)) if n in names]
        grad = [Partial() if j in axes and m.size(j) > 1 else p
                for j, p in enumerate(a.placements)]
        local.append(a.to_local(grad_placements=grad))
    outs = fn(*local)
    single = isinstance(outs, torch.Tensor)
    outs = (outs,) if single else outs
    wrapped = tuple(DTensor.from_local(t, m, placements(m, act_spec(*spec), t.dim()),
                                       shape=torch.Size(shape),
                                       stride=_global_stride(t, shape))
                    for t, spec, shape in zip(outs, out_specs, out_shapes))
    return wrapped[0] if single else wrapped


# --------------------------------------------------------------------------
# Parameter sharding rules: regex on the param path (JAX's table).
# --------------------------------------------------------------------------
# Order matters: first match wins. Written for (pod?, data, model) meshes.
# fsdp=True additionally shards the non-TP dim over "data" (ZeRO-3).
_RULES: list[tuple[str, tuple | None]] = [
    # embeddings / unembedding: vocab dim on model (TP), d_model on data (FSDP)
    (r".*embed.*", ("model", "fsdp")),
    (r".*unembed.*|.*lm_head.*", ("fsdp", "model")),
    # attention: q/k/v column-parallel, o row-parallel
    (r".*\.(wq|wk|wv|wkv_a|wq_a|wq_b|wkv_b|w_patch).*", ("fsdp", "model")),
    (r".*\.wo.*", ("model", "fsdp")),
    # mlp: up/gate column-parallel, down row-parallel
    (r".*\.(w_up|w_gate).*", ("fsdp", "model")),
    (r".*\.w_down.*", ("model", "fsdp")),
    # MoE experts: expert axis over model (EP); expert mats unsharded inside
    (r".*experts.*\.(w_up|w_gate)$", ("model", "fsdp", None)),
    (r".*experts.*\.w_down$", ("model", None, "fsdp")),
    (r".*router.*", ("fsdp", None)),
    # mamba2 / ssm: big in/out projections column/row parallel
    (r".*\.in_proj.*", ("fsdp", "model")),
    (r".*\.out_proj.*", ("model", "fsdp")),
    (r".*\.conv_w.*", (None, None, None)),
    # norms, biases, scalars: replicated
    (r".*(norm|bias|scale|a_log|dt_bias|d_skip).*", None),
]


def spec_for(path: str, shape: tuple, *, fsdp: bool) -> PartitionSpec:
    """PartitionSpec for a parameter path. Layer-stacked params (leading
    scan dim) get a None prepended by the caller."""
    for pat, axes in _RULES:
        if re.fullmatch(pat, path):
            if axes is None:
                return P()
            out = []
            for a in axes[:len(shape)]:
                out.append(("data" if fsdp else None) if a == "fsdp" else a)
            out += [None] * (len(shape) - len(out))
            return P(*out)
    return P()  # default: replicated


def tree_specs(params: dict, *, fsdp: bool, stacked_prefixes=("layers",)) -> dict:
    """PartitionSpec tree matching a params dict (leaves: anything with a
    ``shape``). Params under a ``layers`` subtree are stacked: their
    leading dim is the layer index -> None prepended to the spec."""

    def rec(tree, prefix=""):
        if isinstance(tree, dict):
            return {k: rec(v, f"{prefix}.{k}" if prefix else k) for k, v in tree.items()}
        stacked = any(prefix.startswith(p + ".") or ("." + p + ".") in prefix
                      for p in stacked_prefixes)
        shape = tuple(tree.shape)
        if stacked:
            return P(None, *spec_for(prefix, shape[1:], fsdp=fsdp))
        return spec_for(prefix, shape, fsdp=fsdp)

    return rec(params)


class NamedSharding:
    """JAX's ``NamedSharding``: a mesh (``DeviceMesh`` or
    :class:`AbstractMesh`) and a :class:`PartitionSpec`;
    :meth:`placements` gives its DTensor view for a tensor of rank
    ``ndim``."""

    def __init__(self, mesh, spec: PartitionSpec):
        self.mesh, self.spec = mesh, P(*spec)

    def placements(self, ndim: int | None = None) -> list:
        return placements(self.mesh, self.spec, ndim)

    def __eq__(self, other):
        return (isinstance(other, NamedSharding) and self.mesh is other.mesh
                and self.spec == other.spec)

    def __hash__(self):
        return hash((id(self.mesh), self.spec))

    def __repr__(self):
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"


def _divisible_spec(mesh, spec, shape) -> PartitionSpec:
    """``tree_shardings``' ``fix_spec``: axes the mesh lacks dropped, and an
    entry whose axes do not divide its dimension replicated (GSPMD would
    pad; JAX prefers clean replication, e.g. kv heads < the model axis)."""
    names, sizes = axis_names(mesh), axis_sizes(mesh)
    out = []
    for dim, entry in zip(shape, tuple(spec) + (None,) * 99):
        if entry is None:
            out.append(None)
            continue
        kept = tuple(n for n in (entry if isinstance(entry, tuple) else (entry,)) if n in names)
        size = math.prod(sizes[n] for n in kept)
        if kept and size and dim % size == 0:
            out.append(kept if len(kept) > 1 else kept[0])
        else:
            out.append(None)
    return P(*out)


def tree_shardings(params: dict, mesh, *, fsdp: bool) -> dict:
    """{path: NamedSharding} tree of ``params`` (tensors or anything with a
    ``shape``) on ``mesh``: :func:`tree_specs` with non-dividing axes
    replicated."""
    specs = tree_specs(params, fsdp=fsdp)

    def rec(spec_tree, leaf_tree):
        if isinstance(leaf_tree, dict):
            return {k: rec(spec_tree[k], v) for k, v in leaf_tree.items()}
        return NamedSharding(mesh, _divisible_spec(mesh, spec_tree, tuple(leaf_tree.shape)))

    return rec(specs, params)
