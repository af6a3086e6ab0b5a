"""The dry run's cost counter: what a step computes, moves and holds,
counted over the ops it runs on any device, meta included.

- **FLOPs**: each aten op by ``torch.utils.flop_counter``'s formulas (the
  ``flop_registry`` that ``FlopCounterMode`` reads; ops without a formula
  count 0), plus each hand-written kernel's analytic count. The kernels
  launch through ``ctypes``, which no dispatch mode sees: each wrapper
  runs its kernel (or, on the CPU, its plain version, and on meta its
  shape-only outputs) through :func:`kernel`, which adds the kernel's
  count to the open counter and hides the ops inside from every dispatch
  mode. So a step counts the same on meta, on CPU tensors and on the
  card, and a plain version's own products are never counted beside its
  kernel's formula.
- **Bytes**: each aten op's inputs and outputs, every tensor once an op
  (a broadcast dimension once), views and allocations free; each kernel
  its inputs read once and its outputs written once. This is the eager
  port's own traffic: nothing is fused, so every intermediate goes to
  memory and back.
- **Held**: the bytes of the storages that ops (and kernels) made while
  the counter is open and that are alive: now (:meth:`CostCounter.held_bytes`;
  after a forward, what autograd and the checkpoints keep for the
  backward) and at most at once (:attr:`CostCounter.peak_made_bytes`). A
  storage is followed by a finalizer on its Python object, which torch
  keeps as long as the storage lives, so what a checkpoint keeps (each
  layer's inputs, outside any saved-tensor hook) is counted
  with what autograd saves.

The FLOPs are also split by the operands' dtype (bf16 and fp16 on the
tensor cores, the rest not) for the roofline.
"""
from __future__ import annotations

import gc
import weakref

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode, _disable_current_modes
from torch.utils.flop_counter import flop_registry

_OPEN: list = []  # the counters open now, innermost last
_TENSOR_CORE = (torch.bfloat16, torch.float16)
_ALLOCATIONS = frozenset({"empty", "empty_strided", "new_empty", "new_empty_strided",
                          "empty_like"})


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (tuple, list)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


def tensor_bytes(t: torch.Tensor) -> int:
    """Bytes a pass over ``t`` moves: its elements, a dimension of stride
    0 (a broadcast view) counted once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


def _op_info(func) -> tuple:
    """(FLOP formula or None, returns a view, returns new storage, is an
    allocation) of an aten op, from its schema."""
    aliases = [r.alias_info for r in func._schema.returns if r.alias_info is not None]
    return (flop_registry.get(func._overloadpacket),
            bool(aliases) and not any(a.is_write for a in aliases), not aliases,
            func._schema.name.split("::")[-1] in _ALLOCATIONS)


class CostCounter(TorchDispatchMode):
    """Counts FLOPs, bytes and held storages while open (a context
    manager; counters nest, the innermost gets the kernels' counts).
    Read after it closes: :attr:`flops` (aten + kernels), :attr:`bytes`,
    :attr:`flops_tensor_core` / :attr:`flops_other` (by operand dtype),
    :attr:`kernels` ({name: {"calls", "flops", "bytes"}}) and
    :attr:`peak_made_bytes`; :meth:`held_bytes` while it is open."""

    def __init__(self):
        super().__init__()
        self.aten_flops = 0
        self.aten_bytes = 0
        self.flops_tensor_core = 0
        self.flops_other = 0
        self.kernels: dict = {}
        self.peak_made_bytes = 0
        self._live = 0
        self._made: set = set()
        self._info: dict = {}

    def __enter__(self):
        super().__enter__()
        _OPEN.append(self)
        return self

    def __exit__(self, *exc):
        _OPEN.remove(self)
        return super().__exit__(*exc)

    @property
    def flops(self) -> int:
        return self.aten_flops + sum(k["flops"] for k in self.kernels.values())

    @property
    def bytes(self) -> int:
        return self.aten_bytes + sum(k["bytes"] for k in self.kernels.values())

    def held_bytes(self) -> int:
        """Bytes of the storages made while open that are alive now."""
        gc.collect()
        return self._live

    def _freed(self, key: int, n: int) -> None:
        self._made.discard(key)
        self._live -= n

    def _track(self, out, skip=()) -> None:
        """Follow the storages of ``out`` that are new to the counter."""
        for t in _tensors(out):
            st = t.untyped_storage()
            key = st._cdata
            if key in self._made or key in skip:
                continue
            n = st.nbytes()
            self._made.add(key)
            self._live += n
            weakref.finalize(st, self._freed, key, n)
        self.peak_made_bytes = max(self.peak_made_bytes, self._live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        info = self._info.get(func)
        if info is None:
            info = self._info[func] = _op_info(func)
        flop_fn, view, fresh, alloc = info
        if flop_fn is not None:
            n = flop_fn(*args, **kwargs, out_val=out)
            self.aten_flops += n
            if args[0].dtype in _TENSOR_CORE:
                self.flops_tensor_core += n
            else:
                self.flops_other += n
        if view:
            return out
        if fresh:
            self._track(out)
        if not alloc:
            self.aten_bytes += (sum(tensor_bytes(t) for t in _tensors((args, kwargs)))
                                + sum(tensor_bytes(t) for t in _tensors(out)))
        return out


def kernel(name: str, cost, fn, args: tuple):
    """``fn(*args)``, one call of the hand-written kernel ``name``. Under an
    open :class:`CostCounter`, ``cost(*args)`` gives its (FLOPs, bytes, on
    the tensor cores or not), which the counter adds; the ops ``fn`` runs
    are hidden from every dispatch mode, and the storages it returns that
    are not its inputs' are followed. Otherwise just ``fn(*args)``."""
    if not _OPEN:
        return fn(*args)
    counter = _OPEN[-1]
    with _disable_current_modes():
        out = fn(*args)
        flops, nbytes, tensor_core = cost(*args)
    k = counter.kernels.setdefault(name, {"calls": 0, "flops": 0, "bytes": 0})
    k["calls"] += 1
    k["flops"] += int(flops)
    k["bytes"] += int(nbytes)
    if tensor_core:
        counter.flops_tensor_core += int(flops)
    else:
        counter.flops_other += int(flops)
    counter._track(out, skip={t.untyped_storage()._cdata for t in _tensors(args)})
    return out


def visible_pairs(lq: int, lk: int, causal: bool) -> int:
    """(query, key) pairs attention computes for one (batch, head): all
    Lq x Lk, or with ``causal`` those with key j <= i + (Lk - Lq)."""
    if not causal:
        return lq * lk
    return int(np.clip(np.arange(lq, dtype=np.int64) + (lk - lq) + 1, 0, lk).sum())
