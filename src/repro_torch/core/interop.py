"""Plain numpy interchange of the port's states and search results.

Keys are the JAX package's field paths (``xn``, ``rc.cell_xy``,
``rc.rel``, ``fluid.v``, ``fluid.rho``, ``fluid.m``, ``fixed``, ``t``,
``kind``, ``v_wall``), so a state built by either package can start the
other: ``rc.rel`` travels as its storage dtype (fp16 bits unchanged),
integers and flags keep their width. Optional fields may be absent.

The NNPS path's inputs and outputs travel the same way, keyed by their
JAX field names (:func:`fields_to_numpy` / :func:`fields_from_numpy`):
``RCLLState`` (cell_xy, rel), ``CellBinning`` (table, counts, cell_id,
cell_xy, order, overflow) and ``NeighborList`` (idx, mask, count, trunc).

The persistent carry travels the same way (:func:`carry_to_numpy` /
:func:`carry_from_numpy`): a ``PersistentCarry`` of numpy leaves, the
health guard's host snapshot and the tree a ``CheckpointManager`` of
either package writes, under the same paths (``st/fluid/v``,
``binning/counts``, ...). The step counters travel as int32 0-d arrays,
as JAX keeps them; JAX's uint32 ``flags`` come back as the port's int32.
A stacked carry (``core/ensemble.py``: every tensor with a leading lane
axis B, the counters host ``np.int64`` (B,) vectors) travels the same
way, its counters as int32 (B,) arrays.
``FaultSpec`` and ``GuardPolicy`` travel as their field dicts
(``dataclasses.asdict``), which the port's constructors take as they
are: ``health.FaultSpec(**fields)``, ``recovery.GuardPolicy(**fields)``.

The LM substrate's parameters and caches travel the same way:
:func:`lm_params_from_numpy` takes JAX's parameter paths of every family
(``embed_tokens.embed``, ``layers.attn.wq`` stacked (n_layers, ...),
``layers.moe.experts.w_up``, ``enc_layers.*``, ``shared_attn.*``,
``w_patch``, ``final_norm.norm_w``), and :func:`kv_cache_from_numpy` /
:func:`kv_cache_to_numpy` a ``DenseKVCache``, ``AnchoredKVCache``,
``MLACache`` or ``Mamba2Cache`` keyed by field name, and the nested
``HybridCache`` and ``EncDecCache`` by dotted field path
(``mamba.state``, ``shared.k``, ``self_kv.length``, ``enc_out``), in
JAX's layout, every array in its own dtype (int8/fp16 residual bits
unchanged; bf16 exactly, as fp32 on the numpy side).
:func:`lm_params_to_numpy` is the way back, and :func:`opt_state_from_numpy`
/ :func:`opt_state_to_numpy` carry AdamW's ``OptState`` (``step``,
``mu.<path>``, ``nu.<path>``) between the packages' trainers.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import cells, nnps, rcll, sph
from repro_torch.core.solver import PersistentCarry, SPHState
from repro_torch.models import attention, encdec, hybrid, mamba2
from repro_torch.optim import adamw

_DTYPES = {
    "xn": torch.float32,
    "rc.cell_xy": torch.int32,
    "fluid.v": torch.float32,
    "fluid.rho": torch.float32,
    "fluid.m": torch.float32,
    "fixed": torch.bool,
    "t": torch.float32,
    "kind": torch.int8,
    "v_wall": torch.float32,
}


def _tensor(fields: dict, key: str, device) -> torch.Tensor:
    arr = np.asarray(fields[key])
    if key == "rc.rel":
        if arr.dtype not in (np.float16, np.float32):
            raise ValueError(f"rc.rel must be float16 or float32, got {arr.dtype}")
        return torch.from_numpy(np.ascontiguousarray(arr)).to(device)
    return torch.as_tensor(arr).to(device=device, dtype=_DTYPES[key])


def state_from_numpy(fields: dict[str, np.ndarray], device) -> SPHState:
    """An SPHState on ``device`` from numpy arrays keyed by JAX field path."""
    opt = {k: _tensor(fields, k, device) if fields.get(k) is not None else None
           for k in ("kind", "v_wall")}
    return SPHState(
        xn=_tensor(fields, "xn", device),
        rc=rcll.RCLLState(cell_xy=_tensor(fields, "rc.cell_xy", device),
                          rel=_tensor(fields, "rc.rel", device)),
        fluid=sph.FluidState(v=_tensor(fields, "fluid.v", device),
                             rho=_tensor(fields, "fluid.rho", device),
                             m=_tensor(fields, "fluid.m", device)),
        fixed=_tensor(fields, "fixed", device),
        t=_tensor(fields, "t", device).reshape(()),
        kind=opt["kind"],
        v_wall=opt["v_wall"],
    )


def state_to_numpy(state: SPHState) -> dict[str, np.ndarray]:
    """Numpy arrays keyed by JAX field path (absent optional fields skipped)."""
    out = {
        "xn": state.xn,
        "rc.cell_xy": state.rc.cell_xy,
        "rc.rel": state.rc.rel,
        "fluid.v": state.fluid.v,
        "fluid.rho": state.fluid.rho,
        "fluid.m": state.fluid.m,
        "fixed": state.fixed,
        "t": state.t,
        "kind": state.kind,
        "v_wall": state.v_wall,
    }
    return {k: v.detach().cpu().numpy() for k, v in out.items() if v is not None}


#: Field dtypes per NamedTuple; None keeps a float field's storage dtype.
_FIELDS = {
    rcll.RCLLState: {"cell_xy": torch.int32, "rel": None},
    cells.CellBinning: dict.fromkeys(cells.CellBinning._fields, torch.int32),
    nnps.NeighborList: {"idx": torch.int32, "mask": torch.bool, "count": torch.int32,
                        "trunc": torch.bool},
}


def _float_tensor(arr: np.ndarray, device) -> torch.Tensor:
    if arr.dtype.name == "bfloat16":  # JAX's bf16 arrays; widening to fp32 is exact
        return torch.from_numpy(arr.astype(np.float32)).to(device, torch.bfloat16)
    if arr.dtype not in (np.float16, np.float32, np.float64):
        raise ValueError(f"expected a float array, got {arr.dtype}")
    return torch.tensor(arr, device=device)


def fields_from_numpy(cls: type, fields: dict, device) -> NamedTuple:
    """An ``RCLLState``, ``CellBinning`` or ``NeighborList`` on ``device``
    from numpy arrays keyed by field name (``trunc`` may be absent)."""
    out = {}
    for key, dtype in _FIELDS[cls].items():
        if fields.get(key) is None:
            continue
        arr = np.asarray(fields[key])
        out[key] = (_float_tensor(arr, device) if dtype is None
                    else torch.tensor(arr, device=device).to(dtype))
    return cls(**out)


def _host(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def fields_to_numpy(value: NamedTuple) -> dict[str, np.ndarray]:
    """Numpy arrays keyed by field name (None fields skipped; bf16 as fp32)."""
    return {key: _host(t) for key, t in value._asdict().items() if t is not None}


def _array_tensor(arr: np.ndarray, device) -> torch.Tensor:
    """A tensor of the array's own dtype (JAX's bf16 arrays exactly)."""
    if arr.dtype.name == "bfloat16":
        return _float_tensor(arr, device)
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


def lm_params_from_numpy(tree: dict[str, np.ndarray], device) -> dict:
    """The port's LM parameters (``models.transformer``'s nested dict) on
    ``device`` from numpy arrays keyed by JAX parameter path."""
    out: dict = {}
    for path, arr in tree.items():
        *parents, leaf = path.split(".")
        node = out
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = _array_tensor(np.asarray(arr), device)
    return out


def lm_params_to_numpy(params: dict, prefix: str = "") -> dict[str, np.ndarray]:
    """The port's LM parameters as host numpy arrays keyed by JAX parameter
    path (``lm_params_from_numpy``'s keys), bf16 as fp32, each a copy."""
    out = {}
    for key, value in params.items():
        if isinstance(value, dict):
            out.update(lm_params_to_numpy(value, f"{prefix}{key}."))
        else:
            out[prefix + key] = np.array(_host(value.detach()))
    return out


def opt_state_from_numpy(tree: dict[str, np.ndarray], device):
    """An ``optim.adamw.OptState`` on ``device`` from numpy arrays keyed
    ``step`` (int32 0-d) and ``mu.<path>`` / ``nu.<path>`` by JAX
    parameter path (JAX's ``OptState(step, mu, nu)`` flattened), so both
    packages can start from one optimizer state. Every array is copied:
    ``adamw.apply_updates`` updates the moments in place."""
    def moments(prefix):
        return lm_params_from_numpy({k[3:]: np.array(v) for k, v in tree.items()
                                     if k.startswith(prefix)}, device)

    return adamw.OptState(
        step=torch.tensor(np.asarray(tree["step"]).astype(np.int32), device=device),
        mu=moments("mu."), nu=moments("nu."))


def opt_state_to_numpy(state) -> dict[str, np.ndarray]:
    """:func:`opt_state_from_numpy`'s arrays of an ``OptState``, each a copy."""
    out = {"step": np.asarray(_host(state.step), dtype=np.int32)}
    out.update(lm_params_to_numpy(state.mu, "mu."))
    out.update(lm_params_to_numpy(state.nu, "nu."))
    return out


#: The cache classes a nested cache's fields hold, by field name.
_NESTED = {
    hybrid.HybridCache: {"mamba": mamba2.Mamba2Cache, "shared": attention.DenseKVCache},
    encdec.EncDecCache: {"self_kv": attention.DenseKVCache},
}


def kv_cache_from_numpy(cls: type, fields: dict, device, prefix: str = "") -> NamedTuple:
    """A cache of class ``cls`` on ``device`` from numpy arrays keyed by
    field name (dotted field path for a nested cache), stacked
    (n_layers, ...) or not."""
    nested = _NESTED.get(cls, {})
    return cls(**{
        key: (kv_cache_from_numpy(nested[key], fields, device, f"{prefix}{key}.")
              if key in nested else _array_tensor(np.asarray(fields[prefix + key]), device))
        for key in cls._fields})


def kv_cache_to_numpy(cache: NamedTuple, prefix: str = "") -> dict[str, np.ndarray]:
    """Numpy arrays keyed by field name, or dotted field path in a nested
    cache (bf16 as fp32, exactly), each a copy that owns its memory (the
    port's decode steps update a cache in place)."""
    out = {}
    for key, value in cache._asdict().items():
        if isinstance(value, tuple):
            out.update(kv_cache_to_numpy(value, f"{prefix}{key}."))
        else:
            out[prefix + key] = np.array(_host(value))
    return out


def _map_leaves(tree, fn):
    """``fn`` over the leaves of a tree of NamedTuples (None kept)."""
    if tree is None:
        return None
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_leaves(v, fn) for v in tree))
    return fn(tree)


#: The carry's host-int fields (int32 0-d arrays on the numpy side).
_HOST_INTS = ("rebuilds", "steps")


def carry_to_numpy(carry: PersistentCarry) -> PersistentCarry:
    """A host copy of the carry: every tensor copied to a numpy array
    that owns its memory (never a view of the carry, which the solver
    updates in place), the step counters as int32 arrays (0-d, or (B,)
    for a stacked carry)."""

    def host(t):
        if isinstance(t, torch.Tensor):
            return t.detach().to("cpu", copy=True).numpy()
        return np.asarray(t, dtype=np.int32)

    return _map_leaves(carry, host)


def carry_from_numpy(tree: PersistentCarry, device) -> PersistentCarry:
    """A carry on ``device`` from a ``PersistentCarry`` of numpy leaves
    (:func:`carry_to_numpy`'s, or either package's checkpoint restored
    with one as template). Every tensor is a fresh copy, so the carry
    owns its storage and the tree can restore again. The step counters
    come back as host ints, or as ``np.int64`` (B,) vectors for a
    stacked carry."""
    dev = torch.device(device)
    fields = {}
    for name, value in zip(PersistentCarry._fields, tree):
        if name in _HOST_INTS:
            fields[name] = (int(value) if np.ndim(value) == 0
                            else np.asarray(value).astype(np.int64))
        elif name == "flags" and value is not None:
            fields[name] = torch.tensor(np.asarray(value).astype(np.int32), device=dev)
        else:
            fields[name] = _map_leaves(
                value, lambda a: torch.tensor(np.asarray(a), device=dev))
    return PersistentCarry(**fields)

