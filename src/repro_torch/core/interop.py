"""Plain numpy interchange of an ``SPHState``.

Keys are the JAX package's field paths (``xn``, ``rc.cell_xy``,
``rc.rel``, ``fluid.v``, ``fluid.rho``, ``fluid.m``, ``fixed``, ``t``,
``kind``, ``v_wall``), so a state built by either package can start the
other: ``rc.rel`` travels as its storage dtype (fp16 bits unchanged),
integers and flags keep their width. Optional fields may be absent.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import rcll, sph
from repro_torch.core.solver import SPHState

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
