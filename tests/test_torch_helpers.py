"""Helpers shared by the port's tests: the one-thread fixture and the
functions that make kernel inputs. Torch only, no JAX:
``test_torch_cuda_kernels.py`` runs where only the port is installed."""
import numpy as np
import pytest
import torch

from repro_torch.core import cells as tcells
from repro_torch.core import domain as td
from repro_torch.core import rcll as trcll
from repro_torch.core import scheme as tsch
from repro_torch.kernels import ops as tops

@pytest.fixture(autouse=True)
def one_torch_thread():
    """Run each port test on one torch thread: the suite runs several
    worker processes at once, and torch's per-op thread pools on tiny
    tensors then spend their time waiting on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


WCSPH = dict(c0=1.25, rho0=1.0, mu=1.0)
DAM = dict(c0=14.142135623730951, rho0=1.0, eos="tait", gamma=7.0,
           viscosity="none", alpha=0.1, delta=0.1, body_force=(0.0, -1.0))


def make_tiles(seed, dim, scheme, records, n=None):
    """CPU tensors for one K2 call (and its keyword arguments) from a
    random cloud advanced by a fraction of a Verlet skin, so some cell
    shifts are non-zero."""
    rng = np.random.default_rng(seed)
    n = n or (700 if dim == 2 else 1500)
    ds = (1.0 / n) ** (1.0 / dim)
    dom = td.Domain(lo=(0.0,) * dim, hi=(1.0,) * dim, h=1.2 * ds,
                    cell_factor=2.0 if dim == 2 else 1.0,
                    periodic=(True,) + (False,) * (dim - 1))
    x = torch.as_tensor(rng.uniform(0, 1, (n, dim)).astype(np.float32))
    cap = tcells.default_capacity(dom, n, safety=8.0)
    ps = trcll.pack_state(dom, trcll.init_state(dom, dom.normalize(x)), cap)
    skin = 0.5 * min(dom.cell_sizes) * 2.0 / dom.h_d
    dxn = torch.as_tensor(rng.uniform(-1, 1, (n, dim)).astype(np.float32)) * (0.2 * skin)
    rc = trcll.advance(dom, ps.rc, dxn)
    b = ps.packing.binning
    rdt = {"fp32": torch.float32, "fp16": torch.float16, "bf16": torch.bfloat16}[records]
    v = torch.as_tensor((rng.normal(size=(n, dim)) * 0.3).astype(np.float32))
    rho = torch.as_tensor((1.0 + 0.01 * rng.normal(size=n)).astype(np.float32))
    m = torch.full((n,), 1.0 / n)
    sch = tsch.Scheme(**scheme)
    tab = lambda f, fill=0.0: tops._typed_row_table(b, f, f.dtype, fill)
    shift = dom.wrap_cell_delta(rc.cell_xy - b.cell_xy).to(torch.int16)
    cm = lambda f: torch.cat([tcells.to_cell_major(b, f).transpose(1, 2),
                              torch.zeros((1, dim, cap), dtype=f.dtype)])
    return dict(
        rel=cm(rc.rel), shift=cm(shift), v=cm(v.to(rdt)), m=tab(m.to(rdt)),
        inv_rho=tab(1.0 / rho, 1.0 / sch.rho0), nb_ids=tops.nb_with_sentinel(dom, "cpu"),
    ), dict(hc_phys=tuple(dom.cell_sizes), h=dom.h, dim=dim, scheme=sch)
