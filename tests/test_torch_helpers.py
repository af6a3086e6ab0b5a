"""Helpers shared by the port's tests: the one-thread fixture and the
functions that make kernel inputs. Torch only, no JAX:
``test_torch_cuda_kernels.py`` runs where only the port is installed."""
import numpy as np
import pytest
import torch

from repro_torch.core import cells as tcells
from repro_torch.core import domain as td
from repro_torch.core import nnps as tnnps
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


STORAGE = {"fp16": torch.float16, "bf16": torch.bfloat16, "fp32": torch.float32}
WCSPH = dict(c0=1.25, rho0=1.0, mu=1.0)
DAM = dict(c0=14.142135623730951, rho0=1.0, eos="tait", gamma=7.0,
           viscosity="none", alpha=0.1, delta=0.1, body_force=(0.0, -1.0))


def make_tiles(seed, dim, scheme, records, n=None, *, rel="fp16", tight_cap=False,
               hole=False, massless=False):
    """CPU tensors for one K2 call (and its keyword arguments, with the
    binning's occupied ``counts``) from a random cloud advanced by a
    fraction of a Verlet skin, so some cell shifts are non-zero. ``rel`` is
    the storage of the relative coordinates; ``tight_cap`` sets the cell
    capacity to the fullest cell's count, so some rows are full; ``hole``
    removes the particles of a central box, so some cells away from the
    sentinel are empty; ``massless`` zeroes the mass of the particle in
    slot 1 of the first row with at least 3 particles and of the particle
    in the last occupied slot of the next row with at least 2."""
    rng = np.random.default_rng(seed)
    n = n or (700 if dim == 2 else 1500)
    ds = (1.0 / n) ** (1.0 / dim)
    dom = td.Domain(lo=(0.0,) * dim, hi=(1.0,) * dim, h=1.2 * ds,
                    cell_factor=2.0 if dim == 2 else 1.0,
                    periodic=(True,) + (False,) * (dim - 1))
    x = torch.as_tensor(rng.uniform(0, 1, (n, dim)).astype(np.float32))
    if hole:
        x = x[((x - 0.5).abs() > 0.2).any(dim=1)]
        n = x.shape[0]
    cap = tcells.default_capacity(dom, n, safety=8.0)
    st = trcll.init_state(dom, dom.normalize(x), STORAGE[rel])
    ps = trcll.pack_state(dom, st, cap)
    if tight_cap:
        cap = int(ps.packing.binning.counts.max())
        ps = trcll.pack_state(dom, st, cap)
    skin = 0.5 * min(dom.cell_sizes) * 2.0 / dom.h_d
    dxn = torch.as_tensor(rng.uniform(-1, 1, (n, dim)).astype(np.float32)) * (0.2 * skin)
    rc = trcll.advance(dom, ps.rc, dxn, dtype=STORAGE[rel])
    b = ps.packing.binning
    rdt = STORAGE[records]
    v = torch.as_tensor((rng.normal(size=(n, dim)) * 0.3).astype(np.float32))
    rho = torch.as_tensor((1.0 + 0.01 * rng.normal(size=n)).astype(np.float32))
    m = torch.full((n,), 1.0 / n)
    if massless:
        for row, slot in massless_slots(b):
            m[b.table[row, slot]] = 0.0
    sch = tsch.Scheme(**scheme)
    tab = lambda f, fill=0.0: tops._typed_row_table(b, f, f.dtype, fill)
    shift = dom.wrap_cell_delta(rc.cell_xy - b.cell_xy).to(torch.int16)
    cm = lambda f: torch.cat([tcells.to_cell_major(b, f).transpose(1, 2),
                              torch.zeros((1, dim, cap), dtype=f.dtype)])
    return dict(
        rel=cm(rc.rel), shift=cm(shift), v=cm(v.to(rdt)), m=tab(m.to(rdt)),
        inv_rho=tab(1.0 / rho, 1.0 / sch.rho0), nb_ids=tops.nb_with_sentinel(dom, "cpu"),
    ), dict(hc_phys=tuple(dom.cell_sizes), h=dom.h, dim=dim, scheme=sch,
            counts=tops.occupied_counts(b))


def massless_slots(b):
    """(row, slot) of the particles ``make_tiles(massless=True)`` makes
    massless: slot 1 of the first row with at least 3 particles (the middle
    of a row) and the last occupied slot of the next row with at least 2."""
    counts = b.counts.clamp(max=b.table.shape[1])
    mid = int(torch.nonzero(counts >= 3)[0])
    last = int(next(r for r in torch.nonzero(counts >= 2)[:, 0].tolist() if r > mid))
    return (mid, 1), (last, int(counts[last]) - 1)


def make_nnps_tiles(seed, dim, n, storage="fp16", periodic=False, cell_factor=1.0):
    """CPU tensors for one K3/K4/K5 call from a random cloud binned by
    ``bin_by_cell_id``: a dict of (rel, f, occ, ids, nb_ids) tables and the
    keyword arguments the kernels share (weights, r_cell, hc_phys, h, dim)."""
    rng = np.random.default_rng(seed)
    ds = (1.0 / n) ** (1.0 / dim)
    dom = td.Domain(lo=(0.0,) * dim, hi=(1.0,) * dim, h=1.2 * ds, cell_factor=cell_factor,
                    periodic=(periodic,) + (False,) * (dim - 1))
    x = torch.as_tensor(rng.uniform(0, 1, (n, dim)).astype(np.float32))
    st = trcll.init_state(dom, dom.normalize(x), STORAGE[storage])
    cap = tcells.default_capacity(dom, n, safety=6.0)
    b = tcells.bin_by_cell_id(dom, dom.flat_cell_id(st.cell_xy), st.cell_xy, cap)
    assert int(b.overflow) == 0
    f = torch.as_tensor((x[:, 0] ** 3).numpy() + rng.normal(size=n).astype(np.float32) * 0.01)
    rel_t, occ, (f_t,) = tops.pack_cells(b, st.rel, f)
    ids = torch.cat([b.table, torch.full((1, cap), -1, dtype=torch.int32)])
    tabs = dict(rel=rel_t, f=f_t, occ=occ, ids=ids, nb_ids=tops.nb_with_sentinel(dom, "cpu"))
    kw = dict(weights=tuple(dom.cell_weights), r_cell=tnnps.rcll_radius_cell_units(dom),
              hc_phys=tuple(dom.cell_sizes), h=dom.h, dim=dim)
    return tabs, kw


def make_lanes(seed, dim, scheme, records, n, lanes=3, massless_lane=1):
    """CPU per-particle inputs of ``ops.rcll_force_lanes``: ``lanes``
    random clouds of ``n`` particles in one domain, each packed at one
    capacity and advanced by a fraction of a Verlet skin (so some cell
    shifts are non-zero), lane ``massless_lane`` with every 97th particle
    massless. Returns (domain, binning, rc, v, m, rho, scheme, records
    dtype), every tensor with a leading lane axis."""
    rng = np.random.default_rng(seed)
    ds = (1.0 / n) ** (1.0 / dim)
    dom = td.Domain(lo=(0.0,) * dim, hi=(1.0,) * dim, h=1.2 * ds, cell_factor=1.5,
                    periodic=(True,) + (False,) * (dim - 1))
    cap = tcells.robust_capacity(dom, ds, n) + 8
    skin_norm = 2.0 * 0.5 * dom.radius / dom.h_d
    parts = []
    for b in range(lanes):
        x = torch.as_tensor(rng.uniform(0, 1, (n, dim)).astype(np.float32))
        ps = trcll.pack_state(dom, trcll.init_state(dom, dom.normalize(x)), cap)
        assert int(ps.packing.binning.overflow) == 0
        step = torch.as_tensor(rng.uniform(-1, 1, (n, dim)).astype(np.float32))
        rc = trcll.advance(dom, ps.rc, step * (0.2 * skin_norm))
        v = torch.as_tensor((0.3 * rng.normal(size=(n, dim))).astype(np.float32))
        rho = torch.as_tensor((1.0 + 0.01 * rng.normal(size=n)).astype(np.float32))
        m = torch.full((n,), ds**dim)
        if b == massless_lane:
            m[::97] = 0.0
        parts.append((ps.packing.binning, rc, v, m, rho))

    def stack(xs):
        if isinstance(xs[0], torch.Tensor):
            return torch.stack(xs)
        return type(xs[0])(*(torch.stack(f) for f in zip(*xs)))

    binning, rc, v, m, rho = (stack(list(col)) for col in zip(*parts))
    return dom, binning, rc, v, m, rho, tsch.Scheme(**scheme), STORAGE[records]
