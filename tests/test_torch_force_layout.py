"""The table layout K2's CUDA kernel relies on (``rcll_force.rcll_force``):
the occupied slots of row c are the prefix ``0 .. min(counts[c], cap) - 1``
given by the binning's ``counts`` (whatever their masses: a massless
particle is occupied), every empty slot of a row holds the same inputs,
and the plain version gives all empty slots of a row bit-identical
outputs. Checked on K2's inputs as ``ops.rcll_force_particles`` builds
them through K1's plain version and as ``make_tiles`` builds them, on
stale binnings with non-zero cell shifts, with and without massless
particles."""
import numpy as np
import pytest
import torch

from repro_torch.core import cells as tcells
from repro_torch.core import rcll as trcll
from repro_torch.core import scheme as tsch
from repro_torch.core.domain import Domain
from repro_torch.kernels import ops as tops
from repro_torch.kernels import rcll_force as trf
from test_torch_helpers import (DAM, STORAGE, WCSPH, make_tiles,  # noqa: F401
                                massless_slots, one_torch_thread)

_BITS = {1: torch.uint8, 2: torch.int16, 4: torch.int32}


def _k1_path_inputs(dim, rel, records, scheme, seed, n, massless=False):
    """K2's arguments captured from ``ops.rcll_force_particles`` on a
    random cloud advanced after its binning (CPU: K1's plain version);
    ``massless`` zeroes the masses at ``massless_slots`` of the binning."""
    rng = np.random.default_rng(seed)
    ds = (1.0 / n) ** (1.0 / dim)
    dom = Domain(lo=(0.0,) * dim, hi=(1.0,) * dim, h=1.2 * ds,
                 cell_factor=1.5 if dim == 2 else 1.0, periodic=(True,) + (False,) * (dim - 1))
    x = torch.as_tensor(rng.uniform(0, 1, (n, dim)).astype(np.float32))
    cap = tcells.default_capacity(dom, n)
    ps = trcll.pack_state(dom, trcll.init_state(dom, dom.normalize(x), STORAGE[rel]), cap)
    step = torch.as_tensor(rng.uniform(-1, 1, (n, dim)).astype(np.float32))
    rc = trcll.advance(dom, ps.rc, step * (0.2 * dom.radius / dom.h_d), dtype=STORAGE[rel])
    v = torch.as_tensor((0.3 * rng.normal(size=(n, dim))).astype(np.float32))
    rho = torch.as_tensor((1.0 + 0.01 * rng.normal(size=n)).astype(np.float32))
    m = torch.full((n,), ds**dim)
    b = ps.packing.binning
    if massless:
        for row, slot in massless_slots(b):
            m[b.table[row, slot]] = 0.0
    seen = []
    force = trf.rcll_force

    def capture(*args, **kw):
        seen.append((args, kw))
        return force(*args, **kw)

    trf.rcll_force = capture
    try:
        tops.rcll_force_particles(dom, b, rc, v, m, rho,
                                  scheme=tsch.Scheme(**scheme), records_dtype=STORAGE[records])
    finally:
        trf.rcll_force = force
    assert int(b.overflow) == 0
    (args, kw), = seen
    return args, kw


def _assert_empty_slots_alike(t: torch.Tensor, occ: torch.Tensor, name: str) -> None:
    """Every empty slot of a row (cap is the last axis of ``t``) holds the
    bits of the row's first empty slot."""
    bits = t.contiguous().view(_BITS[t.element_size()])
    n_occ = occ.sum(dim=1)
    rows = torch.nonzero(n_occ < occ.shape[1]).squeeze(1)
    r = bits[rows]
    first = n_occ[rows].view((-1,) + (1,) * (r.ndim - 1)).expand(r.shape[:-1] + (1,))
    rep = torch.gather(r, -1, first)
    empty = ~occ[rows].view((rows.shape[0],) + (1,) * (r.ndim - 2) + (occ.shape[1],))
    differ = (r != rep) & empty
    assert not bool(differ.any()), f"{name}: empty slots of a row differ"


def _assert_layout(args, kw, massless=False) -> None:
    """The count-based prefix contract on K2's arguments: ``counts`` within
    [0, cap], 0 for the sentinel row; every slot with m != 0 below its
    row's count; the empty slots of a row (at or past the count) alike in
    every input and in the plain version's outputs. Every occupied slot
    has m != 0 but, with ``massless``, exactly two, one of them in the
    middle of a row."""
    rel, shift, v, m, inv_rho, nb_ids = args
    counts = kw["counts"]
    cap = m.shape[1]
    assert counts.dtype == torch.int32 and tuple(counts.shape) == (m.shape[0],)
    assert int(counts.min()) >= 0 and int(counts.max()) <= cap
    assert int(counts[-1]) == 0, "the sentinel row holds particles"
    occ = trf.occupied_slots(m, counts)
    assert not bool(((m != 0) & ~occ).any()), "a particle with mass lies past its row's count"
    n_occ = occ.sum(dim=1)
    assert bool((n_occ < cap).any()) and int(n_occ.sum()) > 0
    massless_occ = occ & (m == 0)
    if massless:
        mid = massless_occ[:, :-1] & occ[:, 1:]  # a massless slot before an occupied one
        assert bool(mid.any()) and int(massless_occ.sum()) == 2
    else:
        assert not bool(massless_occ.any())
    assert bool((shift != 0).any()), "the binning is not stale"
    for name, t in (("rel", rel), ("shift", shift), ("v", v), ("m", m), ("inv_rho", inv_rho)):
        _assert_empty_slots_alike(t, occ, name)
    drho, acc = trf.rcll_force_ref(*args, **kw)
    _assert_empty_slots_alike(drho, occ, "drho")
    _assert_empty_slots_alike(acc, occ, "acc")


CASES = [(2, "fp16", "fp16"), (2, "fp32", "fp32"), (2, "fp16", "bf16"),
         (3, "fp16", "fp16"), (3, "fp32", "fp32"), (3, "fp16", "bf16")]


@pytest.mark.parametrize("dim,rel,records", CASES)
def test_k1_path_tables_have_kernel_layout(dim, rel, records):
    scheme = WCSPH if dim == 2 else dict(DAM, body_force=())
    args, kw = _k1_path_inputs(dim, rel, records, scheme, seed=20 + dim,
                               n=1500 if dim == 2 else 2000)
    assert args[0].dtype == STORAGE[rel]
    _assert_layout(args, kw)


@pytest.mark.parametrize("dim,rel,records", CASES)
def test_make_tiles_tables_have_kernel_layout(dim, rel, records):
    t, kw = make_tiles(30 + dim, dim, DAM if dim == 2 else WCSPH, records, rel=rel)
    assert t["rel"].dtype == STORAGE[rel]
    _assert_layout(tuple(t.values()), kw)


@pytest.mark.parametrize("dim,rel,records", [(2, "fp16", "fp16"), (2, "fp32", "bf16"),
                                             (3, "fp16", "fp32")])
def test_massless_particles_keep_kernel_layout(dim, rel, records):
    """A massless particle in the middle of a row and one in a row's last
    occupied slot stay occupied: the prefix comes from the binning's
    counts, not from m != 0, on K1's path and on make_tiles' tables."""
    scheme = WCSPH if dim == 2 else dict(DAM, body_force=())
    args, kw = _k1_path_inputs(dim, rel, records, scheme, seed=50 + dim,
                               n=1500 if dim == 2 else 2000, massless=True)
    _assert_layout(args, kw, massless=True)
    t, kw = make_tiles(60 + dim, dim, scheme, records, rel=rel, massless=True)
    _assert_layout(tuple(t.values()), kw, massless=True)


@pytest.mark.parametrize("dim", [2, 3])
def test_full_and_empty_rows_keep_kernel_layout(dim):
    """make_tiles' tight capacity and central hole: some rows full (no
    empty slot) and some non-sentinel rows all empty."""
    t, kw = make_tiles(40 + dim, dim, WCSPH, "fp16", n=3000 if dim == 2 else 6000,
                       tight_cap=True, hole=True)
    n_occ = kw["counts"]
    assert int((n_occ == t["m"].shape[1]).sum()) > 0
    assert int((n_occ[:-1] == 0).sum()) > 0
    _assert_layout(tuple(t.values()), kw)
