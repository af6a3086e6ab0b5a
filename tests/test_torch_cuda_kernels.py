"""Kernel vs plain version on the card: K1, K4, K5 and the rebuild's
counting-sort pack bit for bit, K2, K3,
K6 and K7 by their ``check_against_plain`` (derived rounding bound and
normwise limit), K7b (K7's gradient) by ``check_bwd_against_plain``, and
planted faults that those checks must catch. Marked
``cuda``: a CUDA kernel has no CPU mode, so these skip without a GPU. The file imports no JAX; on a machine
with the card and without JAX run it as

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_cuda_kernels.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import cells as tcells
from repro_torch.core import domain as td
from repro_torch.core import rcll as trcll
from repro_torch.kernels import cell_pack as tcp
from repro_torch.kernels import cell_sort as tcs
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import nnps_pairwise as tnp
from repro_torch.kernels import rcll_force as trf
from repro_torch.kernels import rcll_kv_attention as tkv
from repro_torch.kernels import sph_gradient as tsg
from repro_torch.core import nnps as tnnps
from repro_torch.core import scheme as tsch
from repro_torch.kernels import ops as tops
from repro_torch.models import attention as tattn
from test_torch_helpers import (DAM, STORAGE, WCSPH, make_lanes, make_nnps_tiles,  # noqa: F401
                                make_tiles, one_torch_thread)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel; no CPU mode)")
    return torch.device("cuda")


def _pack_inputs(n, dim, seed):
    rng = np.random.default_rng(seed)
    ds = (1.0 / n) ** (1.0 / dim)
    dom = td.Domain(lo=(0.0,) * dim, hi=(1.0,) * dim, h=1.2 * ds)
    x = torch.as_tensor(rng.uniform(0, 1, (n, dim)).astype(np.float32))
    cap = tcells.default_capacity(dom, n, safety=6.0)
    ps = trcll.pack_state(dom, trcll.init_state(dom, dom.normalize(x)), cap)
    b = ps.packing.binning
    rows16 = torch.cat([ps.rc.rel.view(torch.int16),
                        torch.as_tensor(rng.integers(-300, 300, (n, 2)).astype(np.int16))], 1)
    rows32 = torch.as_tensor(rng.normal(size=(n, 3)).astype(np.float32))
    fill32 = torch.tensor([1.0, 0.0, -3.5])
    return (rows16, rows32, tcells.exclusive_cumsum(b.counts), b.counts, fill32), cap


@pytest.mark.cuda
@pytest.mark.parametrize("n,dim,seed", [(5000, 2, 0), (3000, 3, 1)])
def test_cell_tables_kernel_bit_identical(cuda_device, n, dim, seed):
    args, cap = _pack_inputs(n, dim, seed)
    args = [a.to(cuda_device) for a in args]
    before = tcp.cell_tables.launches
    out_k = tcp.cell_tables(*args, cap=cap)
    torch.cuda.synchronize()
    assert tcp.cell_tables.launches == before + 1
    out_r = tcp.cell_tables_ref(*args, cap=cap)
    for a, c in zip(out_k, out_r):
        assert a.dtype == c.dtype and a.shape == c.shape
        assert torch.equal(a.view(torch.int32) if a.dtype == torch.float32 else a,
                           c.view(torch.int32) if c.dtype == torch.float32 else c)


def _force_pack_args(monkeypatch, dev, dim, rel, records, seed):
    """K1's arguments as ops.rcll_force_particles builds them on ``dev``
    for a random cloud: rel in fp16 or fp32, fp16 or fp32 records."""
    rng = np.random.default_rng(seed)
    n = 6000 if dim == 2 else 4000
    ds = (1.0 / n) ** (1.0 / dim)
    dom = td.Domain(lo=(0.0,) * dim, hi=(1.0,) * dim, h=1.2 * ds, cell_factor=1.5,
                    periodic=(True,) + (False,) * (dim - 1))
    x = torch.as_tensor(rng.uniform(0, 1, (n, dim)).astype(np.float32), device=dev)
    cap = tcells.robust_capacity(dom, ds, n) + 8
    ps = trcll.pack_state(dom, trcll.init_state(dom, dom.normalize(x), STORAGE[rel]), cap)
    v = torch.as_tensor((0.3 * rng.normal(size=(n, dim))).astype(np.float32), device=dev)
    rho = torch.as_tensor((1.0 + 0.01 * rng.normal(size=n)).astype(np.float32), device=dev)
    m = torch.full((n,), ds**dim, device=dev)
    seen, orig = [], tcp.cell_tables

    def capture(*a, **kw):
        seen.append((a, kw))
        return orig(*a, **kw)

    monkeypatch.setattr(tcp, "cell_tables", capture)
    tops.rcll_force_particles(dom, ps.packing.binning, ps.rc, v, m, rho,
                              scheme=tsch.Scheme(**WCSPH), records_dtype=STORAGE[records])
    monkeypatch.undo()
    return seen[0]


@pytest.mark.cuda
@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("rel,records", [("fp16", "fp16"), ("fp32", "fp32"), ("fp16", "fp32"),
                                         ("fp32", "fp16")])
def test_cell_tables_kernel_force_layouts_bit_identical(cuda_device, monkeypatch, dim, rel,
                                                        records):
    """The four slab layouts ops.rcll_force_particles builds, 2-D and 3-D."""
    args, kw = _force_pack_args(monkeypatch, cuda_device, dim, rel, records, seed=40 + dim)
    f16, f32 = args[0].shape[1], args[1].shape[1]
    assert (f16, f32) == {("fp16", "fp16"): (3 * dim, 1), ("fp32", "fp32"): (dim, 1 + 2 * dim),
                          ("fp16", "fp32"): (2 * dim, 1 + dim),
                          ("fp32", "fp16"): (2 * dim, 1 + dim)}[(rel, records)]
    before = tcp.cell_tables.launches
    tcp.check_against_plain(args, kw)
    assert tcp.cell_tables.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("f16,f32,cap,offset", [
    (1, 9, 1, 0), (2, 8, 20, 1), (3, 7, 64, 0), (4, 6, 1, 1), (5, 5, 20, 0),
    (6, 1, 20, 1), (7, 3, 64, 1), (8, 2, 1, 0), (9, 9, 64, 1), (9, 1, 20, 0),
    (3, 30, 1024, 1),  # one cell's tables past the shared-memory tiles: the direct path
])
def test_cell_tables_kernel_widths_bit_identical(cuda_device, f16, f32, cap, offset):
    """Slab widths 1 to 9, cap 1, 20 and 64, cell-sorted rows: a run of cells
    at cap next to a run of empty cells, overflowed cells, the last cells
    full so the last one ends at row N; ``offset`` 1: both slabs are views
    one row into a larger tensor, so neither starts 16-byte aligned."""
    rng = np.random.default_rng(100 * f16 + 10 * f32 + cap)
    c_total = 3000 if cap < 1024 else 300
    counts = rng.poisson(0.3 * cap + 0.5, c_total)
    counts[500:700] = cap
    counts[700:900] = 0
    counts[1000:1010] = cap + 2
    counts[-5:] = cap
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    n = int(counts.sum())
    dev = cuda_device
    rows16 = torch.as_tensor(rng.integers(-2**15, 2**15, (n + offset, f16)).astype(np.int16),
                             device=dev)[offset:]
    rows32 = torch.as_tensor(rng.normal(size=(n + offset, f32)).astype(np.float32),
                             device=dev)[offset:]
    fill32 = torch.as_tensor(rng.normal(size=f32).astype(np.float32), device=dev)
    as_i32 = lambda a: torch.as_tensor(a.astype(np.int32), device=dev)
    args = (rows16, rows32, as_i32(starts), as_i32(counts), fill32)
    assert (rows16.data_ptr() % 16 != 0) == bool(offset)
    tcp.check_against_plain(args, dict(cap=cap))


@pytest.mark.cuda
@pytest.mark.parametrize("fault", tcp.FAULTS)
def test_cell_tables_check_fails_a_planted_fault(cuda_device, monkeypatch, fault):
    """The bit-for-bit check catches a wrong K1: the last occupied slot of
    each cell left empty, or empty fp32 slots filled with 0."""
    args, cap = _pack_inputs(5000, 2, 0)
    args = tuple(a.to(cuda_device) for a in args)
    tcp.check_against_plain(args, dict(cap=cap))
    monkeypatch.setattr(tcp, "kernel_params", tcp.planted_params(fault))
    with pytest.raises(AssertionError, match="disagrees"):
        tcp.check_against_plain(args, dict(cap=cap))


#: The rebuild's counting-sort pack: (domain, N, capacity or None for a
#: roomy one). A tenth of the particles start in the cells at the low edge
#: of each axis and move down by 0.9 of a cell: across the periodic seam,
#: or pinned at a wall.
SORT_CASES = {
    "2d_periodic_seam": (dict(lo=(0.0, 0.0), hi=(1.0, 1.0), h=0.03, periodic=(True, True)),
                         3000, None),
    "2d_walls_clamped": (dict(lo=(-0.15, -0.15), hi=(2.15, 1.3), h=0.06, cell_factor=1.5),
                         3000, None),
    "3d": (dict(lo=(0.0,) * 3, hi=(1.0,) * 3, h=0.05, periodic=(True, False, True)), 3000, None),
    "empty_and_over_cap": (dict(lo=(0.0, 0.0), hi=(2.0, 1.0), h=0.02, periodic=(True, False)),
                           1500, 3),
    "n0": (dict(lo=(0.0, 0.0), hi=(1.0, 1.0), h=0.05, periodic=(True, True)), 0, None),
    "n1": (dict(lo=(0.0, 0.0), hi=(1.0, 1.0), h=0.05, periodic=(True, False)), 1, None),
}


def _sort_inputs(dev, case, seed=0, far=False):
    """A packed cloud advanced by under a cell (or one particle by three
    cells, ``far``): (domain, advanced state, capacity, previous binning)."""
    spec, n, cap = SORT_CASES[case]
    rng = np.random.default_rng(seed)
    dom = td.Domain(**spec)
    lo, hi = np.asarray(spec["lo"]), np.asarray(spec["hi"])
    u = rng.uniform(0, 1, (n, dom.dim))
    u[: n // 10] *= 0.02
    x = torch.as_tensor((lo + u * (hi - lo)).astype(np.float32), device=dev)
    cap = cap or tcells.default_capacity(dom, max(n, 1), safety=6.0)
    ps = trcll.pack_state(dom, trcll.init_state(dom, dom.normalize(x)), cap)
    dxn = rng.uniform(-0.9, 0.9, (n, dom.dim)) * dom.hc_ref
    dxn[ps.rc.cell_xy.cpu().numpy() == 0] = -0.9 * dom.hc_ref
    if far:
        dxn[n // 2, 0] = 3.5 * dom.hc_ref
    at = trcll.advance(dom, ps.rc, torch.as_tensor(dxn.astype(np.float32), device=dev))
    return dom, at, cap, ps.packing.binning


def _assert_sort_is_stable_argsort(dom, at, packing):
    cid = dom.flat_cell_id(at.cell_xy)
    assert torch.equal(packing.order, torch.argsort(cid, stable=True).to(torch.int32))
    assert torch.equal(packing.inverse, tcells._argsort_positions(cid))


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(SORT_CASES))
def test_cell_sort_pack_bit_identical(cuda_device, case):
    """Every output of the pack against the plain path and the stable
    argsort, with the preconditions of each case shown to hold."""
    dom, at, cap, prev = _sort_inputs(cuda_device, case)
    n = at.cell_xy.shape[0]
    delta = (at.cell_xy - prev.cell_xy).cpu()
    if case == "2d_periodic_seam":
        assert int((delta.abs() == dom.ncells[0] - 1).sum()) > 10  # crossed the seam
    if case == "2d_walls_clamped":
        assert int((at.rel == -1.0).sum()) > 10  # pinned at the wall
    launches, fallbacks = tcs.repack.launches, tcs.repack.fallbacks
    tcs.check_against_plain(dom, at.cell_xy, at.rel, cap, prev)
    torch.cuda.synchronize()
    assert (tcs.repack.launches, tcs.repack.fallbacks) == (launches + 1, fallbacks)
    packing, _ = tcs.repack(dom, at.cell_xy, at.rel, cap, prev)
    _assert_sort_is_stable_argsort(dom, at, packing)
    counts = packing.binning.counts
    assert int(counts.sum()) == n
    if case == "empty_and_over_cap":
        assert int(packing.binning.overflow) > 0 and int((counts == 0).sum()) > 0


@pytest.mark.cuda
def test_cell_sort_far_mover_takes_the_oracle(cuda_device):
    """A particle three cells away: the argsort oracle runs, counted as a
    fallback and not as a pack, with the plain path's outputs."""
    dom, at, cap, prev = _sort_inputs(cuda_device, "2d_walls_clamped", far=True)
    launches, fallbacks = tcs.repack.launches, tcs.repack.fallbacks
    tcs.check_against_plain(dom, at.cell_xy, at.rel, cap, prev)
    assert (tcs.repack.launches, tcs.repack.fallbacks) == (launches, fallbacks + 1)


@pytest.mark.cuda
def test_cell_sort_pack_is_deterministic(cuda_device):
    dom, at, cap, prev = _sort_inputs(cuda_device, "3d", seed=4)
    one = tcs.outputs(*tcs.repack(dom, at.cell_xy, at.rel, cap, prev))
    two = tcs.outputs(*tcs.repack(dom, at.cell_xy, at.rel, cap, prev))
    for name, a in one.items():
        assert torch.equal(tcs._bits(a), tcs._bits(two[name])), name


@pytest.mark.cuda
@pytest.mark.parametrize("fault", tcs.FAULTS)
def test_cell_sort_check_fails_a_planted_fault(cuda_device, monkeypatch, fault):
    """The bit-for-bit check catches a wrong pack: each run walked
    backwards, or the sources left in offset order across the seam."""
    dom, at, cap, prev = _sort_inputs(cuda_device, "2d_periodic_seam", seed=2)
    tcs.check_against_plain(dom, at.cell_xy, at.rel, cap, prev)
    monkeypatch.setattr(tcs, "kernel_params", tcs.planted_params(fault))
    with pytest.raises(AssertionError, match="disagrees"):
        tcs.check_against_plain(dom, at.cell_xy, at.rel, cap, prev)


@pytest.mark.parametrize("case", list(SORT_CASES))
def test_cell_sort_cpu_tensors_take_the_plain_path(monkeypatch, case):
    """On the CPU ``rcll.pack_state`` with ``prev`` runs the plain version:
    no kernel is loaded or counted, and the permutation is the stable
    argsort's."""
    monkeypatch.setattr(tcs, "_entries", lambda: pytest.fail("kernel library loaded"))
    dom, at, cap, prev = _sort_inputs(torch.device("cpu"), case)
    launches, fallbacks = tcs.repack.launches, tcs.repack.fallbacks
    ps = trcll.pack_state(dom, at, cap, prev=prev)
    packing, rel = tcs.repack_ref(dom, at.cell_xy, at.rel, cap, prev)
    got, want = tcs.outputs(ps.packing, ps.rc.rel), tcs.outputs(packing, rel)
    for name, a in got.items():
        assert torch.equal(tcs._bits(a), tcs._bits(want[name])), name
    _assert_sort_is_stable_argsort(dom, at, ps.packing)
    assert (tcs.repack.launches, tcs.repack.fallbacks) == (launches, fallbacks)


def _tiles_on(t, kw, dev):
    """make_tiles' tables as K2's positional arguments on ``dev``, and
    its keyword arguments with the occupied counts there too."""
    return tuple(x.to(dev) for x in t.values()), dict(kw, counts=kw["counts"].to(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("dim,scheme,records,layout", [
    (2, WCSPH, "fp16", {}), (2, DAM, "fp32", {}), (2, DAM, "bf16", {}), (3, WCSPH, "fp16", {}),
    # the occupied-slot walk where it could go wrong: rows full at cap (no
    # representative empty slot), all-empty cells away from the sentinel,
    # fp32 rel, and 3-D Tait + artificial viscosity + delta-SPH, fp32 records
    (2, WCSPH, "fp16", dict(tight_cap=True)),
    (2, DAM, "fp32", dict(hole=True)),
    (3, WCSPH, "bf16", dict(tight_cap=True, hole=True, rel="fp32")),
    (3, dict(DAM, body_force=()), "fp32", {}),
])
def test_rcll_force_kernel_within_rounding_bound(cuda_device, dim, scheme, records, layout):
    seed = 5 + dim if not layout else 11 + dim
    t, kw = make_tiles(seed, dim, scheme, records, n=8000 if dim == 2 else 6000, **layout)
    n_occ = kw["counts"]
    if layout.get("tight_cap"):
        assert int((n_occ == t["m"].shape[1]).sum()) > 0
    if layout.get("hole"):
        assert int((n_occ[:-1] == 0).sum()) > 0
    args, kw = _tiles_on(t, kw, cuda_device)
    before = trf.rcll_force.launches
    # raises unless every element is within rounding_bound and each
    # output's normwise difference over occupied slots within NORMWISE_LIMIT
    trf.check_against_plain(args, kw)
    assert trf.rcll_force.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("dim,scheme,records", [(2, WCSPH, "fp16"), (2, DAM, "fp32"),
                                                (3, dict(DAM, body_force=()), "bf16")])
def test_rcll_force_kernel_walks_massless_particles(cuda_device, dim, scheme, records):
    """A massless particle in the middle of a row and one in a row's last
    occupied slot are occupied slots: with the binning's counts the kernel
    agrees with the plain version at every slot. Given the occupied count
    by mass (m != 0) instead, as an occupancy-by-mass kernel would take it,
    the row's last particle drops out of every sum and the check fails."""
    t, kw = make_tiles(70 + dim, dim, scheme, records, n=8000 if dim == 2 else 6000,
                       massless=True)
    args, kw = _tiles_on(t, kw, cuda_device)
    assert int((trf.occupied_slots(args[3], kw["counts"]) & (args[3] == 0)).sum()) == 2
    trf.check_against_plain(args, kw)
    by_mass = (args[3] != 0).sum(dim=1).to(torch.int32)
    assert not torch.equal(by_mass, kw["counts"])
    with pytest.raises(AssertionError, match="disagrees"):
        trf.check_against_plain(args, dict(kw, counts=by_mass))


def _force_lanes_vs_solo(monkeypatch, dev, dim, scheme, records):
    """ops.rcll_force_lanes over 3 lanes (one with massless particles) is
    ONE K1 and ONE K2 call, each lane bit for bit the solo call of
    rcll_force_particles, and the folded calls pass their kernels' checks
    against the plain versions. Returns the folded K2 check."""
    dom, b, rc, v, m, rho, sch, rdt = make_lanes(90 + dim, dim, scheme, records,
                                                 n=8000 if dim == 2 else 6000)
    on = lambda t: t.to(dev)
    b, rc = (type(x)(*(on(f) for f in x)) for x in (b, rc))
    v, m, rho = on(v), on(m), on(rho)
    first = {}

    def capture(key, fn):
        def run(*a, **kw):
            first.setdefault(key, (a, kw))
            return fn(*a, **kw)
        return run

    monkeypatch.setattr(tcp, "cell_tables", capture("k1", tcp.cell_tables))
    monkeypatch.setattr(trf, "rcll_force", capture("k2", trf.rcll_force))
    before = (tcp._WRAPPER.launches, trf._WRAPPER.launches)
    drho, acc = tops.rcll_force_lanes(dom, b, rc, v, m, rho, scheme=sch, records_dtype=rdt)
    if dev.type == "cuda":
        torch.cuda.synchronize()
        assert (tcp._WRAPPER.launches, trf._WRAPPER.launches) == (before[0] + 1, before[1] + 1)
    assert first["k2"][0][0].shape[0] == 3 * (b.counts.shape[1]) + 1
    for lane in range(3):
        lb = type(b)(*(f[lane] for f in b))
        lrc = type(rc)(*(f[lane] for f in rc))
        d1, a1 = tops.rcll_force_particles(dom, lb, lrc, v[lane], m[lane], rho[lane],
                                           scheme=sch, records_dtype=rdt)
        assert torch.equal(drho[lane], d1) and torch.equal(acc[lane], a1), lane
    tcp.check_against_plain(*first["k1"])
    return trf.check_against_plain(*first["k2"])


@pytest.mark.cuda
@pytest.mark.parametrize("dim,scheme,records", [(2, WCSPH, "fp16"), (2, DAM, "fp32"),
                                                (3, WCSPH, "fp16")])
def test_folded_force_lanes_bit_identical_to_solo_launches(cuda_device, monkeypatch, dim,
                                                           scheme, records):
    _force_lanes_vs_solo(monkeypatch, cuda_device, dim, scheme, records)


def test_folded_force_lanes_plain_versions_on_cpu(monkeypatch):
    """The same check on the CPU, where the wrappers take their plain versions."""
    _force_lanes_vs_solo(monkeypatch, torch.device("cpu"), 2, WCSPH, "fp16")


@pytest.mark.cuda
@pytest.mark.parametrize("fault", trf.FAULTS)
def test_check_against_plain_fails_a_planted_fault(cuda_device, monkeypatch, fault):
    """The tolerances catch a wrong kernel: the Morris term dropped, the
    EOS constant 1% off (at taylor_green's c0 and mu), or the last
    occupied slot of every neighbor tile skipped."""
    t, kw = make_tiles(7, 2, dict(c0=10.0, rho0=1.0, mu=0.05), "fp16", n=8000)
    args, kw = _tiles_on(t, kw, cuda_device)
    monkeypatch.setattr(trf, "kernel_params", trf.planted_params(fault))
    with pytest.raises(AssertionError, match="disagrees"):
        trf.check_against_plain(args, kw)


@pytest.mark.parametrize("scale", [1.0, 1.0 + 1e-3])
def test_check_against_plain_flags_a_wrong_output(monkeypatch, scale):
    """The checker itself, on the CPU: the plain version passes against
    itself, and an acceleration 0.1% off fails the normwise limit."""
    t, kw = make_tiles(3, 2, dict(c0=10.0, rho0=1.0, mu=0.05), "fp16")
    ref = trf.rcll_force_ref

    def scaled(*args, **k):
        drho, acc = ref(*args, **k)
        return drho, acc * scale

    monkeypatch.setattr(trf, "rcll_force", scaled)
    if scale == 1.0:
        assert trf.check_against_plain(tuple(t.values()), kw)["max_abs_err"] == 0.0
    else:
        with pytest.raises(AssertionError, match="normwise"):
            trf.check_against_plain(tuple(t.values()), kw)


@pytest.mark.cuda
def test_wrapper_rejects_wrong_dtype_on_card(cuda_device):
    t, kw = make_tiles(3, 2, WCSPH, "fp16", n=2000)
    args, kw = _tiles_on(t, kw, cuda_device)
    with pytest.raises(ValueError, match="shift"):
        trf.rcll_force(args[0], args[1].to(torch.int32), *args[2:], **kw)
    with pytest.raises(ValueError, match="counts"):
        trf.rcll_force(*args, **dict(kw, counts=None))


# --------------------------------------------------------------------------
# K3, K4, K5
# --------------------------------------------------------------------------
def _nnps_calls(tabs, kw, compute, dev, k_slots=48):
    t = {k: x.to(dev) for k, x in tabs.items()}
    nk = dict(weights=kw["weights"], r_cell=kw["r_cell"], compute_dtype=compute)
    k4 = ((t["rel"], t["occ"], t["ids"], t["nb_ids"]), dict(nk, k_slots=k_slots))
    k5 = ((t["rel"], t["occ"], t["nb_ids"]), nk)
    return k4, k5


@pytest.mark.cuda
@pytest.mark.parametrize("dim,n,storage,compute,periodic", [
    (2, 20000, "fp16", torch.float32, False), (2, 20000, "fp16", torch.float16, True),
    (2, 20000, "bf16", torch.float32, True), (2, 20000, "fp32", torch.float16, False),
    (3, 12000, "fp16", torch.float16, True), (3, 12000, "fp32", torch.float32, False),
])
def test_nnps_kernels_bit_identical(cuda_device, dim, n, storage, compute, periodic):
    tabs, kw = make_nnps_tiles(11 + dim, dim, n, storage, periodic)
    k4, k5 = _nnps_calls(tabs, kw, compute, cuda_device)
    before = (tnp.rcll_neighbor_list_tables.launches, tnp.rcll_adjacency.launches)
    assert tnp.check_against_plain("K4", *k4)["hits"] > 0
    assert tnp.check_against_plain("K5", *k5)["hits"] > 0
    assert (tnp.rcll_neighbor_list_tables.launches, tnp.rcll_adjacency.launches) == (
        before[0] + 1, before[1] + 1)


def _edge_nnps_tiles(seed, dim, cap, storage):
    """K3/K4/K5 inputs for a small grid of cells at any cap: random
    coordinates in each cell, a random {0,1} occupancy with holes anywhere
    in a row (not a prefix), distinct ids in the occupied slots and -1 in
    the empty ones, and a random field f; the sentinel row is empty.
    Returns a dict of (rel, f, occ, ids, nb_ids) tables and the keyword
    arguments the kernels share (weights, r_cell, hc_phys, h, dim)."""
    rng = np.random.default_rng(seed)
    dom = td.Domain(lo=(0.0,) * dim, hi=(1.0,) * dim, h=0.07 if dim == 2 else 0.11,
                    periodic=(True,) + (False,) * (dim - 1))
    c1 = dom.ncells_total + 1
    rel = torch.as_tensor(rng.uniform(-1, 1, (c1, dim, cap)).astype(np.float32)).to(
        STORAGE[storage])
    occ = torch.as_tensor((rng.random((c1, cap)) < 0.45).astype(np.float32))
    occ[-1] = 0.0
    ids = torch.as_tensor(rng.permutation(c1 * cap).astype(np.int32).reshape(c1, cap))
    ids[occ == 0] = -1
    f = torch.as_tensor(rng.normal(size=(c1, cap)).astype(np.float32))
    tabs = dict(rel=rel, f=f, occ=occ, ids=ids, nb_ids=tops.nb_with_sentinel(dom, "cpu"))
    kw = dict(weights=tuple(dom.cell_weights), r_cell=tnnps.rcll_radius_cell_units(dom),
              hc_phys=tuple(dom.cell_sizes), h=dom.h, dim=dim)
    return tabs, kw


@pytest.mark.cuda
@pytest.mark.parametrize("dim,cap,storage,compute", [
    (2, 1, "fp16", torch.float32), (2, 3, "fp16", torch.float32),
    (2, 20, "fp16", torch.float32), (2, 20, "bf16", torch.float16),
    (2, 37, "fp32", torch.float16), (2, 128, "bf16", torch.float32),
    (3, 3, "fp32", torch.float32), (3, 20, "fp16", torch.float16),
    (3, 37, "bf16", torch.float32),
])
def test_adjacency_kernel_edges_bit_identical(cuda_device, dim, cap, storage, compute):
    """K5 where its design could go wrong: cap 1, 3 and 37 (cap^2 not a
    multiple of 4, so 16-byte chunks cross rows and tiles and regions
    start unaligned), cap 37 and 128 (several slot groups and mask words a
    row), occupancy with holes, 3-D, fp16 compute, bf16 storage."""
    tabs, kw = _edge_nnps_tiles(cap + dim, dim, cap, storage)
    _, k5 = _nnps_calls(tabs, kw, compute, cuda_device)
    before = tnp.rcll_adjacency.launches
    assert tnp.check_against_plain("K5", *k5)["hits"] > 0
    assert tnp.rcll_adjacency.launches == before + 1


#: Masks with holes for K3 and K4: (dim, cap, storage, compute) at cap 1,
#: 3, 20, 37 (two slot groups) and 128 (four), 2-D and 3-D.
HOLES_CASES = [
    (2, 1, "fp16", torch.float32), (2, 3, "fp32", torch.float16),
    (2, 20, "fp16", torch.float16), (2, 20, "bf16", torch.float32),
    (2, 37, "fp32", torch.float32), (2, 128, "fp16", torch.float32),
    (3, 1, "bf16", torch.float16), (3, 3, "fp16", torch.float32),
    (3, 20, "fp32", torch.float16), (3, 37, "bf16", torch.float32),
    (3, 128, "fp16", torch.float16),
]


@pytest.mark.cuda
@pytest.mark.parametrize("k_slots", [1, 3, 48, 50])
@pytest.mark.parametrize("dim,cap,storage,compute", HOLES_CASES)
def test_neighbor_lists_kernel_holes_bit_identical(cuda_device, dim, cap, storage, compute,
                                                   k_slots):
    """K4 on masks with holes anywhere in a row: ids in (k, j) order, -1
    padding and true counts, bit for bit. K = 1, 3 and 50, not multiples
    of 4, take the stores of single ids (and, at odd caps, chunks of the
    empty rows that cross rows); cap 37 and 128 have several occupancy
    words a row."""
    tabs, kw = _edge_nnps_tiles(7 * cap + dim, dim, cap, storage)
    k4, _ = _nnps_calls(tabs, kw, compute, cuda_device, k_slots=k_slots)
    before = tnp.rcll_neighbor_list_tables.launches
    hits = tnp.check_against_plain("K4", *k4)["hits"]
    assert tnp.rcll_neighbor_list_tables.launches == before + 1
    assert hits > 0 or cap == 1


@pytest.mark.cuda
@pytest.mark.parametrize("dim,cap,k_slots", [(2, 37, 400), (3, 20, 700), (2, 3, 5001)])
def test_neighbor_lists_kernel_past_the_stage_bit_identical(cuda_device, dim, cap, k_slots):
    """A K whose stage does not fit in a block's budget takes the unstaged
    path: each thread writes its own row, ids then padding (at K = 5001
    one by one, its rows not 16-byte aligned)."""
    assert tnp.list_stride(k_slots) == 0
    tabs, kw = _edge_nnps_tiles(cap + k_slots, dim, cap, "fp16")
    k4, _ = _nnps_calls(tabs, kw, torch.float32, cuda_device, k_slots=k_slots)
    assert tnp.check_against_plain("K4", *k4)["hits"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("k_slots", [1, 4, 9])
def test_neighbor_lists_kernel_counts_past_k(cuda_device, k_slots):
    """Counts past K stay the true counts; the lists hold the first K."""
    tabs, kw = make_nnps_tiles(15, 2, 20000, "fp16")
    k4, _ = _nnps_calls(tabs, kw, torch.float32, cuda_device, k_slots=k_slots)
    _, counts = tnp.rcll_neighbor_list_tables(*k4[0], **k4[1])
    assert int(counts.max()) > k_slots
    tnp.check_against_plain("K4", *k4)


@pytest.mark.cuda
@pytest.mark.parametrize("dim,cap,storage,nnps_dtype", HOLES_CASES)
def test_gradient_kernel_holes_within_rounding_bound(cuda_device, dim, cap, storage,
                                                      nnps_dtype):
    """K3 on masks with holes anywhere in a row: its work rows are the
    occupied slots, its walk the neighbors' occupied slots."""
    tabs, kw = _edge_nnps_tiles(5 * cap + dim, dim, cap, storage)
    t = {k: x.to(cuda_device) for k, x in tabs.items()}
    before = tsg.rcll_gradient.launches
    tsg.check_against_plain((t["rel"], t["f"], t["occ"], t["nb_ids"]),
                            dict(kw, nnps_dtype=nnps_dtype))
    assert tsg.rcll_gradient.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("dim,n,storage,nnps_dtype", [
    (2, 20000, "fp16", torch.float16), (2, 20000, "bf16", torch.float32),
    (3, 12000, "fp16", torch.float16), (3, 12000, "fp32", torch.float32),
])
def test_gradient_kernel_within_rounding_bound(cuda_device, dim, n, storage, nnps_dtype):
    tabs, kw = make_nnps_tiles(21 + dim, dim, n, storage, periodic=dim == 2)
    t = {k: x.to(cuda_device) for k, x in tabs.items()}
    before = tsg.rcll_gradient.launches
    tsg.check_against_plain((t["rel"], t["f"], t["occ"], t["nb_ids"]),
                            dict(kw, nnps_dtype=nnps_dtype))
    assert tsg.rcll_gradient.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["r2_1pct", "self_pair"])
@pytest.mark.parametrize("kernel", ["K4", "K5"])
def test_nnps_checks_fail_a_planted_fault(cuda_device, monkeypatch, kernel, fault):
    tabs, kw = make_nnps_tiles(5, 2, 20000, "fp16")
    k4, k5 = _nnps_calls(tabs, kw, torch.float32, cuda_device)
    params = tnp.kernel_params

    def faulty(**k):
        f, i = params(**k)
        if fault == "r2_1pct":
            f[3] *= 1.01
        else:
            i[0] = 1
        return f, i

    monkeypatch.setattr(tnp, "kernel_params", faulty)
    with pytest.raises(AssertionError, match="disagrees"):
        tnp.check_against_plain(kernel, *(k4 if kernel == "K4" else k5))


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["df_sign", "hc_1pct"])
def test_gradient_check_fails_a_planted_fault(cuda_device, monkeypatch, fault):
    tabs, kw = make_nnps_tiles(6, 2, 20000, "fp16")
    t = {k: x.to(cuda_device) for k, x in tabs.items()}
    params = tsg.kernel_params

    def faulty(**k):
        f = params(**k)
        if fault == "df_sign":
            f[9] = -1.0
        else:
            f[4] *= 1.01
        return f

    monkeypatch.setattr(tsg, "kernel_params", faulty)
    with pytest.raises(AssertionError, match="disagrees"):
        tsg.check_against_plain((t["rel"], t["f"], t["occ"], t["nb_ids"]),
                                dict(kw, nnps_dtype=torch.float16))


@pytest.mark.cuda
@pytest.mark.parametrize("fault", tnp.FAULTS)
def test_neighbor_lists_check_fails_a_planted_fault(cuda_device, monkeypatch, fault):
    """K4's padding 0 for -1, and its counts saturated at K (shown at a
    small K, where counts pass it)."""
    tabs, kw = _edge_nnps_tiles(41, 2, 20, "fp16")
    k4, _ = _nnps_calls(tabs, kw, torch.float32, cuda_device, k_slots=3)
    monkeypatch.setattr(tnp, "kernel_params", tnp.planted_params(fault))
    with pytest.raises(AssertionError, match="disagrees"):
        tnp.check_against_plain("K4", *k4)


@pytest.mark.cuda
@pytest.mark.parametrize("fault", tsg.FAULTS)
def test_gradient_check_fails_a_planted_walk_fault(cuda_device, monkeypatch, fault):
    """K3's walk one occupied slot short, and a row's first empty slot
    taken as its end (visible only on a mask with holes)."""
    tabs, kw = _edge_nnps_tiles(42, 2, 20, "fp16")
    t = {k: x.to(cuda_device) for k, x in tabs.items()}
    monkeypatch.setattr(tsg, "walk_params", tsg.planted_params(fault))
    with pytest.raises(AssertionError, match="disagrees"):
        tsg.check_against_plain((t["rel"], t["f"], t["occ"], t["nb_ids"]),
                                dict(kw, nnps_dtype=torch.float16))


def _k3_k4_calls(dev):
    """One K4 and one K3 call on the same mask with holes, as thunks."""
    tabs, kw = _edge_nnps_tiles(43, 2, 37, "fp16")
    k4, _ = _nnps_calls(tabs, kw, torch.float32, dev, k_slots=50)
    t = {k: x.to(dev) for k, x in tabs.items()}
    return (lambda: tnp.rcll_neighbor_list_tables(*k4[0], **k4[1]),
            lambda: tsg.rcll_gradient(t["rel"], t["f"], t["occ"], t["nb_ids"], **kw,
                                      nnps_dtype=torch.float16))


def _bits(outs):
    return [o.view(torch.int32) for o in outs]


@pytest.mark.cuda
def test_neighbor_lists_and_gradient_kernels_are_deterministic(cuda_device):
    """Two launches on the same inputs give the same bits: every output
    element is written once, by one thread, in a fixed order."""
    for call in _k3_k4_calls(cuda_device):
        first = _bits(call())
        for _ in range(2):
            assert all(torch.equal(a, b) for a, b in zip(first, _bits(call())))


@pytest.mark.cuda
def test_neighbor_lists_and_gradient_kernels_replay_in_a_cuda_graph(cuda_device):
    """K4 and K3 captured in one CUDA graph (K3's two passes and its
    scratch words included) replay to the eager launches' bits."""
    calls = _k3_k4_calls(cuda_device)
    eager = [_bits(call()) for call in calls]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for call in calls:
            call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = (tnp.rcll_neighbor_list_tables.launches, tsg.rcll_gradient.launches)
    with torch.cuda.graph(graph):
        captured = [call() for call in calls]
    assert (tnp.rcll_neighbor_list_tables.launches, tsg.rcll_gradient.launches) == (
        before[0] + 1, before[1] + 1)
    for _ in range(2):
        for outs in captured:
            for o in outs:
                o.fill_(float("nan") if o.is_floating_point() else 7)
        graph.replay()
        torch.cuda.synchronize()
        for want, outs in zip(eager, captured):
            assert all(torch.equal(a, b) for a, b in zip(want, _bits(outs)))


# --------------------------------------------------------------------------
# K6 (RCLL-KV decode) and K7 (flash prefill)
# --------------------------------------------------------------------------
KV_CASES = {  # b, h, hkv, dh, nblk, blk, residuals, lengths, heads-last views
    "int8": (3, 24, 8, 128, 5, 128, torch.int8, [1, 513, 640], True),
    "fp16": (3, 24, 8, 128, 5, 128, torch.float16, [1, 513, 640], False),
    "bf16": (3, 24, 8, 128, 5, 128, torch.bfloat16, [1, 513, 640], True),
    "all_rows_empty": (3, 24, 8, 128, 5, 128, torch.int8, [0, 0, 0], True),
    "full_beside_empty": (3, 24, 8, 128, 5, 128, torch.int8, [0, 640, 0], True),
    "blk256": (2, 8, 2, 64, 3, 256, torch.float16, [700, 255], False),
    "dh16": (2, 6, 2, 16, 4, 128, torch.int8, [500, 129], False),
    "dh24_plain_loads": (2, 4, 2, 24, 3, 128, torch.int8, [300, 129], False),
    "nblk1": (3, 8, 8, 128, 1, 128, torch.bfloat16, [128, 1, 77], True),
    "path_ragged": (4, 24, 8, 128, 10, 128, torch.int8, [1152, 1153, 64, 65], True),
    "rep8_blk256_fp16": (2, 16, 2, 128, 2, 256, torch.float16, [512, 300], True),
    # 1100 cache blocks: the merge walks 1100 partials a row
    "long_cache": (1, 3, 1, 128, 1100, 128, torch.int8, [140000], True),
    # the served families' shapes: internlm2-20b rep 6, stablelm-1.6b
    # rep 1 at Dh 64, deepseek-moe-16b rep 1
    "internlm2_rep6": (2, 48, 8, 128, 9, 128, torch.int8, [1024, 1100], True),
    "stablelm_rep1_dh64": (2, 32, 32, 64, 9, 128, torch.int8, [1024, 1087], True),
    "deepseek_moe_rep1": (2, 16, 16, 128, 10, 128, torch.int8, [1152, 1025], True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(KV_CASES))
def test_kv_decode_kernel_within_rounding_bound(cuda_device, case):
    b, h, hkv, dh, nblk, blk, resid, lengths, heads_last = KV_CASES[case]
    args = tkv.random_inputs(11, b, h, hkv, dh, nblk, blk, resid, lengths,
                            heads_last=heads_last, device=cuda_device)
    before = tkv.rcll_kv_decode.launches
    tkv.check_against_plain(args, {})
    assert tkv.rcll_kv_decode.launches == before + 1
    if not any(lengths):
        out, m, l = tkv.rcll_kv_decode(*args, return_stats=True)
        assert not bool(out.any()) and bool((m == tkv.NEG_INF).all()) and not bool(l.any())


@pytest.mark.cuda
def test_kv_decode_refuses_a_block_past_shared_memory(cuda_device):
    """A CTA holds a whole cache block's K and V tiles: 1024 fp16 keys of
    128 dims (~0.5 MB) do not fit, and the wrapper raises, launching
    nothing; the next call on blocks that fit is not disturbed."""
    args = tkv.random_inputs(11, 1, 2, 1, 128, 1, 1024, torch.float16, [1024],
                             device=cuda_device)
    before = tkv.rcll_kv_decode.launches
    with pytest.raises(RuntimeError, match="rcll_kv_decode"):
        tkv.rcll_kv_decode(*args)
    assert tkv.rcll_kv_decode.launches == before
    tkv.check_against_plain(tkv.random_inputs(11, 1, 2, 1, 128, 8, 128, torch.float16, [1024],
                                              device=cuda_device), {})


@pytest.mark.parametrize("fault", tkv.FAULTS)
def test_kv_planted_params_change_one_field(fault):
    clean = tkv.kernel_params(scale=0.125)
    planted = tkv.planted_params(fault)(scale=0.125)
    changed = [f for f, _ in tkv.KvParams._fields_
               if getattr(clean, f) != getattr(planted, f)]
    assert changed == [{"len_one_block_short": "len_shift_blocks", "divisor_128": "inv_levels",
                        "drop_last_split": "drop_last_split"}[fault]]


def _path_inputs(dev, lengths=(1152, 1152, 1152, 1152)):
    """K6's inputs at the served request's last decode step (llama3.2-3b,
    B 4, 10 blocks of 128 int8 keys, strided views of the model's cache)."""
    return tkv.random_inputs(17, 4, 24, 8, 128, 10, 128, torch.int8, list(lengths),
                             heads_last=True, device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("lengths", [(1152,) * 4, (1153, 0, 37, 1280)])
def test_kv_decode_kernel_is_deterministic(cuda_device, lengths):
    """Two launches on the same inputs give the same bits: the merge takes
    the splits in a fixed order."""
    args = _path_inputs(cuda_device, lengths)
    first = tkv.rcll_kv_decode(*args, return_stats=True)
    for _ in range(3):
        again = tkv.rcll_kv_decode(*args, return_stats=True)
        for x, y in zip(first, again):
            assert torch.equal(x.view(torch.int32), y.view(torch.int32))


@pytest.mark.cuda
def test_kv_decode_kernel_replays_in_a_cuda_graph(cuda_device):
    """A launch captured in a CUDA graph and replayed twice gives the
    eager launch's bits (a call keeps no state between launches)."""
    args = _path_inputs(cuda_device, (1152, 1153, 640, 1))
    eager = tkv.rcll_kv_decode(*args, return_stats=True)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tkv.rcll_kv_decode(*args, return_stats=True)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = tkv.rcll_kv_decode.launches
    with torch.cuda.graph(graph):
        captured = tkv.rcll_kv_decode(*args, return_stats=True)
    assert tkv.rcll_kv_decode.launches == before + 1
    for _ in range(2):
        for x in captured:
            x.fill_(float("nan"))
        graph.replay()
        torch.cuda.synchronize()
        for x, y in zip(eager, captured):
            assert torch.equal(x.view(torch.int32), y.view(torch.int32))


@pytest.mark.cuda
def test_kv_decode_graphs_replay_after_other_launches(cuda_device):
    """Two graphs captured on one stream, one at B * Hkv = 32 and one at
    B * Hkv = 320, replayed in the other order after an eager launch at
    the larger shape: each gives its eager bits (no state is shared
    between calls)."""
    small = _path_inputs(cuda_device, (1152, 1153, 640, 1))
    large = tkv.random_inputs(18, 40, 24, 8, 128, 2, 128, torch.int8,
                              [(37 * i) % 257 for i in range(40)], heads_last=True,
                              device=cuda_device)
    eager = [tkv.rcll_kv_decode(*a, return_stats=True) for a in (small, large)]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for a in (small, large):
            tkv.rcll_kv_decode(*a, return_stats=True)
    torch.cuda.current_stream().wait_stream(side)
    graphs, captured = [], []
    for a in (small, large):
        graphs.append(torch.cuda.CUDAGraph())
        with torch.cuda.graph(graphs[-1]):
            captured.append(tkv.rcll_kv_decode(*a, return_stats=True))
    tkv.rcll_kv_decode(*large, return_stats=True)
    for i in (1, 0):
        for x in captured[i]:
            x.fill_(float("nan"))
        graphs[i].replay()
    torch.cuda.synchronize()
    for want, got in zip(eager, captured):
        for x, y in zip(want, got):
            assert torch.equal(x.view(torch.int32), y.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,causal,lq,lk,dh,heads_last", [
    (torch.bfloat16, True, 300, 300, 128, True), (torch.float32, True, 77, 200, 64, False),
    (torch.bfloat16, False, 129, 65, 16, False), (torch.float32, False, 64, 64, 32, True)])
def test_flash_kernel_within_rounding_bound(cuda_device, dtype, causal, lq, lk, dh, heads_last):
    args = tfa.random_inputs(12, 2, 8, 2, lq, lk, dh, dtype, heads_last=heads_last,
                            device=cuda_device)
    before = tfa.flash_attention.launches
    tfa.check_against_plain(args, {"causal": causal})
    assert tfa.flash_attention.launches == before + 1


# The bf16 tensor-core kernel: 128 query rows a CTA, 64-key tiles. Lengths
# of 1, 63, 65, 127, 129 and 1000 keep a multiple of a tile from hiding the
# ragged mask; rep = H / Hkv of 1, 3 and 8.
FLASH_BF16_CASES = {  # b, h, hkv, lq, lk, dh, causal, heads-last views
    "dh16": (2, 6, 2, 129, 129, 16, True, True),
    "dh32": (2, 6, 2, 127, 127, 32, True, False),
    "dh64": (2, 6, 2, 65, 65, 64, True, True),
    "dh128": (1, 6, 2, 1000, 1000, 128, True, True),
    "len1": (2, 4, 4, 1, 1, 128, True, False),
    "len63": (2, 8, 1, 63, 63, 64, True, True),
    "len65_not_causal": (1, 6, 2, 65, 65, 128, False, False),
    "len127_rep8": (1, 16, 2, 127, 127, 128, True, True),
    "len1000_not_causal": (1, 3, 1, 1000, 1000, 32, False, True),
    "lq_gt_lk": (2, 6, 2, 200, 65, 128, True, False),
    "lq_lt_lk": (2, 6, 2, 65, 1000, 128, True, True),
    "lq1_lk129": (2, 6, 2, 1, 129, 64, True, False),
    "lq129_lk63_not_causal": (1, 8, 8, 129, 63, 16, False, True),
    "prefill_rows": (1, 24, 8, 1024, 1024, 128, True, True),
    # the served families' shapes: whisper-large-v3's encoder (1500 frames,
    # off the 128-row tile), its cross-attention and causal decoder at Dh
    # 64, rep 1; internlm2-20b rep 6
    "whisper_encoder": (1, 20, 20, 1500, 1500, 64, False, True),
    "whisper_cross": (1, 20, 20, 256, 1500, 64, False, True),
    "whisper_decoder": (2, 20, 20, 256, 256, 64, True, True),
    "internlm2_rep6": (1, 48, 8, 1024, 1024, 128, True, True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(FLASH_BF16_CASES))
def test_flash_bf16_kernel_within_rounding_bound(cuda_device, case):
    b, h, hkv, lq, lk, dh, causal, heads_last = FLASH_BF16_CASES[case]
    args = tfa.random_inputs(21, b, h, hkv, lq, lk, dh, torch.bfloat16, heads_last=heads_last,
                             device=cuda_device)
    before = tfa.flash_attention.launches
    tfa.check_against_plain(args, {"causal": causal})
    assert tfa.flash_attention.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_fully_masked_rows_are_zero(cuda_device, dtype):
    """Lq > Lk, causal: the first Lq - Lk rows see no key and are exactly 0."""
    args = tfa.random_inputs(22, 2, 6, 2, 200, 65, 64, dtype, device=cuda_device)
    out = tfa.flash_attention(*args)
    torch.cuda.synchronize()
    assert not bool(out[:, :, :135].any())
    assert bool((out[:, :, 135:].abs().sum(-1) > 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("view", ["padded_rows", "unaligned_base"])
def test_flash_bf16_copies_a_view_tma_cannot_address(cuda_device, view):
    """A bf16 view whose row stride is not a multiple of 16 bytes, or whose
    base is not 16-byte aligned, is copied by the wrapper and still agrees
    with the plain version."""
    q, k, v = tfa.random_inputs(23, 2, 6, 2, 129, 129, 64, torch.bfloat16, device=cuda_device)
    if view == "padded_rows":
        wide = torch.zeros(2, 2, 129, 68, dtype=torch.bfloat16, device=cuda_device)
        wide[..., :64] = k
        k = wide[..., :64]
    else:
        flat = torch.zeros(k.numel() + 1, dtype=torch.bfloat16, device=cuda_device)
        flat[1:] = k.reshape(-1)
        k = flat[1:].view(k.shape)
    assert not tfa.tma_addressable(k) and tfa.tma_addressable(q)
    before = tfa.flash_attention.launches
    tfa.check_against_plain((q, k, v), {"causal": True})
    assert tfa.flash_attention.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("dh,lq,lk,causal", [(16, 129, 1000, True), (128, 65, 63, False),
                                             (128, 1000, 1000, True)])
def test_flash_fp32_kernel_still_within_rounding_bound(cuda_device, dh, lq, lk, causal):
    """fp32 inputs take the CUDA-core instantiation."""
    args = tfa.random_inputs(24, 1, 6, 2, lq, lk, dh, torch.float32, heads_last=True,
                             device=cuda_device)
    tfa.check_against_plain(args, {"causal": causal})


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_kernel_is_deterministic(cuda_device, dtype):
    """Two launches on the same inputs give the same bits: each output row
    is written once, by one CTA, with no atomics."""
    args = tfa.random_inputs(25, 2, 24, 8, 1000, 1000, 128, dtype, heads_last=True,
                             device=cuda_device)
    first = tfa.flash_attention(*args)
    for _ in range(2):
        assert torch.equal(first.view(torch.int32), tfa.flash_attention(*args).view(torch.int32))


@pytest.mark.cuda
def test_flash_kernel_replays_in_a_cuda_graph(cuda_device):
    """A bf16 launch captured in a CUDA graph (its tensor maps are kernel
    parameters) replays to the eager launch's bits."""
    args = tfa.random_inputs(26, 2, 24, 8, 300, 300, 128, torch.bfloat16, heads_last=True,
                             device=cuda_device)
    eager = tfa.flash_attention(*args)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tfa.flash_attention(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = tfa.flash_attention.launches
    with torch.cuda.graph(graph):
        captured = tfa.flash_attention(*args)
    assert tfa.flash_attention.launches == before + 1
    for _ in range(2):
        captured.fill_(float("nan"))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(eager.view(torch.int32), captured.view(torch.int32))


@pytest.mark.parametrize("fault", tfa.FAULTS)
def test_flash_planted_params_change_one_field(fault):
    clean = tfa.kernel_params(scale=0.125, causal=True)
    planted = tfa.planted_params(fault)(scale=0.125, causal=True)
    changed = [f for f, _ in tfa.FlashParams._fields_
               if getattr(clean, f) != getattr(planted, f)]
    assert changed == [{"causal_plus_one": "causal_shift", "p_bf16": "p_hi_only"}[fault]]


def test_tma_addressable_views():
    """The wrapper's rule for bf16 views TMA reads in place, on CPU
    tensors: the model's heads-last views and contiguous tensors pass; a
    row stride off 16 bytes or an unaligned base does not; the stride of
    a size-1 dim is never read."""
    q, k, v = tfa.random_inputs(27, 2, 6, 2, 33, 33, 64, torch.bfloat16, heads_last=True)
    assert all(tfa.tma_addressable(t) for t in (q, k, v, q.contiguous()))
    assert not tfa.tma_addressable(torch.zeros(2, 2, 33, 68, dtype=torch.bfloat16)[..., :64])
    flat = torch.zeros(2 * 2 * 33 * 64 + 1, dtype=torch.bfloat16)
    assert not tfa.tma_addressable(flat[1:].view(2, 2, 33, 64))
    assert tfa.tma_addressable(torch.zeros(1, 1, 33, 64, dtype=torch.bfloat16)
                               .as_strided((1, 1, 33, 64), (3, 5, 64, 1)))


@pytest.mark.cuda
@pytest.mark.parametrize("fault", tkv.FAULTS + tfa.FAULTS)
def test_lm_checks_fail_a_planted_fault(cuda_device, monkeypatch, fault):
    mod = tkv if fault in tkv.FAULTS else tfa
    monkeypatch.setattr(mod, "kernel_params", mod.planted_params(fault))
    with pytest.raises(AssertionError, match="disagree"):
        if mod is tkv:
            tkv.check_against_plain(
                tkv.random_inputs(13, 2, 8, 2, 64, 3, 128, torch.int8, [300, 384],
                                  device=cuda_device), {})
        else:
            tfa.check_against_plain(
                tfa.random_inputs(14, 1, 8, 2, 200, 200, 64, torch.bfloat16, device=cuda_device),
                {"causal": True})


@pytest.mark.cuda
def test_smoke_model_serves_through_both_kernels(cuda_device):
    from repro_torch.launch.serve import ServeRun

    k6_0, k7_0 = tkv.rcll_kv_decode.launches, tfa.flash_attention.launches
    out = ServeRun(arch="llama3.2-3b", smoke=True, batch=2, prompt_len=128, gen=6,
                   kv_mode="anchored", device="cuda").run()
    assert out["tokens"].shape == (2, 6)
    assert tfa.flash_attention.launches - k7_0 == 2  # one per layer of the prefill
    assert tkv.rcll_kv_decode.launches - k6_0 == 2 * 6  # per layer, warm-up + 5 steps


@pytest.mark.parametrize("which,scale", [("K6", 1.0), ("K6", 1.0 + 1e-4), ("K7", 1.0),
                                         ("K7", 1.0 + 1e-4)])
def test_lm_checks_flag_a_wrong_output(monkeypatch, which, scale):
    """The checkers themselves, on the CPU: the plain version passes
    against itself, and an output 0.01% off fails."""
    if which == "K6":
        args = tkv.random_inputs(15, 2, 8, 2, 64, 3, 128, torch.int8, [300, 384])
        ref = tkv.rcll_kv_decode_ref

        def scaled(*a, **k):
            out = ref(*a, **k)
            return (out[0] * scale,) + tuple(out[1:]) if k.get("return_stats") else out * scale

        monkeypatch.setattr(tkv, "rcll_kv_decode", scaled)
        check = lambda: tkv.check_against_plain(args, {})
    else:
        args = tfa.random_inputs(16, 1, 8, 2, 100, 100, 32, torch.float32)
        ref = tfa.flash_attention_ref
        monkeypatch.setattr(tfa, "flash_attention", lambda *a, **k: ref(*a, **k) * scale)
        check = lambda: tfa.check_against_plain(args, {"causal": True})
    if scale == 1.0:
        assert check()["max_abs_err"] == 0.0
    else:
        with pytest.raises(AssertionError, match="disagrees"):
            check()


# --------------------------------------------------------------------------
# K7b (K7's gradient, for training)
# --------------------------------------------------------------------------
# fp32 takes the CUDA-core kernels (32-row tiles), bf16 the tensor-core ones
# (dQ: 128 query rows a CTA over 64-key tiles; dK/dV: 64 keys a CTA over
# 64-query tiles; lse and D padded to 64 rows).
BWD_CASES = [  # b, h, hkv, lq, lk, causal, heads_last
    (2, 8, 2, 200, 200, True, True),     # rep 4, causal, ragged against the 32-row tiles
    (2, 6, 2, 100, 300, False, False),   # cross-attention, Lq < Lk
    (2, 4, 4, 300, 65, True, False),     # Lq > Lk: 235 rows see no key
    (1, 8, 1, 65, 190, True, True),      # rep 8, Lq < Lk causal (the offset mask)
    (2, 24, 8, 256, 256, True, True),    # llama3.2-3b's heads
    (1, 24, 8, 1000, 1000, True, True),  # llama3.2-3b's heads, ragged against 64 and 128
    (2, 6, 2, 129, 127, True, False),    # one row past a 128-row tile, keys one short of 128
    (1, 6, 3, 65, 191, False, True),     # non-causal, both lengths one past a 64-row tile
]


@pytest.mark.cuda
@pytest.mark.parametrize("dh", [16, 32, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", BWD_CASES, ids=lambda c: "-".join(map(str, c)))
def test_flash_bwd_kernel_within_rounding_bound(cuda_device, case, dtype, dh):
    b, h, hkv, lq, lk, causal, heads_last = case
    args = tfa.random_bwd_inputs(30, b, h, hkv, lq, lk, dh, dtype, causal=causal,
                                 heads_last=heads_last, device=cuda_device)
    before = tfa.flash_attention_bwd.launches
    res = tfa.check_bwd_against_plain(args, {"causal": causal})
    assert tfa.flash_attention_bwd.launches == before + 1
    assert res["max_ratio"] <= 1.0
    if causal and lq > lk:
        dq, _, _ = tfa.flash_attention_bwd(*args, causal=causal)
        assert not dq[:, :, :lq - lk].any()


@pytest.mark.cuda
@pytest.mark.parametrize("view", ["padded_rows", "unaligned_base"])
def test_flash_bwd_copies_a_view_tma_cannot_address(cuda_device, view):
    """A bf16 K7b input whose row stride is not a multiple of 16 bytes, or
    whose base is not 16-byte aligned, is copied by the wrapper (the
    tensor-core path reads q, k and v with TMA) and the gradients still
    agree with the plain version."""
    q, k, v, out, lse, dout = tfa.random_bwd_inputs(35, 2, 6, 2, 129, 129, 64, torch.bfloat16,
                                                    device=cuda_device)
    if view == "padded_rows":
        wide = torch.zeros(2, 2, 129, 68, dtype=torch.bfloat16, device=cuda_device)
        wide[..., :64] = v
        v = wide[..., :64]
    else:
        flat = torch.zeros(q.numel() + 1, dtype=torch.bfloat16, device=cuda_device)
        flat[1:] = q.reshape(-1)
        q = flat[1:].view(q.shape)
    assert not all(tfa.tma_addressable(t) for t in (q, k, v))
    before = tfa.flash_attention_bwd.launches
    tfa.check_bwd_against_plain((q, k, v, out, lse, dout), {"causal": True})
    assert tfa.flash_attention_bwd.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_lse_output_keeps_the_bits(cuda_device, dtype, causal):
    """K7 with its logsumexp output writes the same output bits as without
    it (serving's launch), and the logsumexp of its plain version within
    the forward's relative bound (+inf on the rows that see no key)."""
    q, k, v = tfa.random_inputs(31, 2, 8, 2, 300, 200, 128, dtype, heads_last=True,
                                device=cuda_device)
    plain_out = tfa.flash_attention(q, k, v, causal=causal)
    out, lse, _ = tfa._launch(q, k, v, causal, None, with_lse=True)
    assert torch.equal(out.view(torch.int32), plain_out.view(torch.int32))
    want = tfa.lse_ref(q, k, causal=causal)
    finite = torch.isfinite(want)
    assert torch.equal(finite, torch.isfinite(lse))
    assert (lse[~finite] > 0).all()
    rel = tfa.rounding_bound(*tfa._gqa(q, k, v), tfa._valid(300, 200, causal, cuda_device),
                             1 / 128**0.5, relative=True)[..., 0]
    err = (lse - want).abs()[finite]
    assert bool((err <= rel[finite] * (1 + want.abs()[finite])).all())


@pytest.mark.cuda
@pytest.mark.parametrize("fault", tfa.BACKWARD_FAULTS)
def test_flash_bwd_check_fails_a_planted_fault(cuda_device, monkeypatch, fault):
    monkeypatch.setattr(tfa, "backward_params", tfa.planted_backward_params(fault))
    with pytest.raises(AssertionError, match="disagrees"):
        tfa.check_bwd_against_plain(
            tfa.random_bwd_inputs(32, 2, 8, 2, 128, 128, 64, torch.bfloat16,
                                  device=cuda_device), {"causal": True})


@pytest.mark.cuda
def test_flash_bwd_kernel_is_deterministic(cuda_device):
    args = tfa.random_bwd_inputs(33, 2, 24, 8, 512, 512, 128, torch.bfloat16, heads_last=True,
                                 device=cuda_device)
    first = tfa.flash_attention_bwd(*args)
    for _ in range(3):
        for a, b in zip(first, tfa.flash_attention_bwd(*args)):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_attention_op_launches_k7_and_k7b(cuda_device, dtype):
    """An input that needs a gradient makes K7's call an autograd op: one
    K7 launch (with the logsumexp), one K7b call in the backward, whose
    gradients autograd returns cast to the inputs' dtype."""
    q, k, v = (t.requires_grad_() for t in tfa.random_inputs(
        34, 2, 8, 2, 160, 160, 64, dtype, heads_last=False, device=cuda_device))
    f0, b0 = tfa.flash_attention.launches, tfa.flash_attention_bwd.launches
    out = tfa.flash_attention(q, k, v)
    assert type(out.grad_fn).__name__ == "AttentionBackward"
    dout = torch.randn_like(out)
    grads = torch.autograd.grad(out, (q, k, v), dout)
    assert tfa.flash_attention.launches == f0 + 1
    assert tfa.flash_attention_bwd.launches == b0 + 1
    lse = tfa.lse_ref(q.detach(), k.detach())
    want = tfa.flash_attention_bwd(q.detach(), k.detach(), v.detach(), out.detach(),
                                   tfa._launch(q.detach(), k.detach(), v.detach(), True, None,
                                               with_lse=True)[1], dout)
    for g, w, t in zip(grads, want, (q, k, v)):
        assert g.dtype == t.dtype
        assert torch.equal(g, w.to(dtype))
    assert torch.isfinite(lse[torch.isfinite(lse)]).all()


@pytest.mark.cuda
def test_smoke_model_trains_through_k7_and_k7b(cuda_device):
    from repro_torch.launch.train import TrainRun

    f0, b0 = tfa.flash_attention.launches, tfa.flash_attention_bwd.launches
    out = TrainRun(arch="llama3.2-3b", smoke=True, steps=3, batch=2, seq=128,
                   device="cuda", log_every=100).run()
    assert all(np.isfinite(out["losses"])) and len(out["losses"]) == 3
    assert tfa.flash_attention.launches - f0 == 2 * 3  # a layer a step
    assert tfa.flash_attention_bwd.launches - b0 == 2 * 3
    for name in ("wq", "wk", "wv"):
        assert out["params"]["layers"]["attn"][name].grad.abs().sum() > 0


# --------------------------------------------------------------------------
# the dry run's counts (kernels.cost) on the card
# --------------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("causal", [True, False])
def test_kernel_counts_on_the_card_equal_meta(cuda_device, dtype, causal):
    """K6, K7 and K7b on CUDA tensors launch their kernels (the meta path
    is never taken: real outputs, the launch counters move) and count under
    the dry run's counter what they count on meta for the same shapes."""
    from repro_torch.kernels import cost

    a = tfa.random_bwd_inputs(5, 2, 8, 2, 200, 200, 64, dtype, causal=causal)
    kv = tkv.random_inputs(6, 2, 8, 2, 64, 3, 128, torch.int8, [300, 17])
    counts = {}
    for dev in ("meta", cuda_device):
        a_d, kv_d = tuple(t.to(dev) for t in a), tuple(t.to(dev) for t in kv)
        before = (tfa.flash_attention.launches, tfa.flash_attention_bwd.launches,
                  tkv.rcll_kv_decode.launches)
        with cost.CostCounter() as c:
            out = tfa.flash_attention(*a_d[:3], causal=causal)
            grads = tfa.flash_attention_bwd(*a_d, causal=causal)
            dec = tkv.rcll_kv_decode(*kv_d)
        after = (tfa.flash_attention.launches, tfa.flash_attention_bwd.launches,
                 tkv.rcll_kv_decode.launches)
        assert c.aten_flops == 0
        counts[str(dev)] = c.kernels
        if dev != "meta":
            torch.cuda.synchronize()
            assert after == tuple(x + 1 for x in before)
            assert not any(t.is_meta for t in (out, dec, *grads))
            assert bool(torch.isfinite(out).all()) and bool(torch.isfinite(dec).all())
        else:
            assert after == before
    assert counts["meta"] == counts["cuda"]
    assert set(counts["cuda"]) == {"flash_attention", "flash_attention_bwd", "rcll_kv_decode"}


#: Model degrees over llama3.2-3b's 24 heads / 8 kv heads: 2, 4 and 8 keep
#: whole kv groups; 3 and 16 (2 heads a rank, 4 ranks empty) cut them.
SHARD_DEGREES = [2, 3, 4, 8, 16]


def _shard_inputs(seed, dev):
    q, k, v = tfa.random_inputs(seed, 2, 24, 8, 1024, 1024, 128, torch.bfloat16,
                                heads_last=True, device=dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    return q, k, v, torch.randn(q.shape, generator=g, device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("degree", SHARD_DEGREES)
def test_flash_head_shards_match_the_whole_call(cuda_device, degree):
    """K7 and K7b on each model rank's head shard of llama3.2-3b's layer
    shapes (2, 24, 1024, 128) bf16 causal (``attention.check_head_shards``):
    outputs and dQ bit-equal to one whole call, dK and dV bit-equal where
    every rank holds whole kv groups, else within K7b's rounding bound; one
    K7 and one K7b launch per shard that attends, and one for the whole."""
    f0, b0 = tfa.flash_attention.launches, tfa.flash_attention_bwd.launches
    r = tattn.check_head_shards(*_shard_inputs(40 + degree, cuda_device), degree)
    assert r["ok"] and r["out_equal"] and r["dq_equal"], r
    assert r["whole_groups"] == (degree in (2, 4, 8)), r
    assert r["dkv_equal"] or not r["whole_groups"], r
    assert tfa.flash_attention.launches - f0 == r["calls"] + 1
    assert tfa.flash_attention_bwd.launches - b0 == r["calls"] + 1


def _kv_one_group_off(q, k, v, h0, h1, n_heads, *, causal):
    return tattn.local_attention(q, k.roll(-1, 1), v.roll(-1, 1), h0, h1, n_heads,
                                 causal=causal)


@pytest.mark.cuda
def test_flash_head_shard_check_fails_a_kv_offset(cuda_device):
    r = tattn.check_head_shards(*_shard_inputs(60, cuda_device), 4, local=_kv_one_group_off)
    assert not r["ok"] and not r["out_equal"], r


@pytest.mark.cuda
def test_flash_refuses_a_dtensor(cuda_device):
    """A DTensor never reaches the kernels' data pointers: they raise, and
    the mesh path hands them each rank's local shard."""
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.launch import mesh as tmesh

    q, k, v = tfa.random_inputs(61, 1, 8, 2, 128, 128, 64, torch.bfloat16, device=cuda_device)
    mesh = tmesh.make_mesh((1, 1), ("data", "model"), cuda_device)
    try:
        dq, dk, dv = (distribute_tensor(t, mesh, [Replicate(), Replicate()]) for t in (q, k, v))
        with pytest.raises(TypeError, match="local shard"):
            tfa.flash_attention(dq, dk, dv)
    finally:
        tmesh.release()


@pytest.mark.cuda
@pytest.mark.parametrize("arch,remat", [(a, "none") for a in (
    "granite-3-8b", "stablelm-1.6b", "internlm2-20b", "llama3.2-3b", "deepseek-v2-236b",
    "deepseek-moe-16b", "whisper-large-v3", "zamba2-1.2b", "pixtral-12b", "mamba2-130m")]
    + [(a, "full") for a in ("llama3.2-3b", "zamba2-1.2b", "whisper-large-v3",
                            "deepseek-v2-236b", "mamba2-130m")])
def test_every_family_trains_bit_equal_on_a_1x1_mesh(cuda_device, monkeypatch, arch, remat):
    """``TrainRun(mesh_shape=(1, 1))`` at SMOKE size on the card (a one-rank
    NCCL group, DTensor parameters, K7/K7b on local shards) against the run
    without a mesh: losses and final parameters bit for bit."""
    import dataclasses

    from repro_torch.launch.train import TrainRun
    from repro_torch.models import registry
    from repro_torch.optim import adamw

    get = registry.get_config
    monkeypatch.setattr(registry, "get_config", lambda a, smoke=False: dataclasses.replace(
        get(a, smoke=smoke), remat=remat))
    kw = dict(arch=arch, smoke=True, steps=2, batch=2, seq=64, log_every=100)
    mesh = TrainRun(mesh_shape=(1, 1), **kw).run()
    plain = TrainRun(**kw).run()
    assert mesh["losses"] == plain["losses"]
    for a, b in zip(adamw.tree_leaves(mesh["params"]), adamw.tree_leaves(plain["params"]),
                    strict=True):
        assert torch.equal(a.detach().to_local(), b.detach())
