"""Port parity, the NNPS path: binning, the three searches, their
accuracy counters, the Eq. (7) decode and the SPH gradient operators.

The same seeded inputs go through the JAX function (eager, as the JAX
package's oracles are called) and its port:

  * binning, candidate gathers and every search (ids, masks, counts) are
    bit-identical: integer work, and elementwise arithmetic rounded op by
    op in both packages, with sums over the 2-3 axes accumulated in fp32
    as XLA's reduce does (``nnps._sum_last``);
  * the decode and the gradient operators agree within fp32 rounding of
    their sums over the K neighbors (rtol 1e-5, atol 1e-6 of the scale).
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.core import cases as jcases
from repro.core import cells as jcells
from repro.core import domain as jd
from repro.core import nnps as jnnps
from repro.core import rcll as jrcll
from repro.core import sph as jsph
from repro_torch.core import cases as tcases
from repro_torch.core import cells as tcells
from repro_torch.core import domain as td
from repro_torch.core import interop
from repro_torch.core import nnps as tnnps
from repro_torch.core import rcll as trcll
from repro_torch.core import sph as tsph
from test_torch_helpers import one_torch_thread  # noqa: F401  (autouse fixture)

JDT = {"fp16": jnp.float16, "bf16": jnp.bfloat16, "fp32": jnp.float32}
TDT = {"fp16": torch.float16, "bf16": torch.bfloat16, "fp32": torch.float32}

SPECS = {
    "2d": dict(lo=(0.0, 0.0), hi=(1.0, 1.0), h=0.03),
    "2d_periodic": dict(lo=(0.0, 0.0), hi=(1.0, 1.0), h=0.03, periodic=(True, True),
                        cell_factor=1.5),
    "3d": dict(lo=(0.0, 0.0, 0.0), hi=(1.0, 1.0, 1.0), h=0.06),
    "3d_periodic": dict(lo=(-0.1, 0.0, 0.0), hi=(1.1, 1.0, 0.9), h=0.06,
                        periodic=(True, False, True)),
}


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _equal(a, b):
    a, b = np.atleast_1d(_np(a)), np.atleast_1d(_np(b))
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_array_equal(a, b)


def _assert_lists_equal(nj, nt):
    for f in ("idx", "mask", "count"):
        _equal(getattr(nj, f), getattr(nt, f))


def _cloud(spec, n, seed, storage="fp16"):
    """The same cloud in both packages: JAX's state, carried across."""
    rng = np.random.default_rng(seed)
    dj, dt = jd.Domain(**spec), td.Domain(**spec)
    lo, hi = np.asarray(spec["lo"]), np.asarray(spec["hi"])
    x = (lo + rng.uniform(0, 1, (n, dj.dim)) * (hi - lo)).astype(np.float32)
    xn_j = dj.normalize(jnp.asarray(x))
    st_j = jrcll.init_state(dj, xn_j, JDT[storage])
    st_t = interop.fields_from_numpy(
        trcll.RCLLState, {"cell_xy": np.asarray(st_j.cell_xy), "rel": np.asarray(st_j.rel)},
        "cpu")
    return dj, dt, x, xn_j, torch.tensor(np.asarray(xn_j)), st_j, st_t


def test_unit_domains_match_jax():
    for make in ("unit_square", "unit_cube"):
        a, b = getattr(jd, make)(0.05, cell_factor=1.5), getattr(td, make)(0.05, cell_factor=1.5)
        assert (a.lo, a.hi, a.h, a.ncells, a.cell_sizes) == (b.lo, b.hi, b.h, b.ncells,
                                                              b.cell_sizes)


@pytest.mark.parametrize("spec", list(SPECS), ids=list(SPECS))
def test_binning_and_candidates_match_jax(spec):
    dj, dt, x, xn_j, xn_t, st_j, st_t = _cloud(SPECS[spec], N, seed=1)
    cap = 3  # small enough that some cells overflow
    bj = jcells.bin_particles(dj, xn_j, cap)
    bt = tcells.bin_particles(dt, xn_t, cap)
    assert int(bj.overflow) > 0
    for f in bj._fields:
        _equal(getattr(bj, f), getattr(bt, f))
    bj = jcells.bin_by_cell_id(dj, dj.flat_cell_id(st_j.cell_xy), st_j.cell_xy, 4 * cap)
    bt = tcells.bin_by_cell_id(dt, dt.flat_cell_id(st_t.cell_xy), st_t.cell_xy, 4 * cap)
    for f in bj._fields:
        _equal(getattr(bj, f), getattr(bt, f))
    for a, b in zip(jcells.candidate_cells(dj, st_j.cell_xy),
                    tcells.candidate_cells(dt, st_t.cell_xy)):
        _equal(a, b)
    for a, b in zip(jcells.gather_candidates(dj, bj), tcells.gather_candidates(dt, bt)):
        _equal(a, b)
    # the binning crosses over unchanged
    back = interop.fields_from_numpy(tcells.CellBinning, interop.fields_to_numpy(bt), "cpu")
    for f in bt._fields:
        _equal(getattr(bt, f), getattr(back, f))


def test_select_k_keeps_candidate_order_like_top_k():
    rng = np.random.default_rng(3)
    cand = rng.integers(0, 1000, (64, 40)).astype(np.int32)
    ok = rng.uniform(size=(64, 40)) < 0.3
    for k in (8, 40, 50):
        ij, mj = jnnps.select_k(jnp.asarray(cand), jnp.asarray(ok), k)
        it, mt = tnnps.select_k(torch.as_tensor(cand), torch.as_tensor(ok), k)
        _equal(ij, it)
        _equal(mj, mt)


#: One particle count for every test, so JAX's eager op cache is reused.
N = 600


@pytest.mark.parametrize("spec,dtype", [("2d_periodic", "fp16"), ("3d", "fp32")])
def test_all_list_search_matches_jax(spec, dtype):
    dj, dt, x, xn_j, xn_t, *_ = _cloud(SPECS[spec], N, seed=2)
    kw = dict(k=40, include_self=False)
    nj = jnnps.all_list_neighbors(xn_j, dj.radius_norm, dtype=JDT[dtype], domain=dj, **kw)
    nt = tnnps.all_list_neighbors(xn_t, dt.radius_norm, dtype=TDT[dtype], domain=dt, **kw)
    _assert_lists_equal(nj, nt)
    # row blocks give the same lists and counts
    _assert_lists_equal(nj, tnnps.all_list_neighbors(xn_t, dt.radius_norm, dtype=TDT[dtype],
                                                     domain=dt, block=96, **kw))
    _equal(jnnps.all_list_count(xn_j, dj.radius_norm, dtype=JDT[dtype], domain=dj),
           tnnps.all_list_count(xn_t, dt.radius_norm, dtype=TDT[dtype], domain=dt, block=96))


@pytest.mark.parametrize("spec,dtype", [
    ("2d", "fp16"), ("2d_periodic", "fp32"), ("3d", "fp32"), ("3d_periodic", "fp16"),
])
def test_cell_list_search_matches_jax(spec, dtype):
    dj, dt, x, xn_j, xn_t, *_ = _cloud(SPECS[spec], N, seed=3)
    nj = jnnps.cell_list_neighbors(dj, xn_j, dtype=JDT[dtype], k=48)
    nt = tnnps.cell_list_neighbors(dt, xn_t, dtype=TDT[dtype], k=48)
    _assert_lists_equal(nj, nt)
    assert not bool(nt.overflowed)


@pytest.mark.parametrize("spec,storage,compute", [
    ("2d", "fp16", "fp32"), ("2d", "bf16", "fp32"), ("2d", "fp16", "fp16"),
    ("2d_periodic", "fp32", "fp32"), ("2d_periodic", "fp16", "fp16"),
    ("3d", "fp16", "fp32"), ("3d_periodic", "fp16", "fp16"), ("3d_periodic", "bf16", "fp32"),
])
def test_rcll_search_matches_jax(spec, storage, compute):
    """fp16 compute is held against JAX called eagerly: under jit XLA keeps
    fp32 between fused fp16 ops and decides boundary pairs differently."""
    dj, dt, x, xn_j, xn_t, st_j, st_t = _cloud(SPECS[spec], N, seed=4, storage=storage)
    kw = dict(k=48, include_self=False)
    nj = jnnps.rcll_neighbors(dj, st_j.rel, st_j.cell_xy, dtype=JDT[storage],
                              compute_dtype=JDT[compute], **kw)
    nt = tnnps.rcll_neighbors(dt, st_t.rel, st_t.cell_xy, dtype=TDT[storage],
                              compute_dtype=TDT[compute], **kw)
    _assert_lists_equal(nj, nt)
    # the list crosses over unchanged, and refilter/pair_r2_cell agree
    back = interop.fields_from_numpy(tnnps.NeighborList, interop.fields_to_numpy(nt), "cpu")
    _assert_lists_equal(nt, back)
    d2j = jrcll.pair_r2_cell(dj, st_j, nj, dtype=JDT[storage], compute_dtype=JDT[compute])
    d2t = trcll.pair_r2_cell(dt, st_t, nt, dtype=TDT[storage], compute_dtype=TDT[compute])
    np.testing.assert_array_equal(np.asarray(d2j, np.float32), d2t.float().numpy())
    r2 = 0.8 * tnnps.rcll_radius_cell_units(dt) ** 2
    _assert_lists_equal(jnnps.refilter(nj, d2j, r2), tnnps.refilter(nt, d2t, r2))


def test_rcll_neighbors_entry_matches_jax():
    dj, dt, x, xn_j, xn_t, st_j, st_t = _cloud(SPECS["2d_periodic"], N, seed=5)
    nj, bj = jrcll.neighbors(dj, st_j, k=48)
    nt, bt = trcll.neighbors(dt, st_t, k=48)
    _assert_lists_equal(nj, nt)
    for f in bj._fields:
        _equal(getattr(bj, f), getattr(bt, f))


@pytest.mark.parametrize("spec", ["2d", "3d_periodic"])
def test_accuracy_counters_match_jax(spec):
    """Table 2's counters on the same lists: fp64/fp32 truth against the
    fp16 absolute-coordinate search (approach II) and fp16 RCLL."""
    dj, dt, x, xn_j, xn_t, st_j, st_t = _cloud(SPECS[spec], N, seed=6)
    truth_j = jnnps.reference_neighbors(dj, xn_j, k=64)  # fp32 without jax x64
    truth_t = tnnps.reference_neighbors(dt, xn_t, k=64, dtype=torch.float32)
    _assert_lists_equal(truth_j, truth_t)
    tests = [
        (jnnps.cell_list_neighbors(dj, xn_j, dtype=jnp.float16, k=48),
         tnnps.cell_list_neighbors(dt, xn_t, dtype=torch.float16, k=48)),
        (jnnps.rcll_neighbors(dj, st_j.rel, st_j.cell_xy, k=48),
         tnnps.rcll_neighbors(dt, st_t.rel, st_t.cell_xy, k=48)),
    ]
    for nj, nt in tests:
        _assert_lists_equal(nj, nt)
        assert int(jnnps.count_wrong_determinations(truth_j, nj)) == int(
            tnnps.count_wrong_determinations(truth_t, nt))
        k = truth_t.idx.shape[1]
        pad = lambda nl: tnnps.NeighborList(
            torch.nn.functional.pad(nl.idx, (0, k - nl.idx.shape[1])),
            torch.nn.functional.pad(nl.mask, (0, k - nl.mask.shape[1])), nl.count)
        padj = lambda nl: jnnps.NeighborList(
            jnp.pad(nl.idx, ((0, 0), (0, k - nl.idx.shape[1]))),
            jnp.pad(nl.mask, ((0, 0), (0, k - nl.mask.shape[1]))), nl.count)
        _equal(jnnps.neighbor_sets_equal(truth_j, padj(nj)),
               tnnps.neighbor_sets_equal(truth_t, pad(nt)))
    # a list with every third slot of the truth dropped: a known, nonzero count
    keep = np.arange(truth_t.idx.shape[1]) % 3 != 0
    thin_j = truth_j._replace(mask=truth_j.mask & jnp.asarray(keep))
    thin_t = truth_t._replace(mask=truth_t.mask & torch.as_tensor(keep))
    dropped = int((truth_t.mask & ~torch.as_tensor(keep)).sum())
    assert dropped > 0
    assert int(jnnps.count_wrong_determinations(truth_j, thin_j)) == dropped
    assert int(tnnps.count_wrong_determinations(truth_t, thin_t)) == dropped
    assert int(tnnps.count_wrong_determinations(thin_t, truth_t)) == dropped
    assert int(tnnps.count_wrong_determinations(truth_t, truth_t)) == 0
    # the fp64 truth of the port (no JAX counterpart without x64)
    xn64 = dt.normalize(torch.as_tensor(x, dtype=torch.float64), dtype=torch.float64)
    t64 = tnnps.reference_neighbors(dt, xn64, k=64)
    assert t64.idx.dtype == torch.int32 and not bool(t64.overflowed)


@pytest.mark.parametrize("spec", ["2d_periodic", "3d_periodic"])
def test_decode_and_gradient_operators_match_jax(spec):
    dj, dt, x, xn_j, xn_t, st_j, st_t = _cloud(SPECS[spec], N, seed=7)
    nj = jnnps.rcll_neighbors(dj, st_j.rel, st_j.cell_xy, k=48)
    nt = tnnps.rcll_neighbors(dt, st_t.rel, st_t.cell_xy, k=48)
    _assert_lists_equal(nj, nt)
    dispj, rj = jrcll.pair_displacements(dj, st_j, nj)
    dispt, rt = trcll.pair_displacements(dt, st_t, nt)
    scale = float(np.abs(np.asarray(dispj)).max())
    np.testing.assert_allclose(dispt.numpy(), np.asarray(dispj), rtol=1e-6, atol=1e-6 * scale)
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=1e-6, atol=1e-6 * scale)
    rng = np.random.default_rng(8)
    n = x.shape[0]
    f = (x[:, 0] ** 3 + rng.normal(size=n) * 0.01).astype(np.float32)
    vol = np.full(n, 1.0 / n, np.float32)
    fj, ft = jnp.asarray(f), torch.as_tensor(f)
    gwj = jsph.grad_w(dispj, rj, dj.h, dj.dim, nj.mask)
    gwt = tsph.grad_w(dispt, rt, dt.h, dt.dim, nt.mask)
    gscale = float(np.abs(np.asarray(gwj)).max())
    np.testing.assert_allclose(gwt.numpy(), np.asarray(gwj), rtol=1e-5, atol=1e-6 * gscale)
    xq_j = jrcll.to_normalized(dj, st_j)
    xq_t = torch.tensor(np.asarray(xq_j))
    outs = [
        (jsph.gradient_standard(fj, jnp.asarray(vol), nj.idx, gwj),
         tsph.gradient_standard(ft, torch.as_tensor(vol), nt.idx, gwt)),
        (jsph.gradient_normalized(fj, xq_j, nj.idx, nj.mask, gwj),
         tsph.gradient_normalized(ft, xq_t, nt.idx, nt.mask, gwt)),
        (jsph.gradient_normalized_pairs(fj, dispj, rj, nj.idx, nj.mask, dj.h, dj.dim),
         tsph.gradient_normalized_pairs(ft, dispt, rt, nt.idx, nt.mask, dt.h, dt.dim)),
    ]
    for a, b in outs:
        a = np.asarray(a)
        np.testing.assert_allclose(b.numpy(), a, rtol=1e-5, atol=1e-6 * np.abs(a).max())


def test_gradient_test_particles_match_jax():
    for dim, ds in ((2, 1 / 32), (3, 1 / 12)):
        dj, xj = jcases.gradient_test_particles(ds, dim=dim)
        dt, xt = tcases.gradient_test_particles(ds, dim=dim)
        assert (dj.lo, dj.hi, dj.h, dj.ncells) == (dt.lo, dt.hi, dt.h, dt.ncells)
        np.testing.assert_array_equal(xj, xt)
        np.testing.assert_array_equal(
            np.asarray(jcases.cubic_gradient_x(xj)), tcases.cubic_gradient_x(xt))
        np.testing.assert_allclose(tcases.cubic_field(torch.as_tensor(xt)).numpy(),
                                   np.asarray(jcases.cubic_field(xj)), rtol=1e-15)


def test_rcll_search_mirrors_jax_cell_overflow():
    """ROADMAP Queue 3 entry A, recorded, not fixed: at the hypothesis
    example of ``tests/test_nnps.py::test_property_rcll_equals_alllist``
    (n = 64, seed = 2147483646, not periodic) cell (0, 0) holds 15
    particles, one more than ``default_capacity``'s 14, so the dense-table
    RCLL search drops particle 63 and makes 15 wrong determinations
    against the all-list search. The port does the same as JAX: the same
    lists, the same count, the same dropped particle and a binning
    overflow of 1."""
    n, seed = 64, 2147483646
    rng = np.random.default_rng(seed)
    ds = (1.0 / n) ** 0.5
    spec = dict(lo=(0.0, 0.0), hi=(1.0, 1.0), h=1.2 * ds, periodic=(False, False))
    dj, dt = jd.Domain(**spec), td.Domain(**spec)
    xn_j = dj.normalize(jnp.asarray(rng.uniform(0, 1, (n, 2))))
    xn_t = torch.tensor(np.asarray(xn_j))
    k = 80
    aj = jnnps.all_list_neighbors(xn_j, dj.radius_norm, dtype=jnp.float32, k=k)
    at = tnnps.all_list_neighbors(xn_t, dt.radius_norm, dtype=torch.float32, k=k)
    _assert_lists_equal(aj, at)
    st_j = jrcll.init_state(dj, xn_j, dtype=jnp.float32)
    st_t = trcll.init_state(dt, xn_t, dtype=torch.float32)
    _equal(st_j.cell_xy, st_t.cell_xy)
    rj = jnnps.rcll_neighbors(dj, st_j.rel, st_j.cell_xy, dtype=jnp.float32, k=k)
    rt = tnnps.rcll_neighbors(dt, st_t.rel, st_t.cell_xy, dtype=torch.float32, k=k)
    _assert_lists_equal(rj, rt)
    assert int(at.count.max()) < k  # no k overflow: the test's comparison applies
    assert int(jnnps.count_wrong_determinations(aj, rj)) == 15
    assert int(tnnps.count_wrong_determinations(at, rt)) == 15
    cap = tcells.default_capacity(dt, n)
    assert cap == jcells.default_capacity(dj, n) == 14
    bj = jcells.bin_by_cell_id(dj, dj.flat_cell_id(st_j.cell_xy), st_j.cell_xy, cap)
    bt = tcells.bin_by_cell_id(dt, dt.flat_cell_id(st_t.cell_xy), st_t.cell_xy, cap)
    for f in bj._fields:
        _equal(getattr(bj, f), getattr(bt, f))
    assert int(bt.overflow) == 1 and int(bt.counts.max()) == 15
    kept = bt.table[bt.table >= 0]
    assert sorted(set(range(n)) - set(kept.tolist())) == [63]
    # the dropped particle is missing from each of its 15 neighbors' lists
    assert int(((at.idx == 63) & at.mask).sum()) == 15
    assert not bool(((rt.idx == 63) & rt.mask).any())
