"""Port parity, RCLL state and rebuild: cell packing (argsort and
counting-sort branches), the fused statepack permutation, the Eq. (8)
advance, and every case's ``build()``.

All bit-exact: these are integer permutations, bitcasts and elementwise
fp32/fp16 arithmetic evaluated op by op in both packages.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.core import cases as jcases
from repro.core import cells as jcells
from repro.core import domain as jd
from repro.core import rcll as jrcll
from repro.core import statepack as jsp
from repro_torch.core import cases as tcases
from repro_torch.core import cells as tcells
from repro_torch.core import domain as td
from repro_torch.core import interop
from repro_torch.core import rcll as trcll
from repro_torch.core import statepack as tsp
from test_torch_helpers import one_torch_thread  # noqa: F401  (autouse fixture)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _bits_equal(a, b):
    a, b = np.atleast_1d(_np(a)), np.atleast_1d(_np(b))
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype, a.shape, b.shape)
    np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


def _cloud(spec, n, seed):
    rng = np.random.default_rng(seed)
    dj, dt = jd.Domain(**spec), td.Domain(**spec)
    lo, hi = np.asarray(spec["lo"]), np.asarray(spec["hi"])
    x = (lo + rng.uniform(0, 1, (n, dj.dim)) * (hi - lo)).astype(np.float32)
    rj = jrcll.init_state(dj, dj.normalize(jnp.asarray(x)), jnp.float16)
    rt = trcll.init_state(dt, dt.normalize(torch.as_tensor(x)), torch.float16)
    return rng, dj, dt, rj, rt


SPECS = [
    dict(lo=(0.0, 0.0), hi=(1.0, 1.0), h=0.03, periodic=(True, True), cell_factor=1.5),
    dict(lo=(-0.15, -0.15), hi=(2.15, 1.3), h=0.06, cell_factor=1.5),
    dict(lo=(0.0, 0.0, 0.0), hi=(1.0, 1.0, 1.0), h=0.05, periodic=(True, False, True)),
]


def _assert_packing_equal(pj, pt):
    _bits_equal(pj.rc.rel, pt.rc.rel)
    _bits_equal(pj.rc.cell_xy, pt.rc.cell_xy)
    _bits_equal(pj.packing.order, pt.packing.order)
    _bits_equal(pj.packing.inverse, pt.packing.inverse)
    bj, bt = pj.packing.binning, pt.packing.binning
    for f in ("table", "counts", "cell_id", "cell_xy", "order", "overflow"):
        _bits_equal(getattr(bj, f), getattr(bt, f))


@pytest.mark.parametrize("spec", SPECS)
def test_pack_argsort_and_counting_sort_match_jax(spec):
    n = 900
    rng, dj, dt, rj, rt = _cloud(spec, n, seed=len(str(spec)))
    _bits_equal(rj.rel, rt.rel)
    _bits_equal(rj.cell_xy, rt.cell_xy)
    cap = jcells.default_capacity(dj, n, safety=6.0)
    assert cap == tcells.default_capacity(dt, n, safety=6.0)
    pj = jrcll.pack_state(dj, rj, cap)  # cold start: stable argsort
    pt = trcll.pack_state(dt, rt, cap)
    _assert_packing_equal(pj, pt)
    # advance by < one cell so particles migrate to adjacent cells, then
    # re-pack against the previous binning: the counting-sort branch
    dxn = (rng.uniform(-1, 1, (n, dj.dim)) * 0.6 * dj.hc_ref).astype(np.float32)
    aj = jrcll.advance(dj, pj.rc, jnp.asarray(dxn))
    at = trcll.advance(dt, pt.rc, torch.as_tensor(dxn))
    _bits_equal(aj.rel, at.rel)
    _bits_equal(aj.cell_xy, at.cell_xy)
    assert np.any(np.asarray(aj.cell_xy) != np.asarray(pj.rc.cell_xy))
    qj = jrcll.pack_state(dj, aj, cap, prev=pj.packing.binning)
    qt = trcll.pack_state(dt, at, cap, prev=pt.packing.binning)
    _assert_packing_equal(qj, qt)
    # and the counting sort IS the stable argsort permutation
    cid = dt.flat_cell_id(at.cell_xy)
    want = torch.argsort(cid, stable=True).to(torch.int32)
    _bits_equal(qt.packing.order, want)


def test_pack_far_mover_takes_argsort_branch():
    spec = SPECS[1]
    n = 600
    rng, dj, dt, rj, rt = _cloud(spec, n, seed=5)
    cap = jcells.default_capacity(dj, n, safety=6.0)
    pj, pt = jrcll.pack_state(dj, rj, cap), trcll.pack_state(dt, rt, cap)
    dxn = np.zeros((n, 2), np.float32)
    dxn[7] = 3.5 * dj.hc_ref  # one particle jumps three cells
    aj = jrcll.advance(dj, pj.rc, jnp.asarray(dxn))
    at = trcll.advance(dt, pt.rc, torch.as_tensor(dxn))
    assert int(np.abs(np.asarray(aj.cell_xy) - np.asarray(pj.rc.cell_xy)).max()) > 1
    qj = jrcll.pack_state(dj, aj, cap, prev=pj.packing.binning)
    qt = trcll.pack_state(dt, at, cap, prev=pt.packing.binning)
    _assert_packing_equal(qj, qt)


def test_pack_helpers_match():
    rng = np.random.default_rng(2)
    counts = rng.integers(0, 9, 50).astype(np.int32)
    _bits_equal(jcells.exclusive_cumsum(jnp.asarray(counts)),
                tcells.exclusive_cumsum(torch.as_tensor(counts)))
    for a, b in zip(jcells._packed_table(50, jnp.asarray(counts), 6),
                    tcells._packed_table(50, torch.as_tensor(counts), 6)):
        _bits_equal(a, b)
    perm = rng.permutation(77).astype(np.int32)
    _bits_equal(jcells.inverse_permutation(jnp.asarray(perm)),
                tcells.inverse_permutation(torch.as_tensor(perm)))
    np.testing.assert_array_equal(jcells.neighbor_cell_offsets(3),
                                  tcells.neighbor_cell_offsets(3))
    dom_j, dom_t = jd.Domain(**SPECS[1]), td.Domain(**SPECS[1])
    assert jcells.robust_capacity(dom_j, 0.05, 5000) == tcells.robust_capacity(dom_t, 0.05, 5000)
    assert jcells.dense_capacity(dom_j, 0.05) == tcells.dense_capacity(dom_t, 0.05)


def test_cell_major_round_trip_matches_jax():
    spec = SPECS[0]
    n = 700
    rng, dj, dt, rj, rt = _cloud(spec, n, seed=9)
    cap = jcells.default_capacity(dj, n, safety=6.0)
    bj = jrcll.pack_state(dj, rj, cap).packing.binning
    bt = trcll.pack_state(dt, rt, cap).packing.binning
    f = rng.normal(size=(n, 3)).astype(np.float32)
    tj = jcells.to_cell_major(bj, jnp.asarray(f), fill=-2.0)
    tt = tcells.to_cell_major(bt, torch.as_tensor(f), fill=-2.0)
    _bits_equal(tj, tt)
    _bits_equal(jcells.from_cell_major(bj, tj), tcells.from_cell_major(bt, tt))
    np.testing.assert_array_equal(tcells.from_cell_major(bt, tt).numpy(), f)


def test_statepack_round_trip_bit_exact():
    rng = np.random.default_rng(4)
    n = 257
    f32 = rng.normal(size=(n, 2)).astype(np.float32)
    f32[:3, 0] = [np.nan, -0.0, np.inf]
    fields_np = [
        f32,
        rng.normal(size=(n,)).astype(np.float16),
        rng.integers(-2**31, 2**31 - 1, (n, 3), dtype=np.int64).astype(np.int32),
        rng.random(n) < 0.3,
        rng.integers(-128, 127, n).astype(np.int8),
        None,
        rng.normal(size=(n, 2)).astype(np.float32).view(np.int32) | 0x7FC00001,
    ]
    bf16 = torch.as_tensor(rng.normal(size=(n, 2)).astype(np.float32)).to(torch.bfloat16)
    fields_t = tuple(None if f is None else torch.as_tensor(f) for f in fields_np) + (bf16,)
    perm = rng.permutation(n).astype(np.int32)
    out = tsp.permute_fields(fields_t, torch.as_tensor(perm))
    pl = torch.as_tensor(perm).long()
    for f, o in zip(fields_t, out):
        if f is None:
            assert o is None
            continue
        assert o.dtype == f.dtype and o.shape == f.shape
        _bits_equal(o.view(torch.int16) if o.dtype == torch.bfloat16 else o,
                    f[pl].view(torch.int16) if f.dtype == torch.bfloat16 else f[pl])
    # and equal to the JAX fused permutation on the fields both packages hold
    fields_j = tuple(None if f is None else jnp.asarray(f) for f in fields_np)
    out_j = jsp.permute_fields(fields_j, jnp.asarray(perm))
    for oj, ot in zip(out_j, out):
        if oj is not None:
            _bits_equal(oj, ot)


@pytest.mark.parametrize("spec", [SPECS[0], SPECS[1]])
def test_advance_fp16_bit_exact(spec):
    """Eq. (8) in fp16 from identical inputs, including multi-cell moves,
    periodic wraps and the near-edge pin of non-periodic exits."""
    n = 1000
    rng, dj, dt, rj, rt = _cloud(spec, n, seed=11)
    dxn = (rng.normal(size=(n, 2)) * 0.7 * dj.hc_ref).astype(np.float32)
    dxn[:20] *= 8.0
    for _ in range(3):
        rj = jrcll.advance(dj, rj, jnp.asarray(dxn))
        rt = trcll.advance(dt, rt, torch.as_tensor(dxn))
        _bits_equal(rj.rel, rt.rel)
        _bits_equal(rj.cell_xy, rt.cell_xy)
    _bits_equal(jrcll.to_normalized(dj, rj), trcll.to_normalized(dt, rt))


def _jax_fields(st):
    d = {"xn": st.xn, "rc.cell_xy": st.rc.cell_xy, "rc.rel": st.rc.rel,
         "fluid.v": st.fluid.v, "fluid.rho": st.fluid.rho, "fluid.m": st.fluid.m,
         "fixed": st.fixed, "t": st.t, "kind": st.kind, "v_wall": st.v_wall}
    return {k: np.asarray(v) for k, v in d.items() if v is not None}


@pytest.mark.parametrize("name,kw", [
    ("taylor_green", dict(ds=1 / 16)),
    ("dam_break", dict(ds=0.1, v0=1.0, cell_factor=1.5)),
    ("cavity", dict(ds=0.1)),
    ("poiseuille", dict(ds=0.1, Lx=0.8)),
])
def test_case_build_bit_identical(name, kw):
    cj, sj = jcases.build_case(name, **kw).build()
    ct, st = tcases.build_case(name, **kw).build(device="cpu")
    a, b = _jax_fields(sj), interop.state_to_numpy(st)
    assert a.keys() == b.keys()
    for k in a:
        _bits_equal(a[k], b[k])
    assert cj.dt == ct.dt and cj.ds == ct.ds
    assert cj.domain.ncells == ct.domain.ncells
    assert cj.cap(len(a["xn"])) == ct.cap(len(b["xn"]))
    sj_, st_ = cj.resolved_scheme, ct.resolved_scheme
    for f in ("c0", "rho0", "eos", "gamma", "viscosity", "mu", "alpha", "delta", "body_force"):
        assert getattr(sj_, f) == getattr(st_, f), f
    # interop round trip is exact
    back = interop.state_to_numpy(interop.state_from_numpy(b, "cpu"))
    for k in b:
        _bits_equal(b[k], back[k])


def test_resolve_ds_and_registry_match():
    assert jcases.case_names() == tcases.case_names()
    for name in tcases.case_names():
        assert jcases.resolve_ds(name, 5000) == tcases.resolve_ds(name, 5000)
    with pytest.raises(ValueError, match="unknown case"):
        tcases.build_case("nope")
