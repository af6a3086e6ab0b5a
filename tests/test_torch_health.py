"""Port parity, the health word: ``check_carry``, ``check_batch``,
``inject_fault`` and ``cells.max_neighborhood_occupancy`` of the port
against the JAX package's on the same seeded inputs
(``tests/faults.py`` and its port ``tests/torch_faults.py``).

Both packages pack the same initial state into the same order (a stable
sort by cell id), so a carry built by each holds the same particle in
the same packed slot. The word, the counts and the occupancy are
integers and must be equal; the float stats are the same fp32 ops in
the same order (a sum of d squares, a sqrt, a max; a division by rho0),
and are held equal too. JAX's ``"pallas"`` backend is held against the
port's ``"kernel"``, JAX's ``"xla"`` against the port's ``"xla"``.
"""
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import faults
import torch_faults
from repro.core import cells as jcells
from repro.core import domain as jd
from repro.core import health as jhealth
from repro.core import solver as jsolver
from repro_torch.core import cells as tcells
from repro_torch.core import domain as td
from repro_torch.core import health as thealth
from repro_torch.core import solver as tsolver
from test_torch_helpers import one_torch_thread  # noqa: F401  (autouse fixture)

BACKENDS = [("xla", "xla"), ("pallas", "kernel")]


def _carries(jax_backend, torch_backend, **cfg_kw):
    cj, sj = faults.lattice(dict(backend=jax_backend, **cfg_kw))
    ct, st = torch_faults.lattice(dict(backend=torch_backend, **cfg_kw))
    return cj, jsolver.init_persistent(cj, sj), ct, tsolver.init_persistent(ct, st)


def _poison(name, cj, kj, ct, kt):
    """The same corruption of both packages' carries (and configs)."""
    fj, ft = kj.st.fluid, kt.st.fluid
    if name == "nan_v":
        kj = kj._replace(st=kj.st._replace(fluid=fj._replace(v=fj.v.at[3, 0].set(jnp.nan))))
        v = ft.v.clone()
        v[3, 0] = float("nan")
        kt = kt._replace(st=kt.st._replace(fluid=ft._replace(v=v)))
    elif name == "nan_x":
        rj = kj.st.rc
        kj = kj._replace(st=kj.st._replace(rc=rj._replace(rel=rj.rel.at[2, 1].set(jnp.nan))))
        rel = kt.st.rc.rel.clone()
        rel[2, 1] = float("nan")
        kt = kt._replace(st=kt.st._replace(rc=kt.st.rc._replace(rel=rel)))
    elif name == "nan_rho":
        kj = kj._replace(st=kj.st._replace(fluid=fj._replace(rho=fj.rho.at[5].set(jnp.inf))))
        rho = ft.rho.clone()
        rho[5] = float("inf")
        kt = kt._replace(st=kt.st._replace(fluid=ft._replace(rho=rho)))
    elif name == "rho_dev":
        kj = kj._replace(st=kj.st._replace(fluid=fj._replace(rho=fj.rho * 2.0)))
        kt = kt._replace(st=kt.st._replace(fluid=ft._replace(rho=ft.rho * 2.0)))
    elif name == "cfl":
        cj, ct = dataclasses.replace(cj, dt=1e3), dataclasses.replace(ct, dt=1e3)
    return cj, kj, ct, kt


def _assert_words_equal(hj, ht):
    assert int(ht.word) == int(hj.word)
    assert ht.word.dtype == torch.int32 and ht.word.shape == ()
    sj, st = hj.host_stats(), ht.host_stats()
    assert st == sj, (st, sj)


CORRUPTIONS = ["clean", "nan_v", "nan_x", "nan_rho", "rho_dev", "cfl"]


@pytest.mark.parametrize("backends", BACKENDS, ids=lambda b: f"{b[0]}-{b[1]}")
@pytest.mark.parametrize("name", CORRUPTIONS)
def test_check_carry_bits_and_stats_match_jax(backends, name):
    """Each numeric bit on the same carry in both packages, with the
    masked statistics (finite under NaN poisoning) equal."""
    cj, kj, ct, kt = _poison(name, *_carries(*backends))
    hj, ht = jhealth.check_carry(cj, kj), thealth.check_carry(ct, kt)
    _assert_words_equal(hj, ht)
    want = {"clean": 0, "nan_v": thealth.NAN_V, "nan_x": thealth.NAN_X,
            "nan_rho": thealth.NAN_RHO, "rho_dev": thealth.RHO_DEV, "cfl": thealth.CFL}[name]
    assert int(ht.word) == want
    stats = ht.host_stats()
    assert np.isfinite(stats["vmax"]) and np.isfinite(stats["rho_dev"])
    if name == "clean":
        assert stats["vmax"] > 0 and stats["bad_x"] == stats["bad_v"] == stats["bad_rho"] == 0


@pytest.mark.parametrize("backends", BACKENDS, ids=lambda b: f"{b[0]}-{b[1]}")
def test_cell_overflow_bit_matches_jax(backends):
    """An undersized capacity overflows at the init rebuild: the binning
    sentinel and the carry's flags both carry the bit; max_cell is the
    true (unclamped) occupancy."""
    cj, kj, ct, kt = _carries(*backends, capacity=2)
    hj, ht = jhealth.check_carry(cj, kj), thealth.check_carry(ct, kt)
    _assert_words_equal(hj, ht)
    assert int(ht.word) == thealth.CELL_OVERFLOW
    assert int(kt.flags) == thealth.CELL_OVERFLOW
    assert int(ht.max_cell) > 2


@pytest.mark.parametrize("backends", BACKENDS, ids=lambda b: f"{b[0]}-{b[1]}")
def test_window_trunc_bit_matches_jax_and_is_inert_on_kernel(backends):
    """A too-small window truncates the list backends' search; the
    kernel backend (JAX's pallas) carries a zero-width list, so the bit
    never trips there, in either package."""
    cj, kj, ct, kt = _carries(*backends, window=8)
    hj, ht = jhealth.check_carry(cj, kj), thealth.check_carry(ct, kt)
    _assert_words_equal(hj, ht)
    if backends[1] == "kernel":
        assert kt.nl.mask.shape[1] == 0 and int(ht.word) == 0 and int(ht.max_count) == 0
    else:
        assert int(ht.word) == thealth.WINDOW_TRUNC


def test_enabled_mask_suppresses():
    _, _, ct, kt = _carries("xla", "xla")
    v = kt.st.fluid.v.clone()
    v[0, 0] = float("nan")
    kt = kt._replace(st=kt.st._replace(fluid=kt.st.fluid._replace(v=v)))
    enabled = thealth.ALL_CHECKS & ~(thealth.NAN_V | thealth.NAN_X | thealth.NAN_RHO)
    assert int(thealth.check_carry(ct, kt, enabled=enabled).word) == 0
    assert int(thealth.check_carry(ct, kt).word) == thealth.NAN_V


def test_check_names_constants_and_faultspec_validation():
    for name in ("NAN_X", "NAN_V", "NAN_RHO", "RHO_DEV", "CFL", "WINDOW_TRUNC",
                 "CELL_OVERFLOW", "ALL_CHECKS", "NUMERIC_CHECKS", "CAPACITY_CHECKS",
                 "DEFAULT_RHO_DEV_LIMIT", "DEFAULT_CFL_LIMIT"):
        assert getattr(thealth, name) == getattr(jhealth, name), name
    assert thealth.CHECK_NAMES == jhealth.CHECK_NAMES
    for word in (0, thealth.NAN_V | thealth.CELL_OVERFLOW, thealth.ALL_CHECKS):
        assert thealth.check_names(word) == jhealth.check_names(word)
    assert thealth.check_names(thealth.NAN_V | thealth.CELL_OVERFLOW) == ("nan_v", "cell_overflow")
    with pytest.raises(ValueError, match="unknown fault"):
        thealth.FaultSpec("bogus", step=1)
    assert (dataclasses.asdict(thealth.FaultSpec("teleport", step=3))
            == dataclasses.asdict(jhealth.FaultSpec("teleport", step=3)))


def _stack(carries):
    """A batch-leading carry from per-lane carries (host ints kept)."""
    def stack(*leaves):
        if leaves[0] is None:
            return None
        if isinstance(leaves[0], torch.Tensor):
            return torch.stack(leaves)
        if hasattr(leaves[0], "_fields"):
            return type(leaves[0])(*(stack(*col) for col in zip(*leaves)))
        return leaves[0]
    return stack(*carries)


def test_check_batch_equals_per_lane_check_carry_and_jax():
    """Two stacked carries (one healthy, one NaN-poisoned with a tighter
    per-lane dt): the batch word and stats equal two check_carry calls,
    and JAX's vmapped check_batch on the same lanes."""
    cj, kj0, ct, kt0 = _carries("xla", "xla")
    _, kj1, _, kt1 = _poison("nan_v", cj, kj0, ct, kt0)
    dt = torch.tensor([1e-3, 5e-4])
    hb = thealth.check_batch(ct, _stack([kt0, kt1]), dt=dt)
    assert hb.word.shape == (2,)
    for b, kt in enumerate((kt0, kt1)):
        one = thealth.check_carry(ct, kt, dt=dt[b])
        for f in thealth.HealthWord._fields:
            assert torch.equal(getattr(hb, f)[b], getattr(one, f)), f
    jb = jhealth.check_batch(cj, jax.tree.map(lambda *x: jnp.stack(x), kj0, kj1),
                             dt=jnp.asarray(dt.numpy()))
    np.testing.assert_array_equal(hb.word.numpy(), np.asarray(jb.word).astype(np.int32))
    np.testing.assert_array_equal(hb.bad_v.numpy(), np.asarray(jb.bad_v))
    np.testing.assert_array_equal(hb.cfl.numpy(), np.asarray(jb.cfl))


def _packed(k, torch_side):
    conv = (lambda t: t.numpy()) if torch_side else np.asarray
    return {"v": conv(k.st.fluid.v), "rel": conv(k.st.rc.rel),
            "cell_xy": conv(k.st.rc.cell_xy), "disp_acc": conv(k.disp_acc)}


@pytest.mark.parametrize("coords", ["fp16", "fp32"])
@pytest.mark.parametrize("kind", ["nan_v", "teleport"])
def test_inject_fault_matches_jax(kind, coords):
    """At the trip step both packages leave the same packed state (the
    teleport's offset added in the storage dtype, bit for bit); off the
    trip step nothing changes, and the carry passed in is not written."""
    from repro.core.precision import PrecisionPolicy as JPolicy
    from repro_torch.core.precision import PrecisionPolicy as TPolicy

    cj, sj = faults.lattice(dict(policy=JPolicy(coords=coords)))
    ct, st = torch_faults.lattice(dict(policy=TPolicy(coords=coords)))
    kj, kt = jsolver.init_persistent(cj, sj), tsolver.init_persistent(ct, st)
    kj = kj._replace(steps=jnp.asarray(5, jnp.int32), disp_acc=kj.disp_acc + 0.01)
    kt = kt._replace(steps=5, disp_acc=kt.disp_acc + 0.01)
    before = _packed(kt, True)
    before = {k: v.copy() for k, v in before.items()}
    fj = jhealth.FaultSpec(kind, step=5, particle=4, target=57)
    ft = thealth.FaultSpec(kind, step=5, particle=4, target=57)
    a, b = _packed(jhealth.inject_fault(fj, kj), False), _packed(thealth.inject_fault(ft, kt), True)
    for f in a:
        assert a[f].dtype == b[f].dtype and a[f].tobytes() == b[f].tobytes(), f
    assert any(a[f].tobytes() != before[f].tobytes() for f in a)
    for f, arr in _packed(kt, True).items():  # the input carry is untouched
        assert arr.tobytes() == before[f].tobytes(), f
    off = thealth.inject_fault(dataclasses.replace(ft, step=6), kt)
    assert off is kt


GEOMS = [((0.0, 0.0), (1.0, 0.6), (True, True)), ((0.0, 0.0), (1.0, 0.6), (False, True)),
         ((0.0, 0.0), (1.0, 0.6), (False, False)),
         ((0.0, 0.0, 0.0), (1.0, 0.8, 0.6), (True, False, True)),
         ((0.0, 0.0, 0.0), (1.0, 0.8, 0.6), (False, False, False))]


@pytest.mark.parametrize("lo,hi,periodic", GEOMS, ids=lambda v: str(v))
def test_max_neighborhood_occupancy_matches_jax(lo, hi, periodic):
    spec = dict(lo=lo, hi=hi, h=0.06, periodic=periodic)
    dj, dt = jd.Domain(**spec), td.Domain(**spec)
    rng = np.random.default_rng(len(lo) + sum(periodic))
    counts = rng.integers(0, 9, size=dt.ncells_total).astype(np.int32)
    counts[0] = 40  # a hot corner cell, so the boundary handling matters
    want = int(jcells.max_neighborhood_occupancy(dj, jnp.asarray(counts)))
    got = tcells.max_neighborhood_occupancy(dt, torch.tensor(counts))
    assert got.shape == () and int(got) == want
