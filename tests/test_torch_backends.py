"""Port parity, the list backends and the absolute algos: the merged-window
search, the fused ``"xla"`` sweep, the ``sph`` gather family, the
``"reference"`` backend and the ``"cell"``/``"all"`` paths, each against
the JAX package on the same seeded inputs.

Tolerances and where they come from:
  * the window search (ids, mask, count, trunc): bit-identical to eager
    JAX, integer work and Eq. (7) rounded op by op in both. The port's
    result does not depend on the chunking; JAX's ``lax.map`` compiles
    the chunk body, which keeps fp32 between fp16 ops (ROADMAP Queue 3,
    closed entries), so chunked runs are held to JAX's one-chunk (eager)
    lists;
  * ``fused.force_rhs`` is jitted in JAX (fp32 multiply-adds contracted),
    so each output is held within the rounding bound of its K-term sum,
    4 (K + 16) 2^-24 Σ|terms| (the bound K2's check derives,
    ``kernels/rcll_force.rounding_bound``), and, as a ceiling, within
    tests/test_fused_force.py:89-90 (rtol 2e-5; atol 1e-5 drho, 2e-3 acc);
  * the ``sph`` gather functions run eagerly in both packages; sums over
    the K neighbors agree within fp32 rounding (rtol 1e-5, atol 1e-6 of
    the scale), as tests/test_torch_nnps.py holds the gradient operators;
  * ``simulate_stats``: tests/test_torch_solver.py's slice tolerances
    (fp32 records: positions and density 1e-6, velocity nsteps·dt·1e-4
    for the contracted multiply-adds of jitted XLA; fp16 records: plus
    one storage quantum on positions). The fp16 absolute search (approach
    II) is held to JAX's ``_step_absolute`` stepped eagerly, the rounding
    the port reproduces; approach I (fp32) to the jitted run.
"""
import dataclasses

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.core import api as japi
from repro.core import cases as jcases
from repro.core import cells as jcells
from repro.core import domain as jd
from repro.core import fused as jfused
from repro.core import health as jhealth
from repro.core import nnps as jnnps
from repro.core import rcll as jrcll
from repro.core import solver as jsolver
from repro.core import sph as jsph
from repro.core.precision import PrecisionPolicy as JPolicy
from repro_torch.core import api as tapi
from repro_torch.core import cases as tcases
from repro_torch.core import domain as td
from repro_torch.core import fused as tfused
from repro_torch.core import health as thealth
from repro_torch.core import interop
from repro_torch.core import nnps as tnnps
from repro_torch.core import rcll as trcll
from repro_torch.core import scheme as tscheme
from repro_torch.core import solver as tsolver
from repro_torch.core import sph as tsph
from repro_torch.core.precision import PrecisionPolicy as TPolicy
from test_torch_helpers import one_torch_thread  # noqa: F401  (autouse fixture)

JDT = {"fp16": jnp.float16, "bf16": jnp.bfloat16, "fp32": jnp.float32}
TDT = {"fp16": torch.float16, "bf16": torch.bfloat16, "fp32": torch.float32}
C0, RHO0, MU = 1.25, 1.0, 1.0


def _np(x):
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


def _packed_cloud(dim, periodic, n, seed, storage="fp16", h=None, cell_factor=1.4):
    """A random cloud, RCLL-initialized and cell-packed by JAX, carried to
    the port: (JAX domain, port domain, JAX packed state, port rel,
    cell_xy, counts, capacity)."""
    rng = np.random.default_rng(seed)
    spec = dict(lo=(0.0,) * dim, hi=(1.0,) * dim, h=h or (0.07 if dim == 2 else 0.12),
                cell_factor=cell_factor, periodic=periodic)
    dj, dt = jd.Domain(**spec), td.Domain(**spec)
    x = rng.uniform(0, 1, (n, dim)).astype(np.float32)
    st = jrcll.init_state(dj, dj.normalize(jnp.asarray(x)), JDT[storage])
    cap = jcells.default_capacity(dj, n, safety=5.0)
    ps = jrcll.pack_state(dj, st, cap)
    rc = interop.fields_from_numpy(
        trcll.RCLLState, {"cell_xy": np.asarray(ps.rc.cell_xy), "rel": np.asarray(ps.rc.rel)},
        "cpu")
    counts = torch.tensor(np.asarray(ps.packing.binning.counts))
    return dj, dt, ps, rc, counts, cap


def _lists_equal(nj, nt):
    for f in ("idx", "mask", "count", "trunc"):
        np.testing.assert_array_equal(_np(getattr(nt, f)), np.asarray(getattr(nj, f)), err_msg=f)


# --------------------------------------------------------------------------
# the merged-window search
# --------------------------------------------------------------------------
WINDOW_GEOMS = [(2, (False, False)), (2, (True, False)), (2, (False, True)),
                (2, (True, True)), (3, (True, False, True)), (3, (False, False, False))]


@pytest.mark.parametrize("dim,periodic", WINDOW_GEOMS, ids=lambda v: str(v))
@pytest.mark.parametrize("storage,compute", [("fp16", "fp32"), ("fp16", "fp16"),
                                             ("fp32", "fp32"), ("bf16", "fp32")])
def test_window_search_bit_identical_to_jax(dim, periodic, storage, compute):
    """Ids, mask, count and trunc bit for bit, including self, a window
    below k (the pad), a window too small (the k + 1 sentinel and trunc)
    and every chunking (several chunks, a short last one)."""
    dj, dt, ps, rc, counts, cap = _packed_cloud(dim, periodic, 300, seed=dim + sum(periodic),
                                                storage=storage,
                                                h=0.08 if dim == 3 else None)
    wide = jnnps.auto_window(dj, capacity=cap)
    assert tnnps.auto_window(dt, capacity=cap) == wide
    for window, k, include_self in [(wide, 64, False), (6, 16, False), (wide, 8, True)]:
        kw = dict(k=k, window=window, include_self=include_self)
        nj = jnnps.rcll_neighbors_windows(
            dj, ps.rc.rel, ps.rc.cell_xy, ps.packing.binning.counts,
            dtype=JDT[storage], compute_dtype=JDT[compute], **kw)
        for chunk in (0, 100, 37):
            nt = tnnps.rcll_neighbors_windows(dt, rc.rel, rc.cell_xy, counts, dtype=TDT[storage],
                                              compute_dtype=TDT[compute], chunk=chunk, **kw)
            _lists_equal(nj, nt)
        if window == 6:  # too small: the sentinel and the trunc bit fire
            assert bool(nt.trunc) and bool(nt.overflowed)
            assert int(nt.count.max()) == k + 1


def test_window_search_chunked_matches_jax_chunked_at_fp32():
    """At the fp32 arithmetic of the production policy, JAX's own mapped
    (chunked, padded) search equals its eager one, and so does the port's."""
    dj, dt, ps, rc, counts, cap = _packed_cloud(2, (True, False), 500, seed=5)
    kw = dict(k=48, window=jnnps.auto_window(dj, capacity=cap))
    for chunk in (64, 333):
        nj = jnnps.rcll_neighbors_windows(
            dj, ps.rc.rel, ps.rc.cell_xy, ps.packing.binning.counts,
            dtype=jnp.float16, compute_dtype=jnp.float32, chunk=chunk, **kw)
        nt = tnnps.rcll_neighbors_windows(dt, rc.rel, rc.cell_xy, counts, dtype=torch.float16,
                                          compute_dtype=torch.float32, chunk=chunk, **kw)
        _lists_equal(nj, nt)


@pytest.mark.parametrize("radius_scale", [1.0, 1.3])
def test_packed_neighbors_matches_jax(radius_scale):
    """``rcll.packed_neighbors`` with its default window (from the table
    capacity, and from ds) and a skin-inflated radius."""
    dj, dt, ps, rc, counts, cap = _packed_cloud(2, (True, False), 500, seed=7)
    tps = trcll.pack_state(dt, rc, cap)
    rad = radius_scale * jnnps.rcll_radius_cell_units(dj)
    for ds in (None, 0.04):
        nj = jrcll.packed_neighbors(dj, ps, k=128, radius_cell=rad, ds=ds,
                                    compute_dtype=jnp.float32)
        nt = trcll.packed_neighbors(dt, tps, k=128, radius_cell=rad, ds=ds,
                                    compute_dtype=torch.float32)
        _lists_equal(nj, nt)
        assert not bool(nt.overflowed)
        # dummy-padded ids: invalid slots hold exactly N
        n = rc.rel.shape[0]
        assert bool(torch.all(torch.where(nt.mask, nt.idx < n, nt.idx == n)))


def test_auto_window_matches_jax():
    for spec in (dict(lo=(0.0, 0.0), hi=(1.0, 1.0), h=0.03),
                 dict(lo=(0.0,) * 3, hi=(1.0, 1.0, 0.7), h=0.06, cell_factor=1.5)):
        dj, dt = jd.Domain(**spec), td.Domain(**spec)
        for kw in (dict(ds=0.02), dict(ds=0.013, safety=2.0), dict(capacity=11)):
            assert tnnps.auto_window(dt, **kw) == jnnps.auto_window(dj, **kw)
    with pytest.raises(ValueError, match="ds or capacity"):
        tnnps.auto_window(dt)


def test_advance_ef_bit_identical_to_jax():
    dj, dt, ps, rc, counts, cap = _packed_cloud(2, (True, False), 300, seed=3)
    rng = np.random.default_rng(3)
    carry_j = jnp.zeros(ps.rc.rel.shape, jnp.float32)
    carry_t = torch.zeros(rc.rel.shape)
    st_j, st_t = ps.rc, rc
    for _ in range(4):  # some particles leave their cells, some leave the box
        dxn = rng.normal(size=rc.rel.shape).astype(np.float32) * 0.6
        st_j, carry_j = jrcll.advance_ef(dj, st_j, jnp.asarray(dxn), carry_j)
        st_t, carry_t = trcll.advance_ef(dt, st_t, torch.tensor(dxn), carry_t)
        np.testing.assert_array_equal(_np(st_t.cell_xy), np.asarray(st_j.cell_xy))
        np.testing.assert_array_equal(_np(st_t.rel), np.asarray(st_j.rel))
        np.testing.assert_array_equal(_np(carry_t), np.asarray(carry_j))


# --------------------------------------------------------------------------
# the fused sweep
# --------------------------------------------------------------------------
def _force_inputs(seed, n=600, k=160, masses=None):
    """A skin-inflated packed list (JAX's window search) and random
    fields, in both packages."""
    dj, dt, ps, rc, counts, cap = _packed_cloud(2, (True, False), n, seed=seed,
                                                h=1.2 / n**0.5, cell_factor=2.0)
    rad = 1.5 * jnnps.rcll_radius_cell_units(dj)
    nl_j = jrcll.packed_neighbors(dj, ps, k=k, radius_cell=rad, compute_dtype=jnp.float32)
    assert not bool(nl_j.overflowed)
    rng = np.random.default_rng(seed)
    f = dict(v=(rng.normal(size=(n, 2)) * 0.1).astype(np.float32),
             m=np.full((n,), 1.0 / n, np.float32) if masses is None else masses,
             rho=(1.0 + 0.01 * rng.normal(size=n)).astype(np.float32))
    nl_t = interop.fields_from_numpy(
        tnnps.NeighborList, {key: np.asarray(getattr(nl_j, key)) for key in ("idx", "mask", "count")},
        "cpu")
    return dj, dt, ps, rc, nl_j, nl_t, f


def _abs_sums(dt, rc, nl, v, m, rho, sch):
    """Σ_j |term| of each output of the sweep on these (decoded) inputs."""
    n = rc.rel.shape[0]
    idx = torch.clamp(nl.idx, max=n - 1).long()
    q = tfused.cell_coords_f32(rc)
    disp, r2, coef = tfused._pair_geometry(dt, q[:, None, :], q[idx])
    mj = torch.where(nl.mask, m[idx], 0.0)
    dv = v[:, None, :] - v[idx]
    inv = 1.0 / rho
    por2 = sch.por2_inv(inv)
    d_abs = torch.sum((mj * coef).abs() * (dv * disp).abs().sum(-1), dim=-1)
    gc = (mj * (por2[:, None].abs() + por2[idx].abs()) * coef).abs()
    vc = sch.dv_pair_coef(mj, coef * r2, inv[:, None], inv[idx], r2, h=dt.h).abs()
    a_abs = torch.sum(gc[..., None] * disp.abs() + vc[..., None] * dv.abs(), dim=-2)
    return d_abs, a_abs


def _hold(name, got, want, abs_sum, k, atol):
    bound = 4.0 * (k + 16) * 2.0**-24 * abs_sum.numpy() + 1e-30
    err = np.abs(got.numpy() - np.asarray(want))
    assert np.all(err <= bound), (name, float((err / bound).max()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=atol, err_msg=name)


@pytest.mark.parametrize("records", ["fp32", "fp16", "bf16"])
@pytest.mark.parametrize("chunk", [0, 100, 10**6])
def test_force_rhs_matches_jax(records, chunk):
    dj, dt, ps, rc, nl_j, nl_t, f = _force_inputs(seed=1)
    v, m, rho = (torch.tensor(f[key]) for key in ("v", "m", "rho"))
    scale = tfused.mass_scale(m)
    dj_out = jfused.force_rhs(dj, ps.rc, nl_j, jnp.asarray(f["v"]), jnp.asarray(f["m"]),
                              jnp.asarray(f["rho"]), c0=C0, rho0=RHO0, mu=MU, chunk=chunk,
                              records=records, m_scale=jnp.asarray(scale.numpy()))
    dt_out = tfused.force_rhs(dt, rc, nl_t, v, m, rho, c0=C0, rho0=RHO0, mu=MU, chunk=chunk,
                              records=records, m_scale=scale)
    if records != "fp32":  # the sums run on the records' decoded values
        rdt = TDT[records]
        v, m = v.to(rdt).float(), (m / scale).to(rdt).float() * scale
    d_abs, a_abs = _abs_sums(dt, rc, nl_t, v, m, rho, tscheme.wcsph(C0, RHO0, MU))
    k = nl_t.idx.shape[1]
    _hold("drho", dt_out[0], dj_out[0], d_abs, k, atol=1e-5)
    _hold("acc", dt_out[1], dj_out[1], a_abs[:, :], k, atol=2e-3)


def test_force_rhs_dam_break_scheme_and_dummy_ids_match_jax():
    """The Tait EOS + artificial viscosity + delta-SPH scheme, with the
    ids given pre-sanitized (``idx_dummy``) as the solver passes them."""
    dj, dt, ps, rc, nl_j, nl_t, f = _force_inputs(seed=2)
    kw = dict(c0=14.1, rho0=1.0, eos="tait", gamma=7.0, viscosity="none", alpha=0.1,
              delta=0.1)
    from repro.core import scheme as jscheme
    out_j = jfused.force_rhs(dj, ps.rc, nl_j, jnp.asarray(f["v"]), jnp.asarray(f["m"]),
                             jnp.asarray(f["rho"]), scheme=jscheme.Scheme(**kw), records="fp32")
    out_t = tfused.force_rhs(dt, rc, nl_t, *(torch.tensor(f[key]) for key in ("v", "m", "rho")),
                             scheme=tscheme.Scheme(**kw), records="fp32",
                             idx_dummy=tfused._sanitized_idx(nl_t, rc.rel.shape[0]))
    for got, want, atol in zip(out_t, out_j, (1e-5, 2e-3)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=atol)


def test_force_rhs_half_records_survive_tiny_masses():
    """Masses below fp16's subnormal range (2e-8 stores as 0) keep full
    precision through the mean-mass normalizer; tests/test_fused_force.py's
    tolerance (2e-3 of each field's scale) against fp32 records, and the
    same answer as JAX's half-record sweep."""
    n = 600
    dj, dt, ps, rc, nl_j, nl_t, f = _force_inputs(seed=13, masses=np.full((n,), 2e-8, np.float32))
    v, m, rho = (torch.tensor(f[key]) for key in ("v", "m", "rho"))
    assert float(m.to(torch.float16)[0]) == 0.0
    kw = dict(c0=C0, rho0=RHO0, mu=MU)
    d32, a32 = tfused.force_rhs(dt, rc, nl_t, v, m, rho, records="fp32", **kw)
    d16, a16 = tfused.force_rhs(dt, rc, nl_t, v, m, rho, records="fp16", **kw)
    assert float(d32.abs().max()) > 0
    for got, want in ((d16, d32), (a16, a32)):
        atol = 2e-3 * float(want.abs().max())
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-3, atol=atol)
    dj16, aj16 = jfused.force_rhs(dj, ps.rc, nl_j, jnp.asarray(f["v"]), jnp.asarray(f["m"]),
                                  jnp.asarray(f["rho"]), records="fp16",
                                  m_scale=jnp.asarray(tfused.mass_scale(m).numpy()), **kw)
    np.testing.assert_allclose(d16.numpy(), np.asarray(dj16), rtol=2e-5,
                               atol=1e-5 * float(d32.abs().max()))
    np.testing.assert_allclose(a16.numpy(), np.asarray(aj16), rtol=2e-5,
                               atol=1e-5 * float(a32.abs().max()))


def test_half_records_reject_huge_grids_and_solver_falls_back():
    spec = dict(lo=(0.0, 0.0), hi=(2000.0, 1.0), h=0.2)
    dt = td.Domain(**spec)
    assert max(dt.ncells) >= 1 << 11
    n = 8
    rc = trcll.init_state(dt, torch.zeros((n, 2)), torch.float16)
    nl = tnnps.NeighborList(idx=torch.zeros((n, 4), dtype=torch.int32),
                            mask=torch.zeros((n, 4), dtype=torch.bool),
                            count=torch.zeros((n,), dtype=torch.int32))
    with pytest.raises(ValueError, match="16-bit"):
        tfused.force_rhs(dt, rc, nl, torch.zeros((n, 2)), torch.ones(n), torch.ones(n),
                         c0=C0, rho0=RHO0, records="fp16")
    for hi, want in (((2000.0, 1.0), "fp32"), ((1.0, 1.0), "fp16")):
        dom_j, dom_t = jd.Domain(lo=(0.0, 0.0), hi=hi, h=0.2), td.Domain(lo=(0.0, 0.0), hi=hi, h=0.2)
        cj = jsolver.SPHConfig(domain=dom_j, ds=0.1, dt=1e-3, algo="rcll")
        ct = tsolver.SPHConfig(domain=dom_t, ds=0.1, dt=1e-3, algo="rcll")
        assert tsolver._resolved_records(ct) == jsolver._resolved_records(cj) == want


@pytest.mark.parametrize("d", [2, 3])
def test_byte_models_match_jax(d):
    assert tfused.resolve_chunk(8455, 4096) == jfused.resolve_chunk(8455, 4096) == 2819
    for n, c in ((100, 0), (20000, 0), (20000, 3000), (5, 100)):
        assert tfused.resolve_chunk(n, c) == jfused.resolve_chunk(n, c)
    for records in ("fp32", "fp16", "bf16"):
        assert tfused.record_bytes_per_pair(d, records) == jfused.record_bytes_per_pair(d, records)
        for fz in (True, False):
            assert (tfused.estimate_hbm_bytes_per_step(1 << 20, 48, d, fz, records)
                    == jfused.estimate_hbm_bytes_per_step(1 << 20, 48, d, fz, records))


# --------------------------------------------------------------------------
# the sph gather family
# --------------------------------------------------------------------------
def test_sph_gather_family_matches_jax():
    dj, dt, ps, rc, nl_j, nl_t, f = _force_inputs(seed=4)
    n = rc.rel.shape[0]
    rng = np.random.default_rng(4)
    p = rng.normal(size=n).astype(np.float32)
    # the reference backend gathers with ids clamped into range (JAX clamps)
    nl_jc = nl_j._replace(idx=jnp.minimum(nl_j.idx, n - 1))
    nl_tc = nl_t._replace(idx=torch.clamp(nl_t.idx, max=n - 1))
    disp_j, r_j = jrcll.pair_displacements(dj, ps.rc, nl_jc)
    disp_t, r_t = trcll.pair_displacements(dt, rc, nl_tc)
    gw_j = jsph.grad_w(disp_j, r_j, dj.h, 2, nl_jc.mask)
    gw_t = tsph.grad_w(disp_t, r_t, dt.h, 2, nl_tc.mask)
    fj = jsph.FluidState(v=jnp.asarray(f["v"]), rho=jnp.asarray(f["rho"]), m=jnp.asarray(f["m"]))
    ft = tsph.FluidState(*(torch.tensor(f[key]) for key in ("v", "rho", "m")))
    bf_j, bf_t = jnp.asarray([0.1, -0.2], jnp.float32), torch.tensor([0.1, -0.2])
    pairs = [
        (jsph.continuity_rhs(fj, nl_jc.idx, nl_jc.mask, gw_j),
         tsph.continuity_rhs(ft, nl_tc.idx, nl_tc.mask, gw_t)),
        (jsph.momentum_rhs(fj, jnp.asarray(p), nl_jc.idx, nl_jc.mask, gw_j, disp_j, r_j,
                           h=dj.h, mu=MU, body_force=bf_j),
         tsph.momentum_rhs(ft, torch.tensor(p), nl_tc.idx, nl_tc.mask, gw_t, disp_t, r_t,
                           h=dt.h, mu=MU, body_force=bf_t)),
        (jsph.energy_rhs(fj, jnp.asarray(p), nl_jc.idx, nl_jc.mask, gw_j),
         tsph.energy_rhs(ft, torch.tensor(p), nl_tc.idx, nl_tc.mask, gw_t)),
        (jsph.density_summation(fj, nl_jc.idx, nl_jc.mask, r_j, dj.h, 2),
         tsph.density_summation(ft, nl_tc.idx, nl_tc.mask, r_t, dt.h, 2)),
    ]
    pf_j = jsph.gather_pair_fields(fj.v, fj.m, nl_jc.idx, nl_jc.mask)
    pf_t = tsph.gather_pair_fields(ft.v, ft.m, nl_tc.idx, nl_tc.mask)
    np.testing.assert_array_equal(pf_t.dv.numpy(), np.asarray(pf_j.dv))
    np.testing.assert_array_equal(pf_t.mj.numpy(), np.asarray(pf_j.mj))
    r2 = r_j * r_j
    pairs.append((jsph.viscosity_pair_coef(pf_j.mj, r2, fj.rho[:, None], fj.rho[nl_jc.idx], r2,
                                           h=dj.h, mu=MU),
                  tsph.viscosity_pair_coef(pf_t.mj, r_t * r_t, ft.rho[:, None],
                                           ft.rho[nl_tc.idx.long()], r_t * r_t, h=dt.h, mu=MU)))
    for want, got in pairs:
        scale = float(np.abs(np.asarray(want)).max())
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6 * scale)
    assert tsph.alpha_d(2, 0.1) == jsph.alpha_d(2, 0.1)


# --------------------------------------------------------------------------
# the solver: list backends, exact lists, overflow, absolute algos
# --------------------------------------------------------------------------
def _both(name, j_kw, t_kw):
    cj, sj = jcases.build_case(name, **j_kw).build()
    ct, st = tcases.build_case(name, **t_kw).build(device="cpu")
    return cj, sj, ct, st


def _outs(cj, oj, ct, ot):
    return {"pos": (np.asarray(jsolver.positions(cj, oj)), tsolver.positions(ct, ot).numpy()),
            "v": (np.asarray(oj.fluid.v), ot.fluid.v.numpy()),
            "rho": (np.asarray(oj.fluid.rho), ot.fluid.rho.numpy())}


def _hold_slice(cfg, outs, nsteps, quantum=0.0):
    tol = {"pos": 1e-6 + quantum, "rho": 1e-6, "v": nsteps * cfg.dt * 1e-4}
    for key, (want, got) in outs.items():
        np.testing.assert_allclose(got, want, rtol=0, atol=tol[key], err_msg=key)


POLICIES = {"fp32": dict(records="fp32"), "fp16": {}}
RUNS = [("poiseuille", dict(ds=0.1, Lx=0.8)), ("taylor_green", dict(ds=1 / 16))]


@pytest.mark.parametrize("name,kw", RUNS, ids=[r[0] for r in RUNS])
@pytest.mark.parametrize("backend,window,records", [
    ("reference", 0, "fp32"), ("xla", 0, "fp32"), ("xla", None, "fp32"), ("xla", 0, "fp16")])
def test_list_backends_simulate_stats_match_jax(name, kw, backend, window, records):
    nsteps = 10
    pj, pt = JPolicy(**POLICIES[records]), TPolicy(**POLICIES[records])
    cj, sj, ct, st = _both(name, dict(kw, backend=backend, policy=pj),
                           dict(kw, backend=backend, policy=pt))
    cj, ct = dataclasses.replace(cj, window=window), dataclasses.replace(ct, window=window)
    oj, statj = jsolver.simulate_stats(cj, sj, nsteps)
    ot, statt = tsolver.simulate_stats(ct, st, nsteps)
    assert (int(statj.rebuilds), int(statj.steps), bool(statj.overflow)) == tuple(statt)
    quantum = max(ct.domain.cell_sizes) / 2 * 2.0**-10 if records == "fp16" else 0.0
    _hold_slice(ct, _outs(cj, oj, ct, ot), nsteps, quantum)


def test_list_backend_carry_lists_and_exact_list_match_jax():
    """The rebuild's list (window search and table oracle), its dummy ids
    and the exact-radius refilter, bit for bit at init; after skinned
    steps the exact sets equal a fresh search's (the skin invariant)."""
    kw = dict(ds=0.05, Lx=0.8, cell_factor=2.0, max_neighbors=96)
    for window in (0, None):
        cj, sj, ct, st = _both("poiseuille", dict(kw, backend="xla"), dict(kw, backend="xla"))
        skin = 0.5 * min(ct.domain.cell_sizes)
        cj = dataclasses.replace(cj, skin=skin, window=window)
        ct = dataclasses.replace(ct, skin=skin, window=window)
        carry_j, carry_t = jsolver.init_persistent(cj, sj), tsolver.init_persistent(ct, st)
        np.testing.assert_array_equal(carry_t.order.numpy(), np.asarray(carry_j.order))
        for f in ("idx", "mask", "count"):
            np.testing.assert_array_equal(_np(getattr(carry_t.nl, f)),
                                          np.asarray(getattr(carry_j.nl, f)))
        assert (carry_t.idx_dummy is None) == (carry_j.idx_dummy is None) == (window == 0)
        if window is None:
            np.testing.assert_array_equal(carry_t.idx_dummy.numpy(), np.asarray(carry_j.idx_dummy))
        ej, et = jsolver.exact_neighbor_list(cj, carry_j), tsolver.exact_neighbor_list(ct, carry_t)
        for f in ("idx", "mask", "count"):
            np.testing.assert_array_equal(_np(getattr(et, f)), np.asarray(getattr(ej, f)))
    n = st.xn.shape[0]
    pol = ct.policy
    for _ in range(12):
        carry_t = tsolver.step_persistent(ct, carry_t)
        exact = tsolver.exact_neighbor_list(ct, carry_t)
        ps = trcll.pack_state(ct.domain, carry_t.st.rc, ct.cap(n))
        fresh = trcll.packed_neighbors(ct.domain, ps, dtype=pol.nnps_dtype,
                                       compute_dtype=pol.nnps_compute_dtype, k=ct.max_neighbors)
        # fresh is in the re-packed order: carry it back to the carry's
        order, inv = ps.packing.order.long(), ps.packing.inverse.long()
        back = tnnps.NeighborList(
            idx=order[torch.clamp(fresh.idx, max=n - 1).long()][inv].to(torch.int32),
            mask=fresh.mask[inv], count=fresh.count[inv])
        assert bool(torch.all(tnnps.neighbor_sets_equal(exact, back)))
    assert carry_t.rebuilds < 10 and not bool(carry_t.overflow)
    with pytest.raises(ValueError, match="neighbor list"):
        tsolver.exact_neighbor_list(dataclasses.replace(ct, backend="kernel"), carry_t)


def test_window_truncation_and_k_overflow_raise_like_jax():
    """An undersized window or K: stats report overflow in both packages,
    and check_overflow raises JAX's error with the capacity word."""
    for change in (dict(window=8), dict(max_neighbors=4)):
        cj, sj, ct, st = _both("poiseuille", dict(ds=0.1, Lx=0.8, backend="xla"),
                               dict(ds=0.1, Lx=0.8, backend="xla"))
        cj, ct = dataclasses.replace(cj, **change), dataclasses.replace(ct, **change)
        _, statj = jsolver.simulate_stats(cj, sj, 3)
        _, statt = tsolver.simulate_stats(ct, st, 3)
        assert bool(statj.overflow) and statt.overflow
        carry = tsolver.init_persistent(ct, st)
        assert int(carry.flags) & thealth.WINDOW_TRUNC
        with pytest.raises(jhealth.SimulationDiverged) as ej:
            jsolver.simulate_stats(dataclasses.replace(cj, check_overflow=True), sj, 3)
        with pytest.raises(thealth.SimulationDiverged) as et:
            tsolver.simulate_stats(dataclasses.replace(ct, check_overflow=True), st, 3)
        assert str(et.value) == str(ej.value)
        assert et.value.word == ej.value.word == thealth.CAPACITY_CHECKS
        assert et.value.checks == ej.value.checks


ABS_RUNS = [("poiseuille", dict(ds=0.1, Lx=0.8)), ("taylor_green", dict(ds=1 / 16))]


@pytest.mark.parametrize("name,kw", ABS_RUNS, ids=[r[0] for r in ABS_RUNS])
@pytest.mark.parametrize("algo", ["cell", "all"])
def test_absolute_algos_approach_I_match_jax(name, kw, algo):
    """fp32 search and coordinates (approach I) against the jitted run."""
    nsteps = 10
    pol = dict(nnps="fp32", coords="fp32")
    cj, sj, ct, st = _both(name, dict(kw, algo=algo, policy=JPolicy(**pol)),
                           dict(kw, algo=algo, policy=TPolicy(**pol)))
    oj, statj = jsolver.simulate_stats(cj, sj, nsteps)
    ot, statt = tsolver.simulate_stats(ct, st, nsteps)
    assert (int(statj.rebuilds), int(statj.steps), bool(statj.overflow)) == tuple(statt)
    _hold_slice(ct, _outs(cj, oj, ct, ot), nsteps)
    np.testing.assert_array_equal(ot.rc.rel.numpy(), np.asarray(st.rc.rel))  # rc stays frozen


@pytest.mark.parametrize("name,kw", ABS_RUNS, ids=[r[0] for r in ABS_RUNS])
@pytest.mark.parametrize("algo", ["cell", "all"])
def test_absolute_algos_approach_II_match_eager_jax(name, kw, algo):
    """fp16 absolute search (approach II): the search's neighbor lists bit
    for bit and the run within the slice tolerances, against JAX's
    ``_step_absolute`` stepped eagerly (rounded op by op, as the port)."""
    nsteps = 3
    cj, sj, ct, st = _both(name, dict(kw, algo=algo), dict(kw, algo=algo))
    assert ct.policy.nnps == "fp16"
    oj, ot = sj, st
    for _ in range(nsteps):
        nl_j, _, _ = jsolver._neighbors_and_pairs(cj, oj)
        nl_t, _, _ = tsolver._neighbors_and_pairs(ct, ot)
        for f in ("idx", "mask", "count"):
            np.testing.assert_array_equal(_np(getattr(nl_t, f)), np.asarray(getattr(nl_j, f)))
        oj, ot = jsolver._step_absolute(cj, oj), tsolver._step_absolute(ct, ot)
    _hold_slice(ct, _outs(cj, oj, ct, ot), nsteps)
    ot2 = tsolver.simulate(ct, st, nsteps)
    assert torch.equal(ot2.xn, ot.xn) and torch.equal(ot2.fluid.v, ot.fluid.v)


def test_absolute_path_wraps_a_seam_crossing_particle_like_jax():
    """A tracer crossing the periodic seam in one step lands on the other
    side, as in JAX (``torch.remainder`` is ``jnp.mod`` bit for bit)."""
    rng = np.random.default_rng(0)
    x = (rng.normal(size=100_000) * 50).astype(np.float32)
    s = np.float32(7.3)
    np.testing.assert_array_equal(torch.remainder(torch.tensor(x), float(s)).numpy(),
                                  np.asarray(jnp.mod(jnp.asarray(x), s)))
    cj, sj, ct, st = _both("taylor_green", dict(ds=1 / 16, algo="cell"),
                           dict(ds=1 / 16, algo="cell"))
    i = int(np.argmax(np.asarray(sj.xn)[:, 0]))  # the particle nearest the seam at hi x
    v = np.asarray(sj.fluid.v).copy()
    v[i, 0] = 2.0 * cj.domain.h_d / (2.0 * cj.dt) * 0.05  # 0.05 normalized units a step
    m = np.asarray(sj.fluid.m).copy()
    m[i] = 0.0
    sj = sj._replace(fluid=sj.fluid._replace(v=jnp.asarray(v), m=jnp.asarray(m)))
    st = st._replace(fluid=st.fluid._replace(v=torch.tensor(v), m=torch.tensor(m)))
    oj, ot = sj, st
    for _ in range(3):
        oj, ot = jsolver._step_absolute(cj, oj), tsolver._step_absolute(ct, ot)
    lo = ct.domain.origin_norm[0]
    assert float(ot.xn[i, 0]) < lo + 0.5 < float(st.xn[i, 0])  # it crossed and wrapped
    np.testing.assert_allclose(ot.xn.numpy(), np.asarray(oj.xn), rtol=0, atol=1e-5)


def test_absolute_path_drops_list_overflow_like_jax():
    """ROADMAP Queue 3 entry D: with K far below the true counts, the
    absolute path reports no overflow in either package (a fault of the
    reference, mirrored), and check_overflow does not raise."""
    kw = dict(ds=1 / 16, algo="cell", max_neighbors=4, check_overflow=True)
    cj, sj, ct, st = _both("taylor_green", kw, kw)
    nl_j, _, _ = jsolver._neighbors_and_pairs(cj, sj)
    nl_t, _, _ = tsolver._neighbors_and_pairs(ct, st)
    assert int(nl_t.count.max()) == int(nl_j.count.max()) > 4
    assert bool(nl_t.overflowed) and bool(nl_j.overflowed)
    _, statj = jsolver.simulate_stats(cj, sj, 2)
    _, statt = tsolver.simulate_stats(ct, st, 2)
    assert bool(statj.overflow) is statt.overflow is False


def test_observed_absolute_run_matches_jax():
    jsim = japi.Simulation.from_case("taylor_green", ds=1 / 16, algo="cell",
                                     policy=JPolicy(nnps="fp32", coords="fp32"))
    tsim = tapi.Simulation.from_case("taylor_green", device="cpu", ds=1 / 16, algo="cell",
                                     policy=TPolicy(nnps="fp32", coords="fp32"))
    rj, rt = jsim.run(12, observe_every=4), tsim.run(12, observe_every=4)
    assert rt.stats == tsolver.SimStats(rebuilds=12, steps=12, overflow=False)
    assert int(rj.stats.steps) == 12 and rt.observables.ekin.shape == (3,)
    for f in ("t", "ekin", "vmax", "rho_err"):
        np.testing.assert_allclose(getattr(rt.observables, f).numpy(),
                                   np.asarray(getattr(rj.observables, f)), rtol=1e-5, atol=1e-7)
    _hold_slice(tsim.cfg, _outs(jsim.cfg, rj.state, tsim.cfg, rt.state), 12)
    assert tsim.state is rt.state


def test_massless_tracer_counting_sort_fallback_on_xla():
    """tests/test_packed.py:404 on the port's xla backend: a massless
    tracer crossing ~2.5 cells a step forces the argsort fallback every
    rebuild; the persistent run equals the stateless per-step ``step``."""
    ds = 1.0 / 16
    dom = td.Domain(lo=(0.0, 0.0), hi=(1.0, 1.0), h=1.2 * ds, periodic=(True, True))
    x = td.lattice_positions(dom, ds, jitter=0.05, seed=3)
    n = x.shape[0]
    cfg = tsolver.SPHConfig(domain=dom, ds=ds, dt=1e-3, c0=1.0, mu=0.0, body_force=(0.0, 0.0),
                            max_neighbors=48, algo="rcll", backend="xla")
    v = np.zeros((n, 2), np.float32)
    hc = dom.hc_norm_axes[0]
    v[0, 0] = 2.5 * hc * dom.h_d / (2.0 * cfg.dt)
    m = np.full((n,), ds * ds, np.float32)
    m[0] = 0.0
    st = tsolver.init_state(cfg, x, v, m, np.ones((n,), np.float32), device="cpu")
    out = tsolver.simulate(cfg, st, 8)
    ref = st
    for _ in range(8):
        ref = tsolver.step(cfg, ref)
    np.testing.assert_allclose(tsolver.positions(cfg, out).numpy(),
                               tsolver.positions(cfg, ref).numpy(), atol=1e-5)
    np.testing.assert_allclose(out.fluid.rho.numpy(), ref.fluid.rho.numpy(), rtol=0, atol=1e-5)
    assert torch.equal(out.fluid.m, st.fluid.m)


def test_backends_accept_jax_values():
    cfg, st = tcases.build_case("taylor_green", ds=1 / 16).build(device="cpu")
    assert cfg.resolved_backend == "kernel" and cfg.window == 0 and cfg.force_chunk == 0
    assert cfg.max_neighbors == 48 and cfg.resolved_window() == tnnps.auto_window(
        cfg.domain, ds=cfg.ds)
    for be in ("reference", "xla", "kernel"):
        assert dataclasses.replace(cfg, backend=be).resolved_backend == be
    with pytest.raises(ValueError, match="table oracle"):
        dataclasses.replace(cfg, window=None).resolved_window()
    cj = jcases.build_case("poiseuille", ds=0.1, Lx=0.8).build()[0]
    ct = tcases.build_case("poiseuille", ds=0.1, Lx=0.8).build(device="cpu")[0]
    assert (ct.max_neighbors, ct.force_chunk, ct.search_radius_cell) == (
        cj.max_neighbors, cj.force_chunk, cj.search_radius_cell)
