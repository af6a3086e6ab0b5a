"""Port parity, kernels: K1 (cell pack) and K2 (fused force).

On the CPU the port's wrappers run their plain PyTorch versions, which
are held against the JAX Pallas kernels in interpret mode:

  * ``cell_tables_ref`` vs ``cell_pack.cell_tables(interpret=True)``:
    bit-identical (pure copies and selects), 2-D and 3-D;
  * ``rcll_force_ref`` vs ``rcll_force.rcll_force(interpret=True)`` on
    the same tiles: within ``rounding_bound`` — XLA's jit contracts fp32
    multiply-adds exactly like nvcc does, so this also checks the bound
    the CUDA kernel is held to;
  * ``ops.rcll_force_particles`` vs the JAX wrapper, static and under
    stale-binning migration, at the ``tests/test_fused_force.py:104-105``
    tolerances (rtol 2e-5; atol 1e-5 drho, 2e-3 acc).

The kernel-vs-plain tests on the card live in
``tests/test_torch_cuda_kernels.py``, which imports no JAX so that it
runs where only the port is installed.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.core import cells as jcells
from repro.core import domain as jd
from repro.core import rcll as jrcll
from repro.core import scheme as jsch
from repro.kernels import cell_pack as jcp
from repro.kernels import ops as jops
from repro.kernels import rcll_force as jrf
from repro_torch.core import cells as tcells
from repro_torch.core import domain as td
from repro_torch.core import rcll as trcll
from repro_torch.core import scheme as tsch
from repro_torch.kernels import cell_pack as tcp
from repro_torch.kernels import ops as tops
from repro_torch.kernels import rcll_force as trf
from test_torch_helpers import DAM, WCSPH, make_tiles, one_torch_thread  # noqa: F401

C0, RHO0 = 1.25, 1.0


# --------------------------------------------------------------------------
# K1
# --------------------------------------------------------------------------
def _pack_inputs(n, dim, seed):
    rng = np.random.default_rng(seed)
    ds = (1.0 / n) ** (1.0 / dim)
    spec = dict(lo=(0.0,) * dim, hi=(1.0,) * dim, h=1.2 * ds)
    dj, dt = jd.Domain(**spec), td.Domain(**spec)
    x = rng.uniform(0, 1, (n, dim)).astype(np.float32)
    st = jrcll.init_state(dj, dj.normalize(jnp.asarray(x)), jnp.float16)
    cap = jcells.default_capacity(dj, n, safety=6.0)
    ps = jrcll.pack_state(dj, st, cap)
    b = ps.packing.binning
    starts = np.asarray(jcells.exclusive_cumsum(b.counts))
    rows16 = np.asarray(ps.rc.rel).view(np.int16)
    rows16 = np.concatenate([rows16, rng.integers(-300, 300, (n, 2)).astype(np.int16)], 1)
    rows32 = rng.normal(size=(n, 3)).astype(np.float32)
    fill32 = np.asarray([1.0, 0.0, -3.5], np.float32)
    return rows16, rows32, starts, np.asarray(b.counts), fill32, cap, b


@pytest.mark.parametrize("n,dim,seed", [(500, 2, 0), (300, 3, 1)])
def test_cell_tables_ref_matches_pallas(n, dim, seed):
    rows16, rows32, starts, counts, fill32, cap, b = _pack_inputs(n, dim, seed)
    out_j = jcp.cell_tables(
        jnp.asarray(rows16.view(np.uint16)), jnp.asarray(rows32),
        jnp.asarray(starts), jnp.asarray(counts), jnp.asarray(fill32),
        cap=cap, interpret=True,
    )
    before = tcp.cell_tables.launches
    out_t = tcp.cell_tables(
        *(torch.as_tensor(a) for a in (rows16, rows32, starts, counts, fill32)), cap=cap
    )
    assert tcp.cell_tables.launches == before  # CPU tensors: plain version only
    np.testing.assert_array_equal(np.asarray(out_j[0]).view(np.int16), out_t[0].numpy())
    for a, c in zip(out_j[1:], out_t[1:]):
        np.testing.assert_array_equal(np.asarray(a).view(np.uint8), c.numpy().view(np.uint8))
    np.testing.assert_array_equal(out_t[2][:-1].numpy(), np.asarray(b.table))


# --------------------------------------------------------------------------
# K2 and the force wrapper
# --------------------------------------------------------------------------
def _cloud(n=800, seed=0, rel_dtype="fp16"):
    """Random cloud + packed states in both packages (no overflow)."""
    rng = np.random.default_rng(seed)
    ds = (1.0 / n) ** 0.5
    spec = dict(lo=(0.0, 0.0), hi=(1.0, 1.0), h=1.2 * ds, cell_factor=2.0)
    dj, dt = jd.Domain(**spec), td.Domain(**spec)
    x = rng.uniform(0, 1, (n, 2)).astype(np.float32)
    jdt, tdt = {"fp16": (jnp.float16, torch.float16),
                "fp32": (jnp.float32, torch.float32)}[rel_dtype]
    cap = jcells.default_capacity(dj, n, safety=8.0)
    pj = jrcll.pack_state(dj, jrcll.init_state(dj, dj.normalize(jnp.asarray(x)), jdt), cap)
    pt = trcll.pack_state(dt, trcll.init_state(dt, dt.normalize(torch.as_tensor(x)), tdt), cap)
    fields = dict(
        v=(rng.normal(size=(n, 2)) * 0.1).astype(np.float32),
        m=np.full((n,), 1.0 / n, np.float32),
        rho=(1.0 + 0.01 * rng.normal(size=(n,))).astype(np.float32),
    )
    skin_norm = 2.0 * 0.5 * min(dj.cell_sizes) / dj.h_d
    return rng, dj, dt, pj, pt, fields, skin_norm


def _force_pair(dj, dt, bj, bt, rcj, rct, f, scheme, records):
    rj = {"fp32": jnp.float32, "fp16": jnp.float16, "bf16": jnp.bfloat16}[records]
    rt = {"fp32": torch.float32, "fp16": torch.float16, "bf16": torch.bfloat16}[records]
    J = {k: jnp.asarray(v) for k, v in f.items()}
    T = {k: torch.as_tensor(v) for k, v in f.items()}
    out_j = jops.rcll_force_particles(
        dj, bj, rcj, J["v"], J["m"], J["rho"], scheme=jsch.Scheme(**scheme),
        records_dtype=rj, interpret=True,
    )
    out_t = tops.rcll_force_particles(
        dt, bt, rct, T["v"], T["m"], T["rho"], scheme=tsch.Scheme(**scheme),
        records_dtype=rt,
    )
    return [np.asarray(a) for a in out_j], [a.numpy() for a in out_t]


@pytest.mark.parametrize("records", ["fp32", "fp16"])
def test_rcll_force_particles_matches_pallas(records):
    _, dj, dt, pj, pt, f, _ = _cloud(seed=0)
    (dr_j, acc_j), (dr_t, acc_t) = _force_pair(
        dj, dt, pj.packing.binning, pt.packing.binning, pj.rc, pt.rc, f, WCSPH, records)
    np.testing.assert_allclose(dr_t, dr_j, rtol=2e-5, atol=1e-5)
    np.testing.assert_allclose(acc_t, acc_j, rtol=2e-5, atol=2e-3)


@pytest.mark.parametrize("scheme,records", [(WCSPH, "fp32"), (DAM, "bf16")])
def test_rcll_force_particles_stale_binning_with_migrations(scheme, records):
    """Between rebuilds migrated particles decode through the int16 shift
    re-anchor against the stale binning (tests/test_fused_force.py:108)."""
    rng, dj, dt, pj, pt, f, skin_norm = _cloud(seed=3)
    n = f["m"].shape[0]
    dxn = rng.uniform(-1, 1, (n, 2)).astype(np.float32)
    dxn = (dxn / np.linalg.norm(dxn, axis=1, keepdims=True) * (0.45 * skin_norm / 2)).astype(np.float32)
    rcj = jrcll.advance(dj, pj.rc, jnp.asarray(dxn), dtype=jnp.float16)
    rct = trcll.advance(dt, pt.rc, torch.as_tensor(dxn), dtype=torch.float16)
    assert (rct.cell_xy != pt.rc.cell_xy).any(dim=1).sum() > 0
    (dr_j, acc_j), (dr_t, acc_t) = _force_pair(
        dj, dt, pj.packing.binning, pt.packing.binning, rcj, rct, f, scheme, records)
    np.testing.assert_allclose(dr_t, dr_j, rtol=2e-5, atol=1e-5)
    np.testing.assert_allclose(acc_t, acc_j, rtol=2e-5, atol=2e-3)


def test_rcll_force_particles_fp32_coords():
    """APPROACH_I-style fp32 rel rides the fp32 slab, unquantized."""
    _, dj, dt, pj, pt, f, _ = _cloud(n=600, seed=11, rel_dtype="fp32")
    (dr_j, acc_j), (dr_t, acc_t) = _force_pair(
        dj, dt, pj.packing.binning, pt.packing.binning, pj.rc, pt.rc, f, WCSPH, "fp32")
    np.testing.assert_allclose(dr_t, dr_j, rtol=1e-5, atol=2e-6)
    np.testing.assert_allclose(acc_t, acc_j, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("dim,scheme,records", [
    (2, WCSPH, "fp16"), (2, DAM, "fp32"), (3, dict(DAM, body_force=()), "bf16"),
])
def test_rcll_force_ref_within_rounding_bound_of_pallas(dim, scheme, records):
    """The plain version against the Pallas kernel on identical tiles.
    Jitted XLA contracts multiply-adds like nvcc, so the gap must sit
    inside ``rounding_bound`` — the tolerance the CUDA kernel meets."""
    t, kw = make_tiles(7 + dim, dim, scheme, records)
    d_t, a_t, d_abs, a_abs = trf.rcll_force_ref(*t.values(), **kw, abs_sums=True)
    conv = lambda x: jnp.asarray(x.view(torch.int16).numpy()).view(jnp.bfloat16) \
        if x.dtype == torch.bfloat16 else jnp.asarray(x.numpy())
    offs = tuple(map(tuple, jcells.neighbor_cell_offsets(dim)))
    d_j, a_j = jrf.rcll_force(
        *(conv(x) for x in t.values()), offs=offs, hc_phys=kw["hc_phys"],
        h=kw["h"], dim=dim, scheme=jsch.Scheme(**scheme), interpret=True,
    )
    assert float(d_abs.max()) > 0 and float(a_abs.max()) > 0
    assert np.all(np.abs(np.asarray(d_j) - d_t.numpy()) <= trf.rounding_bound(d_abs, dim).numpy())
    assert np.all(np.abs(np.asarray(a_j) - a_t.numpy()) <= trf.rounding_bound(a_abs, dim).numpy())


def test_wrappers_reject_bad_inputs_before_launch():
    t, kw = make_tiles(1, 2, WCSPH, "fp16", n=400)
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        trf.rcll_force(*(x.to(meta) for x in t.values()), **kw)
    with pytest.raises(ValueError, match="cuda or cpu"):
        tcp.cell_tables(*(torch.zeros(4, 2, dtype=dt, device=meta) for dt in
                          (torch.int16, torch.float32)),
                        *(torch.zeros(3, dtype=torch.int32, device=meta) for _ in range(2)),
                        torch.zeros(2, device=meta), cap=4)
