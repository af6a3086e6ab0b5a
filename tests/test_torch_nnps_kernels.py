"""Port parity, the NNPS kernels K4 (neighbor lists) and K5 (dense
adjacency); K3 is in ``test_torch_nnps_gradient.py``.

On the CPU the port's wrappers run their plain versions, held against
the JAX package on the same seeded inputs:

  * with fp32 compute (K4 and K5's default) fp16 storage decodes exactly,
    and K5's adjacency equals JAX's ``ref_rcll_adjacency`` and the Pallas
    kernel in interpret mode bit for bit; K4's ids and counts equal the
    interpret-mode kernel's;
  * with fp16 compute every op rounds to fp16 in both packages only when
    JAX runs eagerly: jitted XLA (the interpret-mode kernels) keeps fp32
    between fused fp16 ops. The decisions are held against JAX's tile
    math called eagerly (``tiling.tile_r2_cell`` under ``vmap``). JAX's
    ``ref_rcll_adjacency`` sums the 2-3 squares with one fp32 reduce, so
    it equals the tile math in 2-D only.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro.core import cells as jcells
from repro.core import domain as jd
from repro.core import nnps as jnnps
from repro.core import rcll as jrcll
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels import tiling as jtiling
from repro_torch.core import cells as tcells
from repro_torch.core import domain as td
from repro_torch.core import interop
from repro_torch.core import nnps as tnnps
from repro_torch.core import rcll as trcll
from repro_torch.kernels import nnps_pairwise as tnp
from repro_torch.kernels import ops as tops
from test_torch_helpers import one_torch_thread  # noqa: F401  (autouse fixture)

JDT = {"fp16": jnp.float16, "bf16": jnp.bfloat16, "fp32": jnp.float32}
TDT = {"fp16": torch.float16, "bf16": torch.bfloat16, "fp32": torch.float32}


def _setup(n, dim, cap, storage="fp16", seed=0, periodic=False):
    """One cloud in both packages (JAX's state carried across) and the
    kernel tables of each."""
    rng = np.random.default_rng(seed)
    ds = (1.0 / n) ** (1.0 / dim)
    kw = dict(h=1.2 * ds, periodic=(periodic,) + (False,) * (dim - 1))
    dj = jd.unit_square(**kw) if dim == 2 else jd.unit_cube(**kw)
    dt = td.unit_square(**kw) if dim == 2 else td.unit_cube(**kw)
    x = rng.uniform(0, 1, (n, dim))
    st_j = jrcll.init_state(dj, dj.normalize(jnp.asarray(x)), JDT[storage])
    bj = jcells.bin_by_cell_id(dj, dj.flat_cell_id(st_j.cell_xy), st_j.cell_xy, cap)
    assert int(bj.overflow) == 0
    st_t = interop.fields_from_numpy(
        trcll.RCLLState, {"cell_xy": np.asarray(st_j.cell_xy), "rel": np.asarray(st_j.rel)},
        "cpu")
    bt = tcells.bin_by_cell_id(dt, dt.flat_cell_id(st_t.cell_xy), st_t.cell_xy, cap)
    f = (x[:, 0] ** 3).astype(np.float32)
    return dj, dt, x, f, st_j, st_t, bj, bt


def _jax_tables(dj, bj, rel, f):
    rel_t, occ, (f_t,) = jops.pack_cells(bj, rel, jnp.asarray(f))
    return rel_t, occ, f_t, jops.nb_with_sentinel(dj)


def _eager_tile_decisions(dj, rel_t, occ, nb, compute):
    """JAX's kernel tile math (tile_r2_cell, tile_pair_mask) run eagerly,
    op by op, over every (cell, k) tile: (C+1, M, cap, cap) f32."""
    c1, d, cap = rel_t.shape
    offs = jcells.neighbor_cell_offsets(d)
    w = tuple(dj.cell_weights)
    r2 = jnp.dtype(compute).type(jnnps.rcll_radius_cell_units(dj) ** 2)
    rows = jnp.arange(c1)
    out = []
    for k in range(offs.shape[0]):
        nbk = nb[:, k]
        off = jnp.asarray(offs[k], jnp.float32)
        d2 = jax.vmap(lambda ri, rj: jtiling.tile_r2_cell(ri, rj, off, w, compute))(
            rel_t, rel_t[nbk])
        mask = jax.vmap(lambda oi, oj, s: jtiling.tile_pair_mask(oi, oj, s, cap))(
            occ, occ[nbk], nbk == rows)
        out.append((d2 <= r2) & mask)
    return np.asarray(jnp.stack(out, axis=1), np.float32)


# --------------------------------------------------------------------------
# K5
# --------------------------------------------------------------------------
@pytest.mark.parametrize("n,dim,cap,storage,periodic,interpret", [
    (500, 2, 16, "fp16", False, False), (500, 2, 16, "bf16", True, False),
    (800, 3, 32, "fp16", True, True), (800, 3, 32, "fp32", False, False),
    # odd caps: cap^2 is not a multiple of 4
    (500, 2, 19, "fp16", True, True), (800, 3, 37, "bf16", False, False),
])
def test_adjacency_plain_matches_jax(n, dim, cap, storage, periodic, interpret):
    dj, dt, x, f, st_j, st_t, bj, bt = _setup(n, dim, cap, storage, periodic=periodic)
    before = tnp.rcll_adjacency.launches
    adj_t, cnt_t = tops.rcll_adjacency_cells(dt, bt, st_t.rel)
    assert tnp.rcll_adjacency.launches == before  # CPU tensors: the plain version
    if interpret:  # each shape compiles the interpret-mode kernel anew
        adj_k, cnt_k = jops.rcll_adjacency_cells(dj, bj, st_j.rel, interpret=True)
        np.testing.assert_array_equal(adj_t.numpy(), np.asarray(adj_k))
        np.testing.assert_array_equal(cnt_t.numpy(), np.asarray(cnt_k))
    rel_t, occ, _, nb = _jax_tables(dj, bj, st_j.rel, f)
    adj_r, _ = jref.ref_rcll_adjacency(
        rel_t, occ, nb, jcells.neighbor_cell_offsets(dim), np.asarray(dj.cell_weights),
        jnnps.rcll_radius_cell_units(dj))
    np.testing.assert_array_equal(adj_t.numpy(), np.asarray(adj_r))
    # counts agree with the port's search at the same dtypes
    nl = tnnps.rcll_neighbors(dt, st_t.rel, st_t.cell_xy, dtype=TDT[storage],
                              compute_dtype=torch.float32, k=96, binning=bt)
    np.testing.assert_array_equal(cnt_t.numpy().astype(np.int32), nl.count.numpy())


@pytest.mark.parametrize("c1,dim,cap", [
    (7, 2, 20), (5, 2, 3), (4, 2, 1), (6, 2, 32), (3, 2, 33), (3, 3, 37), (2, 2, 128), (2, 3, 20),
])
def test_adjacency_regions_cover_every_element_once(c1, dim, cap):
    """K5's launch geometry: the regions its warps write partition the flat
    (C+1)·M·cap² output, and each splits into 16-byte aligned chunks plus
    at most 3 single elements at each end (so a warp stores them in one
    pass of its 32 lanes)."""
    m = 3**dim
    seen = np.zeros(c1 * m * cap * cap, np.int64)
    regions = list(tnp.adjacency_regions(c1, m, cap))
    assert len(regions) == c1 * (1 if cap <= 32 else m * tnp.adjacency_groups(cap))
    for e0, length in regions:
        head = min((4 - e0 % 4) % 4, length)  # as the kernel's stream_rows splits a region
        chunks = (length - head) // 4
        tail = length - head - 4 * chunks
        assert head < 4 and tail < 4 and (e0 + head) % 4 == 0
        seen[e0:e0 + length] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("c1,cap,k_slots", [
    (7, 20, 48), (5, 3, 50), (4, 1, 1), (6, 32, 3), (3, 33, 48), (3, 37, 50), (2, 128, 9),
    (3, 20, 400), (50, 20, 48), (33, 3, 5), (17, 37, 50),
])
def test_list_regions_cover_every_element_once(c1, cap, k_slots):
    """K4's launch geometry: the regions its blocks write partition the
    flat (C+1)·cap·K output, each starts 16-byte aligned, and only the
    last one may end in single elements (at most 3, one pass of its
    threads)."""
    seen = np.zeros(c1 * cap * k_slots, np.int64)
    regions = list(tnp.list_regions(c1, cap, k_slots))
    assert len(regions) == -(-c1 // tnp.LIST_CELLS)
    for e0, length in regions:
        assert e0 % 4 == 0  # 16-byte chunks from the region's start
        assert length % (cap * k_slots) == 0  # whole cells
        if length < tnp.LIST_CELLS * cap * k_slots:  # only the last block is short
            assert e0 + length == c1 * cap * k_slots
        else:
            assert length % 4 == 0  # no single elements at its end
        seen[e0:e0 + length] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("k_slots", [1, 3, 4, 8, 48, 50, 92, 93, 400, 5000])
def test_list_stride_fits_the_stage(k_slots):
    """A K4 stage row holds K hits, starts 8-byte aligned and on its own
    bank group (an odd multiple of 4 hits), and the block's stage fits in
    its budget; a K whose stage would not takes the unstaged path."""
    stride = tnp.list_stride(k_slots)
    if stride == 0:
        assert 2 * tnp.LIST_THREADS * k_slots > tnp.LIST_STAGE_BYTES - 2 * 8 * tnp.LIST_THREADS
        return
    assert stride >= k_slots and stride % 4 == 0 and (stride // 4) % 2 == 1
    assert stride - k_slots < 8
    assert 2 * tnp.LIST_THREADS * stride <= tnp.LIST_STAGE_BYTES


@pytest.mark.parametrize("fault", tnp.FAULTS)
def test_neighbor_lists_planted_params_change_one_field(fault):
    kw = dict(weights=(1.0, 0.5), r_cell=2.0, compute_dtype=torch.float32)
    f0, i0 = tnp.kernel_params(**kw)
    f1, i1 = tnp.planted_params(fault)(**kw)
    assert list(f0) == list(f1) and list(i0) == [0, -1, 0]
    changed = [n for n, a, b in zip(("keep_self", "pad", "count_at_k"), i0, i1) if a != b]
    assert changed == [{"pad_zero": "pad", "count_at_k": "count_at_k"}[fault]]
    with pytest.raises(ValueError):
        tnp.planted_params("no_such_fault")


@pytest.mark.parametrize("dim,periodic", [(2, True), (3, False)])
def test_adjacency_fp16_compute_matches_eager_jax(dim, periodic):
    n, cap = (500, 16) if dim == 2 else (800, 32)
    dj, dt, x, f, st_j, st_t, bj, bt = _setup(n, dim, cap, "fp16", seed=1, periodic=periodic)
    adj_t, _ = tops.rcll_adjacency_cells(dt, bt, st_t.rel, compute_dtype=torch.float16)
    rel_t, occ, _, nb = _jax_tables(dj, bj, st_j.rel, f)
    if dim == 2:  # two squares: the fp32 reduce rounds like the fp16 add
        adj_r, _ = jref.ref_rcll_adjacency(
            rel_t, occ, nb, jcells.neighbor_cell_offsets(dim), np.asarray(dj.cell_weights),
            jnnps.rcll_radius_cell_units(dj), compute_dtype=jnp.float16)
        np.testing.assert_array_equal(adj_t.numpy(), np.asarray(adj_r))
    else:
        np.testing.assert_array_equal(adj_t.numpy(),
                                      _eager_tile_decisions(dj, rel_t, occ, nb, jnp.float16))


# --------------------------------------------------------------------------
# K4
# --------------------------------------------------------------------------
def _ids(nl):
    """The valid ids of a list, -1 elsewhere (masked slots hold garbage)."""
    return np.where(np.asarray(nl.mask), np.asarray(nl.idx), -1)


@pytest.mark.parametrize("n,dim,cap,storage,k", [
    (500, 2, 16, "fp16", 32), (500, 2, 16, "fp32", 6), (800, 3, 32, "bf16", 48),
])
def test_neighbor_lists_plain_match_jax(n, dim, cap, storage, k):
    dj, dt, x, f, st_j, st_t, bj, bt = _setup(n, dim, cap, storage, seed=2)
    before = tnp.rcll_neighbor_list_tables.launches
    nt = tops.rcll_neighbor_lists(dt, bt, st_t.rel, k=k, nnps_dtype=TDT[storage])
    assert tnp.rcll_neighbor_list_tables.launches == before
    nj = jops.rcll_neighbor_lists(dj, bj, st_j.rel, k=k, nnps_dtype=JDT[storage],
                                  interpret=True)
    for fld in ("idx", "mask", "count"):
        np.testing.assert_array_equal(getattr(nt, fld).numpy(), np.asarray(getattr(nj, fld)))
    # true counts, past the written slots: the small list overflows
    assert bool(nt.overflowed) == bool(nj.overflowed) and (k > 6 or bool(nt.overflowed))
    # the (k, j) order of the search: identical ids where the counts fit
    ns = tnnps.rcll_neighbors(dt, st_t.rel, st_t.cell_xy, dtype=TDT[storage],
                              compute_dtype=torch.float32, k=k, binning=bt)
    np.testing.assert_array_equal(nt.count.numpy(), ns.count.numpy())
    fit = (ns.count <= k).numpy()
    np.testing.assert_array_equal(_ids(nt)[fit], _ids(ns)[fit])


def test_neighbor_lists_fp16_compute_match_eager_jax():
    """2-D: JAX's eager search (fp32-reduced squares) decides as the
    per-op tile math does, so the lists are identical."""
    dj, dt, x, f, st_j, st_t, bj, bt = _setup(500, 2, 20, "fp16", seed=3, periodic=True)
    nt = tops.rcll_neighbor_lists(dt, bt, st_t.rel, k=48, compute_dtype=torch.float16)
    nj = jnnps.rcll_neighbors(dj, st_j.rel, st_j.cell_xy, compute_dtype=jnp.float16, k=48,
                              binning=bj)
    np.testing.assert_array_equal(_ids(nt), _ids(nj))
    np.testing.assert_array_equal(nt.count.numpy(), np.asarray(nj.count))
