"""Port parity, K3: the fused RCLL search and A5 gradient.

On the CPU the port's wrapper runs its plain version. Its decisions are
made in the NNPS dtype with every op rounded, as JAX's tile math does
when called eagerly (``test_torch_nnps_kernels.py`` says why jitted JAX
differs). Its sums are held against JAX's eager ``ref_rcll_gradient``
within ``sph_gradient.rounding_bound``. The reference sums the 2-3
squares with one fp32 reduce, which decides as the per-op tile math does
at fp32 and in 2-D; for fp16 in 3-D it takes its decisions from JAX's
tile math run eagerly (``_eager_tile_decisions``, which K5's plain
version equals bit for bit, and K3's shares its decision code). The
per-particle gradient against the interpret-mode
Pallas kernel at ``tests/test_kernels.py``'s rtol = atol = 2e-4: pairs
that flip under jit sit at r ~ 2h, where dW/dr -> 0.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.core import cells as jcells
from repro.core import nnps as jnnps
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import nnps as tnnps
from repro_torch.kernels import ops as tops
from repro_torch.kernels import sph_gradient as tsg
from test_torch_helpers import one_torch_thread  # noqa: F401  (autouse fixture)
from test_torch_nnps_kernels import JDT, TDT, _eager_tile_decisions, _jax_tables, _setup


@pytest.mark.parametrize("n,dim,cap,nnps_dtype,interpret", [
    (400, 2, 24, "fp16", True), (400, 2, 24, "fp32", False), (300, 3, 32, "fp16", False),
    (300, 3, 32, "fp32", True),
])
def test_gradient_plain_matches_jax(monkeypatch, n, dim, cap, nnps_dtype, interpret):
    dj, dt, x, f, st_j, st_t, bj, bt = _setup(n, dim, cap, "fp16", seed=4)
    rel_j, occ_j, f_j, nb_j = _jax_tables(dj, bj, st_j.rel, f)
    rel_t, occ_t, (f_t,) = tops.pack_cells(bt, st_t.rel, torch.as_tensor(f))
    for a, b in ((rel_j, rel_t), (occ_j, occ_t), (f_j, f_t)):
        np.testing.assert_array_equal(np.asarray(a, np.float32), b.float().numpy())
    kw = dict(weights=tuple(dt.cell_weights), r_cell=tnnps.rcll_radius_cell_units(dt),
              hc_phys=tuple(dt.cell_sizes), h=dt.h, dim=dim, nnps_dtype=TDT[nnps_dtype])
    nb_t = tops.nb_with_sentinel(dt, "cpu")
    num, den, num_abs, den_abs = tsg.rcll_gradient_ref(rel_t, f_t, occ_t, nb_t, **kw,
                                                       abs_sums=True)
    if dim == 3 and nnps_dtype == "fp16":  # the eager tile math decides (module doc)
        adj = jnp.asarray(_eager_tile_decisions(dj, rel_j, occ_j, nb_j, jnp.float16))
        monkeypatch.setattr(jref, "ref_rcll_adjacency", lambda *a, **k: (adj, None))
    num_r, den_r = jref.ref_rcll_gradient(
        rel_j, f_j, occ_j, nb_j, jcells.neighbor_cell_offsets(dim),
        np.asarray(dj.cell_weights), jnnps.rcll_radius_cell_units(dj),
        np.asarray(dj.cell_sizes), dj.h, dim, compute_dtype=JDT[nnps_dtype])
    for got, want, mag in ((num, num_r, num_abs), (den, den_r, den_abs)):
        err = np.abs(got.numpy() - np.asarray(want))
        assert (err <= tsg.rounding_bound(mag, dim).numpy()).all()
    if not interpret:
        return
    # the whole wrapper against the interpret-mode kernel
    g_t = tops.rcll_gradient_particles(dt, bt, st_t.rel, torch.as_tensor(f),
                                       nnps_dtype=TDT[nnps_dtype])
    g_j = jops.rcll_gradient_particles(dj, bj, st_j.rel, jnp.asarray(f),
                                       nnps_dtype=JDT[nnps_dtype], interpret=True)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("cap,c1", [(1, 40), (3, 70), (20, 70), (37, 33), (128, 5)])
def test_gradient_work_rows_are_the_occupied_slots(cap, c1):
    """K3's work rows, by the kernel's arithmetic (popcount scan, search,
    rank-th set bit), are exactly the occupied slots of a mask with holes
    anywhere, in cell-major order; its occupancy words hold the mask."""
    rng = np.random.default_rng(cap)
    occ = torch.as_tensor((rng.random((c1, cap)) < 0.45).astype(np.float32))
    occ[rng.integers(0, c1)] = 0.0  # an empty cell inside a block
    occ[-1] = 0.0
    words = tsg.occupancy_words(occ)
    assert words.shape == (c1, -(-cap // 32))
    for c in range(c1):
        for s in range(cap):
            assert bool((int(words[c, s // 32]) >> (s % 32)) & 1) == bool(occ[c, s] > 0)
    want = [(c, s) for c in range(c1) for s in range(cap) if occ[c, s] > 0]
    assert tsg.work_rows(occ) == want


@pytest.mark.parametrize("fault", tsg.FAULTS)
def test_gradient_planted_params_change_one_field(fault):
    clean, planted = list(tsg.walk_params()), list(tsg.planted_params(fault)())
    assert clean == [0, 0]
    changed = [n for n, a, b in zip(tsg.FAULTS, clean, planted) if a != b]
    assert changed == [fault]
    with pytest.raises(ValueError):
        tsg.planted_params("no_such_fault")
