"""Port parity, the NNPS path as a whole: the paper's gradient case
(``cases.gradient_test_particles``, ds = 1/32) through the port's entry
points (binning, K4, K5 and K3; plain versions on the CPU) and through
the JAX package's (Pallas kernels in interpret mode). Neighbor sets and
counts are equal; the gradients agree at ``tests/test_kernels.py``'s
rtol = atol = 2e-4 (see ``test_torch_nnps_kernels.py`` for why not bit
for bit), and the port's meets that test's interior accuracy gate.
"""
import numpy as np
import jax.numpy as jnp
import torch

from repro.core import cases as jcases
from repro.core import cells as jcells
from repro.core import nnps as jnnps
from repro.core import rcll as jrcll
from repro.kernels import ops as jops
from repro_torch.core import cases as tcases
from repro_torch.core import cells as tcells
from repro_torch.core import interop
from repro_torch.core import nnps as tnnps
from repro_torch.core import rcll as trcll
from repro_torch.kernels import ops as tops
from test_torch_helpers import one_torch_thread  # noqa: F401  (autouse fixture)


def test_nnps_path_matches_jax():
    """The NNPS path on the paper's gradient case (ds = 1/32): binning, K4,
    K5 and K3 through the port's entry points (plain versions on the CPU)
    and through JAX's (interpret-mode kernels)."""
    dj, x = jcases.gradient_test_particles(ds=1 / 32)
    dt, x_t = tcases.gradient_test_particles(ds=1 / 32)
    np.testing.assert_array_equal(x, x_t)
    n = x.shape[0]
    st_j = jrcll.init_state(dj, dj.normalize(jnp.asarray(x)))
    st_t = trcll.init_state(dt, dt.normalize(torch.as_tensor(x)))
    np.testing.assert_array_equal(np.asarray(st_j.rel), st_t.rel.numpy())
    cap = tcells.default_capacity(dt, n)
    assert cap == jcells.default_capacity(dj, n)
    bj = jcells.bin_by_cell_id(dj, dj.flat_cell_id(st_j.cell_xy), st_j.cell_xy, cap)
    bt = tcells.bin_by_cell_id(dt, dt.flat_cell_id(st_t.cell_xy), st_t.cell_xy, cap)
    assert int(bt.overflow) == 0
    nj = jops.rcll_neighbor_lists(dj, bj, st_j.rel, k=48, interpret=True)
    nt = tops.rcll_neighbor_lists(dt, bt, st_t.rel, k=48)
    np.testing.assert_array_equal(nt.count.numpy(), np.asarray(nj.count))
    assert bool(tnnps.neighbor_sets_equal(
        nt, interop.fields_from_numpy(tnnps.NeighborList, {
            f: np.asarray(getattr(nj, f)) for f in ("idx", "mask", "count")}, "cpu")).all())
    _, cnt = tops.rcll_adjacency_cells(dt, bt, st_t.rel)
    np.testing.assert_array_equal(cnt.numpy().astype(np.int32), nt.count.numpy())
    f_t = tcases.cubic_field(torch.as_tensor(x)).float()
    f_j = jnp.asarray(f_t.numpy())
    g_t = tops.rcll_gradient_particles(dt, bt, st_t.rel, f_t)
    g_j = jops.rcll_gradient_particles(dj, bj, st_j.rel, f_j, interpret=True)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=2e-4, atol=2e-4)
    interior = (np.abs(x - 0.5) < 0.5 - 2.5 * dt.h).all(axis=1)
    rms = np.sqrt(np.mean((g_t.numpy()[interior, 0] - tcases.cubic_gradient_x(x)[interior]) ** 2))
    assert rms < 0.15
    # Table 2 on the path: the fp32 truth (JAX without x64) and the fp16 lists
    truth_j = jnnps.reference_neighbors(dj, dj.normalize(jnp.asarray(x)), k=48)
    truth_t = tnnps.reference_neighbors(dt, dt.normalize(torch.as_tensor(x)), k=48,
                                        dtype=torch.float32)
    assert int(jnnps.count_wrong_determinations(truth_j, nj)) == int(
        tnnps.count_wrong_determinations(truth_t, nt))
