"""Kernel vs plain version on the card: K1 bit for bit, K2 by
``rcll_force.check_against_plain``. Marked ``cuda``: a CUDA kernel has no CPU
mode, so these skip without a GPU. The file imports no JAX; on a machine
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
from repro_torch.kernels import rcll_force as trf
from test_torch_helpers import DAM, WCSPH, make_tiles, one_torch_thread  # noqa: F401


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


@pytest.mark.cuda
@pytest.mark.parametrize("dim,scheme,records", [
    (2, WCSPH, "fp16"), (2, DAM, "fp32"), (2, DAM, "bf16"), (3, WCSPH, "fp16"),
])
def test_rcll_force_kernel_within_rounding_bound(cuda_device, dim, scheme, records):
    t, kw = make_tiles(5 + dim, dim, scheme, records, n=8000 if dim == 2 else 6000)
    t = {k: x.to(cuda_device) for k, x in t.items()}
    before = trf.rcll_force.launches
    # raises unless every element is within rounding_bound and each
    # output's normwise difference over occupied slots within NORMWISE_LIMIT
    trf.check_against_plain(tuple(t.values()), kw)
    assert trf.rcll_force.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["no_dv", "eos_1pct"])
def test_check_against_plain_fails_a_planted_fault(cuda_device, monkeypatch, fault):
    """The tolerances catch a wrong kernel: the Morris term dropped, or
    the EOS constant 1% off (at taylor_green's c0 and mu)."""
    t, kw = make_tiles(7, 2, dict(c0=10.0, rho0=1.0, mu=0.05), "fp16", n=8000)
    t = {k: x.to(cuda_device) for k, x in t.items()}
    params = trf.kernel_params

    def faulty(**k):
        f, i = params(**k)
        if fault == "no_dv":
            i[2] = 0
        else:
            f[5] *= 1.01
        return f, i

    monkeypatch.setattr(trf, "kernel_params", faulty)
    with pytest.raises(AssertionError, match="disagrees"):
        trf.check_against_plain(tuple(t.values()), kw)


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
    t = {k: x.to(cuda_device) for k, x in t.items()}
    t["shift"] = t["shift"].to(torch.int32)
    with pytest.raises(ValueError, match="shift"):
        trf.rcll_force(*t.values(), **kw)
