"""K2: fused cell-blocked WCSPH force evaluation over RCLL cell tables.

Replaces the Pallas kernel ``repro/kernels/rcll_force.py::rcll_force``
with the hand-written CUDA kernel ``csrc/rcll_force.cu``. Per (self cell,
neighbor cell) tile of ``cap x cap`` pairs it decodes Eq. (7) with the
stale-cell shift re-anchor, evaluates the B-spline gradient, derives
p/ρ² from the streamed 1/ρ through the scheme's EOS and sums the ∇W
channel (pressure + artificial viscosity), the Morris dv channel and the
delta-SPH continuity term in fp32 over the 3^d neighborhood.

Inputs (C+1 rows, the last the sentinel empty cell): ``rel (C+1, d,
cap)`` fp16 or fp32, ``shift (C+1, d, cap)`` int16 (cell_now −
cell_stale), ``v (C+1, d, cap)`` and ``m (C+1, cap)`` in the records
dtype (fp16, bf16 or fp32), ``inv_rho (C+1, cap)`` fp32, ``nb_ids (C+1,
M)`` int32. Outputs ``drho (C+1, cap)`` and ``acc (C+1, d, cap)`` fp32.

On the H100 the kernel is bound by operations: about 60 fp32 operations
per pair against ~16 bytes per slot (taylor_green at N = 1,048,576
evaluates (C+1)·9·cap² ≈ 6.5e8 pairs per step). The simple design (one
block per self cell, one thread per self slot, neighbor tiles staged in
shared memory) is described, with what it leaves on the table, in the
CUDA source.

:func:`rcll_force` launches the kernel for CUDA tensors and takes the
plain version :func:`rcll_force_ref` only for CPU tensors.
``rcll_force.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import bspline
from repro_torch.core import cells as cells_lib
from repro_torch.core import scheme as scheme_lib
from repro_torch.kernels import _build, tiling

_REL_KIND = {torch.float16: 0, torch.float32: 1}
_REC_KIND = {torch.float16: 0, torch.bfloat16: 1, torch.float32: 2}

#: Peak bytes of pair intermediates per chunk of the plain version.
REF_CHUNK_BYTES = 2 * 10**9


def rcll_force_ref(
    rel: torch.Tensor,
    shift: torch.Tensor,
    v: torch.Tensor,
    m: torch.Tensor,
    inv_rho: torch.Tensor,
    nb_ids: torch.Tensor,
    *,
    hc_phys: tuple,
    h: float,
    dim: int,
    scheme: scheme_lib.Scheme,
    abs_sums: bool = False,
):
    """Plain PyTorch version of :func:`rcll_force`.

    Processes self cells in chunks sized so that the pair intermediates
    stay under about ``REF_CHUNK_BYTES``; within a chunk it walks the
    neighbor cells in order and adds each tile's sum over j, as the
    kernel does. With ``abs_sums`` it also returns, per output, the sum
    over pairs of the magnitudes that round in each pair term (drho_abs,
    acc_abs; see :func:`_magnitudes`), from which :func:`rounding_bound`
    derives the kernel-vs-plain tolerance.
    """
    C1, d, cap = rel.shape
    M = nb_ids.shape[1]
    offs = cells_lib.neighbor_cell_offsets(dim)
    dev = rel.device
    por2 = scheme.por2_inv(inv_rho)
    drho = torch.empty((C1, cap), dtype=torch.float32, device=dev)
    acc = torch.empty((C1, d, cap), dtype=torch.float32, device=dev)
    if abs_sums:
        drho_abs = torch.empty_like(drho)
        acc_abs = torch.empty_like(acc)
        por2_mag = _por2_mag(scheme, inv_rho, por2)
    chunk = max(1, REF_CHUNK_BYTES // (cap * cap * 4 * 32))
    for c0 in range(0, C1, chunk):
        sl = slice(c0, min(C1, c0 + chunk))
        rel_i, shift_i = rel[sl], shift[sl]
        v_i = v[sl].to(torch.float32)
        inv_i = inv_rho[sl][:, :, None]
        por2_i = por2[sl][:, :, None]
        b = rel_i.shape[0]
        drho_c = torch.zeros((b, cap), dtype=torch.float32, device=dev)
        acc_c = torch.zeros((b, d, cap), dtype=torch.float32, device=dev)
        if abs_sums:
            drho_a = torch.zeros_like(drho_c)
            acc_a = torch.zeros_like(acc_c)
        for k in range(M):
            nbk = nb_ids[sl, k].long()
            disp, r2 = tiling.tile_phys_disp_shifted(
                rel_i, rel[nbk], shift_i, shift[nbk], offs[k], hc_phys
            )
            coef = bspline.dw_over_r(torch.sqrt(r2), h, dim)
            mj = m[nbk].to(torch.float32)[:, None, :]
            inv_j = inv_rho[nbk][:, None, :]
            por2_j = por2[nbk][:, None, :]
            v_j = v[nbk].to(torch.float32)
            dv = [v_i[:, a, :, None] - v_j[:, a, None, :] for a in range(d)]
            dv_dot_disp = torch.zeros_like(r2)
            for a in range(d):
                dv_dot_disp = dv_dot_disp + dv[a] * disp[a]
            gc = scheme.gradw_pair_coef(
                mj, por2_i, por2_j, inv_i, inv_j, dv_dot_disp, r2, h=h
            ) * coef
            if scheme.has_dv_term:
                vc = scheme.dv_pair_coef(mj, coef * r2, inv_i, inv_j, r2, h=h)
            for a in range(d):
                contrib = -gc * disp[a]
                if scheme.has_dv_term:
                    contrib = contrib + vc * dv[a]
                acc_c[:, a] += torch.sum(contrib, dim=-1)
            dterm = mj * coef * dv_dot_disp
            if scheme.has_delta_term:
                dterm = dterm + scheme.drho_pair_term(
                    mj, inv_i, inv_j, coef * r2, r2, h=h
                )
            if abs_sums:
                d_mag, a_mag = _magnitudes(
                    scheme, h, mj, inv_i, inv_j, coef, r2, disp, dv,
                    por2_mag[sl][:, :, None], por2_mag[nbk][:, None, :],
                )
                drho_a += torch.sum(d_mag, dim=-1)
                for a in range(d):
                    acc_a[:, a] += torch.sum(a_mag[a], dim=-1)
            drho_c += torch.sum(dterm, dim=-1)
        drho[sl] = drho_c
        acc[sl] = acc_c
        if abs_sums:
            drho_abs[sl] = drho_a
            acc_abs[sl] = acc_a
    if abs_sums:
        return drho, acc, drho_abs, acc_abs
    return drho, acc


def _por2_mag(scheme: scheme_lib.Scheme, inv: torch.Tensor,
              por2: torch.Tensor) -> torch.Tensor:
    """Magnitude of p/ρ² for the rounding bound.

    The kernel evaluates the linear EOS's p/ρ² = c0²(1/ρ − ρ0/ρ²) with
    explicitly rounded operations in this version's order, so the two
    agree on it bit for bit and |p/ρ²| is its magnitude. Taking the EOS's
    two terms with absolute values instead would inflate it by
    ~1/|1 − ρ0/ρ| (~200x at taylor_green's densities) and hide a wrong
    pressure or viscous term. Tait's p/ρ² goes through ``powf`` in the
    kernel and torch's ``pow`` here, which may differ by an ulp before
    (ρ0/ρ)^-γ − 1 cancels, so there the two terms are taken with absolute
    values.
    """
    if scheme.eos == "tait":
        B = abs(scheme.c0 * scheme.c0 * scheme.rho0 / scheme.gamma)
        return B * ((scheme.rho0 * inv) ** -scheme.gamma + 1.0) * inv * inv
    return torch.abs(por2)


def _magnitudes(scheme, h, mj, inv_i, inv_j, coef, r2, disp, dv, pm_i, pm_j):
    """Per-pair magnitudes of the quantities whose rounding differs
    between the kernel (FMA-contracted) and the plain version: every sum
    inside a pair term is replaced by the sum of its parts' magnitudes,
    so no cancellation hides a rounding error."""
    d = len(disp)
    acoef = torch.abs(coef)
    dvd_mag = sum(torch.abs(dv[a] * disp[a]) for a in range(d))
    reg = 0.01 * h * h
    gc_mag = mj * (pm_i + pm_j)
    if scheme.has_av_term:
        gc_mag = gc_mag + mj * abs(scheme.alpha * scheme.c0 * h) * dvd_mag / (
            r2 + reg) * 2.0 * inv_i * inv_j / (inv_i + inv_j)
    gc_mag = gc_mag * acoef
    d_mag = mj * acoef * dvd_mag
    if scheme.has_delta_term:
        d_mag = d_mag + abs(2.0 * scheme.delta * h * scheme.c0) * mj * inv_j * (
            torch.abs(inv_i - inv_j)) / (inv_i * inv_j) * acoef * r2 / (r2 + reg)
    a_mag = []
    for a in range(d):
        t = gc_mag * torch.abs(disp[a])
        if scheme.has_dv_term:
            t = t + mj * abs(2.0 * scheme.mu) * acoef * r2 * inv_i * inv_j / (
                r2 + reg) * torch.abs(dv[a])
        a_mag.append(t)
    return d_mag, a_mag


def rounding_bound(abs_sum: torch.Tensor, dim: int) -> torch.Tensor:
    """Kernel-vs-plain tolerance from the magnitude sums of
    :func:`rcll_force_ref`.

    Both sum n = 3^dim · cap pair terms in fp32, in different orders,
    and each term's ~16 roundings differ where nvcc contracts
    multiply-adds: |Δ| <= (n + 16) · u · Σ|parts| with u = 2^-24 (the
    classic recursive-summation and product bounds). A factor 4 covers
    the rounding of r² feeding the B-spline (continuous at R = 1, 2).
    ``abs_sum`` carries the cap dimension last; n uses it.
    """
    n = 3**dim * abs_sum.shape[-1]
    return 4.0 * (n + 16) * 2.0**-24 * abs_sum


#: Limit on ‖kernel − plain‖₂ / ‖plain‖₂ of each output over occupied
#: slots. Readings on an H100 (PERF.md): at most 1.8e-6 at the main
#: path's inputs (taylor_green, N = 1,048,576) and 1.9e-7 on random
#: clouds; a 1% error in the EOS constant gives 3.5e-4 or more, a 1%
#: error in μ 1e-2 and a dropped Morris term ~1.
NORMWISE_LIMIT = 1e-5


def check_against_plain(args: tuple, kw: dict) -> dict:
    """Launch the kernel and its plain version on the same inputs (CUDA
    tensors) and hold the kernel to both tolerances: every output element
    within :func:`rounding_bound`, and each output's normwise difference
    over occupied slots (m != 0) within :data:`NORMWISE_LIMIT`.

    Empty slots carry v = 0 and m = 0, so their outputs (never read back)
    hold viscous sums against their neighbors' full velocities, up to
    ~2e3 times the occupied slots' (taylor_green at N = 1,048,576):
    ``max_abs_err`` is taken over occupied slots, which the force pass
    returns. Raises AssertionError; returns ``max_abs_err``, ``max_ratio``
    (error over bound, all slots) and ``normwise``.
    """
    d_k, a_k = rcll_force(*args, **kw)
    d_r, a_r, d_abs, a_abs = rcll_force_ref(*args, **kw, abs_sums=True)
    occ = args[3] != 0
    out = {"max_abs_err": 0.0, "max_ratio": 0.0, "normwise": 0.0}
    for name, k, r, s, mask in (("drho", d_k, d_r, d_abs, occ),
                                ("acc", a_k, a_r, a_abs, occ[:, None, :].expand_as(a_r))):
        if not bool(torch.isfinite(k).all()):
            raise AssertionError(f"K2 {name}: non-finite values")
        err = torch.abs(k - r)
        ratio = float((err / rounding_bound(s, kw["dim"]).clamp_min(1e-30)).max())
        normwise = float(torch.linalg.vector_norm(err[mask])
                         / torch.linalg.vector_norm(r[mask]).clamp_min(1e-30))
        out["max_abs_err"] = max(out["max_abs_err"], float(err[mask].max()))
        out["max_ratio"] = max(out["max_ratio"], ratio)
        out["normwise"] = max(out["normwise"], normwise)
        if ratio > 1.0 or normwise > NORMWISE_LIMIT:
            raise AssertionError(
                f"K2 {name} disagrees with its plain version: max err/bound {ratio:.3g}, "
                f"normwise {normwise:.3g} (limit {NORMWISE_LIMIT:g})")
    return out


@functools.cache
def _entry():
    fn = _build.library().lib.repro_rcll_force
    fn.argtypes = (
        [ctypes.c_int] * 3 + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3
        + [ctypes.c_void_p] * 3
    )
    fn.restype = ctypes.c_int
    return fn


def kernel_params(*, hc_phys: tuple, h: float, dim: int, scheme: scheme_lib.Scheme):
    """The kernel's fp32/int parameters, each folded in double in the
    order the plain version's Python expressions fold it."""
    hc = list(hc_phys) + [0.0] * (3 - len(hc_phys))
    if scheme.eos == "tait":
        eos_k = scheme.c0 * scheme.c0 * scheme.rho0 / scheme.gamma
    else:
        eos_k = scheme.c0 * scheme.c0
    fparams = hc + [
        h,
        bspline.alpha_d(dim, h) / h,
        eos_k,
        scheme.rho0,
        -scheme.gamma,
        0.01 * h * h,
        -scheme.alpha * scheme.c0 * h,
        2.0 * scheme.mu,
        2.0 * scheme.delta * h * scheme.c0,
    ]
    iparams = [
        int(scheme.eos == "tait"), int(scheme.has_av_term),
        int(scheme.has_dv_term), int(scheme.has_delta_term),
    ]
    return (ctypes.c_float * len(fparams))(*fparams), (ctypes.c_int * 4)(*iparams)


def _check(t, name, dtypes, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name} has dtype {t.dtype}, expected one of {dtypes}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def rcll_force(
    rel: torch.Tensor,
    shift: torch.Tensor,
    v: torch.Tensor,
    m: torch.Tensor,
    inv_rho: torch.Tensor,
    nb_ids: torch.Tensor,
    *,
    hc_phys: tuple,
    h: float,
    dim: int,
    scheme: scheme_lib.Scheme,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused SPH RHS ``(drho (C+1, cap), acc (C+1, d, cap))``.

    CPU tensors take :func:`rcll_force_ref`; CUDA tensors launch the
    kernel or raise.
    """
    dev = rel.device
    if dev.type == "cpu":
        return rcll_force_ref(rel, shift, v, m, inv_rho, nb_ids,
                              hc_phys=hc_phys, h=h, dim=dim, scheme=scheme)
    if dev.type != "cuda":
        raise ValueError(f"rcll_force runs on cuda or cpu tensors, got {dev}")
    C1, d, cap = rel.shape
    M = 3**dim
    if d != dim or dim not in (2, 3):
        raise ValueError(f"rel has {d} axes; dim is {dim} (2 or 3 supported)")
    if not 1 <= cap <= 1024:
        raise ValueError(f"cap must be in [1, 1024], got {cap}")
    _check(rel, "rel", tuple(_REL_KIND), (C1, d, cap), dev)
    _check(shift, "shift", (torch.int16,), (C1, d, cap), dev)
    _check(v, "v", tuple(_REC_KIND), (C1, d, cap), dev)
    _check(m, "m", (v.dtype,), (C1, cap), dev)
    _check(inv_rho, "inv_rho", (torch.float32,), (C1, cap), dev)
    _check(nb_ids, "nb_ids", (torch.int32,), (C1, M), dev)
    drho = torch.empty((C1, cap), dtype=torch.float32, device=dev)
    acc = torch.empty((C1, d, cap), dtype=torch.float32, device=dev)
    fparams, iparams = kernel_params(hc_phys=hc_phys, h=h, dim=dim, scheme=scheme)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _entry()(
            dim, _REL_KIND[rel.dtype], _REC_KIND[v.dtype],
            rel.data_ptr(), shift.data_ptr(), v.data_ptr(), m.data_ptr(),
            inv_rho.data_ptr(), nb_ids.data_ptr(), drho.data_ptr(), acc.data_ptr(),
            C1, cap, M, ctypes.addressof(fparams), ctypes.addressof(iparams), stream,
        )
    _build.check_rc(rc, "rcll_force")
    _WRAPPER.launches += 1
    return drho, acc


rcll_force.launches = 0
# The counter lives on this function object even if the module attribute
# is rebound (e.g. by a harness that wraps the wrapper).
_WRAPPER = rcll_force
