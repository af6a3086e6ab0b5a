"""Port parity, foundations: precision, Domain (Eqs. 5-6), the B-spline,
the sph pair primitives, the Scheme channels and the wall lattices.

Every test feeds the same numpy inputs (from a seed) to the JAX function
and its ``repro_torch`` counterpart. Tolerance: bitwise, except where a
transcendental (``pow`` of the Tait EOS) is evaluated by two different
math libraries — there within 4 ulp of fp32.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.core import boundaries as jb
from repro.core import bspline as jbs
from repro.core import domain as jd
from repro.core import precision as jp
from repro.core import scheme as jsch
from repro.core import sph as jsph
from repro_torch.core import boundaries as tb
from repro_torch.core import bspline as tbs
from repro_torch.core import domain as td
from repro_torch.core import precision as tp
from repro_torch.core import scheme as tsch
from repro_torch.core import sph as tsph
from test_torch_helpers import one_torch_thread  # noqa: F401  (autouse fixture)

DOMAINS = [
    dict(lo=(0.0, 0.0), hi=(1.0, 1.0), h=0.03, periodic=(True, True)),
    dict(lo=(0.0, -0.075), hi=(0.8, 1.075), h=0.06, periodic=(True, False)),
    dict(lo=(-0.15, -0.15), hi=(2.15, 1.3), h=0.06, cell_factor=1.5),
    dict(lo=(0.0, 0.0, 0.0), hi=(1.0, 0.5, 0.7), h=0.04, periodic=(True, False, True)),
]


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _bits_equal(a, b):
    a, b = np.atleast_1d(_np(a)), np.atleast_1d(_np(b))
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


def test_precision_tables_match():
    assert set(tp.DTYPES) == set(jp.DTYPES)
    for name in jp.DTYPES:
        assert tp.DTYPES[name].itemsize == jnp.dtype(jp.DTYPES[name]).itemsize
    for pol_t, pol_j in [(tp.PrecisionPolicy(), jp.PrecisionPolicy()),
                         (tp.APPROACH_I, jp.APPROACH_I),
                         (tp.FP32_RECORDS, jp.FP32_RECORDS)]:
        assert pol_t.half_records == pol_j.half_records
        for f in ("nnps", "coords", "physics", "accum", "nnps_compute", "records"):
            assert getattr(pol_t, f) == getattr(pol_j, f)
            assert getattr(pol_t, f + "_dtype") == tp.DTYPES[getattr(pol_j, f)]
    assert tp.PrecisionPolicy().with_records("bf16").records_dtype == torch.bfloat16
    with pytest.raises(ValueError):
        tp.PrecisionPolicy().with_records("fp8")


@pytest.mark.parametrize("spec", DOMAINS)
def test_domain_geometry_and_eq5_eq6(spec):
    dj, dt = jd.Domain(**spec), td.Domain(**spec)
    for attr in ("ncells", "cell_sizes", "hc_norm_axes", "cell_weights",
                 "origin_norm", "h_d", "radius_norm", "ncells_total"):
        assert getattr(dj, attr) == getattr(dt, attr), attr
    rng = np.random.default_rng(sum(map(ord, str(spec))))
    lo, hi = np.asarray(spec["lo"]), np.asarray(spec["hi"])
    x = (lo + rng.uniform(-0.02, 1.02, (500, dj.dim)) * (hi - lo)).astype(np.float32)
    xn_j = dj.normalize(jnp.asarray(x))
    xn_t = dt.normalize(torch.as_tensor(x))
    _bits_equal(xn_j, xn_t)
    c_j, c_t = dj.cell_coords_of(xn_j), dt.cell_coords_of(xn_t)
    _bits_equal(c_j, c_t)
    rel_j, rel_t = dj.to_relative(xn_j, c_j), dt.to_relative(xn_t, c_t)
    _bits_equal(rel_j, rel_t)
    _bits_equal(dj.from_relative(rel_j, c_j), dt.from_relative(rel_t, c_t))
    _bits_equal(dj.denormalize(xn_j), dt.denormalize(xn_t))
    _bits_equal(dj.flat_cell_id(c_j), dt.flat_cell_id(c_t))
    delta = rng.integers(-40, 40, (300, dj.dim)).astype(np.int32)
    _bits_equal(dj.wrap_cell_delta(jnp.asarray(delta)),
                dt.wrap_cell_delta(torch.as_tensor(delta)))


def test_lattice_positions_match():
    spec = DOMAINS[2]
    np.testing.assert_array_equal(
        jd.lattice_positions(jd.Domain(**spec), 0.05, jitter=0.2, seed=3),
        td.lattice_positions(td.Domain(**spec), 0.05, jitter=0.2, seed=3),
    )


@pytest.mark.parametrize("dim", [2, 3])
def test_bspline_bitwise(dim):
    rng = np.random.default_rng(dim)
    h = 0.037
    r = rng.uniform(0.0, 2.3 * h, 4000).astype(np.float32)
    r[:5] = [0.0, h, 2 * h, 1e-13, 0.5 * h]
    rj, rt = jnp.asarray(r), torch.as_tensor(r)
    assert jbs.alpha_d(dim, h) == tbs.alpha_d(dim, h)
    for fj, ft in [(jbs.w, tbs.w), (jbs.dw_dr, tbs.dw_dr),
                   (jbs.dw_over_r, tbs.dw_over_r)]:
        _bits_equal(fj(rj, h, dim), ft(rt, h, dim))


def _pair_inputs(seed, n=3000):
    rng = np.random.default_rng(seed)
    f = lambda lo, hi: rng.uniform(lo, hi, n).astype(np.float32)
    return dict(mj=f(0, 2e-3), inv_i=f(0.9, 1.1), inv_j=f(0.9, 1.1),
                por2_i=f(-2, 2), por2_j=f(-2, 2), dvd=f(-1, 1),
                r2=f(0, 4e-3), xdg=f(-3, 3))


def test_sph_pair_primitives_bitwise():
    a = _pair_inputs(0)
    J = {k: jnp.asarray(v) for k, v in a.items()}
    T = {k: torch.as_tensor(v) for k, v in a.items()}
    _bits_equal(jsph.eos_tait(J["inv_i"], 1.0, 12.5), tsph.eos_tait(T["inv_i"], 1.0, 12.5))
    _bits_equal(jsph.eos_tait_por2_inv(J["inv_i"], 1.0, 12.5),
                tsph.eos_tait_por2_inv(T["inv_i"], 1.0, 12.5))
    _bits_equal(jsph.pressure_pair_coef(J["mj"], J["por2_i"], J["por2_j"]),
                tsph.pressure_pair_coef(T["mj"], T["por2_i"], T["por2_j"]))
    _bits_equal(
        jsph.viscosity_pair_coef_inv(J["mj"], J["xdg"], J["inv_i"], J["inv_j"],
                                     J["r2"], h=0.0375, mu=0.05),
        tsph.viscosity_pair_coef_inv(T["mj"], T["xdg"], T["inv_i"], T["inv_j"],
                                     T["r2"], h=0.0375, mu=0.05),
    )


SCHEMES = [
    dict(c0=10.0, rho0=1.0, mu=0.05),  # taylor_green / poiseuille (linear + Morris)
    dict(c0=14.142135623730951, rho0=1.0, eos="tait", gamma=7.0,
         viscosity="none", alpha=0.1, delta=0.1, body_force=(0.0, -1.0)),  # dam_break
    dict(c0=10.0, mu=0.01, delta=0.1),  # cavity
]


@pytest.mark.parametrize("spec", SCHEMES)
def test_scheme_channels(spec):
    sj, st = jsch.Scheme(**spec), tsch.Scheme(**spec)
    assert (sj.has_av_term, sj.has_dv_term, sj.has_delta_term) == (
        st.has_av_term, st.has_dv_term, st.has_delta_term)
    a = _pair_inputs(1)
    J = {k: jnp.asarray(v) for k, v in a.items()}
    T = {k: torch.as_tensor(v) for k, v in a.items()}
    h = 0.06
    pj, pt = sj.por2_inv(J["inv_i"]), st.por2_inv(T["inv_i"])
    if sj.eos == "linear":
        _bits_equal(pj, pt)
    else:
        # XLA's pow vs torch's (two libms): the power agrees within
        # 4 ulp, so p/ρ² = B (pow − 1) inv² within 4 ulp of B·pow·inv²
        # (the subtraction of 1 cancels, it adds no error of its own).
        ratio = 1.0 * a["inv_i"]
        pow_j = np.asarray(jnp.asarray(ratio) ** -sj.gamma)
        pow_t = (torch.as_tensor(ratio) ** -st.gamma).numpy()
        assert _ulps(pow_j, pow_t).max() <= 4
        B = sj.c0 * sj.c0 * sj.rho0 / sj.gamma
        scale = np.abs(B * pow_j * a["inv_i"] ** 2)
        assert np.all(np.abs(np.asarray(pj) - pt.numpy()) <= 4 * 2**-23 * scale)
        pr_j, pr_t = sj.pressure(1.0 / J["inv_i"]), st.pressure(1.0 / T["inv_i"])
        np.testing.assert_allclose(pr_t.numpy(), np.asarray(pr_j), rtol=4 * 2**-23, atol=1e-5)
    _bits_equal(
        sj.gradw_pair_coef(J["mj"], J["por2_i"], J["por2_j"], J["inv_i"],
                           J["inv_j"], J["dvd"], J["r2"], h=h),
        st.gradw_pair_coef(T["mj"], T["por2_i"], T["por2_j"], T["inv_i"],
                           T["inv_j"], T["dvd"], T["r2"], h=h),
    )
    if sj.has_dv_term:
        _bits_equal(
            sj.dv_pair_coef(J["mj"], J["xdg"], J["inv_i"], J["inv_j"], J["r2"], h=h),
            st.dv_pair_coef(T["mj"], T["xdg"], T["inv_i"], T["inv_j"], T["r2"], h=h),
        )
    if sj.has_delta_term:
        _bits_equal(
            sj.drho_pair_term(J["mj"], J["inv_i"], J["inv_j"], J["xdg"], J["r2"], h=h),
            st.drho_pair_term(T["mj"], T["inv_i"], T["inv_j"], T["xdg"], T["r2"], h=h),
        )
    _bits_equal(sj.body_force_vec(2), st.body_force_vec(2, "cpu"))


def test_scheme_rejects_unknown_kinds():
    with pytest.raises(ValueError):
        tsch.Scheme(c0=1.0, eos="ideal")
    with pytest.raises(ValueError):
        tsch.Scheme(c0=1.0, viscosity="sph")
    assert tsch.wcsph(10.0, 1.0, 0.05) == tsch.Scheme(c0=10.0, rho0=1.0, mu=0.05)


def test_boundaries_match():
    sides = ((1, 1), (1, 0), (0, 0), (0, 1))
    vel = {(1, 1): (1.0, 0.0)}
    pj, vj = jb.box_wall_particles((0.0, 0.0), (1.0, 1.0), 0.05, 3, sides, vel)
    pt, vt = tb.box_wall_particles((0.0, 0.0), (1.0, 1.0), 0.05, 3, sides, vel)
    np.testing.assert_array_equal(pj, pt)
    np.testing.assert_array_equal(vj, vt)
    assert jb.wall_extent((0.0, 0.0), (2.0, 1.3), 0.05, 3, sides[1:]) == \
        tb.wall_extent((0.0, 0.0), (2.0, 1.3), 0.05, 3, sides[1:])
    np.testing.assert_array_equal(jb.fluid_lattice((0.0, 0.0), (0.5, 1.0), 0.05),
                                  tb.fluid_lattice((0.0, 0.0), (0.5, 1.0), 0.05))
