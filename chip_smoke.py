#!/usr/bin/env python3
"""Build and drive the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py                 # all phases but the profile (6)
    python3 chip_smoke.py --phases 1,2    # build + kernel checks only
    python3 chip_smoke.py --phases 6      # the profile

Phases (each prints its own lines and raises on failure):
  1. device and build: ``nvidia-smi`` name and power limit, torch/CUDA
     versions, the nvcc build of ``src/repro_torch/csrc`` and its ptxas
     register/spill lines;
  2. every kernel against its plain PyTorch version on the card, on
     random Verlet-advanced clouds (2-D ~65k and 3-D ~30k particles):
     K1 (cell pack) bit for bit in both slab layouts, K2 (fused force)
     by ``rcll_force.check_against_plain`` (each element within
     ``rounding_bound``, each output within ``NORMWISE_LIMIT`` over
     occupied slots) for the linear EOS + Morris and the Tait EOS +
     artificial viscosity + delta-SPH schemes, fp16 and fp32 records;
  3. the main path at full size: ``Simulation.from_case("taylor_green",
     ds=1/1024)`` (N = 1,048,576, fp16 records) through ``run_timed``
     with observables every 10 steps; launch counts are zeroed just
     before and read just after; then K1 and K2 are timed on the main
     path's own inputs beside their plain versions and their bounds;
  4. the stale-binning path: the skinned, dropped-column dam break at
     ~250k particles, long enough for >= 2 in-run rebuilds between which
     K2 consumes non-zero cell shifts;
  5. a small taylor_green (ds = 1/64, 20 steps) through the kernels and
     through the plain versions, both on the card, with fp32 and with fp16
     records, at the CPU slice test's tolerances (see the phase);
  6. (only when asked: ``--phases 6``) where a main-path step's time
     goes: host-timed decision / rebuild / physics split with a
     synchronize after each, and a ``torch.profiler`` window with device
     time by kernel and the device's busy share;
  7. planted faults in K2: the K2 check at the main path's inputs,
     phase 2 and phase 5 must each fail on each.

The line before the last is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``. Without CUDA (or without the package
beside this script) it exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_FP32_OPS_PER_S = 67e12  # fp32 outside the tensor cores, H100 SXM


def log(msg: str = "") -> None:
    print(msg, flush=True)


# --------------------------------------------------------------------------
# helpers
# --------------------------------------------------------------------------
@contextlib.contextmanager
def capture_kernel_inputs(store: dict):
    """Record the arguments of the next K1/K2 wrapper calls (the calls
    still go through the original wrappers and their counters)."""
    from repro_torch.kernels import cell_pack, rcll_force

    k1, k2 = cell_pack.cell_tables, rcll_force.rcll_force

    def cap1(*args, **kw):
        store["k1"] = (args, kw)
        return k1(*args, **kw)

    def cap2(*args, **kw):
        store["k2"] = (args, kw)
        return k2(*args, **kw)

    cell_pack.cell_tables, rcll_force.rcll_force = cap1, cap2
    try:
        yield store
    finally:
        cell_pack.cell_tables, rcll_force.rcll_force = k1, k2


@contextlib.contextmanager
def plain_versions():
    """Route the force pass through the plain versions (on the card)."""
    from repro_torch.kernels import cell_pack, rcll_force

    k1, k2 = cell_pack.cell_tables, rcll_force.rcll_force
    cell_pack.cell_tables = cell_pack.cell_tables_ref
    rcll_force.rcll_force = rcll_force.rcll_force_ref
    try:
        yield
    finally:
        cell_pack.cell_tables, rcll_force.rcll_force = k1, k2


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def k1_bytes(args, kw) -> int:
    rows16, rows32, starts, counts, fill32 = args
    n, f16 = rows16.shape
    f32 = rows32.shape[1]
    c = starts.shape[0]
    cap = kw["cap"]
    read = n * (2 * f16 + 4 * f32) + 8 * c + 4 * f32
    write = (c + 1) * cap * (2 * f16 + 4 * f32 + 4)
    return read + write


def k2_ops_per_pair(dim: int, scheme) -> int:
    """fp32 operations of one pair in the kernel's loop (a division or a
    square root counts as one; compares and selects are not counted)."""
    ops = (6 * dim - 1) + 11 + 3 * dim + 2 + 2  # decode, B-spline, dv, pressure, coef
    if scheme.has_av_term:
        ops += 10
    if scheme.has_dv_term:
        ops += 6
    ops += dim * (2 + (2 if scheme.has_dv_term else 0))
    ops += 3 + (10 if scheme.has_delta_term else 0)
    return ops


def k2_work(args, kw):
    """(needed pairs, operations, bytes) of one K2 call on these inputs:
    pairs of occupied slots in non-sentinel neighbor cells only."""
    rel, shift, v, m, inv_rho, nb_ids = args
    c1, d, cap = rel.shape
    occ = (m != 0).sum(dim=1).to(torch.int64)  # empty slots carry m = 0
    occ[-1] = 0
    pairs = int((occ[:, None] * occ[nb_ids.long()]).sum())
    ops = pairs * k2_ops_per_pair(kw["dim"], kw["scheme"])
    nbytes = (c1 * (d * cap * (rel.element_size() + 2 + v.element_size())
                    + cap * (m.element_size() + 4))
              + nb_ids.numel() * 4 + c1 * cap * (1 + d) * 4)
    return pairs, ops, nbytes


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_k1(args, kw) -> None:
    from repro_torch.kernels import cell_pack

    out_k = cell_pack.cell_tables(*args, **kw)
    out_r = cell_pack.cell_tables_ref(*args, **kw)
    torch.cuda.synchronize()
    for name, a, b in zip(("t16", "t32", "ids"), out_k, out_r):
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"K1 {name}: {a.shape}/{a.dtype} vs {b.shape}/{b.dtype}")
        ai = a.view(torch.int32) if a.dtype == torch.float32 else a
        bi = b.view(torch.int32) if b.dtype == torch.float32 else b
        if not torch.equal(ai, bi):
            raise AssertionError(f"K1 {name} differs from the plain version "
                                 f"in {(ai != bi).sum().item()} entries")


def k2_summary(c: dict) -> str:
    from repro_torch.kernels import rcll_force

    return (f"K2 max|err| {c['max_abs_err']:.3e} (occupied slots), max err/bound "
            f"{c['max_ratio']:.3e} (bound: 4(3^d cap + 16) 2^-24 sum|parts|), normwise "
            f"{c['normwise']:.3e} (limit {rcll_force.NORMWISE_LIMIT:g})")


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------
def phase1_build() -> dict:
    from repro_torch.kernels import _build

    log(gpu_line())  # the card's name and power limit, as nvidia-smi gives them
    log(f"[1] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    lib = _build.library()
    log(f"[1] kernel library {lib.path.name}: nvcc build {lib.build_seconds:.1f} s "
        f"(load {time.perf_counter() - t0:.1f} s total)")
    for line in lib.log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"[1] ptxas {line.strip()}")
    return {"build_s": lib.build_seconds}


def _cloud_inputs(dim, n, scheme_kw, records, seed, dev=torch.device("cuda")):
    """K1/K2 inputs from ops.rcll_force_particles on a random cloud whose
    positions were Verlet-advanced (so some cell shifts are non-zero)."""
    from repro_torch.core import cells, rcll
    from repro_torch.core import scheme as scheme_lib
    from repro_torch.core.domain import Domain
    from repro_torch.kernels import ops

    rng = np.random.default_rng(seed)
    ds = (1.0 / n) ** (1.0 / dim)
    dom = Domain(lo=(0.0,) * dim, hi=(1.0,) * dim, h=1.2 * ds, cell_factor=1.5,
                 periodic=(True,) + (False,) * (dim - 1))
    x = torch.as_tensor(rng.uniform(0, 1, (n, dim)).astype(np.float32), device=dev)
    cap = cells.robust_capacity(dom, ds, n) + 8
    ps = rcll.pack_state(dom, rcll.init_state(dom, dom.normalize(x)), cap)
    skin_norm = 2.0 * 0.5 * dom.radius / dom.h_d
    step = torch.as_tensor(rng.uniform(-1, 1, (n, dim)).astype(np.float32), device=dev)
    rc = rcll.advance(dom, ps.rc, step * (0.2 * skin_norm))
    shifted = int((rc.cell_xy != ps.rc.cell_xy).any(dim=1).sum())
    v = torch.as_tensor((0.3 * rng.normal(size=(n, dim))).astype(np.float32), device=dev)
    rho = torch.as_tensor((1.0 + 0.01 * rng.normal(size=n)).astype(np.float32), device=dev)
    m = torch.full((n,), ds**dim, device=dev)
    store: dict = {}
    rdt = {"fp16": torch.float16, "fp32": torch.float32}[records]
    with capture_kernel_inputs(store):
        ops.rcll_force_particles(dom, ps.packing.binning, rc, v, m, rho,
                                 scheme=scheme_lib.Scheme(**scheme_kw), records_dtype=rdt)
    return store, shifted, int(ps.packing.binning.overflow)


def phase2_kernels() -> None:
    from repro_torch.kernels import rcll_force

    wcsph = dict(c0=10.0, rho0=1.0, mu=0.05)
    dam = dict(c0=10.0 * math.sqrt(2.0), rho0=1.0, eos="tait", gamma=7.0,
               viscosity="none", alpha=0.1, delta=0.1)
    cases = [
        (2, 65536, wcsph, "fp16"), (2, 65536, wcsph, "fp32"),
        (2, 65536, dam, "fp16"), (2, 65536, dam, "fp32"),
        (3, 32768, wcsph, "fp16"), (3, 32768, dam, "fp32"),
    ]
    for i, (dim, n, sch, rec) in enumerate(cases):
        store, shifted, overflow = _cloud_inputs(dim, n, sch, rec, seed=100 + i)
        if overflow:
            raise AssertionError(f"test cloud overflowed its cell capacity ({overflow})")
        if shifted == 0:
            raise AssertionError("test cloud has no migrated particles")
        check_k1(*store["k1"])
        c2 = rcll_force.check_against_plain(*store["k2"])
        eos = sch.get("eos", "linear")
        f16, f32 = store["k1"][0][0].shape[1], store["k1"][0][1].shape[1]
        log(f"[2] dim {dim} N {n} eos {eos} records {rec}: K1 bit-identical "
            f"(F16 {f16}, F32 {f32}); {k2_summary(c2)}; "
            f"{shifted} particles with non-zero shift")


def phase3_main_path(results: dict) -> None:
    from repro_torch.core import solver
    from repro_torch.core.api import Simulation
    from repro_torch.kernels import cell_pack, rcll_force

    K1, K2 = cell_pack.cell_tables, rcll_force.rcll_force
    nsteps = 50
    sim = Simulation.from_case("taylor_green", ds=1.0 / 1024)
    n = sim.n_particles
    cfg = sim.cfg
    log(f"[3] taylor_green ds=1/1024: N {n}, cells {cfg.domain.ncells}, "
        f"cap {cfg.cap(n)}, records {cfg.policy.records}, dt {cfg.dt:.3e}")
    torch.cuda.reset_peak_memory_stats()
    K1.launches = 0
    K2.launches = 0
    res, steps_per_s = sim.run_timed(nsteps, observe_every=10)
    torch.cuda.synchronize()
    l1, l2 = K1.launches, K2.launches
    driven = 2 * res.stats.steps  # run_timed: a warm-up run, then the timed run
    log(f"[3] steps/s {steps_per_s:.3f} (timed run of {res.stats.steps} steps; "
        f"{driven} steps driven incl. warm-up)")
    log(f"[3] launches: K1 {l1}, K2 {l2} (steps driven {driven}); "
        f"rebuilds in timed run {res.stats.rebuilds}; overflow {res.stats.overflow}")
    if l1 != driven or l2 != driven:
        raise AssertionError("K1/K2 launch counts differ from the step count")
    peak = torch.cuda.max_memory_allocated()
    log(f"[3] max_memory_allocated {peak} bytes ({peak / 2**30:.2f} GiB)")
    st = res.state
    fields = {"rel": st.rc.rel, "v": st.fluid.v, "rho": st.fluid.rho, "m": st.fluid.m}
    finite = {k: bool(torch.isfinite(t).all()) for k, t in fields.items()}
    log(f"[3] finite: {finite}")
    if not all(finite.values()) or res.stats.overflow:
        raise AssertionError("main path produced non-finite fields or overflowed")
    ke = res.observables.ekin.cpu().numpy().astype(float)
    log(f"[3] KE trajectory {ke.tolist()} at t {res.observables.t.cpu().numpy().tolist()}")
    if not np.all(np.diff(ke) < 0):
        raise AssertionError("taylor_green kinetic energy did not decrease monotonically")
    results["steps_per_s"] = steps_per_s
    results["launches"] = {"cell_tables": l1, "rcll_force": l2}

    # The main path's own K1/K2 inputs (one more step, outside the count).
    store: dict = {}
    carry = solver.init_persistent(cfg, sim.state)
    with capture_kernel_inputs(store):
        solver.step_persistent(cfg, carry)
    a1, kw1 = store["k1"]
    a2, kw2 = store["k2"]
    check_k1(a1, kw1)
    c2 = rcll_force.check_against_plain(a2, kw2)
    ms1 = time_ms(lambda: K1(*a1, **kw1), reps=20)
    plain1 = time_ms(lambda: cell_pack.cell_tables_ref(*a1, **kw1), reps=10)
    ms2 = time_ms(lambda: K2(*a2, **kw2), reps=10)
    plain2 = time_ms(lambda: rcll_force.rcll_force_ref(*a2, **kw2), reps=3, warmup=1)
    b1, by1 = bound(k1_bytes(a1, kw1), 0.0)
    pairs, ops2, bytes2 = k2_work(a2, kw2)
    b2, by2 = bound(bytes2, ops2)
    log(f"[3] K1 at main-path shapes t16 {tuple(a1[0].shape)} rows: {ms1:.4f} ms "
        f"(plain {plain1:.4f} ms), bound {b1:.4f} ms by {by1} "
        f"({k1_bytes(a1, kw1)} bytes), bit-identical")
    log(f"[3] K2 at main-path shapes rel {tuple(a2[0].shape)}: {ms2:.4f} ms "
        f"(plain {plain2:.4f} ms), bound {b2:.4f} ms by {by2} ({pairs} needed pairs, "
        f"{ops2:.4g} ops, {bytes2} bytes); {k2_summary(c2)}, in the kernel's "
        f"mass-normalized units (m_scale {float(carry.m_scale):.6g})")
    results["kernels"] = [
        {"name": "cell_tables", "route": "cuda",
         "source": "src/repro_torch/csrc/cell_pack.cu",
         "replaces": "src/repro/kernels/cell_pack.py:82",
         "launches": l1, "max_abs_err": 0.0, "ms": ms1, "plain_ms": plain1,
         "bound_ms": b1, "bound_by": by1, "library_ms": None},
        {"name": "rcll_force", "route": "cuda",
         "source": "src/repro_torch/csrc/rcll_force.cu",
         "replaces": "src/repro/kernels/rcll_force.py:166",
         "launches": l2, "max_abs_err": c2["max_abs_err"], "ms": ms2, "plain_ms": plain2,
         "bound_ms": b2, "bound_by": by2, "library_ms": None},
    ]


def phase4_stale_binning() -> None:
    from repro_torch.core import cases, solver
    from repro_torch.kernels import cell_pack, rcll_force

    K1, K2 = cell_pack.cell_tables, rcll_force.rcll_force
    ds = cases.resolve_ds("dam_break", 250_000)
    radius = 2.0 * cases.build_case("dam_break", ds=ds).h
    case = cases.build_case("dam_break", ds=ds, cell_factor=1.5,
                            skin=0.25 * radius, v0=1.0)
    cfg, st = case.build()
    n = st.xn.shape[0]
    log(f"[4] dam_break ds {ds:.5f}: N {n}, cells {cfg.domain.ncells}, cap {cfg.cap(n)}, "
        f"skin {cfg.skin:.3e}, dt {cfg.dt:.3e}")
    K1.launches = 0
    K2.launches = 0
    t0 = time.perf_counter()
    carry = solver.init_persistent(cfg, st)
    steps, max_shifted, segments = 0, 0, 0
    while steps < 400 and (carry.rebuilds < 3 or segments < 2):
        carry = solver.run_persistent(cfg, carry, 10)
        steps += 10
        shifted = int((carry.st.rc.cell_xy != carry.binning.cell_xy).any(dim=1).sum())
        max_shifted = max(max_shifted, shifted)
        segments += 1
    out = solver.finalize_persistent(cfg, carry)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    in_run = carry.rebuilds - 1  # the first rebuild is init_persistent's pack
    finite = all(bool(torch.isfinite(t).all())
                 for t in (out.rc.rel, out.fluid.v, out.fluid.rho))
    log(f"[4] {steps} steps in {wall:.2f} s; rebuilds {carry.rebuilds} "
        f"({in_run} in-run); K1 launches {K1.launches}, K2 launches {K2.launches}; "
        f"max particles with non-zero shift seen by K2 {max_shifted}; "
        f"overflow {bool(carry.overflow)}; finite {finite}")
    if in_run < 2 or max_shifted == 0:
        raise AssertionError("stale-binning path did not rebuild twice with live shifts")
    if K1.launches != steps or K2.launches != steps or not finite or bool(carry.overflow):
        raise AssertionError("dam_break: launch counts, finiteness or overflow check failed")


#: Phase 5's velocity limit with fp16 records, from readings on an H100
#: (PERF.md): at most 3.6e-5 over a 20-step run; a 1% error in K2's EOS
#: constant gives 3.5e-4 and a dropped Morris term 3.6e-2.
FP16_RECORDS_DV_LIMIT = 1e-4


def phase5_kernel_vs_plain_path() -> None:
    """The kernel path against the plain path, both on the card, at the
    tolerances of tests/test_torch_solver.py (the CPU slice test).

    fp32 records: positions, density and velocity at that test's
    fp32-records tolerances, on the final state as there. fp16 records
    (the default): positions and density at its fp16-records tolerances.
    Its velocity tolerance does not carry over: a velocity difference far
    below one fp16 quantum can flip the rounding of a stored velocity
    record, which moves the neighbors' viscous sums by ~3e-5 in one step;
    the maximum over the steps is held to ``FP16_RECORDS_DV_LIMIT``
    instead.
    """
    from repro_torch.core import cases, solver
    from repro_torch.core.precision import FP32_RECORDS, PrecisionPolicy

    nsteps = 20
    for policy in (FP32_RECORDS, PrecisionPolicy()):
        cfg, st = cases.build_case("taylor_green", ds=1.0 / 64, policy=policy).build()
        if policy.records == "fp32":
            tol = {"pos": 1e-6, "rho": 1e-6, "v": nsteps * cfg.dt * 1e-4}
        else:
            quantum = max(cfg.domain.cell_sizes) / 2 * 2.0**-10  # one fp16 rel step
            tol = {"pos": 1e-6 + quantum, "rho": 1e-6, "v": FP16_RECORDS_DV_LIMIT}
        ck = solver.init_persistent(cfg, st)
        with plain_versions():
            cp = solver.init_persistent(cfg, st)
        worst = dict.fromkeys(tol, 0.0)  # max over the steps
        for _ in range(nsteps):
            ck = solver.step_persistent(cfg, ck)
            with plain_versions():
                cp = solver.step_persistent(cfg, cp)
            sk, sp = solver.finalize_persistent(cfg, ck), solver.finalize_persistent(cfg, cp)
            final = {
                "pos": solver.positions(cfg, sk) - solver.positions(cfg, sp),
                "rho": sk.fluid.rho - sp.fluid.rho,
                "v": sk.fluid.v - sp.fluid.v,
            }
            final = {k: float(d.abs().max()) for k, d in final.items()}
            worst = {k: max(worst[k], final[k]) for k in final}
        # The CPU test's tolerances hold for the final state, as there; the
        # fp16 velocity limit was set from the maximum over the steps.
        held = dict(final, v=final["v"] if policy.records == "fp32" else worst["v"])
        log(f"[5] taylor_green ds=1/64 N {st.xn.shape[0]} records {policy.records}, "
            f"{nsteps} steps, kernel vs plain: " + ", ".join(
                f"|d{k}| final {final[k]:.3e}, max over the steps {worst[k]:.3e}"
                for k in final) + "; held: " + ", ".join(
                f"{k} {held[k]:.3e} <= {tol[k]:.3e}" for k in held)
            + f"; rebuilds {ck.rebuilds}/{cp.rebuilds}")
        if any(held[k] > tol[k] for k in held) or ck.rebuilds != cp.rebuilds:
            raise AssertionError(f"kernel path and plain path disagree ({policy.records} records)")


def phase7_planted_faults() -> None:
    """Plant faults in K2 through its runtime parameters (the sources are
    untouched): the Morris term dropped, and the EOS constant 1% off. The
    K2 check at the main path's inputs (phase 3's), phase 2 and phase 5
    must each fail on each fault."""
    from repro_torch.core import solver
    from repro_torch.core.api import Simulation
    from repro_torch.kernels import rcll_force

    sim = Simulation.from_case("taylor_green", ds=1.0 / 1024)
    sim.run(50)
    store: dict = {}
    with capture_kernel_inputs(store):
        solver.step_persistent(sim.cfg, solver.init_persistent(sim.cfg, sim.state))
    params = rcll_force.kernel_params

    def planted(fault):
        def faulty(**kw):
            f, i = params(**kw)
            if fault == "no_dv":
                i[2] = 0  # has_dv
            else:
                f[5] *= 1.01  # eos_k
            return f, i
        return faulty

    checks = (("main-path K2 check", lambda: rcll_force.check_against_plain(*store["k2"])),
              ("phase 2", phase2_kernels), ("phase 5", phase5_kernel_vs_plain_path))
    missed = []
    for fault in ("no_dv", "eos_k_1pct"):
        for name, check in checks:
            rcll_force.kernel_params = planted(fault)
            try:
                check()
                missed.append((fault, name))
                log(f"[7] {fault}: {name} PASSED: the fault was not caught")
            except AssertionError as e:
                log(f"[7] {fault}: {name} failed, as it must: {e}")
            finally:
                rcll_force.kernel_params = params
    if missed:
        raise AssertionError(f"planted faults not caught: {missed}")


def phase6_profile(nsteps: int = 10) -> None:
    from repro_torch.core import solver
    from repro_torch.core.api import Simulation

    sim = Simulation.from_case("taylor_green", ds=1.0 / 1024)
    cfg = sim.cfg
    carry = solver.init_persistent(cfg, sim.state)
    carry = solver.run_persistent(cfg, carry, 3)  # warm-up
    torch.cuda.synchronize()
    split = {"decide": 0.0, "rebuild": 0.0, "physics": 0.0}
    for _ in range(nsteps):
        t0 = time.perf_counter()
        need = solver._needs_rebuild(cfg, carry)
        t1 = time.perf_counter()
        if need:
            carry = solver._rebuild(cfg, carry)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        carry = solver._physics_step(cfg, carry)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        split["decide"] += t1 - t0
        split["rebuild"] += t2 - t1
        split["physics"] += t3 - t2
    log("[6] host-timed step split (ms/step, synchronized): " + ", ".join(
        f"{k} {1e3 * v / nsteps:.3f}" for k, v in split.items()))
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        carry = solver.run_persistent(cfg, carry, nsteps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    device_us = sum(e.self_device_time_total for e in events)
    log(f"[6] profiled {nsteps} steps: wall {1e3 * wall / nsteps:.3f} ms/step, device "
        f"time {device_us / 1e3 / nsteps:.3f} ms/step, device busy share "
        f"{device_us / 1e6 / wall:.3f}")
    top = sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:15]
    for e in top:
        if e.self_device_time_total > 0:
            log(f"[6]   {e.self_device_time_total / 1e3 / nsteps:9.4f} ms/step "
                f"{e.count // nsteps:4d} calls/step  {e.key[:90]}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="1,2,3,4,5,7",
                    help="comma-separated phases to run (default: all but 6)")
    args = ap.parse_args()
    phases = {int(p) for p in args.phases.split(",")}
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails here without the package)

    results: dict = {}
    t0 = time.perf_counter()
    if 1 in phases:
        phase1_build()
    if 2 in phases:
        phase2_kernels()
    if 3 in phases:
        phase3_main_path(results)
    if 4 in phases:
        phase4_stale_binning()
    if 5 in phases:
        phase5_kernel_vs_plain_path()
    if 6 in phases:
        phase6_profile()
    if 7 in phases:
        phase7_planted_faults()
    log(f"[done] phases {sorted(phases)} in {time.perf_counter() - t0:.1f} s")
    if 1 not in phases:
        log(gpu_line())
    log(json.dumps({"kernels": results.get("kernels", [])}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
