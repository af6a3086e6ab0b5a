"""Mixed-precision SPH solver: the paper's three approaches (Table 4).

Port of ``repro.core.solver``:
  I   : cell-list NNPS in hi precision on absolute fp32 positions;
  II  : cell-list NNPS in fp16 absolute coordinates, fp32 positions;
  III : RCLL, the persistent cell-packed pipeline: positions live as (int
        cell, fp16 relative), NNPS in fp16 relative coordinates (Eq. 7),
        positions advanced in relative form (Eq. 8).

The RCLL state is kept cell-packed; each step checks the Verlet-skin
criterion, rebuilds when it fires (counting-sort pack -> one fused state
permutation -> the backend's neighbor structure) and runs the force pass
of ``backend``, then the explicit WCSPH update and the Eq. (8) advance:

  * ``"reference"`` - the gather oracle: per-particle neighbor list from
    the merged-window search, (N, K) pair arrays, ``sph`` pair terms;
  * ``"xla"`` - the same list, swept by the chunked fused record pass
    (``core/fused.py``);
  * ``"kernel"`` (the default; JAX's ``"pallas"``) - the two CUDA kernels
    (K1 cell pack, K2 fused force) over the cell tables; no list.

The absolute algos (``"all"``, ``"cell"``) search and step on ``xn``.

Where JAX traces ``lax.cond``/``lax.scan``, the port runs a Python loop:
the rebuild decision is read on the host once per step, and a rebuild
reads whether the counting sort's adjacency precondition holds. These are
two of the step's host syncs (``torch.cuda.set_sync_debug_mode("warn")``
names each by its line). ``core/tracing.py``'s ``sph.*`` spans name the
step's stretches for a profiler. CUDA graphs are later work.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import NamedTuple

import torch

from repro_torch.core import cells as cells_lib
from repro_torch.core import fused, health, nnps, rcll, sph, statepack, tracing
from repro_torch.core import scheme as scheme_lib
from repro_torch.core.domain import Domain
from repro_torch.core.precision import PrecisionPolicy

_log = logging.getLogger(__name__)

#: The force backends (``"kernel"`` is the JAX package's ``"pallas"``).
BACKENDS = ("reference", "xla", "kernel")


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another. Raises when CUDA is asked for (or implied) and missing —
    the port never falls back to the CPU on its own."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the plain "
                "PyTorch versions on the CPU"
            )
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    return dev


@dataclasses.dataclass(frozen=True)
class SPHConfig:
    domain: Domain
    ds: float  # particle spacing
    dt: float
    rho0: float = 1.0
    c0: float = 1.25  # speed of sound (>= 10 * v_max for WCSPH)
    mu: float = 1.0  # dynamic viscosity (rho0 * nu)
    body_force: tuple[float, ...] = (0.0, 0.0)
    max_neighbors: int = 40  # K of the list backends and the absolute algos
    capacity: int | None = None
    algo: str = "rcll"  # "all" | "cell" | "rcll"
    policy: PrecisionPolicy = PrecisionPolicy()
    # Physics-term spec; None builds the WCSPH scheme from rho0/c0/mu/body_force.
    scheme: scheme_lib.Scheme | None = None
    # Clamp wall-particle density at >= rho0 after the continuity update.
    wall_rho_clamp: bool = False
    # --- persistent-pipeline knobs ---
    skin: float = 0.0  # physical Verlet-skin width added to the search radius
    rebuild_every: int | None = None  # static rebuild cadence (overrides skin)
    backend: str | None = None  # None -> "kernel" | "reference" | "xla"
    # Rows per chunk of the fused "xla" sweep (0 = auto).
    force_chunk: int = 0
    # Merged candidate budget per particle of the window search (the list
    # backends' rebuild search). 0 = auto (nnps.auto_window from ds);
    # None selects the dense-table search (nnps.rcll_neighbors) as the
    # oracle path. Truncation is flagged through the overflow plumbing.
    window: int | None = 0
    # Raise health.SimulationDiverged from simulate/simulate_stats when a
    # cell table or a neighbor list overflowed during the run (one host
    # read after it).
    check_overflow: bool = False
    # Deterministic fault-injection hook (health.FaultSpec) of the
    # recovery tests and the guarded smoke: None in production. Fires in
    # step_persistent when the step counter matches.
    fault: health.FaultSpec | None = None

    @property
    def h(self) -> float:
        return self.domain.h

    def cap(self, n: int) -> int:
        """Per-cell table capacity: explicit override or the robust rule."""
        return self.capacity or cells_lib.robust_capacity(self.domain, self.ds, n)

    def resolved_window(self) -> int:
        """The window search's merged candidate budget (0 -> the
        ds-derived 3^dim-block lattice bound)."""
        if self.window is None:
            raise ValueError("window=None selects the table oracle path")
        if self.window > 0:
            return self.window
        return nnps.auto_window(self.domain, ds=self.ds)

    @property
    def skin_norm(self) -> float:
        """Skin width in normalized (Eq. 5) units."""
        return 2.0 * self.skin / self.domain.h_d

    @property
    def search_radius_cell(self) -> float:
        """Inflated search radius in reference-cell units (r + skin)."""
        return float((self.domain.radius_norm + self.skin_norm) / self.domain.hc_ref)

    @property
    def resolved_scheme(self) -> scheme_lib.Scheme:
        if self.scheme is not None:
            return self.scheme
        return scheme_lib.wcsph(self.c0, self.rho0, self.mu, self.body_force)

    @property
    def resolved_backend(self) -> str:
        if self.backend is None:
            return "kernel"
        if self.backend not in BACKENDS:
            raise ValueError(
                f"unknown backend {self.backend!r}; one of 'reference', 'xla', 'kernel'")
        return self.backend

    def validate_skin(self) -> None:
        """The inflated radius must stay inside the one-cell coverage of
        the 3^dim neighborhood (build the Domain with cell_factor >=
        (r + skin) / r to use a skin)."""
        if self.skin < 0:
            raise ValueError(f"skin must be >= 0, got {self.skin}")
        limit = min(self.domain.cell_sizes)
        if self.domain.radius + self.skin > limit * (1 + 1e-9):
            raise ValueError(
                f"skin {self.skin} too large: r + skin = "
                f"{self.domain.radius + self.skin:.6g} exceeds the cell "
                f"coverage guarantee {limit:.6g}; increase cell_factor to "
                f">= {(self.domain.radius + self.skin) / self.domain.radius:.3f}"
            )


class SPHState(NamedTuple):
    """Particle system state. ``xn`` is the normalized-absolute position
    (the source of truth for algos all/cell); ``rc`` is the RCLL state
    (the source of truth for algo rcll); the inactive one stays at its
    initial value. ``fixed`` marks wall particles (never advected, velocity
    prescribed: ``v_wall`` where given, else 0); ``kind`` is their int8
    classification (boundaries.FLUID / WALL)."""

    xn: torch.Tensor  # (N, d) fp32
    rc: rcll.RCLLState
    fluid: sph.FluidState
    fixed: torch.Tensor  # (N,) bool
    t: torch.Tensor  # () fp32 simulation time
    kind: torch.Tensor | None = None  # (N,) int8
    v_wall: torch.Tensor | None = None  # (N, d) fp32


class PersistentCarry(NamedTuple):
    """Carry of the packed persistent pipeline.

    All per-particle tensors in ``st`` are in PACKED order; ``order``
    maps packed position -> original particle id. ``nl`` is the list
    of the last rebuild in packed indexing, searched with the radius r +
    skin (zero-capacity on the kernel backend). ``binning`` is the packed
    binning of the last rebuild (stale but exact to decode against
    between rebuilds). ``rebuilds``/``steps`` are host ints: the loop
    decides rebuilds on the host anyway.
    """

    st: SPHState
    order: torch.Tensor  # (N,) int32 packed -> original
    nl: nnps.NeighborList
    disp_acc: torch.Tensor  # (N, d) fp32 normalized displacement since rebuild
    rebuilds: int
    steps: int
    overflow: torch.Tensor  # () bool any cell-table or neighbor-list overflow seen
    binning: cells_lib.CellBinning | None = None
    # "xla" with the table oracle (window=None) only: the list's ids with
    # invalid slots redirected to the dummy row N (a window-search list is
    # dummy-padded already and is read directly).
    idx_dummy: torch.Tensor | None = None
    m_scale: torch.Tensor | None = None  # () fp32 half-record mass normalizer
    m_table: torch.Tensor | None = None  # (C+1, cap) static mass tile (kernel)
    flags: torch.Tensor | None = None  # () int32 accumulated health bits


class SimStats(NamedTuple):
    rebuilds: int
    steps: int
    overflow: bool


def init_state(cfg: SPHConfig, x_phys, v, m, rho, fixed=None, kind=None,
               v_wall=None, *, device=None) -> SPHState:
    """Build an SPHState from host arrays; every field is cast to fp32 (or
    its integer dtype) at this boundary, as the JAX package does."""
    dev = resolve_device(device)
    x = torch.as_tensor(x_phys, dtype=torch.float32).to(dev)
    xn = cfg.domain.normalize(x, dtype=torch.float32)
    rc = rcll.init_state(cfg.domain, xn, dtype=cfg.policy.coords_dtype)
    n = xn.shape[0]
    fluid = sph.FluidState(
        v=torch.as_tensor(v, dtype=torch.float32).to(dev),
        rho=torch.as_tensor(rho, dtype=torch.float32).to(dev),
        m=torch.as_tensor(m, dtype=torch.float32).to(dev),
    )
    if kind is not None:
        kind = torch.as_tensor(kind).to(device=dev, dtype=torch.int8)
        if fixed is None:
            fixed = kind != 0  # boundaries.FLUID
    if fixed is None:
        fixed = torch.zeros((n,), dtype=torch.bool, device=dev)
    fixed = torch.as_tensor(fixed).to(device=dev, dtype=torch.bool)
    if kind is None:
        kind = fixed.to(torch.int8)  # boundaries.WALL == 1
    if v_wall is not None:
        v_wall = torch.as_tensor(v_wall, dtype=torch.float32).to(dev)
    return SPHState(xn=xn, rc=rc, fluid=fluid, fixed=fixed,
                    t=torch.zeros((), dtype=torch.float32, device=dev),
                    kind=kind, v_wall=v_wall)


def positions(cfg: SPHConfig, state: SPHState, dtype=torch.float32) -> torch.Tensor:
    """Physical positions decoded from the active representation."""
    if cfg.algo == "rcll":
        xn = rcll.to_normalized(cfg.domain, state.rc, dtype=dtype)
    else:
        xn = state.xn
    return cfg.domain.denormalize(xn, dtype=dtype)


# --------------------------------------------------------------------------
# Persistent cell-packed RCLL pipeline
# --------------------------------------------------------------------------
def _permute_state(st: SPHState, perm: torch.Tensor, rc: rcll.RCLLState) -> SPHState:
    """Reorder every per-particle tensor by ``perm`` (rc supplied sorted);
    one gather per field."""
    p = perm.long()
    return SPHState(
        xn=st.xn[p],
        rc=rc,
        fluid=sph.FluidState(v=st.fluid.v[p], rho=st.fluid.rho[p], m=st.fluid.m[p]),
        fixed=st.fixed[p],
        t=st.t,
        kind=None if st.kind is None else st.kind[p],
        v_wall=None if st.v_wall is None else st.v_wall[p],
    )


def _permute_state_fused(st: SPHState, perm: torch.Tensor, rc: rcll.RCLLState,
                         order: torch.Tensor) -> tuple[SPHState, torch.Tensor]:
    """Reorder the whole per-particle state (and ``order``) by ONE row
    gather (``statepack.permute_fields``); bit-identical to
    :func:`_permute_state` plus ``order[perm]``."""
    xn, v, rho, m, fixed, kind, v_wall, order = statepack.permute_fields(
        (st.xn, st.fluid.v, st.fluid.rho, st.fluid.m, st.fixed,
         st.kind, st.v_wall, order),
        perm,
    )
    st2 = SPHState(xn=xn, rc=rc, fluid=sph.FluidState(v=v, rho=rho, m=m),
                   fixed=fixed, t=st.t, kind=kind, v_wall=v_wall)
    return st2, order


def _packed_neighbor_list(cfg: SPHConfig, ps: rcll.PackedState) -> nnps.NeighborList:
    """The rebuild's neighbor list (packed indexing, radius r + skin).

    Production (``cfg.window`` an int): the table-free merged-window
    search. Oracle (``window=None``): the dense-table search over the
    (C, cap) cell table. One arithmetic dtype either way, so the choice
    never changes neighbor sets.
    """
    pol = cfg.policy
    if cfg.window is None:  # dense-table oracle
        return nnps.rcll_neighbors(
            cfg.domain, ps.rc.rel, ps.rc.cell_xy, dtype=pol.nnps_dtype,
            compute_dtype=pol.nnps_compute_dtype, k=cfg.max_neighbors,
            binning=ps.packing.binning, radius_cell=cfg.search_radius_cell)
    return rcll.packed_neighbors(
        cfg.domain, ps, dtype=pol.nnps_dtype, compute_dtype=pol.nnps_compute_dtype,
        k=cfg.max_neighbors, radius_cell=cfg.search_radius_cell,
        window=cfg.resolved_window())


def _empty_neighbor_list(n: int, device) -> nnps.NeighborList:
    """Zero-capacity list for the backend that never consumes one."""
    return nnps.NeighborList(
        idx=torch.zeros((n, 0), dtype=torch.int32, device=device),
        mask=torch.zeros((n, 0), dtype=torch.bool, device=device),
        count=torch.zeros((n,), dtype=torch.int32, device=device),
    )


@tracing.spanned("sph.rebuild")
def _rebuild(cfg: SPHConfig, carry: PersistentCarry) -> PersistentCarry:
    """Re-sort by cell (counting-sort pack against the carried binning),
    permute the whole state by one row gather, then build the backend's
    neighbor structure: the static mass tile for the kernel backend
    (which reads no list, so its overflow flag means exactly "a cell
    table dropped particles"), the r + skin neighbor list otherwise
    (whose overflow or window truncation folds into the flags)."""
    n = carry.order.shape[0]
    with tracing.span("sph.rebuild.pack"):
        ps = rcll.pack_state(cfg.domain, carry.st.rc, cfg.cap(n), prev=carry.binning)
    perm = ps.packing.order  # current-packed -> new-packed
    binning = ps.packing.binning
    with tracing.span("sph.rebuild.permute"):
        # The step updates rc.cell_xy in place; the stale binning must keep
        # its own copy.
        rc = ps.rc._replace(cell_xy=ps.rc.cell_xy.clone())
        st, order = _permute_state_fused(carry.st, perm, rc, carry.order)
    cell_over = binning.overflow > 0
    overflow = carry.overflow | cell_over
    flags = health.fold_flag(carry.flags, cell_over, health.CELL_OVERFLOW)
    m_table = idx_dummy = None
    if cfg.resolved_backend == "kernel":
        from repro_torch.kernels import ops  # core stays kernel-free at import

        nl = _empty_neighbor_list(n, order.device)
        m_table = ops.mass_table(binning, st.fluid.m, cfg.policy.records_dtype,
                                 carry.m_scale)
    else:
        nl = _packed_neighbor_list(cfg, ps)
        overflow = overflow | nl.overflowed
        win_bad = nl.overflowed if nl.trunc is None else nl.overflowed | nl.trunc
        flags = health.fold_flag(flags, win_bad, health.WINDOW_TRUNC)
        # The window search pads invalid slots with the dummy id N and the
        # fused sweep reads its ids directly; only the table oracle's list
        # (garbage in invalid slots) is sanitized, once per rebuild.
        if cfg.resolved_backend == "xla" and cfg.window is None:
            idx_dummy = fused._sanitized_idx(nl, n)
    return PersistentCarry(
        st=st,
        order=order,
        nl=nl,
        disp_acc=torch.zeros_like(carry.disp_acc),
        rebuilds=carry.rebuilds + 1,
        steps=carry.steps,
        overflow=overflow,
        binning=binning,
        idx_dummy=idx_dummy,
        m_scale=carry.m_scale,
        m_table=m_table,
        flags=flags,
    )


def _resolved_records(cfg: SPHConfig) -> str:
    """The record layout the fused sweep runs: the policy's, but fp32
    when the grid has more cells per axis than the half-width rows'
    16-bit cell column holds (``fused.HALF_CELL_LIMIT``);
    :func:`init_persistent` logs that fallback once per run."""
    records = cfg.policy.records
    if records != "fp32":
        limit = fused.HALF_CELL_LIMIT.get(cfg.policy.records_dtype)
        if limit is not None and max(cfg.domain.ncells) >= limit:
            return "fp32"
    return records


def init_persistent(cfg: SPHConfig, state: SPHState) -> PersistentCarry:
    """Pack the state (first rebuild) and hoist the mass normalizer."""
    cfg.validate_skin()
    backend = cfg.resolved_backend
    n = state.xn.shape[0]
    dev = state.xn.device
    if backend == "xla" and _resolved_records(cfg) != cfg.policy.records:
        _log.warning(
            "half-record layout %r disabled: grid %s exceeds the %d-cell anchor "
            "range; using fp32 records", cfg.policy.records, tuple(cfg.domain.ncells),
            fused.HALF_CELL_LIMIT[cfg.policy.records_dtype])
    m_scale = (fused.mass_scale(state.fluid.m)
               if cfg.policy.half_records and backend != "reference" else None)
    carry = PersistentCarry(
        st=state,
        order=torch.arange(n, dtype=torch.int32, device=dev),
        nl=_empty_neighbor_list(n, dev),
        disp_acc=torch.zeros((n, cfg.domain.dim), dtype=torch.float32, device=dev),
        rebuilds=0,
        steps=0,
        overflow=torch.zeros((), dtype=torch.bool, device=dev),
        m_scale=m_scale,
        flags=torch.zeros((), dtype=torch.int32, device=dev),
    )
    return _rebuild(cfg, carry)


def finalize_persistent(cfg: SPHConfig, carry: PersistentCarry) -> SPHState:
    """Restore original particle indexing at the API boundary."""
    inverse = cells_lib.inverse_permutation(carry.order)
    il = inverse.long()
    rc = rcll.RCLLState(cell_xy=carry.st.rc.cell_xy[il], rel=carry.st.rc.rel[il])
    return _permute_state(carry.st, inverse, rc)


def _needs_rebuild(cfg: SPHConfig, carry: PersistentCarry) -> bool:
    """The Verlet-list criterion (or the static cadence), read on the host."""
    if cfg.rebuild_every is not None:
        return carry.steps > 0 and carry.steps % cfg.rebuild_every == 0
    if cfg.skin == 0.0:
        # Degenerate skin: any movement invalidates the list.
        return bool(torch.max(torch.abs(carry.disp_acc)) > 0.0)
    max_disp = torch.sqrt(torch.max(torch.sum(carry.disp_acc * carry.disp_acc, dim=-1)))
    return bool(max_disp > 0.5 * cfg.skin_norm)


def _in_range(nl: nnps.NeighborList, n: int) -> nnps.NeighborList:
    """``nl`` with its ids clamped to N - 1 for gathering: a window-search
    list holds the dummy id N in its invalid slots, which JAX's gathers
    clamp; every such slot is masked out of the sums."""
    return nl._replace(idx=torch.clamp(nl.idx, max=n - 1))


def _gathered_pair_rhs(sch: scheme_lib.Scheme, dom: Domain, fl: sph.FluidState,
                       nl: nnps.NeighborList, disp: torch.Tensor, r: torch.Tensor,
                       gw: torch.Tensor):
    """(drho, acc) pair sums of ``sch`` on gathered (N, K) pair arrays
    (disp = x_i - x_j (N, K, d), r (N, K), gw the masked kernel gradient).

    The gather-path evaluation of the scheme's channels, the same ∇W/dv
    split as ``fused._pair_rhs`` and K2; shared by the reference backend
    and the absolute algos. Densities enter as reciprocals.
    """
    pf = sph.gather_pair_fields(fl.v, fl.m, nl.idx, nl.mask)
    drho = sph.continuity_rhs_pairs(pf, gw)
    idx = nl.idx.long()
    inv = (1.0 / fl.rho).to(torch.float32)
    por2 = sch.por2_inv(inv)
    inv_i, inv_j = inv[:, None], inv[idx]
    r2 = r * r
    dv_dot_disp = torch.sum(pf.dv * disp, dim=-1)
    gc = sch.gradw_pair_coef(pf.mj, por2[:, None], por2[idx], inv_i, inv_j,
                             dv_dot_disp, r2, h=dom.h)
    acc = -torch.sum(gc[..., None] * gw, dim=-2)
    if sch.has_dv_term or sch.has_delta_term:
        x_dot_gw = torch.sum(disp * gw, dim=-1)
    if sch.has_dv_term:
        vc = sch.dv_pair_coef(pf.mj, x_dot_gw, inv_i, inv_j, r2, h=dom.h)
        acc = acc + torch.sum(vc[..., None] * pf.dv, dim=-2)
    if sch.has_delta_term:
        drho = drho + torch.sum(
            sch.drho_pair_term(pf.mj, inv_i, inv_j, x_dot_gw, r2, h=dom.h), dim=-1)
    return drho, acc


def _force_rhs_reference(cfg: SPHConfig, carry: PersistentCarry):
    """Gather path, the oracle: every pair array materialized (N, K)."""
    dom, pol = cfg.domain, cfg.policy
    st = carry.st
    nl = _in_range(carry.nl, carry.order.shape[0])
    disp, r = rcll.pair_displacements(dom, st.rc, nl, dtype=pol.physics_dtype)
    gw = sph.grad_w(disp, r, cfg.h, dom.dim, nl.mask)
    return _gathered_pair_rhs(cfg.resolved_scheme, dom, st.fluid, nl, disp, r, gw)


def _force_rhs_fused_xla(cfg: SPHConfig, carry: PersistentCarry):
    """The fused cell-blocked sweep over packed row chunks (core/fused)."""
    st, nl, fl = carry.st, carry.nl, carry.st.fluid
    idx_dummy = carry.idx_dummy
    if idx_dummy is None and cfg.window is not None:
        idx_dummy = nl.idx  # window-search lists are dummy-padded already
    return fused.force_rhs(
        cfg.domain, st.rc, nl, fl.v, fl.m, fl.rho,
        scheme=cfg.resolved_scheme, chunk=cfg.force_chunk,
        records=_resolved_records(cfg), idx_dummy=idx_dummy, m_scale=carry.m_scale)


def _force_rhs_kernel(cfg: SPHConfig, carry: PersistentCarry):
    """The fused force pass over the (stale-binning) cell tables: K1 + K2."""
    from repro_torch.kernels import ops

    st, fl = carry.st, carry.st.fluid
    return ops.rcll_force_particles(
        cfg.domain, carry.binning, st.rc, fl.v, fl.m, fl.rho,
        scheme=cfg.resolved_scheme,
        records_dtype=cfg.policy.records_dtype,
        m_scale=carry.m_scale,
        m_table=carry.m_table,
    )


_FORCE_BACKENDS = {
    "reference": _force_rhs_reference,
    "xla": _force_rhs_fused_xla,
    "kernel": _force_rhs_kernel,
}


@tracing.spanned("sph.force")
def _physics_step(cfg: SPHConfig, carry: PersistentCarry,
                  dt: float | torch.Tensor | None = None) -> PersistentCarry:
    """One WCSPH step on the packed state (explicit: every RHS term from
    the current state), reusing the rebuild's neighbor structure.
    ``dt`` optionally overrides ``cfg.dt``.

    The per-particle fields (v, rho, rel, cell_xy, disp_acc) are updated
    IN PLACE, so the carry passed in must not be used again except
    through the returned one.
    """
    dom, pol = cfg.domain, cfg.policy
    sch = cfg.resolved_scheme
    if dt is None:
        dt = cfg.dt
    st, fl = carry.st, carry.st.fluid
    drho, acc = _FORCE_BACKENDS[cfg.resolved_backend](cfg, carry)
    rho = fl.rho + dt * drho
    if cfg.wall_rho_clamp:
        rho = torch.where(st.fixed, torch.clamp(rho, min=sch.rho0), rho)

    bf = sch.body_force_vec(dom.dim, fl.v.device)
    v = fl.v + dt * (acc + bf)
    # Walls: prescribed velocity (0 or v_wall), never advected.
    vw = torch.zeros_like(v) if st.v_wall is None else st.v_wall
    fixed = st.fixed[:, None]
    v = torch.where(fixed, vw, v)

    dxn = torch.where(
        fixed, torch.zeros_like(v), v * dt * (2.0 / dom.h_d)
    ).to(torch.float32)
    rc = rcll.advance(dom, st.rc, dxn, dtype=pol.coords_dtype)
    fl.rho.copy_(rho)
    fl.v.copy_(v)
    st.rc.rel.copy_(rc.rel)
    st.rc.cell_xy.copy_(rc.cell_xy)
    carry.disp_acc.add_(dxn)
    return carry._replace(st=st._replace(t=st.t + dt), steps=carry.steps + 1)


def exact_neighbor_list(cfg: SPHConfig, carry: PersistentCarry) -> nnps.NeighborList:
    """Exact-radius neighbor sets (packed indexing) from the reused list:
    ``carry.nl`` refiltered with the true support radius in the search's
    own Eq. (7) arithmetic, so the sets equal a fresh search's whenever
    the skin invariant holds. Needs a list backend."""
    if cfg.resolved_backend == "kernel":
        raise ValueError(
            "exact_neighbor_list needs backend='reference' or 'xla'; the "
            "kernel force path does not carry a neighbor list")
    pol = cfg.policy
    d2 = rcll.pair_r2_cell(
        cfg.domain, carry.st.rc, _in_range(carry.nl, carry.order.shape[0]),
        dtype=pol.nnps_dtype, compute_dtype=pol.nnps_compute_dtype)
    r = nnps.const(nnps.rcll_radius_cell_units(cfg.domain), d2.dtype, d2.device)
    return nnps.refilter(carry.nl, d2, r * r)


def step_persistent(cfg: SPHConfig, carry: PersistentCarry) -> PersistentCarry:
    """Rebuild if needed (decided on the host) + one physics step."""
    if cfg.fault is not None:
        # Injection precedes the rebuild decision, so a teleported
        # particle's spiked displacement rebuilds in the same step (the
        # overlap must reach the cell tables).
        carry = health.inject_fault(cfg.fault, carry)
    with tracing.span("sph.decide"):
        rebuild = _needs_rebuild(cfg, carry)
    if rebuild:
        carry = _rebuild(cfg, carry)
    return _physics_step(cfg, carry)


def run_persistent(cfg: SPHConfig, carry: PersistentCarry, nsteps: int) -> PersistentCarry:
    """Advance a carry by ``nsteps`` steps, updating it IN PLACE.

    Where the JAX package donates the carry to a jitted scan, the port
    updates the carry's per-particle tensors in place (a rebuild swaps
    in freshly permuted ones). Call as ``carry = run_persistent(cfg,
    carry, n)`` and use only the returned carry afterwards:

        carry = init_persistent(cfg, state)
        for _ in range(segments):
            carry = run_persistent(cfg, carry, steps_per_segment)
        state = finalize_persistent(cfg, carry)
    """
    for _ in range(nsteps):
        carry = step_persistent(cfg, carry)
    return carry


def _raise_on_overflow(overflow, max_neighbors: int) -> None:
    """Strict-mode overflow raise (``SPHConfig.check_overflow``), host-side
    after the run."""
    if overflow:
        raise health.SimulationDiverged(
            "neighbor capacity overflow: some particle saw more "
            f"candidates than max_neighbors={max_neighbors} (or a cell "
            "table row filled). Results silently dropped pairs - raise "
            "max_neighbors (see the sizing rule in README) or enlarge "
            "capacity.",
            checks=("window_trunc", "cell_overflow"),
            word=health.CAPACITY_CHECKS,
        )


# --------------------------------------------------------------------------
# Absolute-coordinate path (algos "all" / "cell")
# --------------------------------------------------------------------------
def _neighbors_and_pairs(cfg: SPHConfig, state: SPHState):
    """NNPS in the policy's search dtype, then the pair geometry from the
    fp32 absolute positions in the physics dtype (physical units)."""
    dom, pol = cfg.domain, cfg.policy
    n = state.xn.shape[0]
    k = cfg.max_neighbors
    if cfg.algo == "cell":
        nl = nnps.cell_list_neighbors(dom, state.xn, dtype=pol.nnps_dtype, k=k,
                                      capacity=cfg.cap(n))
    elif cfg.algo == "all":
        nl = nnps.all_list_neighbors(state.xn, dom.radius_norm, dtype=pol.nnps_dtype,
                                     k=k, domain=dom)
    else:
        raise ValueError(cfg.algo)
    diff = nnps.min_image((state.xn[:, None, :] - state.xn[nl.idx.long()]).to(pol.physics_dtype),
                          nnps.wrap_span_norm(dom, state.xn.device))
    disp = diff * (dom.h_d / 2.0)  # physical units
    r = torch.sqrt(nnps._sum_last(disp * disp))
    return nl, disp, r


def _step_absolute(cfg: SPHConfig, state: SPHState) -> SPHState:
    """One WCSPH step on absolute positions, the same explicit update as
    the RCLL backends. Like the JAX package, it drops the search's
    ``nl.overflowed``: an absolute run never reports overflow (ROADMAP
    Queue 3 entry D)."""
    dom = cfg.domain
    sch = cfg.resolved_scheme
    dev = state.xn.device
    nl, disp, r = _neighbors_and_pairs(cfg, state)
    gw = sph.grad_w(disp, r, cfg.h, dom.dim, nl.mask)

    fl = state.fluid
    drho, acc = _gathered_pair_rhs(sch, dom, fl, nl, disp, r, gw)
    rho = fl.rho + cfg.dt * drho
    if cfg.wall_rho_clamp:
        rho = torch.where(state.fixed, torch.clamp(rho, min=sch.rho0), rho)

    v = fl.v + cfg.dt * (acc + sch.body_force_vec(dom.dim, dev))
    fixed = state.fixed[:, None]
    vw = torch.zeros_like(v) if state.v_wall is None else state.v_wall
    v = torch.where(fixed, vw, v)

    dxn = torch.where(fixed, torch.zeros_like(v), v * cfg.dt * (2.0 / dom.h_d))
    xn = state.xn + dxn
    # Wrap periodic axes back into the box.
    span = torch.tensor([2.0 * s / dom.h_d if p else 0.0
                         for s, p in zip(dom.spans, dom.periodic)],
                        dtype=torch.float32, device=dev)
    org = torch.tensor(dom.origin_norm, dtype=torch.float32, device=dev)
    wrapped = org + torch.remainder(xn - org, torch.where(span > 0, span, 1.0))
    xn = torch.where(span > 0, wrapped, xn)
    return SPHState(xn=xn, rc=state.rc, fluid=sph.FluidState(v=v, rho=rho, m=fl.m),
                    fixed=state.fixed, t=state.t + cfg.dt, kind=state.kind,
                    v_wall=state.v_wall)


def step(cfg: SPHConfig, state: SPHState) -> SPHState:
    """One WCSPH step from and to original particle indexing (the RCLL
    path packs, builds a fresh neighbor structure, steps once, unpacks)."""
    if cfg.algo == "rcll":
        carry = init_persistent(cfg, state)
        return finalize_persistent(cfg, _physics_step(cfg, carry))
    return _step_absolute(cfg, state)


def simulate_stats(cfg: SPHConfig, state: SPHState, nsteps: int) -> tuple[SPHState, SimStats]:
    """Run ``nsteps`` steps; also report rebuild/overflow diagnostics (an
    absolute run counts every step as a rebuild and reports no overflow).

    ``state`` is not modified. With ``cfg.check_overflow`` the run raises
    :class:`health.SimulationDiverged` on any capacity overflow.
    """
    if cfg.algo == "rcll":
        carry = init_persistent(cfg, state)
        carry = run_persistent(cfg, carry, nsteps)
        stats = SimStats(rebuilds=carry.rebuilds, steps=carry.steps,
                         overflow=bool(carry.overflow))
        out = finalize_persistent(cfg, carry)
    else:
        out = state
        for _ in range(nsteps):
            out = _step_absolute(cfg, out)
        stats = SimStats(rebuilds=nsteps, steps=nsteps, overflow=False)
    if cfg.check_overflow and stats.overflow:
        _raise_on_overflow(True, cfg.max_neighbors)
    return out, stats


def simulate(cfg: SPHConfig, state: SPHState, nsteps: int) -> SPHState:
    """Run ``nsteps`` steps."""
    return simulate_stats(cfg, state, nsteps)[0]
