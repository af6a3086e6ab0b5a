"""Mixed-precision SPH solver: the persistent RCLL pipeline, kernel backend.

Port of the persistent-pipeline part of ``repro.core.solver``. The state
is kept cell-packed (all per-particle arrays reordered by flat cell id);
each step checks the Verlet-skin criterion, rebuilds when it fires
(counting-sort pack -> one fused state permutation -> static mass tile)
and then runs the force pass through the two CUDA kernels (K1 cell pack,
K2 fused force) and the explicit WCSPH update with the Eq. (8) advance.

Where JAX traces ``lax.cond``/``lax.scan``, the port runs a Python loop:
the rebuild decision is read on the host once per step (one device sync
per step), and a rebuild reads one more flag (whether the counting sort's
adjacency precondition holds). CUDA graphs are later work.

The port has one force backend, ``"kernel"`` (the counterpart of JAX's
``"pallas"``); the ``"reference"`` gather oracle, the ``"xla"`` fused
sweep and the absolute-coordinate algos wait for their ROADMAP items.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.core import cells as cells_lib
from repro_torch.core import fused, health, rcll, sph, statepack
from repro_torch.core import scheme as scheme_lib
from repro_torch.core.domain import Domain
from repro_torch.core.precision import PrecisionPolicy

#: Backends that exist in the JAX package but are not ported yet, with
#: the ROADMAP Queue 1 item that ports them.
UNPORTED_BACKENDS = {
    "reference": "ROADMAP Queue 1 item 4b (the reference gather backend)",
    "xla": "ROADMAP Queue 1 item 5 (the fused XLA sweep)",
}


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
    capacity: int | None = None
    algo: str = "rcll"  # only the persistent RCLL pipeline is ported
    policy: PrecisionPolicy = PrecisionPolicy()
    # Physics-term spec; None builds the WCSPH scheme from rho0/c0/mu/body_force.
    scheme: scheme_lib.Scheme | None = None
    # Clamp wall-particle density at >= rho0 after the continuity update.
    wall_rho_clamp: bool = False
    # --- persistent-pipeline knobs ---
    skin: float = 0.0  # physical Verlet-skin width added to the search radius
    rebuild_every: int | None = None  # static rebuild cadence (overrides skin)
    backend: str | None = None  # None -> "kernel"
    # Raise health.SimulationDiverged from simulate/simulate_stats when a
    # cell table dropped particles during the run (one host read after it).
    check_overflow: bool = False

    @property
    def h(self) -> float:
        return self.domain.h

    def cap(self, n: int) -> int:
        """Per-cell table capacity: explicit override or the robust rule."""
        return self.capacity or cells_lib.robust_capacity(self.domain, self.ds, n)

    @property
    def skin_norm(self) -> float:
        """Skin width in normalized (Eq. 5) units."""
        return 2.0 * self.skin / self.domain.h_d

    @property
    def resolved_scheme(self) -> scheme_lib.Scheme:
        if self.scheme is not None:
            return self.scheme
        return scheme_lib.wcsph(self.c0, self.rho0, self.mu, self.body_force)

    @property
    def resolved_backend(self) -> str:
        if self.backend is None or self.backend == "kernel":
            return "kernel"
        if self.backend in UNPORTED_BACKENDS:
            raise NotImplementedError(
                f"backend {self.backend!r} is not ported yet: "
                f"{UNPORTED_BACKENDS[self.backend]}"
            )
        raise ValueError(f"unknown backend {self.backend!r}; the port has 'kernel'")

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

    def validate_algo(self) -> None:
        if self.algo != "rcll":
            raise NotImplementedError(
                f"algo {self.algo!r} is not ported yet: ROADMAP Queue 1 item 4b "
                "(the absolute-coordinate paths)"
            )


class SPHState(NamedTuple):
    """Particle system state. ``xn`` is the normalized-absolute position at
    init (frozen afterwards); ``rc`` is the RCLL state, the source of
    truth. ``fixed`` marks wall particles (never advected, velocity
    prescribed: ``v_wall`` where given, else 0); ``kind`` is their int8
    classification (boundaries.FLUID / WALL)."""

    xn: torch.Tensor  # (N, d) fp32
    rc: rcll.RCLLState
    fluid: sph.FluidState
    fixed: torch.Tensor  # (N,) bool
    t: torch.Tensor  # () fp32 simulation time
    kind: torch.Tensor | None = None  # (N,) int8
    v_wall: torch.Tensor | None = None  # (N, d) fp32


class NeighborList(NamedTuple):
    """Neighbor list of the list-consuming backends (ROADMAP Queue 1 item
    5); the kernel backend carries a zero-capacity one."""

    idx: torch.Tensor  # (N, K) int32
    mask: torch.Tensor  # (N, K) bool
    count: torch.Tensor  # (N,) int32


class PersistentCarry(NamedTuple):
    """Carry of the packed persistent pipeline.

    All per-particle tensors in ``st`` are in PACKED order; ``order``
    maps packed position -> original particle id. ``binning`` is the
    packed binning of the last rebuild (stale but exact to decode
    against between rebuilds). ``rebuilds``/``steps`` are host ints: the
    loop decides rebuilds on the host anyway.
    """

    st: SPHState
    order: torch.Tensor  # (N,) int32 packed -> original
    nl: NeighborList
    disp_acc: torch.Tensor  # (N, d) fp32 normalized displacement since rebuild
    rebuilds: int
    steps: int
    overflow: torch.Tensor  # () bool any cell-table overflow seen
    binning: cells_lib.CellBinning | None = None
    m_scale: torch.Tensor | None = None  # () fp32 half-record mass normalizer
    m_table: torch.Tensor | None = None  # (C+1, cap) static mass tile
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
    """Physical positions decoded from the RCLL state."""
    xn = rcll.to_normalized(cfg.domain, state.rc, dtype=dtype)
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


def _empty_neighbor_list(n: int, device) -> NeighborList:
    """Zero-capacity list for backends that never consume one."""
    return NeighborList(
        idx=torch.zeros((n, 0), dtype=torch.int32, device=device),
        mask=torch.zeros((n, 0), dtype=torch.bool, device=device),
        count=torch.zeros((n,), dtype=torch.int32, device=device),
    )


def _rebuild(cfg: SPHConfig, carry: PersistentCarry) -> PersistentCarry:
    """Re-sort by cell (counting-sort pack against the carried binning),
    permute the whole state by one row gather, and rebuild the static
    mass tile. The kernel backend reads no neighbor list, so its overflow
    flag means exactly "a cell table dropped particles"."""
    from repro_torch.kernels import ops  # core stays kernel-free at import

    n = carry.order.shape[0]
    ps = rcll.pack_state(cfg.domain, carry.st.rc, cfg.cap(n), prev=carry.binning)
    perm = ps.packing.order  # current-packed -> new-packed
    binning = ps.packing.binning
    # The step updates rc.cell_xy in place; the stale binning must keep
    # its own copy.
    rc = ps.rc._replace(cell_xy=ps.rc.cell_xy.clone())
    st, order = _permute_state_fused(carry.st, perm, rc, carry.order)
    cell_over = binning.overflow > 0
    m_table = ops.mass_table(binning, st.fluid.m, cfg.policy.records_dtype,
                             carry.m_scale)
    return PersistentCarry(
        st=st,
        order=order,
        nl=_empty_neighbor_list(n, order.device),
        disp_acc=torch.zeros_like(carry.disp_acc),
        rebuilds=carry.rebuilds + 1,
        steps=carry.steps,
        overflow=carry.overflow | cell_over,
        binning=binning,
        m_scale=carry.m_scale,
        m_table=m_table,
        flags=health.fold_flag(carry.flags, cell_over, health.CELL_OVERFLOW),
    )


def init_persistent(cfg: SPHConfig, state: SPHState) -> PersistentCarry:
    """Pack the state (first rebuild) and hoist the mass normalizer."""
    cfg.validate_skin()
    cfg.validate_algo()
    cfg.resolved_backend  # raises for unported backends
    n = state.xn.shape[0]
    dev = state.xn.device
    m_scale = fused.mass_scale(state.fluid.m) if cfg.policy.half_records else None
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
        # Degenerate skin: any movement invalidates the binning.
        return bool(torch.max(torch.abs(carry.disp_acc)) > 0.0)
    max_disp = torch.sqrt(torch.max(torch.sum(carry.disp_acc * carry.disp_acc, dim=-1)))
    return bool(max_disp > 0.5 * cfg.skin_norm)


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


def _physics_step(cfg: SPHConfig, carry: PersistentCarry,
                  dt: float | torch.Tensor | None = None) -> PersistentCarry:
    """One WCSPH step on the packed state (explicit: every RHS term from
    the current state). ``dt`` optionally overrides ``cfg.dt``.

    The per-particle fields (v, rho, rel, cell_xy, disp_acc) are updated
    IN PLACE, so the carry passed in must not be used again except
    through the returned one.
    """
    dom, pol = cfg.domain, cfg.policy
    sch = cfg.resolved_scheme
    if dt is None:
        dt = cfg.dt
    st, fl = carry.st, carry.st.fluid
    drho, acc = _force_rhs_kernel(cfg, carry)
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


def step_persistent(cfg: SPHConfig, carry: PersistentCarry) -> PersistentCarry:
    """Rebuild if needed (decided on the host) + one physics step."""
    if _needs_rebuild(cfg, carry):
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


def _raise_on_overflow() -> None:
    raise health.SimulationDiverged(
        "cell capacity overflow: a cell table row filled and dropped "
        "particles; enlarge SPHConfig.capacity.",
        checks=("cell_overflow",),
        word=health.CELL_OVERFLOW,
    )


def simulate_stats(cfg: SPHConfig, state: SPHState, nsteps: int) -> tuple[SPHState, SimStats]:
    """Run ``nsteps`` steps; also report rebuild/overflow diagnostics.

    ``state`` is not modified (the run works on permuted copies).
    """
    carry = init_persistent(cfg, state)
    carry = run_persistent(cfg, carry, nsteps)
    stats = SimStats(rebuilds=carry.rebuilds, steps=carry.steps,
                     overflow=bool(carry.overflow))
    if cfg.check_overflow and stats.overflow:
        _raise_on_overflow()
    return finalize_persistent(cfg, carry), stats


def simulate(cfg: SPHConfig, state: SPHState, nsteps: int) -> SPHState:
    """Run ``nsteps`` steps of the persistent pipeline."""
    return simulate_stats(cfg, state, nsteps)[0]
