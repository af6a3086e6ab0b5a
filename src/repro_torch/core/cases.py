"""Scenario cases: the case registry plus the shipped benchmark suite.

Port of ``repro.core.cases``. A case is a frozen dataclass whose
``build(device=None)`` returns a ready ``(SPHConfig, SPHState)`` pair on
``device`` (CUDA unless the caller names another); the host-side lattice
and initial fields are the same numpy code as in the JAX package, so a
built state is bit-identical to the JAX one. Cases are registered by name
(:func:`register_case`) and built with field overrides through
:func:`build_case`; :func:`resolve_ds` maps a target particle count to a
spacing.

Shipped cases: ``poiseuille`` (2-D channel, periodic x, dummy walls),
``dam_break`` (collapsing column, Tait EOS + artificial viscosity +
delta-SPH), ``cavity`` (moving lid via ``v_wall``), ``taylor_green``
(fully periodic, analytic viscous decay).

Poiseuille analytic transient (series) solution:

  v_x(y,t) = F/(2 nu) * y (L - y)
           - sum_n 4 F L^2 / (nu pi^3 (2n+1)^3) * sin(pi y (2n+1)/L)
             * exp(-(2n+1)^2 pi^2 nu t / L^2)
"""
from __future__ import annotations

import dataclasses
from typing import Protocol, runtime_checkable

import numpy as np

from repro_torch.core import boundaries
from repro_torch.core import scheme as scheme_lib
from repro_torch.core import solver as solver_lib
from repro_torch.core.domain import Domain
from repro_torch.core.precision import PrecisionPolicy

Array = np.ndarray


# --------------------------------------------------------------------------
# Case registry
# --------------------------------------------------------------------------
@runtime_checkable
class CaseSpec(Protocol):
    """What the scenario layer requires of a case.

    Required: ``build()``. The CLI/gallery additionally read the class
    metadata attributes (``boundary``, ``validation``,
    ``default_nsteps``, ``fluid_area``) and, when present, call
    ``validate(times, ekin)`` for case-specific analytic checks.
    """

    name: str

    def build(self, device=None) -> tuple["solver_lib.SPHConfig", "solver_lib.SPHState"]:
        ...


CASES: dict[str, type] = {}


def register_case(name: str):
    """Class decorator: register a CaseSpec under ``name``."""

    def deco(cls):
        cls.name = name
        CASES[name] = cls
        return cls

    return deco


def case_names() -> list[str]:
    return sorted(CASES)


def build_case(name: str, **overrides):
    """Instantiate a registered case with dataclass-field overrides."""
    try:
        cls = CASES[name]
    except KeyError:
        raise ValueError(
            f"unknown case {name!r}; registered: {case_names()}"
        ) from None
    return cls(**overrides)


def resolve_ds(name: str, n_target: int, **overrides) -> float:
    """Spacing that puts ~``n_target`` particles in the case's fluid body."""
    case = build_case(name, **overrides)
    return float(np.sqrt(case.fluid_area / max(1, n_target)))


@register_case("poiseuille")
@dataclasses.dataclass(frozen=True)
class PoiseuilleCase:
    ds: float = 0.025
    L: float = 1.0  # channel width (y)
    Lx: float = 0.4  # periodic streamwise extent
    nu: float = 1.0
    rho0: float = 1.0
    v_max: float = 0.125
    n_wall: int = 3  # dummy-particle wall layers per side
    algo: str = "rcll"
    policy: PrecisionPolicy = PrecisionPolicy()
    max_neighbors: int = 40
    cfl: float = 0.125
    # Persistent-pipeline knobs: a Verlet skin needs cells that cover the
    # inflated radius, so cell_factor must be >= (r + skin) / r.
    skin: float = 0.0
    cell_factor: float = 1.0
    rebuild_every: int | None = None
    backend: str | None = None  # None -> "kernel" | "reference" | "xla"
    force_chunk: int = 0
    check_overflow: bool = False

    # --- CLI / gallery metadata ---
    boundary = "periodic x; no-slip dummy walls y (3 layers/side)"
    validation = "transient velocity profile vs Morris 1997 series"
    default_nsteps = 400

    @property
    def fluid_area(self) -> float:
        return self.L * self.Lx

    @property
    def F(self) -> float:
        return 8.0 * self.nu * self.v_max / (self.L * self.L)

    @property
    def c0(self) -> float:
        return 10.0 * self.v_max

    @property
    def h(self) -> float:
        return 1.2 * self.ds

    @property
    def dt(self) -> float:
        dt_visc = self.cfl * self.h * self.h / self.nu
        dt_acoustic = 0.25 * self.h / self.c0
        dt_force = 0.25 * np.sqrt(self.h / max(self.F, 1e-12))
        return float(min(dt_visc, dt_acoustic, dt_force))

    def domain(self) -> Domain:
        wall = self.n_wall * self.ds
        return Domain(
            lo=(0.0, -wall),
            hi=(self.Lx, self.L + wall),
            h=self.h,
            cell_factor=self.cell_factor,
            periodic=(True, False),
        )

    def build(self, device=None) -> tuple[solver_lib.SPHConfig, solver_lib.SPHState]:
        ds, L = self.ds, self.L
        nx = int(round(self.Lx / ds))
        xs = (np.arange(nx) + 0.5) * ds
        # fluid rows in (0, L); wall rows outside
        ys_fluid = (np.arange(int(round(L / ds))) + 0.5) * ds
        ys_wall_lo = -(np.arange(self.n_wall) + 0.5) * ds
        ys_wall_hi = L + (np.arange(self.n_wall) + 0.5) * ds
        ys = np.concatenate([ys_fluid, ys_wall_lo, ys_wall_hi])
        fixed_rows = np.concatenate(
            [np.zeros_like(ys_fluid, bool),
             np.ones_like(ys_wall_lo, bool),
             np.ones_like(ys_wall_hi, bool)]
        )
        X, Y = np.meshgrid(xs, ys, indexing="ij")
        pos = np.stack([X.ravel(), Y.ravel()], axis=-1)
        fixed = np.broadcast_to(fixed_rows[None, :], X.shape).ravel().copy()
        n = pos.shape[0]
        m = np.full((n,), self.rho0 * ds * ds)
        rho = np.full((n,), self.rho0)
        v = np.zeros((n, 2))
        cfg = solver_lib.SPHConfig(
            domain=self.domain(),
            ds=ds,
            dt=self.dt,
            rho0=self.rho0,
            c0=self.c0,
            mu=self.rho0 * self.nu,
            body_force=(self.F, 0.0),
            max_neighbors=self.max_neighbors,
            algo=self.algo,
            policy=self.policy,
            skin=self.skin,
            rebuild_every=self.rebuild_every,
            backend=self.backend,
            force_chunk=self.force_chunk,
            check_overflow=self.check_overflow,
        )
        state = solver_lib.init_state(
            cfg, pos, v, m, rho, fixed=fixed, device=device
        )
        return cfg, state

    def analytic_vx(self, y: Array, t: float, nterms: int = 60) -> Array:
        """Transient series solution (paper ref [42], Morris 1997)."""
        F, nu, L = self.F, self.nu, self.L
        y = np.asarray(y)
        steady = F / (2.0 * nu) * y * (L - y)
        total = steady
        for n in range(nterms):
            k = 2 * n + 1
            term = (
                4.0 * F * L * L / (nu * np.pi**3 * k**3)
                * np.sin(np.pi * y * k / L)
                * np.exp(-(k**2) * np.pi**2 * nu * t / (L * L))
            )
            total = total - term
        return total

    def analytic_displacement(self, y: Array, t: float,
                              nterms: int = 60) -> Array:
        """x-displacement = integral of analytic_vx over [0, t] (Table 5)."""
        F, nu, L = self.F, self.nu, self.L
        y = np.asarray(y)
        disp = F / (2.0 * nu) * y * (L - y) * t
        for n in range(nterms):
            k = 2 * n + 1
            lam = (k**2) * np.pi**2 * nu / (L * L)
            term = (
                4.0 * F * L * L / (nu * np.pi**3 * k**3)
                * np.sin(np.pi * y * k / L)
                * (1.0 - np.exp(-lam * t)) / lam
            )
            disp = disp - term
        return disp


# --------------------------------------------------------------------------
# Dam break (free surface, non-periodic tank, Tait EOS + artificial visc)
# --------------------------------------------------------------------------
@register_case("dam_break")
@dataclasses.dataclass(frozen=True)
class DamBreakCase:
    """2-D collapsing water column in an open-topped tank.

    The classic free-surface benchmark (Monaghan 1994; DualSPHysics,
    arXiv:1110.3711): a column of width ``col_w`` and height ``col_h``
    held against the left wall collapses under gravity and surges along
    the floor. Physics follow the standard dam-break recipe: Tait EOS
    (γ=7), Monaghan artificial viscosity (no laminar term), hydrostatic
    density initialization, and the DualSPHysics wall-density clamp.

    Validation: the surge-front position; after the initial transient
    the front advances at ~2√(g·col_h) (the shallow-water dam-break
    front speed — Ritter's solution), which the CLI reports against the
    measured front trajectory.
    """

    ds: float = 0.05
    width: float = 2.0  # tank inner width
    height: float = 1.3  # tank inner height (open top, splash headroom)
    col_w: float = 0.5
    col_h: float = 1.0
    g: float = 1.0
    rho0: float = 1.0
    alpha: float = 0.1  # Monaghan artificial-viscosity coefficient
    delta: float = 0.1  # delta-SPH density diffusion
    gamma: float = 7.0
    n_wall: int = 3
    algo: str = "rcll"
    policy: PrecisionPolicy = PrecisionPolicy()
    max_neighbors: int = 48
    backend: str | None = None
    check_overflow: bool = False
    # Verlet-skin reuse knobs (the --dynamic benchmark's amortized-
    # rebuild mode): a skin needs cells covering r + skin, so
    # cell_factor must be >= (r + skin) / r. Defaults keep the legacy
    # per-step-rebuild behavior.
    skin: float = 0.0
    cell_factor: float = 1.0
    # Initial downward fluid speed (the "dropped column" start). The
    # collapse from rest needs O(sqrt(col_h/g)) of physical time before
    # anything moves a cell — thousands of steps at fine ds — so
    # benchmarks that must observe rebuilds inside a short timed window
    # start the column already falling at a collapse-representative
    # speed instead. 0 = the validated classic quiescent start.
    v0: float = 0.0

    boundary = "no-slip walls x-lo/x-hi/y-lo (3 layers), open top"
    validation = "surge-front speed vs 2*sqrt(g*col_h) (Ritter)"
    default_nsteps = 600

    @property
    def c0(self) -> float:
        # WCSPH rule: c0 >= 10 * max flow speed ~ sqrt(2 g col_h)
        return 10.0 * float(np.sqrt(2.0 * self.g * self.col_h))

    @property
    def h(self) -> float:
        return 1.2 * self.ds

    @property
    def dt(self) -> float:
        # The c0 rule (10x the gravity speed scale) does not cover the
        # dropped-column start: a whole column impacting the floor at
        # v0 develops local speeds ~2 v0 and a water-hammer pressure
        # spike, which blows the acoustic CFL at fine ds. Augment the
        # signal speed by the same 10x rule applied to the impact
        # scale; v0 = 0 keeps the classic dt exactly.
        dt_acoustic = 0.25 * self.h / (self.c0 + 20.0 * self.v0)
        dt_force = 0.25 * float(np.sqrt(self.h / self.g))
        return float(min(dt_acoustic, dt_force))

    @property
    def fluid_area(self) -> float:
        return self.col_w * self.col_h

    @property
    def sides(self) -> tuple[tuple[int, int], ...]:
        return ((0, 0), (0, 1), (1, 0))  # x-lo, x-hi, floor

    def scheme(self) -> scheme_lib.Scheme:
        return scheme_lib.Scheme(
            c0=self.c0, rho0=self.rho0, eos="tait", gamma=self.gamma,
            viscosity="none", alpha=self.alpha, delta=self.delta,
            body_force=(0.0, -self.g),
        )

    def domain(self) -> Domain:
        lo, hi = boundaries.wall_extent(
            (0.0, 0.0), (self.width, self.height), self.ds, self.n_wall,
            self.sides,
        )
        return Domain(
            lo=lo, hi=hi, h=self.h, cell_factor=self.cell_factor,
            periodic=(False, False),
        )

    def build(self, device=None) -> tuple[solver_lib.SPHConfig, solver_lib.SPHState]:
        fluid = boundaries.fluid_lattice(
            (0.0, 0.0), (self.col_w, self.col_h), self.ds
        )
        walls, _ = boundaries.box_wall_particles(
            (0.0, 0.0), (self.width, self.height), self.ds, self.n_wall,
            self.sides,
        )
        pos = np.concatenate([fluid, walls])
        kind = np.concatenate([
            np.full(len(fluid), boundaries.FLUID, np.int8),
            np.full(len(walls), boundaries.WALL, np.int8),
        ])
        n = pos.shape[0]
        sch = self.scheme()
        # Hydrostatic column init (Tait-inverted): ρ(y) = ρ0 (1 + γ p_h /
        # (ρ0 c0²))^(1/γ), p_h = ρ0 g (col_h − y). Starting in mechanical
        # equilibrium removes the startup pressure shock.
        p_h = self.rho0 * self.g * np.maximum(self.col_h - pos[:, 1], 0.0)
        rho = self.rho0 * (
            1.0 + self.gamma * p_h / (self.rho0 * self.c0**2)
        ) ** (1.0 / self.gamma)
        rho = np.where(kind == boundaries.WALL, self.rho0, rho)
        m = np.full((n,), self.rho0 * self.ds * self.ds)
        v = np.zeros((n, 2))
        if self.v0:
            v[:len(fluid), 1] = -self.v0
        dom = self.domain()
        cfg = solver_lib.SPHConfig(
            domain=dom,
            ds=self.ds,
            dt=self.dt,
            rho0=self.rho0,
            c0=self.c0,
            mu=0.0,
            body_force=(0.0, -self.g),
            max_neighbors=self.max_neighbors,
            # capacity: the default robust rule (cells.robust_capacity)
            # already covers the DENSE column in the mostly-empty tank —
            # no per-case override to forget.
            algo=self.algo,
            policy=self.policy,
            backend=self.backend,
            scheme=sch,
            wall_rho_clamp=True,
            skin=self.skin,
            check_overflow=self.check_overflow,
        )
        state = solver_lib.init_state(
            cfg, pos, v, m, rho, kind=kind, device=device
        )
        return cfg, state

    def front_position(self, cfg, state) -> float:
        """Surge-front x: rightmost fluid particle (the CLI's metric)."""
        pos = solver_lib.positions(cfg, state).cpu().numpy()
        fl = ~state.fixed.cpu().numpy()
        return float(pos[fl, 0].max())


# --------------------------------------------------------------------------
# Lid-driven cavity (enclosed box, moving wall)
# --------------------------------------------------------------------------
@register_case("cavity")
@dataclasses.dataclass(frozen=True)
class LidCavityCase:
    """Lid-driven cavity: enclosed unit box, top lid sliding at ``U``.

    The standard internal-flow benchmark (Ghia et al. 1982). The lid is
    a MOVING wall: its dummy layers carry the prescribed velocity (U, 0)
    through ``SPHState.v_wall`` — they drag the fluid through the
    viscous pair term via the same per-particle v array (and fused
    record rows) as everything else, but never advect. The lid owns its
    corners (listed first in ``sides``), matching the usual SPH cavity
    setup.
    """

    ds: float = 0.05
    L: float = 1.0
    U: float = 1.0  # lid speed
    Re: float = 100.0
    rho0: float = 1.0
    # delta-SPH density diffusion: the lid corners are genuine pressure
    # singularities; continuity-integrated density drifts there and the
    # run blows up by ~500 steps without diffusion (rho_err stays ~1%
    # with it).
    delta: float = 0.1
    n_wall: int = 3
    algo: str = "rcll"
    policy: PrecisionPolicy = PrecisionPolicy()
    max_neighbors: int = 48
    backend: str | None = None
    check_overflow: bool = False

    boundary = "no-slip walls all sides; MOVING lid y-hi (v_wall=(U,0))"
    validation = "spin-up to steady recirculation (KE plateau, |v|<=U)"
    default_nsteps = 600

    @property
    def nu(self) -> float:
        return self.U * self.L / self.Re

    @property
    def c0(self) -> float:
        return 10.0 * self.U

    @property
    def h(self) -> float:
        return 1.2 * self.ds

    @property
    def dt(self) -> float:
        dt_acoustic = 0.25 * self.h / self.c0
        dt_visc = 0.125 * self.h * self.h / self.nu
        return float(min(dt_acoustic, dt_visc))

    @property
    def fluid_area(self) -> float:
        return self.L * self.L

    @property
    def sides(self) -> tuple[tuple[int, int], ...]:
        # lid FIRST: corner particles belong to the moving lid
        return ((1, 1), (1, 0), (0, 0), (0, 1))

    def scheme(self) -> scheme_lib.Scheme:
        return scheme_lib.Scheme(
            c0=self.c0, rho0=self.rho0, viscosity="morris",
            mu=self.rho0 * self.nu, delta=self.delta,
        )

    def domain(self) -> Domain:
        lo, hi = boundaries.wall_extent(
            (0.0, 0.0), (self.L, self.L), self.ds, self.n_wall, self.sides
        )
        return Domain(lo=lo, hi=hi, h=self.h, periodic=(False, False))

    def build(self, device=None) -> tuple[solver_lib.SPHConfig, solver_lib.SPHState]:
        box = ((0.0, 0.0), (self.L, self.L))
        fluid = boundaries.fluid_lattice(*box, self.ds)
        walls, v_walls = boundaries.box_wall_particles(
            *box, self.ds, self.n_wall, self.sides,
            velocities={(1, 1): (self.U, 0.0)},
        )
        pos = np.concatenate([fluid, walls])
        kind = np.concatenate([
            np.full(len(fluid), boundaries.FLUID, np.int8),
            np.full(len(walls), boundaries.WALL, np.int8),
        ])
        v_wall = np.concatenate([
            np.zeros((len(fluid), 2), np.float32), v_walls
        ])
        n = pos.shape[0]
        m = np.full((n,), self.rho0 * self.ds * self.ds)
        rho = np.full((n,), self.rho0)
        # walls START at their prescribed velocity so the first force
        # evaluation already sees the moving lid
        v = v_wall.copy()
        cfg = solver_lib.SPHConfig(
            domain=self.domain(),
            ds=self.ds,
            dt=self.dt,
            rho0=self.rho0,
            c0=self.c0,
            mu=self.rho0 * self.nu,
            body_force=(0.0, 0.0),
            max_neighbors=self.max_neighbors,
            algo=self.algo,
            policy=self.policy,
            backend=self.backend,
            scheme=self.scheme(),
            check_overflow=self.check_overflow,
        )
        state = solver_lib.init_state(
            cfg, pos, v, m, rho, kind=kind, v_wall=v_wall, device=device
        )
        return cfg, state


# --------------------------------------------------------------------------
# Taylor–Green vortex (fully periodic, analytic viscous decay)
# --------------------------------------------------------------------------
@register_case("taylor_green")
@dataclasses.dataclass(frozen=True)
class TaylorGreenCase:
    """2-D Taylor–Green vortex: the analytic-decay validation case.

    Fully periodic box, initial field
        u =  U sin(kx) cos(ky),  v = -U cos(kx) sin(ky),  k = 2π/L,
    an exact Navier–Stokes solution decaying as exp(−2νk²t) in velocity,
    i.e. kinetic energy ∝ exp(−4νk²t) (:meth:`decay_rate`). Density is
    initialized through the linear EOS from the analytic pressure
    p = −ρ0U²/4 (cos 2kx + cos 2ky), which suppresses the acoustic
    startup transient that a uniform-density start would ring with.

    The measured KE decay includes SPH's resolution-dependent numerical
    dissipation, so validation windows/resolutions matter: at the
    defaults (ds=1/32, Re=20) the log-KE slope over t ∈ [0.02, 0.1]
    matches 4νk² within a few percent.
    """

    ds: float = 1.0 / 32.0
    L: float = 1.0
    U: float = 1.0
    Re: float = 20.0
    rho0: float = 1.0
    algo: str = "rcll"
    policy: PrecisionPolicy = PrecisionPolicy()
    max_neighbors: int = 48
    backend: str | None = None
    check_overflow: bool = False

    boundary = "fully periodic (no walls)"
    validation = "KE decay rate vs analytic 4*nu*k^2 (<5%)"
    default_nsteps = 600

    @property
    def nu(self) -> float:
        return self.U * self.L / self.Re

    @property
    def c0(self) -> float:
        return 10.0 * self.U

    @property
    def h(self) -> float:
        return 1.2 * self.ds

    @property
    def dt(self) -> float:
        dt_acoustic = 0.25 * self.h / self.c0
        dt_visc = 0.125 * self.h * self.h / self.nu
        return float(min(dt_acoustic, dt_visc))

    @property
    def fluid_area(self) -> float:
        return self.L * self.L

    @property
    def k(self) -> float:
        return 2.0 * np.pi / self.L

    @property
    def decay_rate(self) -> float:
        """Analytic kinetic-energy decay rate: KE(t) = KE(0) e^{-λt}."""
        return 4.0 * self.nu * self.k * self.k

    def scheme(self) -> scheme_lib.Scheme:
        return scheme_lib.wcsph(self.c0, self.rho0, self.rho0 * self.nu)

    def domain(self) -> Domain:
        return Domain(
            lo=(0.0, 0.0), hi=(self.L, self.L), h=self.h,
            periodic=(True, True),
        )

    def build(self, device=None) -> tuple[solver_lib.SPHConfig, solver_lib.SPHState]:
        pos = boundaries.fluid_lattice((0.0, 0.0), (self.L, self.L), self.ds)
        n = pos.shape[0]
        kx, ky = self.k * pos[:, 0], self.k * pos[:, 1]
        v = self.U * np.stack(
            [np.sin(kx) * np.cos(ky), -np.cos(kx) * np.sin(ky)], axis=-1
        )
        p0 = -self.rho0 * self.U**2 / 4.0 * (np.cos(2 * kx) + np.cos(2 * ky))
        rho = self.rho0 + p0 / self.c0**2  # linear-EOS-consistent init
        m = np.full((n,), self.rho0 * self.ds * self.ds)
        cfg = solver_lib.SPHConfig(
            domain=self.domain(),
            ds=self.ds,
            dt=self.dt,
            rho0=self.rho0,
            c0=self.c0,
            mu=self.rho0 * self.nu,
            body_force=(0.0, 0.0),
            max_neighbors=self.max_neighbors,
            algo=self.algo,
            policy=self.policy,
            backend=self.backend,
            scheme=self.scheme(),
            check_overflow=self.check_overflow,
        )
        state = solver_lib.init_state(cfg, pos, v, m, rho, device=device)
        return cfg, state

    def analytic_ekin(self, ekin0: float, t) -> np.ndarray:
        return ekin0 * np.exp(-self.decay_rate * np.asarray(t))

    def fit_decay_rate(self, times, ekin, frac_window: float = 0.5) -> float:
        """Least-squares slope of −log KE(t) over the validated window.

        The window is the first KE *half-life* (samples with KE >=
        ``frac_window`` × the back-extrapolated KE(0)): beyond it the
        particle lattice has disordered and SPH's resolution-dependent
        numerical dissipation steepens the decay — a real SPH property,
        not a solver bug, so validation compares where the analytic
        solution is the dominant physics (within ~3% at the defaults).
        """
        t = np.asarray(times, np.float64)
        e = np.asarray(ekin, np.float64)
        e0 = e[0] / np.exp(-self.decay_rate * t[0])
        keep = (e > 0) & (e >= frac_window * e0)
        if keep.sum() < 2:
            # observation window starts past the first half-life (e.g. a
            # warm-started sim): fall back to fitting every positive
            # sample — no crash, though the fit then includes the
            # disorder-dissipation regime.
            keep = e > 0
        a = np.polyfit(t[keep], np.log(e[keep]), 1)
        return float(-a[0])

    def validate(self, times, ekin) -> dict:
        """CLI hook: measured vs analytic KE decay (first half-life)."""
        lam = self.fit_decay_rate(times, ekin)
        ana = self.decay_rate
        return {
            "decay_rate_measured": lam,
            "decay_rate_analytic": ana,
            "decay_rate_rel_err": abs(lam - ana) / ana,
        }


def gradient_test_particles(ds: float, jitter: float = 0.2, seed: int = 0,
                            dim: int = 2) -> tuple[Domain, np.ndarray]:
    """Unit-domain particle set (numpy, float64) for the f(x) = x^3
    gradient study (the paper's Table 3); the jitter breaks the lattice's
    symmetry and its exact-boundary distance ties."""
    h = 1.2 * ds
    dom = Domain(lo=(0.0,) * dim, hi=(1.0,) * dim, h=h)
    axes = [np.arange(ds / 2, 1.0, ds) for _ in range(dim)]
    grid = np.meshgrid(*axes, indexing="ij")
    x = np.stack([g.ravel() for g in grid], axis=-1).astype(np.float64)
    rng = np.random.default_rng(seed)
    x = x + rng.uniform(-jitter * ds, jitter * ds, size=x.shape)
    x = np.clip(x, 1e-6, 1.0 - 1e-6)
    return dom, x


def cubic_field(x):
    """f = x^3 on axis 0 (the paper's Table 3 test function)."""
    return x[..., 0] ** 3


def cubic_gradient_x(x):
    return 3.0 * x[..., 0] ** 2
