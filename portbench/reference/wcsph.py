"""Plain reference of one explicit WCSPH step, in PyTorch, for judging the
program's steps.

It imports nothing of the program. From the configuration's stated
physics (cubic B-spline kernel, linear or Tait EOS, Morris viscosity,
Monaghan artificial viscosity, delta-SPH, walls that are never advected
and whose density is clamped at rho0) it computes one step from a state
given in physical positions, with its own uniform-grid neighbor search
and every pair inside the support r < 2h.

The stated storage precisions are applied where the configuration
states them: the force pass reads velocities and masses as 16-bit
records, 1/rho as a 32-bit record, and positions as 16-bit coordinates
relative to their cell. The arithmetic runs in float64 (``STATED``), or
one step below each stated precision (``lowered``), which is the
control that the comparison has to reject.
"""
from __future__ import annotations

import dataclasses
import math

import torch

#: The dtype one step below each precision a configuration may state.
_BELOW = {
    torch.float64: torch.float32,
    torch.float32: torch.bfloat16,
    torch.float16: torch.float8_e4m3fn,
    torch.bfloat16: torch.float8_e4m3fn,
}
_NAMES = {"fp64": torch.float64, "fp32": torch.float32, "fp16": torch.float16,
          "bf16": torch.bfloat16}

#: Pairs a chunk of rows holds (about 20 float64 intermediates of this size live).
CHUNK_PAIRS = 2**24


@dataclasses.dataclass(frozen=True)
class Physics:
    """The physics a configuration states (``physics`` in its file)."""

    dim: int
    h: float
    dt: float
    rho0: float
    c0: float
    eos: str  # "linear" p = c0^2 (rho - rho0) | "tait" p = B((rho/rho0)^gamma - 1)
    gamma: float
    mu: float  # dynamic viscosity of the Morris term (0: none)
    alpha: float  # Monaghan artificial viscosity (0: none)
    delta: float  # delta-SPH density diffusion (0: none)
    body_force: tuple
    wall_rho_clamp: bool

    @classmethod
    def from_config(cls, conf: dict) -> "Physics":
        p = conf["physics"]
        return cls(dim=len(conf["box"]["lo"]), h=p["h_over_ds"] * conf["ds"], dt=p["dt"],
                   rho0=p["rho0"], c0=p["c0"], eos=p["eos"], gamma=p["gamma"],
                   mu=p["mu"], alpha=p["alpha"], delta=p["delta"],
                   body_force=tuple(p["body_force"]), wall_rho_clamp=p["wall_rho_clamp"])


@dataclasses.dataclass(frozen=True)
class Geometry:
    """The box and the program's cell grid, which its output format
    (integer cell, coordinate relative to the cell centre in half cells)
    is read against."""

    lo: tuple
    hi: tuple
    periodic: tuple
    h: float
    ds: float
    cell_factor: float

    @classmethod
    def from_config(cls, conf: dict, cell_factor: float) -> "Geometry":
        b = conf["box"]
        return cls(lo=tuple(b["lo"]), hi=tuple(b["hi"]), periodic=tuple(b["periodic"]),
                   h=conf["physics"]["h_over_ds"] * conf["ds"], ds=conf["ds"],
                   cell_factor=cell_factor)

    @property
    def spans(self) -> tuple:
        return tuple(h - l for l, h in zip(self.lo, self.hi))

    def cells(self, target: float) -> tuple:
        """Cells per axis of a grid whose edge is at least ``target``:
        whole cells over a periodic span, enough cells to cover a walled
        one."""
        return tuple(max(1, int(math.floor(s / target + 1e-9))) if p
                     else max(1, int(math.ceil(s / target - 1e-9)))
                     for s, p in zip(self.spans, self.periodic))

    def edges(self, target: float) -> tuple:
        return tuple(s / n if p else target
                     for s, n, p in zip(self.spans, self.cells(target), self.periodic))

    @property
    def program_edges(self) -> tuple:
        return self.edges(self.cell_factor * 2.0 * self.h)

    def _t(self, values, like: torch.Tensor) -> torch.Tensor:
        return torch.tensor(values, dtype=torch.float64, device=like.device)

    def decode(self, cell: torch.Tensor, rel: torch.Tensor) -> torch.Tensor:
        """Physical positions (float64) of (cell, rel) in the program's grid."""
        e = self._t(self.program_edges, rel)
        return self._t(self.lo, rel) + (cell.double() + 0.5 + rel.double() * 0.5) * e

    def round_coords(self, x: torch.Tensor, dtype) -> torch.Tensor:
        """``x`` stored as (cell, rel) with rel at ``dtype``, decoded again."""
        e = self._t(self.program_edges, x)
        n = torch.tensor(self.cells(self.cell_factor * 2.0 * self.h), device=x.device)
        u = (x - self._t(self.lo, x)) / e
        cell = torch.floor(u)
        cell = torch.minimum(torch.maximum(cell, torch.zeros_like(cell)), n - 1)
        rel = (2.0 * (u - cell - 0.5)).to(dtype)
        return self.decode(cell, rel)

    def min_image(self, d: torch.Tensor) -> torch.Tensor:
        """Wrap displacements (..., dim) to the nearest periodic image."""
        span = self._t([s if p else 0.0 for s, p in zip(self.spans, self.periodic)], d)
        wrap = torch.where(span > 0, span, torch.ones_like(span))
        return torch.where(span > 0, d - wrap * torch.round(d / wrap), d)


@dataclasses.dataclass(frozen=True)
class Precision:
    """Where the step rounds: pair arithmetic and the updated state
    (``arith``), the force pass's velocity and mass records
    (``records``), its 1/rho record (``inv_rho``) and the stored
    relative coordinates (``coords``)."""

    arith: torch.dtype
    records: torch.dtype
    inv_rho: torch.dtype
    coords: torch.dtype | None  # None: positions as given, new ones exact

    @classmethod
    def stated(cls, policy: dict) -> "Precision":
        """The configuration's storage precisions, with float64 arithmetic.
        Positions come decoded from the stored coordinates already, and
        the new ones are kept exact: their rounding is the program's."""
        return cls(arith=torch.float64, records=_NAMES[policy["records"]],
                   inv_rho=_NAMES[policy["physics"]], coords=None)

    @classmethod
    def lowered(cls, policy: dict) -> "Precision":
        """Every stated precision one step lower: the control."""
        phys = _BELOW[_NAMES[policy["physics"]]]
        return cls(arith=phys, records=_BELOW[_NAMES[policy["records"]]],
                   inv_rho=phys, coords=_BELOW[_NAMES[policy["coords"]]])


def _alpha(dim: int, h: float) -> float:
    """Normalization of the cubic B-spline (Monaghan 1992) in ``dim`` dimensions."""
    return {1: 1.0 / h, 2: 15.0 / (7.0 * math.pi * h * h),
            3: 3.0 / (2.0 * math.pi * h ** 3)}[dim]


def dw_over_r(r: torch.Tensor, h: float, dim: int) -> torch.Tensor:
    """(dW/dr) / r of the cubic B-spline; 0 at r = 0 and for r >= 2h."""
    q = r / h
    near = -2.0 * q + 1.5 * q * q
    far = -0.5 * (2.0 - q) * (2.0 - q)
    d = torch.where(q < 1.0, near, torch.where(q < 2.0, far, torch.zeros_like(q)))
    safe = torch.where(r > 0, r, torch.ones_like(r))
    return torch.where(r > 0, (_alpha(dim, h) / h) * d / safe, torch.zeros_like(r))


class Grid:
    """A uniform search grid with cells at least 2h wide, and the table of
    the particles in each cell (-1 padded; one empty row past the end)."""

    def __init__(self, geom: Geometry, x: torch.Tensor):
        self.geom = geom
        radius = 2.0 * geom.h
        self.n = geom.cells(radius)
        edge = geom._t(geom.edges(radius), x)
        c = torch.floor((x - geom._t(geom.lo, x)) / edge).long()
        n = torch.tensor(self.n, device=x.device)
        per = torch.tensor(geom.periodic, device=x.device)
        c = torch.where(per, torch.remainder(c, n), c.clamp(min=0).minimum(n - 1))
        self.cell = c
        flat = self._flat(c)
        total = math.prod(self.n)
        order = torch.argsort(flat, stable=True)
        counts = torch.bincount(flat, minlength=total)
        starts = torch.cumsum(counts, 0) - counts
        cap = int(counts.max())
        sorted_flat = flat[order]
        rank = torch.arange(x.shape[0], device=x.device) - starts[sorted_flat]
        self.table = torch.full((total + 1, cap), -1, dtype=torch.long, device=x.device)
        self.table[sorted_flat, rank] = order
        self.total = total
        dim = len(geom.lo)
        offs = torch.cartesian_prod(*[torch.tensor([-1, 0, 1])] * dim)
        self.offsets = offs.reshape(-1, dim).to(x.device)
        self.width = self.offsets.shape[0] * cap

    def _flat(self, c: torch.Tensor) -> torch.Tensor:
        flat = c[..., 0]
        for a in range(1, c.shape[-1]):
            flat = flat * self.n[a] + c[..., a]
        return flat

    def candidates(self, rows: torch.Tensor) -> torch.Tensor:
        """(B, 3^d * cap) particle ids in the 3^d cells around each row's
        cell, -1 where a slot is empty or the cell lies outside a wall."""
        nc = self.cell[rows][:, None, :] + self.offsets[None]
        n = torch.tensor(self.n, device=rows.device)
        per = torch.tensor(self.geom.periodic, device=rows.device)
        wrapped = torch.where(per, torch.remainder(nc, n), nc)
        inside = ((wrapped >= 0) & (wrapped < n)).all(-1)
        flat = torch.where(inside, self._flat(wrapped.clamp(min=0).minimum(n - 1)),
                           torch.full_like(inside, self.total, dtype=torch.long))
        return self.table[flat].reshape(rows.shape[0], -1)


def _pairs(grid: Grid, x: torch.Tensor, rows: torch.Tensor):
    """(cand, inside, disp (B, M, d) float64, r2) of the rows' pairs."""
    cand = grid.candidates(rows)
    j = cand.clamp(min=0)
    disp = grid.geom.min_image(x[rows][:, None, :] - x[j])
    r2 = (disp * disp).sum(-1)
    radius = 2.0 * grid.geom.h
    inside = (cand >= 0) & (cand != rows[:, None]) & (r2 < radius * radius)
    return j, inside, disp, r2


def count_pairs(geom: Geometry, x: torch.Tensor) -> int:
    """Ordered pairs (i, j), j != i, with |x_i - x_j| < 2h."""
    grid = Grid(geom, x)
    chunk = max(1, CHUNK_PAIRS // grid.width)
    total = 0
    for s in range(0, x.shape[0], chunk):
        rows = torch.arange(s, min(s + chunk, x.shape[0]), device=x.device)
        total += int(_pairs(grid, x, rows)[1].sum())
    return total


def _eos_por2(ph: Physics, inv: torch.Tensor) -> torch.Tensor:
    """p / rho^2 from 1/rho."""
    if ph.eos == "linear":
        return ph.c0 * ph.c0 * (inv - ph.rho0 * inv * inv)
    b = ph.c0 * ph.c0 * ph.rho0 / ph.gamma
    return b * ((ph.rho0 * inv) ** (-ph.gamma) - 1.0) * inv * inv


def step(ph: Physics, geom: Geometry, prec: Precision, x: torch.Tensor, v: torch.Tensor,
         rho: torch.Tensor, m: torch.Tensor, wall: torch.Tensor):
    """One step from physical positions ``x`` (N, d) float64, ``v`` (N, d)
    and ``rho`` (N,) float32 state, ``m`` (N,) and ``wall`` (N,) bool.

    Returns (x_new, v_new, rho_new) in float64 and the number of pairs
    inside the support.
    """
    ar = prec.arith
    if prec.coords is not None:
        x = geom.round_coords(x, prec.coords)
    m_scale = torch.mean(m.double().abs()).float().double()
    v_rec = v.to(prec.records).to(ar)
    m_rec = ((m.double() / m_scale).to(prec.records).double() * m_scale).to(ar)
    inv = (1.0 / rho.float()).to(prec.inv_rho).to(ar)
    por2 = _eos_por2(ph, inv)
    h, dim = ph.h, ph.dim
    eps = 0.01 * h * h
    grid = Grid(geom, x)
    n = x.shape[0]
    drho = torch.zeros(n, dtype=ar, device=x.device)
    acc = torch.zeros((n, dim), dtype=ar, device=x.device)
    chunk = max(1, CHUNK_PAIRS // grid.width)
    pairs = 0
    for s in range(0, n, chunk):
        rows = torch.arange(s, min(s + chunk, n), device=x.device)
        j, inside, disp, r2 = _pairs(grid, x, rows)
        pairs += int(inside.sum())
        disp, r2 = disp.to(ar), r2.to(ar)
        f = torch.where(inside, dw_over_r(torch.sqrt(r2), h, dim), torch.zeros_like(r2))
        mj = m_rec[j]
        inv_i, inv_j = inv[rows][:, None], inv[j]
        dv = v_rec[rows][:, None, :] - v_rec[j]
        dvdx = (dv * disp).sum(-1)
        xgw = f * r2  # (x_i - x_j) . grad W
        cont = mj * f * dvdx
        coef = mj * (por2[rows][:, None] + por2[j])
        if ph.alpha:
            mu_ij = dvdx / (r2 + eps)
            pi = -ph.alpha * ph.c0 * h * mu_ij * (2.0 * inv_i * inv_j / (inv_i + inv_j))
            coef = coef + mj * torch.where(dvdx < 0, pi, torch.zeros_like(pi))
        a = -(coef * f)[..., None] * disp
        if ph.mu:
            a = a + (mj * (2.0 * ph.mu) * xgw * inv_i * inv_j / (r2 + eps))[..., None] * dv
        if ph.delta:
            rho_diff = (inv_i - inv_j) / (inv_i * inv_j)  # rho_j - rho_i
            cont = cont + (2.0 * ph.delta * h * ph.c0) * mj * inv_j * rho_diff * (
                -xgw) / (r2 + eps)
        drho[rows] = torch.where(inside, cont, torch.zeros_like(cont)).sum(-1)
        acc[rows] = torch.where(inside[..., None], a, torch.zeros_like(a)).sum(-2)
    rho_new = rho.to(ar) + ph.dt * drho
    if ph.wall_rho_clamp:
        rho_new = torch.where(wall, rho_new.clamp(min=ph.rho0), rho_new)
    g = torch.tensor(ph.body_force or (0.0,) * dim, dtype=ar, device=x.device)
    v_new = v.to(ar) + ph.dt * (acc + g)
    v_new = torch.where(wall[:, None], torch.zeros_like(v_new), v_new)
    x_new = x + ph.dt * v_new.double() * (~wall[:, None])
    if prec.coords is not None:
        x_new = geom.round_coords(x_new, prec.coords)
    return x_new, v_new.double(), rho_new.double(), pairs
