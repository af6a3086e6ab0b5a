"""Static dummy/wall-particle boundary subsystem (port of
``repro.core.boundaries``; numpy only, so the port keeps its own copy).

The paper's framework (like its DualSPHysics lineage, arXiv:1110.3711)
treats solid boundaries as layers of *dummy particles*: wall particles
carry mass/density and contribute to every density/pressure pair sum
exactly like fluid particles — through the same record rows and cell
tables, with no pairwise special-casing — but are never advected, and
their velocity is *prescribed* (0 for no-slip walls, a constant for
moving lids) rather than integrated.

This module owns the per-particle ``kind`` classification and the wall
lattice generators the scenario cases build from:

  * ``kind`` — (N,) int8, :data:`FLUID` or :data:`WALL`. Threaded through
    the solver state (``SPHState.kind``), the packing permutations, and
    the integrator (``solver._physics_step``: walls get ``v := v_wall``
    and a zero advection step). Because wall velocities live in the SAME
    per-particle ``v`` array as fluid velocities, they flow through the
    fused force pass's half-width record rows and the Pallas v-tiles
    with zero layout changes — a moving lid is just a wall row whose
    velocity column is nonzero.
  * wall lattices — :func:`box_wall_particles` generates ``n_layers``
    dummy layers outside any chosen subset of box faces (corners
    included once), the geometry every wall-bounded case (dam break,
    cavity, Poiseuille) needs. The enclosing :class:`Domain` must extend
    over the wall band (walls are particles like any other).

The wall band width must cover the kernel support (``n_layers * ds >=
2h``, i.e. ``n_layers >= 2·1.2 = 3`` at the default ``h = 1.2 ds``) so
fluid near a wall never sees a truncated kernel through it.
"""
from __future__ import annotations

import numpy as np

FLUID = 0
WALL = 1


def wall_extent(
    lo: tuple[float, ...],
    hi: tuple[float, ...],
    ds: float,
    n_layers: int,
    sides: tuple[tuple[int, int], ...],
) -> tuple[tuple[float, ...], tuple[float, ...]]:
    """Domain bounds padded by the wall band on each walled side.

    ``sides`` is a tuple of (axis, side) pairs with side 0 = lo face,
    1 = hi face. The returned (lo, hi) is what the :class:`Domain`
    enclosing fluid + walls should use.
    """
    w = n_layers * ds
    lo2 = list(lo)
    hi2 = list(hi)
    for axis, side in sides:
        if side == 0:
            lo2[axis] -= w
        else:
            hi2[axis] += w
    return tuple(lo2), tuple(hi2)


def box_wall_particles(
    lo: tuple[float, ...],
    hi: tuple[float, ...],
    ds: float,
    n_layers: int,
    sides: tuple[tuple[int, int], ...],
    velocities: dict[tuple[int, int], tuple[float, ...]] | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Dummy-particle wall layers outside the box faces in ``sides``.

    Generates the lattice over the padded bounding box and keeps every
    node outside the open box ``(lo, hi)`` — wall bands and their corner
    overlaps appear exactly once each. Points are classified to the
    FIRST side (in ``sides`` order) whose band contains them, which
    fixes the corner ambiguity deterministically: list the moving lid
    first to have it own its corners (the standard cavity convention).

    Args:
      lo / hi: the FLUID box (walls are generated outside it).
      ds: particle spacing (lattice pitch, offset ds/2 like the fluid).
      n_layers: wall thickness in particle layers (>= ceil(2h/ds)).
      sides: (axis, side) faces to wall; side 0 = lo face, 1 = hi face.
      velocities: optional prescribed wall velocity per face (default 0).

    Returns (pos (Nw, d), v_wall (Nw, d)) as float64/float32 numpy.
    """
    dim = len(lo)
    velocities = velocities or {}
    pad_lo, pad_hi = wall_extent(lo, hi, ds, n_layers, sides)
    axes = [
        np.arange(pl + ds / 2, ph, ds)
        for pl, ph in zip(pad_lo, pad_hi)
    ]
    grid = np.meshgrid(*axes, indexing="ij")
    pts = np.stack([g.ravel() for g in grid], axis=-1).astype(np.float64)

    eps = 1e-9 * ds
    inside = np.all(
        (pts > np.asarray(lo) + eps) & (pts < np.asarray(hi) - eps), axis=-1
    )
    side_of = np.full(pts.shape[0], -1, np.int32)
    for si, (axis, side) in enumerate(sides):
        band = (
            pts[:, axis] < lo[axis] + eps
            if side == 0
            else pts[:, axis] > hi[axis] - eps
        )
        take = band & ~inside & (side_of < 0)
        side_of[take] = si
    keep = side_of >= 0
    pos = pts[keep]
    v_wall = np.zeros((pos.shape[0], dim), np.float32)
    for si, face in enumerate(sides):
        vf = velocities.get(face)
        if vf is not None:
            v_wall[side_of[keep] == si] = np.asarray(vf, np.float32)
    return pos, v_wall


def fluid_lattice(
    lo: tuple[float, ...], hi: tuple[float, ...], ds: float
) -> np.ndarray:
    """Regular fluid lattice filling the open box (nodes at ds/2 offsets)."""
    axes = [np.arange(l + ds / 2, h, ds) for l, h in zip(lo, hi)]
    grid = np.meshgrid(*axes, indexing="ij")
    return np.stack([g.ravel() for g in grid], axis=-1).astype(np.float64)
