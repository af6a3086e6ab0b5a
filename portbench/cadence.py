"""Rebuild cadence and pairs a particle of a cell's configuration at a given
spacing, run from its start over a span of physical time: what a
cell's traffic is held against (a skin's rebuilds a step do not depend on
the spacing, since the skin and the time step both scale with it).

    python3 portbench/cadence.py --workload dam-4m-skin --ds 0.005 --until 3 --blocks 12 --v0 0

One JSON line a block of physical time: its steps and rebuilds, rebuilds
a 100 steps, the largest speed, and the ordered pairs inside the support
a particle at the block's end (the reference's own search). ``--v0``
sets the case's start speed (0: the quiescent start), ``--skin-radii`` the
skin (0: a rebuild every step) and ``--cell-factor`` the cells' edge.
Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--ds", type=float, required=True)
    ap.add_argument("--until", type=float, required=True, help="physical time to run to")
    ap.add_argument("--blocks", type=int, default=10)
    ap.add_argument("--v0", type=float, default=None)
    ap.add_argument("--skin-radii", type=float, default=None,
                    help="the Verlet skin in search radii, over the cell's traffic")
    ap.add_argument("--cell-factor", type=float, default=None,
                    help="the cell edge in search radii, over the cell's traffic")
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    for p in (ROOT / "src", ROOT):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))
    import torch

    from portbench import bench, program
    from portbench.reference import compare, wcsph
    from portbench.tests import tiny

    if not torch.cuda.is_available():
        print("cadence.py: needs a CUDA device", file=sys.stderr)
        return 2
    work = bench.cell(args.workload)
    for key in ("skin_radii", "cell_factor"):
        if getattr(args, key) is not None:
            work[key] = getattr(args, key)
    extra = {} if args.v0 is None else {"v0": args.v0}
    conf = tiny.config(work["config"], ds=args.ds, **extra)
    cfg = program.make_config(conf, work)
    geom = wcsph.Geometry.from_config(conf, work["cell_factor"])
    carry = program.start(cfg, bench.make_inputs(conf, args.seed, "cuda"), "cuda")
    n, dt, done = conf["n_particles"], conf["physics"]["dt"], 0
    print(json.dumps({"workload": args.workload, "ds": args.ds, "n": n, "dt": dt,
                      "case_args": conf["case_args"]}), flush=True)
    for b in range(1, args.blocks + 1):
        t0, r0 = time.perf_counter(), carry.rebuilds
        steps = round(args.until * b / args.blocks / dt) - done
        for _ in range(steps):
            carry = program.step(cfg, carry)
        done += steps
        state = compare.by_id(geom, program.fields(carry))
        pairs = wcsph.count_pairs(geom, state["x"]) if compare.finite(state) else 0
        rebuilds = carry.rebuilds - r0
        print(json.dumps({"t": done * dt, "steps": steps, "rebuilds": rebuilds,
                          "per_100_steps": 100.0 * rebuilds / max(steps, 1),
                          "v_max": float(state["v"].float().norm(dim=1).max()),
                          "pairs_a_particle": pairs / n, "overflow": bool(carry.overflow),
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
