"""A benchmark cell's state after N steps on the card, to hold two trees'
steps to each other byte for byte (``portbench/``'s inputs and steps).

Run from the repo root on a machine with a CUDA card:

    PYTHONPATH=src:. python tools/pack_check.py state --workload tg-4m-rebuild \\
        --seed 3000000201 --steps 200 --out build/tg_state.npz
    PYTHONPATH=src:. python tools/pack_check.py same A.npz B.npz

``state`` runs the cell's configuration from the seed's inputs for
``--steps`` steps (``init_persistent``, then ``step_persistent``) and writes
the final state in the inputs' order (cell, rel, v, rho, m, kind) with the
steps, rebuilds and the pack's launches and fallbacks (where the package
has the pack's kernels). With another tree's ``src`` first on
``PYTHONPATH`` it runs that tree, and ``same`` holds two such files to each
other byte for byte.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from portbench import bench, program


def pack_counters() -> tuple[int, int] | None:
    """(launches, fallbacks) of the pack's wrapper; None where the package
    has no such kernels."""
    try:
        from repro_torch.kernels import cell_sort
    except ImportError:
        return None
    return cell_sort.repack.launches, cell_sort.repack.fallbacks


def run(workload: str, seed: int, steps: int):
    """The cell's configuration and carry after ``steps`` steps, and the
    rebuilds and pack counters over those steps."""
    work = bench.cell(workload)
    conf = bench.load("configs", work["config"])
    cfg = program.make_config(conf, work)
    program.build_library()
    dev = torch.device("cuda")
    carry = program.start(cfg, bench.make_inputs(conf, seed, dev), dev)
    rebuilds, before = carry.rebuilds, pack_counters()
    for _ in range(steps):
        carry = program.step(cfg, carry)
    torch.cuda.synchronize()
    after = pack_counters()
    counts = {"steps": steps, "rebuilds": carry.rebuilds - rebuilds}
    if after is not None:
        counts.update(launches=after[0] - before[0], fallbacks=after[1] - before[1])
    return cfg, carry, counts


def cmd_state(args) -> dict:
    cfg, carry, counts = run(args.workload, args.seed, args.steps)
    final = program.finish(cfg, carry)
    np.savez(args.out, **{k: v.cpu().numpy() for k, v in final.items()})
    return dict(counts, out=args.out)


def cmd_same(args) -> dict:
    a, b = np.load(args.a), np.load(args.b)
    diff = {k: int((a[k].view(np.uint8) != b[k].view(np.uint8)).sum())
            for k in sorted(set(a.files) | set(b.files))
            if k in a.files and k in b.files and a[k].shape == b[k].shape}
    same = set(a.files) == set(b.files) and len(diff) == len(a.files) and not any(diff.values())
    return {"same": same, "bytes_differing": diff}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("state")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--steps", type=int, default=60)
    p.add_argument("--out", required=True)
    p = sub.add_parser("same")
    p.add_argument("a")
    p.add_argument("b")
    args = ap.parse_args(argv)
    if args.cmd != "same" and not torch.cuda.is_available():
        print("pack_check.py: needs a CUDA card", file=sys.stderr)
        return 2
    out = {"state": cmd_state, "same": cmd_same}[args.cmd](args)
    print(json.dumps(out))
    return 0 if out.get("same", True) else 1


if __name__ == "__main__":
    sys.exit(main())
