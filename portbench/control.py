"""Readings that a cell's limits are set from: the comparison's numbers of
the program over many seeds, and of the control (the reference with every
stated precision one step lower, put in the program's place on the same
states), in one process.

    python3 portbench/control.py --workload <cell> --seeds 11,12,13 --seconds 10

Each seed is a whole run of the cell (set-up, window, sampled steps) at
its own size; one JSON line a seed, then the largest reading of the
program and the smallest of the control for each number. With
``--fault <name>``, the program runs with that fault of
``tests/faults.py`` planted in its timed path. The benchmark's own runs
do not run the control. Needs a CUDA device.
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
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--fault", default=None, help="a fault of tests/faults.py to plant")
    args = ap.parse_args(argv)
    for p in (ROOT / "src", ROOT):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))
    import pytest
    import torch

    from portbench import bench
    from portbench.tests import faults

    if not torch.cuda.is_available():
        print("control.py: needs a CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        if args.fault:
            faults.ALL[args.fault](mp)
        return _readings(args, bench, torch)


def _readings(args, bench, torch) -> int:
    limits = bench.cell(args.workload)["limits"]
    worst: dict = {}
    least: dict = {}
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        out = bench.run(args.workload, seed, args.seconds, False, device="cuda", t0=t0,
                        control=not args.fault)
        prog, ctl = out["checks"], out["control"] or {}
        for k, v in prog.items():
            worst[k] = max(worst.get(k, v), v)
        for k, v in ctl.items():
            least[k] = min(least.get(k, v), v)
        print(json.dumps({"seed": seed, "steps": out["ctx"].steps, "program": prog,
                          "control": ctl,
                          "program_correct": bench.verdict(prog, limits)[0],
                          "control_correct": ctl and bench.verdict(ctl, limits)[0],
                          "seconds": time.perf_counter() - t0}), flush=True)
        del out
        torch.cuda.empty_cache()
    print(json.dumps({"workload": args.workload, "fault": args.fault,
                      "program_max": worst, "control_min": least,
                      "device": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
