"""The port's benchmark: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. It drives the port (``src/repro_torch``)
on one CUDA device: set-up, a window of ``--seconds`` on the host clock,
with ``--trace 1`` a profiled window after it, then the comparison of the
sampled steps with the plain reference (``reference/``). Its last line
on standard output is one JSON object: ``correct``, ``attempted`` (steps
in the window), ``failed`` (comparisons over their limits), ``metrics``
(the cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device`` and, traced, ``breakdown``; last, ``checks``: each compared
number beside its limit, also the last lines on standard error.

It exits non-zero without printing a result where CUDA is missing or has
fewer devices than the cell asks for, where the port cannot be imported,
or where JAX or the JAX package was loaded into this process.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
#: Modules no run may hold, compared by the whole top-level name.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list:
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def card_power() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="One run of one cell of the port's benchmark.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    for p in (ROOT / "src", ROOT):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))
    import torch

    from portbench import bench, trace

    work = bench.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < work["chips"]:
        print(f"run.py: the cell needs {work['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 2
    try:
        from portbench import program  # noqa: F401  (imports the port)
    except ImportError as e:
        print(f"run.py: the port cannot be imported from {ROOT / 'src'}: {e}", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec = bench.benchmark(ROOT)
    entries = bench.metrics(spec, bool(args.trace))

    out = bench.run(args.workload, args.seed, args.seconds, bool(args.trace),
                    device="cuda", t0=T0)
    bad = forbidden_modules()
    if bad:
        print(f"run.py: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3

    ctx = out["ctx"]
    metrics = {}
    for m in entries:
        value = bench.reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    correct, failed, checks = bench.verdict(out["checks"], work["limits"])
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": work["chips"], "memory_peak_bytes": ctx.peak_bytes}
    result = {"correct": correct, "attempted": ctx.steps, "failed": failed,
              "metrics": metrics, "device": device}
    if args.trace:
        device["busy_s"] = trace.busy_s(ctx.trace)
        device["window_s"] = ctx.trace_window_s
        result["breakdown"] = {"device_ops": trace.top_ops(ctx.trace),
                               "idle_gaps": trace.idle_gaps(ctx.trace)}
    result["checks"] = checks

    c = out["counters"]
    build_s = out["build"][1]
    power = card_power()
    print(f"run.py: kernel library built in {build_s:.3f} s (0 where the checkout held it; "
          f"left out of the set-up time)", file=sys.stderr)
    print(f"run.py: {args.workload} seed {args.seed}: N {ctx.n}, set-up {ctx.setup_seconds:.3f} s "
          f"without the build, window {ctx.window_s:.3f} s over "
          f"{ctx.steps} steps ({len(ctx.step_s)} step times), rebuilds {c['rebuilds']}, "
          f"K1 {c['k1_launches']} and K2 {c['k2_launches']} launches, overflow "
          f"{c['overflow']}, {out['samples']} sampled steps; {power}", file=sys.stderr)
    print("run.py: seconds by phase: " + ", ".join(f"{k} {v:.3f}" for k, v in out["phases"].items()),
          file=sys.stderr)
    if args.trace:
        print(f"run.py: traced {ctx.trace_steps} steps ({ctx.trace_rebuilds} rebuilds) in "
              f"{ctx.trace_window_s:.3f} s, {len(ctx.trace.ops)} device operations, "
              f"{ctx.trace_pairs} pairs inside the support", file=sys.stderr)
    for name, v in checks.items():
        print(f"check {name}: {v['value']!r} (limit {v['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
