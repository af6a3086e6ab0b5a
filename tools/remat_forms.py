"""Times llama3.2-3b's training step on one GPU under four forms of
``remat`` (each layer body run plainly, or under ``torch.utils.checkpoint``
in three forms) and prints, for each, the step's parts from CUDA events,
the host's time in the forward and backward calls and in Python's
garbage collector, the busy share of a profiled step and the peak
memory.

The forms are swapped in for ``repro_torch.models.transformer.run_body``
for the length of a block of steps, in the order A B C D D C B A:

- ``none``: the body as it is (every activation kept);
- ``nonreentrant``: non-reentrant checkpoint (the graph recorded in the
  forward, each saved tensor handed to a Python hook and dropped, the
  body rerun in the backward when a saved tensor is first asked for);
- ``nonreentrant_nocheck``: the same without its check that the
  recompute saves tensors of the same shapes and dtypes;
- ``reentrant``: reentrant checkpoint (the forward under ``no_grad``,
  the backward reruns the body and backpropagates through it).

Run from the repo root on a machine with a CUDA card:

    PYTHONPATH=src python tools/remat_forms.py [--batch 2] [--seq 1024] \\
        [--steps 3] [--out chiprun_out/remat_forms.json]
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import subprocess
import time

import torch
import torch.utils.checkpoint as cp
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.data.pipeline import make_batch
from repro_torch.launch.train import TrainRun, step_parts, train_step, _stamp
from repro_torch.models import transformer
from repro_torch.optim import adamw

FORMS = {
    "none": lambda remat, body, *a, **_: body(*a),
    "nonreentrant": lambda remat, body, *a, **_: cp.checkpoint(
        body, *a, use_reentrant=False, preserve_rng_state=False),
    "nonreentrant_nocheck": lambda remat, body, *a, **_: cp.checkpoint(
        body, *a, use_reentrant=False, preserve_rng_state=False, determinism_check="none"),
    "reentrant": lambda remat, body, *a, **_: cp.checkpoint(
        body, *a, use_reentrant=True, preserve_rng_state=False),
}


def saved_tensors(mod, params, batch, cfg) -> int:
    """Tensors autograd saves in one forward without remat: the number of
    calls non-reentrant checkpoint makes to its Python pack hook."""
    n = [0]

    def pack(_x):
        n[0] += 1  # keeps nothing: a tensor kept here would hold its own graph in a cycle

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda _: None):
        mod.loss_fn(params, batch, dataclasses.replace(cfg, remat="none"))
    return n[0]


def one_step(mod, cfg, ocfg, params, opt, batch) -> tuple:
    """One training step: its parts (CUDA events), the host's seconds
    from the step's start to the end of the forward call and of the
    backward call (no synchronization inside the step), and the seconds
    Python's cyclic garbage collector ran in the step."""
    marks, host, gc_s, gc_t0 = [], {}, [0.0], [0.0]
    t0 = time.perf_counter()

    def mark(part):
        marks.append((part, _stamp(torch.device("cuda"))))
        host[part] = time.perf_counter() - t0

    def on_gc(phase, _info):
        if phase == "start":
            gc_t0[0] = time.perf_counter()
        else:
            gc_s[0] += time.perf_counter() - gc_t0[0]

    gc.callbacks.append(on_gc)
    try:
        params, opt, m = train_step(mod, cfg, ocfg, params, opt, batch, mark=mark)
        float(m["loss"])
    finally:
        gc.callbacks.remove(on_gc)
    return params, opt, step_parts(marks), {
        "forward": host["forward"], "backward": host["backward"] - host["forward"],
        "gc": gc_s[0]}


def busy_share(mod, cfg, ocfg, params, opt, batch) -> tuple:
    """(wall ms, device ms, busy share) of one profiled step."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, opt, _, _ = one_step(mod, cfg, ocfg, params, opt, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev_us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA)
    return 1e3 * wall, dev_us / 1e3, dev_us / 1e6 / wall


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=3, help="timed steps a block, after one warm-up")
    ap.add_argument("--out", default=None, help="write the readings here as JSON")
    args = ap.parse_args()
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True, capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    run = TrainRun(arch=args.arch, smoke=False, device="cuda", batch=args.batch, seq=args.seq,
                   steps=1, seed=0)
    cfg, mod, dev, params, opt, dcfg, _ = run.build()
    cfg = dataclasses.replace(cfg, remat="full")
    ocfg = adamw.OptConfig(lr=1e-3, warmup_steps=20, total_steps=1000)
    batch = run._with_stubs(make_batch(dcfg, 0, dev), cfg)
    n_saved = saved_tensors(mod, params, batch, cfg)
    print(f"# {args.arch} B {args.batch} x {args.seq}, {cfg.n_layers} layers; "
          f"{n_saved} saved tensors a forward without remat ({gpu})", flush=True)
    orig = transformer.run_body
    readings = {k: {"parts": [], "host": [], "peak": 0} for k in FORMS}
    order = list(FORMS) + list(FORMS)[::-1]
    try:
        for form in order:
            transformer.run_body = FORMS[form]
            torch.cuda.reset_peak_memory_stats()
            params, opt, _, _ = one_step(mod, cfg, ocfg, params, opt, batch)  # warm-up
            for _ in range(args.steps):
                params, opt, parts, host = one_step(mod, cfg, ocfg, params, opt, batch)
                readings[form]["parts"].append(parts)
                readings[form]["host"].append(host)
            readings[form]["peak"] = max(readings[form]["peak"],
                                         torch.cuda.max_memory_allocated())
        for form in FORMS:
            transformer.run_body = FORMS[form]
            readings[form]["profiled"] = busy_share(mod, cfg, ocfg, params, opt, batch)
    finally:
        transformer.run_body = orig
    out = {"gpu": gpu, "arch": args.arch, "batch": args.batch, "seq": args.seq,
           "saved_tensors": n_saved, "forms": {}}
    for form, r in readings.items():
        def span(xs):
            return [round(1e3 * min(xs), 3), round(1e3 * sorted(xs)[len(xs) // 2], 3),
                    round(1e3 * max(xs), 3)]
        rec = {part: span([p[part] for p in r["parts"]])
               for part in ("forward", "backward", "optimizer")}
        rec["step"] = span([sum(p.values()) for p in r["parts"]])
        rec["host_forward"] = span([h["forward"] for h in r["host"]])
        rec["host_backward"] = span([h["backward"] for h in r["host"]])
        rec["gc"] = span([h["gc"] for h in r["host"]])
        wall, dev_ms, busy = r["profiled"]
        rec.update(profiled_wall_ms=round(wall, 3), profiled_device_ms=round(dev_ms, 3),
                   busy_share=round(busy, 3), peak_bytes=r["peak"])
        out["forms"][form] = rec
        print(f"{form:21s} step {rec['step']} ms (min, median, max of {len(r['parts'])}); "
              f"forward {rec['forward']}, backward {rec['backward']}, optimizer "
              f"{rec['optimizer']}; host in the forward call {rec['host_forward']}, in the "
              f"backward call {rec['host_backward']}; garbage collector {rec['gc']}; profiled step {wall:.3f} ms of wall, "
              f"{dev_ms:.3f} of device time, busy {busy:.3f}; peak {r['peak']} bytes ({gpu})",
              flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
