"""Splits the host time of llama3.2-3b's training step on a (1, 1) mesh by
call site, beside the same step without a mesh, on one GPU.

A (1, 1) mesh does the same device work as no mesh (every placement
holds the whole tensor), so what it adds is host time: DTensor's dispatch
of every op on a DTensor, its redistributions, and the sharding hints
(``models.partitioning``) that call them. This tool times, in one
process, steps of ``TrainRun(mesh_shape=(1, 1))``, the same steps with
every hint and DTensor's dispatch and redistribution wrapped by host
timers, then (the mesh run freed) ``TrainRun()`` without a mesh, and
prints for each part of the step (forward, backward, optimizer) the host
seconds until the part was enqueued and the device seconds from CUDA
events, and for the wrapped steps each call site's calls a step and host
seconds a step: ``inclusive`` counts every call, ``top`` only those not
inside another wrapped site, so the ``top`` of the hints adds up without
counting a nested call twice. DTensor's own sites (``dtensor_dispatch``,
where this torch dispatches DTensor ops in Python, and
``redistribute_local_tensor``) are timed inside the hints and outside them
alike; ``dtensor_ops`` counts the ops called on DTensors. The remat
recompute runs layer bodies in the backward, so hints are called there
too.

Run from the repo root on a machine with a CUDA card:

    PYTHONPATH=src python tools/mesh_host_cost.py [--batch 2] [--seq 1024] \\
        [--steps 4] [--wrapped 2] [--out chiprun_out/mesh_host_cost.json]

and on the CPU at SMOKE as a rehearsal (``--device cpu --smoke --batch 2
--seq 32``; its times are the CPU's and its device columns the host's).
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import gc
import json
import subprocess
import threading
import time
from pathlib import Path

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

#: the hints and helpers of ``models.partitioning`` that the models call
HINTS = ("act", "act_vocab", "act_seq", "seq_whole", "contract_whole", "column_parallel",
         "row_parallel", "on_local", "on_replicas", "constrain")


class Sites:
    """Calls and host seconds by (part, site), with the part of the step
    set by the step's marks and the nesting tracked per thread (the
    backward runs on autograd's own thread)."""

    def __init__(self):
        self.part = "forward"
        self.calls, self.incl, self.top = {}, {}, {}
        self.tls = threading.local()

    def wrap(self, name, fn):
        @functools.wraps(fn)
        def timed(*a, **kw):
            depth = getattr(self.tls, "depth", 0)
            self.tls.depth = depth + 1
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                dt = time.perf_counter() - t0
                self.tls.depth = depth
                key = (self.part, name)
                self.calls[key] = self.calls.get(key, 0) + 1
                self.incl[key] = self.incl.get(key, 0.0) + dt
                if depth == 0:
                    self.top[key] = self.top.get(key, 0.0) + dt
        return timed


@contextlib.contextmanager
def wrapped(sites: Sites):
    """Every hint of :data:`HINTS`, ``attention.sharded_attention``,
    DTensor's op dispatch and ``redistribute_local_tensor`` timed by
    ``sites`` for the block."""
    from torch.distributed.tensor import DTensor

    from repro_torch.models import attention
    from repro_torch.models import partitioning as pt

    saved = []

    def patch(owner, attr, name):
        if hasattr(owner, attr):
            orig = getattr(owner, attr)
            saved.append((owner, attr, orig))
            setattr(owner, attr, sites.wrap(name, orig))

    for h in HINTS:
        patch(pt, h, h)
    patch(attention, "sharded_attention", "sharded_attention")
    patch(type(DTensor._op_dispatcher), "dispatch", "dtensor_dispatch")
    try:
        from torch.distributed.tensor import _redistribute
        patch(_redistribute, "redistribute_local_tensor", "redistribute_local_tensor")
    except ImportError:
        pass
    try:
        with DTensorOps(sites):
            yield
    finally:
        for owner, attr, orig in reversed(saved):
            setattr(owner, attr, orig)


class DTensorOps(TorchDispatchMode):
    """A dispatch mode that counts the aten ops called on DTensors, by part
    (site ``dtensor_ops``; no time: the mode itself slows the dispatch),
    and passes each on to DTensor (``NotImplemented``)."""

    def __init__(self, sites: Sites):
        super().__init__()
        self.sites = sites

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            key = (self.sites.part, "dtensor_ops")
            self.sites.calls[key] = self.sites.calls.get(key, 0) + 1
            self.sites.incl.setdefault(key, 0.0)
            return NotImplemented
        return func(*args, **(kwargs or {}))


def run_steps(mesh_shape: tuple, args, wrap_after: int = 0) -> dict:
    """``args.steps`` steps of a ``TrainRun`` (plus ``wrap_after`` more with
    the sites wrapped): per step the host seconds of each part (until it
    was enqueued) and the device seconds (CUDA events), the step's wall
    seconds, and the wrapped steps' sites."""
    from repro_torch.data.pipeline import make_batch
    from repro_torch.launch import train as ttrain

    run = ttrain.TrainRun(arch="llama3.2-3b", smoke=args.smoke, batch=args.batch, seq=args.seq,
                          steps=args.steps + wrap_after, device=args.device,
                          mesh_shape=mesh_shape)
    cuda = torch.device(args.device).type == "cuda"
    sites = Sites()
    host = []
    orig_step = ttrain.train_step

    def host_marked(*a, mark, **kw):
        def both(part):
            host.append((part, time.perf_counter()))
            if part != "start":
                sites.part = {"forward": "backward", "backward": "optimizer"}.get(part, "forward")
            mark(part)
        return orig_step(*a, mark=both, **kw)

    out = {"steps": []}
    params = opt_state = None
    try:
        _, _, dev, params, opt_state, dcfg, step = run.build()
        ttrain.train_step = host_marked
        for i in range(args.steps + wrap_after):
            host.clear()
            sites.part = "forward"
            ctx = wrapped(sites) if i >= args.steps else contextlib.nullcontext()
            t0 = time.perf_counter()
            with ctx:
                params, opt_state, m = step(params, opt_state, make_batch(dcfg, i, dev))
                float(ttrain.global_value(m["loss"]))
            wall = time.perf_counter() - t0
            h = dict(host)
            out["steps"].append({
                "wrapped": i >= args.steps, "wall_s": wall,
                "host_s": {"forward": h["forward"] - h["start"],
                           "backward": h["backward"] - h["forward"],
                           "optimizer": h["optimizer"] - h["backward"]},
                "device_s": ttrain.step_parts(m["marks"])})
        out["peak"] = torch.cuda.max_memory_allocated() if cuda else None
    finally:
        ttrain.train_step = orig_step
        run.close()
        del params, opt_state
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
    n = max(wrap_after, 1)
    out["sites"] = [{"part": p, "site": s, "calls": sites.calls[(p, s)] / n,
                     "inclusive_s": sites.incl[(p, s)] / n,
                     "top_s": sites.top.get((p, s), 0.0) / n}
                    for (p, s) in sorted(sites.calls)]
    return out


def medians(r: dict, wrapped_steps: bool) -> dict:
    rows = [s for s in r["steps"] if s["wrapped"] == wrapped_steps][1 if not wrapped_steps else 0:]
    med = {"wall_ms": 1e3 * float(np.median([s["wall_s"] for s in rows]))}
    for k in ("forward", "backward", "optimizer"):
        med[f"host_{k}_ms"] = 1e3 * float(np.median([s["host_s"][k] for s in rows]))
        med[f"device_{k}_ms"] = 1e3 * float(np.median([s["device_s"][k] for s in rows]))
    return med


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=4, help="timed steps a run (the first warms up)")
    ap.add_argument("--wrapped", type=int, default=2, help="steps with the sites wrapped")
    ap.add_argument("--device", default="cuda", help="cpu with --smoke: a rehearsal")
    ap.add_argument("--smoke", action="store_true", help="the SMOKE config")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    gpu = (subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
           if args.device == "cuda" else args.device)
    mesh = run_steps((1, 1), args, wrap_after=args.wrapped)
    plain = run_steps((), args)
    res = {"gpu": gpu, "batch": args.batch, "seq": args.seq,
           "mesh": medians(mesh, False), "mesh_wrapped": medians(mesh, True),
           "plain": medians(plain, False), "sites": mesh["sites"],
           "peak": {"mesh": mesh["peak"], "plain": plain["peak"]}, "raw": {"mesh": mesh["steps"],
                                                                     "plain": plain["steps"]}}
    print(f"# {gpu}; llama3.2-3b{' SMOKE' if args.smoke else ''} B {args.batch} x {args.seq}, "
          "medians of the unwrapped steps from the second, of every wrapped step")
    for k in ("plain", "mesh", "mesh_wrapped"):
        print(k, json.dumps({a: round(b, 3) for a, b in res[k].items()}))
    print("part       site                        calls/step  inclusive ms  top ms")
    for s in res["sites"]:
        print(f"{s['part']:10s} {s['site']:27s} {s['calls']:10.0f} {1e3 * s['inclusive_s']:13.3f} "
              f"{1e3 * s['top_s']:7.3f}")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(res, indent=1))
    return res


if __name__ == "__main__":
    main()
