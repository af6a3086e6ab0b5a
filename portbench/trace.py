"""Reading a ``torch.profiler`` window: the device's operations, the host
span each was launched from, the device's busy time and its idle gaps by
what the host was doing.

The profile is read from its Chrome trace: device operations (kernels,
copies, fills) carry a correlation id that ties each to the host's
launch call, and a launch belongs to the harness span (a
``record_function`` named with the span prefix) whose host interval
holds it.
"""
from __future__ import annotations

import bisect
import dataclasses
import json
import os
import tempfile

import numpy as np

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver", "python_function")
#: Idle gaps shorter than this are the launch cadence, not a wait.
GAP_MIN_US = 10.0


@dataclasses.dataclass
class Op:
    name: str
    start_us: float
    dur_us: float
    span: str | None  # the harness span the host launched it from


@dataclasses.dataclass
class Trace:
    ops: list  # Op, in start order
    spans: dict  # span name -> how many times the host entered it
    host: list  # (name, cat, start_us, end_us) of host events


def profile_events(prof) -> list:
    """The Chrome trace events of a finished profiler (written to a
    temporary file under TMPDIR and removed)."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.remove(path)


def parse(events: list, span_prefix: str) -> Trace:
    launches, spans, host, dev = {}, [], [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            dev.append(e)
            continue
        if cat in LAUNCH_CATS and "correlation" in e.get("args", {}):
            launches[e["args"]["correlation"]] = ts
        if cat == "user_annotation" and e["name"].startswith(span_prefix):
            spans.append((ts, ts + dur, e["name"][len(span_prefix):]))
        if cat in HOST_CATS:
            host.append((e["name"], cat, ts, ts + dur))
    spans.sort()
    starts = [s[0] for s in spans]
    ops = []
    for e in dev:
        t = launches.get(e.get("args", {}).get("correlation"))
        span = None
        if t is not None:
            i = bisect.bisect_right(starts, t) - 1
            # Spans do not nest, so the latest one that began is the only candidate.
            if i >= 0 and spans[i][1] >= t:
                span = spans[i][2]
        ops.append(Op(e["name"], float(e["ts"]), float(e.get("dur", 0.0)), span))
    ops.sort(key=lambda o: o.start_us)
    counts: dict = {}
    for _, _, name in spans:
        counts[name] = counts.get(name, 0) + 1
    return Trace(ops=ops, spans=counts, host=host)


def _merged(ops: list) -> list:
    """The union of the operations' intervals, as sorted (start, end)."""
    out = []
    for o in ops:
        s, e = o.start_us, o.start_us + o.dur_us
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy_s(tr: Trace) -> float:
    """Seconds in which some operation ran on the device."""
    return sum(e - s for s, e in _merged(tr.ops)) * 1e-6


def device_seconds(tr: Trace, span: str | None = None, names=None) -> float:
    """Device seconds of the operations launched from ``span`` (any span
    where None) whose names contain one of ``names`` (any where None)."""
    return 1e-6 * sum(o.dur_us for o in tr.ops
                      if (span is None or o.span == span)
                      and (names is None or any(n in o.name for n in names)))


def short_name(name: str, width: int = 120) -> str:
    """A kernel's name without ``void``, anonymous namespaces and its
    argument list, cut to ``width``."""
    base = name.replace("(anonymous namespace)::", "").removeprefix("void ")
    depth = 0
    for i, c in enumerate(base):
        depth += (c == "<") - (c == ">")
        # An argument list opens right after the name; "Memcpy DtoH (...)" keeps its words.
        if c == "(" and depth == 0 and i > 0 and (base[i - 1].isalnum() or base[i - 1] in "_>"):
            base = base[:i]
            break
    return base.strip()[:width]


def top_ops(tr: Trace, n: int = 10) -> list:
    """[name, seconds] of the ``n`` operations that took most device time,
    by their short names."""
    by: dict = {}
    for o in tr.ops:
        key = short_name(o.name)
        by[key] = by.get(key, 0.0) + o.dur_us * 1e-6
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def idle_gaps(tr: Trace, n: int = 10, longest: int = 200) -> list:
    """[what the host was doing, seconds] over the ``longest`` idle gaps
    of the device (each ``GAP_MIN_US`` or more), summed by label, the
    ``n`` largest: a gap is named by the host call in progress at its
    middle (a launch or a wait on the device first, else the innermost
    host op or span), or "host" where none is."""
    merged = _merged(tr.ops)
    gaps = [(e0, s1) for (_, e0), (s1, _) in zip(merged, merged[1:]) if s1 - e0 >= GAP_MIN_US]
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:longest]
    if not gaps:
        return []
    name = [h[0] for h in tr.host]
    runtime = np.array([h[1] in LAUNCH_CATS for h in tr.host])
    start = np.array([h[2] for h in tr.host])
    end = np.array([h[3] for h in tr.host])
    by: dict = {}
    for g0, g1 in gaps:
        mid = 0.5 * (g0 + g1)
        cover = (start <= mid) & (end >= mid)
        label = "host"
        if (cover & runtime).any():
            label = name[np.flatnonzero(cover & runtime)[0]]
        elif cover.any():
            idx = np.flatnonzero(cover)
            label = name[idx[np.argmin(end[idx] - start[idx])]]
        by[label] = by.get(label, 0.0) + (g1 - g0) * 1e-6
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]
