"""The program's own spans in a parsed trace: device time and idle time
under each, and the host's syncs inside them.

The port names the stretches of its step with ``record_function`` ranges
(``sph.decide``, ``sph.rebuild`` with ``.pack`` and ``.permute`` inside,
``sph.force`` with the kernel layer's ``rcll.unpack`` inside). They nest,
and ``trace.parse`` keeps them among the host events. A device operation
belongs to the program spans whose host intervals hold its launch; a
span's device time includes that of the spans inside it.

``trace.Trace`` keeps each operation's harness span but not its launch,
so the launches are matched here: on one stream the device runs the
kernels, copies and fills in the order the host launched each kind, so
the k-th kernel is the k-th kernel launch. The match is accepted only
where every kind has as many launches as operations and every matched
launch lies in the harness span the trace's correlation ids gave its
operation; otherwise the readers find nothing. So they read nothing once
the step runs as a CUDA graph (a ``cudaGraphLaunch`` is no kernel launch)
or on a second stream; and a misorder within one harness span (the pack's
and the permutation's operations swapped) would pass unseen.
"""
from __future__ import annotations

import bisect

from portbench import bench, trace

#: Names of the program's spans: the solver's and the kernel layer's.
PREFIX = ("sph.", "rcll.")
#: Host calls that block until the device's queue drains.
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")


def op_kind(name: str) -> str:
    """A device operation's kind by its name: copy, fill or kernel."""
    if name.startswith("Memcpy"):
        return "memcpy"
    if name.startswith("Memset"):
        return "memset"
    return "kernel"


def launch_kind(name: str) -> str | None:
    """The kind of device operation a CUDA API call launches, or None
    where it launches none."""
    if "LaunchKernel" in name or "LaunchCooperativeKernel" in name:
        return "kernel"
    if "Memcpy" in name:
        return "memcpy"
    if "Memset" in name:
        return "memset"
    return None


def intervals(tr, prefix=PREFIX) -> list:
    """(start, end, name) of the host's ``record_function`` spans named
    with ``prefix`` (a string or a tuple of them), sorted by start, an outer span before the inner one
    that begins at the same time."""
    return sorted(((s, e, name) for name, cat, s, e in tr.host
                   if cat == "user_annotation" and name.startswith(prefix)),
                  key=lambda x: (x[0], -x[1]))


def count(tr, name: str) -> int:
    """How many times the host entered the span ``name``."""
    return sum(1 for _, _, n in intervals(tr) if n == name)


def owners(spans: list, times: list) -> list:
    """For each of the sorted ``times``, the names of the nested ``spans``
    (sorted by start) that hold it, outermost first: a tuple, empty where
    none does."""
    out, stack, i = [], [], 0
    for t in times:
        while i < len(spans) and spans[i][0] <= t:
            while stack and stack[-1][1] < spans[i][0]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out.append(tuple(s[2] for s in stack))
    return out


def launch_times(tr) -> list | None:
    """The host time of each of ``tr.ops``' launches, in ``tr.ops``'
    order; None where the launches do not match the operations."""
    launches: dict = {}
    for name, cat, s, _ in tr.host:
        kind = launch_kind(name) if cat in trace.LAUNCH_CATS else None
        if kind:
            launches.setdefault(kind, []).append(s)
    by_kind: dict = {}
    for i, o in enumerate(tr.ops):
        by_kind.setdefault(op_kind(o.name), []).append(i)
    times = [0.0] * len(tr.ops)
    for kind, idx in by_kind.items():
        ts = sorted(launches.get(kind, []))
        if len(ts) != len(idx):
            return None
        for i, t in zip(idx, ts):
            times[i] = t
    cut = len(bench.SPAN_PREFIX)
    harness = [(s, e, n[cut:]) for s, e, n in intervals(tr, bench.SPAN_PREFIX)]
    order = sorted(range(len(times)), key=times.__getitem__)
    found = owners(harness, [times[i] for i in order])
    if any(tr.ops[i].span != (f[-1] if f else None) for i, f in zip(order, found)):
        return None
    return times


def attribute(tr) -> list | None:
    """The program spans that hold each of ``tr.ops``' launch, outermost
    first (``owners``); None where the trace holds no program span or the
    launches do not match."""
    spans = intervals(tr)
    times = launch_times(tr) if spans else None
    if times is None:
        return None
    order = sorted(range(len(times)), key=times.__getitem__)
    out = [()] * len(times)
    for i, names in zip(order, owners(spans, [times[i] for i in order])):
        out[i] = names
    return out


def device_seconds(tr, name: str) -> float | None:
    """Device seconds of the operations under the span ``name``, those of
    the spans inside it included; None where nothing can be attributed."""
    own = attribute(tr)
    if own is None:
        return None
    return 1e-6 * sum(o.dur_us for o, names in zip(tr.ops, own) if name in names)


def idle_seconds(tr, name: str) -> float:
    """Seconds inside the host intervals of the span ``name`` in which no
    operation ran on the device."""
    busy = trace._merged(tr.ops)
    starts = [s for s, _ in busy]
    idle = 0.0
    for s, e, n in intervals(tr):
        if n != name:
            continue
        covered = 0.0
        for b0, b1 in busy[max(bisect.bisect_right(starts, s) - 1, 0):]:
            if b0 >= e:
                break
            covered += max(0.0, min(b1, e) - max(b0, s))
        idle += (e - s) - covered
    return 1e-6 * idle


def syncs(tr) -> int:
    """Host calls that wait on the device (``SYNC_CALLS``) begun inside a
    program span."""
    spans = intervals(tr)
    times = sorted(s for name, cat, s, _ in tr.host
                   if cat in trace.LAUNCH_CATS and name in SYNC_CALLS)
    return sum(bool(names) for names in owners(spans, times))


def device_ms_per(tr, name: str, per: str) -> float | None:
    """ms of device time under the span ``name`` per entry of the span
    ``per``; None where the trace holds no device operation or no ``per``,
    or the launches do not match."""
    n = count(tr, per) if tr and tr.ops else 0
    sec = device_seconds(tr, name) if n else None
    return None if sec is None else 1e3 * sec / n


def idle_ms_per(tr, name: str) -> float | None:
    """ms of device idle time inside the span ``name`` per entry of it;
    None where the trace holds no device operation or no ``name``."""
    n = count(tr, name) if tr and tr.ops else 0
    return 1e3 * idle_seconds(tr, name) / n if n else None
