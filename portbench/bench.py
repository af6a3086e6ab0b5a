"""One run of a cell: set-up, the measured window, the traced window and the
comparison with the plain reference, all driven by the cell's files.

A cell (``workloads/<name>.json``) names its configuration
(``configs/<name>.json``), whose ``inputs`` key names the module under
``inputs/`` that makes its initial state from the seed, and its traffic
(``traffic/<name>.json``: the Verlet skin, the cell size, the warm-up and
the sampled steps), which this file reads for every cell alike. The metrics a run
reports are the cell's entries in ``BENCHMARK.json``, each read by
``metrics/<name>.py``. Nothing here names a cell, a configuration or a
metric.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import time
from pathlib import Path

import numpy as np
import torch

from portbench import trace as trace_lib
from portbench.reference import compare, wcsph

HERE = Path(__file__).resolve().parent
SPAN_PREFIX = "portbench."
_NAME_CHARS = set("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_.-")


def load(kind: str, name: str) -> dict:
    """``<kind>/<name>.json`` under the benchmark's folder."""
    if not name or not set(name) <= _NAME_CHARS or name[0] in ".-":
        raise ValueError(f"bad {kind} name {name!r}")
    return json.loads((HERE / kind / f"{name}.json").read_text())


def cell(name: str) -> dict:
    """A cell's file with its traffic's parameters under it."""
    work = load("workloads", name)
    return {**load("traffic", work["traffic"]), **work}


def benchmark(root: Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def metrics(bench: dict, traced: bool) -> list:
    """The metric entries a run reports: the end-to-end ones untraced,
    the per-layer ones traced."""
    return bench["per_layer"] if traced else bench["end_to_end"]


def reader(name: str):
    """``metrics/<name>.py``'s ``read(ctx)``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def make_inputs(conf: dict, seed: int, device) -> dict:
    spec = importlib.util.spec_from_file_location(
        f"portbench.inputs.{conf['inputs']}", HERE / "inputs" / f"{conf['inputs']}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.make(conf, seed, device)


class Store:
    """Copies of state fields, off the device: pinned host buffers filled
    by asynchronous copies on CUDA (so taking one inside the window queues
    a copy and waits for nothing), plain clones on the CPU."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.slots: dict = {}

    def reserve(self, key, like: dict) -> None:
        self.slots[key] = {k: torch.empty(t.shape, dtype=t.dtype, pin_memory=self.cuda)
                           for k, t in like.items()}

    def take(self, key, fields: dict) -> None:
        if key not in self.slots:
            self.reserve(key, fields)
        for k, t in fields.items():
            self.slots[key][k].copy_(t, non_blocking=self.cuda)

    def get(self, key, device) -> dict:
        return {k: t.to(device) for k, t in self.slots[key].items()}


@dataclasses.dataclass
class Context:
    """What a metric reader reads."""

    conf: dict
    n: int
    steps: int = 0
    window_s: float = 0.0
    setup_seconds: float = 0.0
    peak_bytes: int = 0
    step_s: list = dataclasses.field(default_factory=list)
    trace: trace_lib.Trace | None = None
    trace_window_s: float = 0.0
    trace_steps: int = 0
    trace_rebuilds: int = 0
    trace_pairs: int = 0


def sample_times(seed: int, count: int, seconds: float) -> list:
    """When, in the window, the sampled steps are due: drawn from the seed."""
    rng = np.random.default_rng(seed)
    return sorted(float(u) * seconds for u in rng.uniform(0.05, 0.95, count))


def run(workload: str, seed: int, seconds: float, traced: bool, *, device, t0: float,
        conf: dict | None = None, control: bool = False) -> dict:
    """One run. Returns the context, the comparison's numbers (``checks``;
    with ``control``, also those of the control in the program's place)
    and the program's counters."""
    from portbench import program  # the system under test

    device = torch.device(device)
    cuda = device.type == "cuda"
    work = cell(workload)
    conf = conf or load("configs", work["config"])
    cfg = program.make_config(conf, work)
    build = program.build_library() if cuda else (None, 0.0)
    inputs = make_inputs(conf, seed, device)
    n = inputs["x"].shape[0]
    if n != conf["n_particles"]:
        raise ValueError(f"{conf['name']}: the inputs hold {n} particles, the file states "
                         f"{conf['n_particles']}")
    store = Store(device)
    store.take("inputs", inputs)
    carry = program.start(cfg, inputs, device)
    del inputs
    store.take("first", program.fields(carry, program.START_FIELDS))
    for _ in range(work["warmup_steps"]):
        carry = program.step(cfg, carry)
    if carry.rebuilds < 2:  # a skinned cell: warm the rebuild up too
        carry = program.step(cfg, program.rebuild(cfg, carry))
    due = sample_times(seed, work["samples"], seconds)
    like = program.fields(carry)
    for i in range(len(due) + 1):
        store.reserve(("before", i), like)
        store.reserve(("after", i), like)
    if traced:
        store.reserve("traced", like)
    if cuda:
        torch.cuda.synchronize()
    ctx = Context(conf=conf, n=n)
    ctx.setup_seconds = time.perf_counter() - t0 - build[1]

    taken = 0
    start = time.perf_counter()
    marks = [start]
    while True:
        elapsed = marks[-1] - start
        if elapsed >= seconds and taken == len(due):
            break
        if taken < len(due) and elapsed >= due[taken]:
            store.take(("before", taken), program.fields(carry))
            carry = program.step(cfg, carry)
            store.take(("after", taken), program.fields(carry))
            taken += 1
        else:
            carry = program.step(cfg, carry)
        marks.append(time.perf_counter())
    if cuda:
        torch.cuda.synchronize()
    ctx.window_s = time.perf_counter() - start
    ctx.steps = len(marks) - 1
    ctx.step_s = list(np.diff(marks))
    counts = program.counters(carry)
    # One more sample, past the window: a rebuild forced before a step, so
    # that every run checks its cell's rebuild (pack, permutation, tables).
    store.take(("before", taken), program.fields(carry))
    carry = program.step(cfg, program.rebuild(cfg, carry))
    store.take(("after", taken), program.fields(carry))
    taken += 1

    if traced:
        store.take("traced", program.fields(carry))
        before = program.counters(carry)
        with program.layer_spans(SPAN_PREFIX), torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]
                + ([torch.profiler.ProfilerActivity.CUDA] if cuda else [])) as prof:
            t_trace = time.perf_counter()
            for _ in range(work["trace_steps"]):
                carry = program.step(cfg, carry)
            if cuda:
                torch.cuda.synchronize()
            ctx.trace_window_s = time.perf_counter() - t_trace
        after = program.counters(carry)
        ctx.trace_steps = after["steps"] - before["steps"]
        ctx.trace_rebuilds = after["rebuilds"] - before["rebuilds"]
        ctx.trace = trace_lib.parse(trace_lib.profile_events(prof), SPAN_PREFIX)
    phases = {"set-up": ctx.setup_seconds, "window": ctx.window_s,
              "rebuilt sample and trace": time.perf_counter() - start - ctx.window_s}

    ctx.peak_bytes = int(torch.cuda.max_memory_allocated(device)) if cuda else 0
    final = program.finish(cfg, carry)
    store.take("final", {"m": final["m"], "kind": final["kind"]})
    del carry, final
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    t_judge = time.perf_counter()
    checks, control_checks = judge(conf, work, store, device, taken, control)
    if traced:
        geom = wcsph.Geometry.from_config(conf, work["cell_factor"])
        traced_state = compare.by_id(geom, store.get("traced", device))
        if compare.finite(traced_state):
            ctx.trace_pairs = wcsph.count_pairs(geom, traced_state["x"])
    phases["comparison"] = time.perf_counter() - t_judge
    return {"ctx": ctx, "checks": checks, "control": control_checks, "counters": counts,
            "samples": taken, "build": build, "phases": phases}


def judge(conf: dict, work: dict, store: Store, device, samples: int, control: bool):
    """The comparison's numbers for the program's run and, with
    ``control``, for the reference at the lowered precisions put in the
    program's place on the same states."""
    geom = wcsph.Geometry.from_config(conf, work["cell_factor"])
    ph = wcsph.Physics.from_config(conf)
    stated = wcsph.Precision.stated(conf["policy"])
    lowered = wcsph.Precision.lowered(conf["policy"])
    inputs = store.get("inputs", device)
    wall = inputs["kind"] != 0
    first = compare.by_id(geom, store.get("first", device))
    final = store.get("final", device)
    prog = compare.start_gaps(geom, first, inputs)
    prog["fields_changed"] += compare.changed(final, inputs, ("m", "kind"))
    ctl = None
    if control:
        x0 = geom.round_coords(inputs["x"].double(), lowered.coords)
        ctl = compare.start_gaps(geom, {"x": x0, "v": inputs["v"].to(lowered.arith).float(),
                                        "rho": inputs["rho"].to(lowered.arith).float(),
                                        "m": inputs["m"], "kind": inputs["kind"]}, inputs)
    for i in range(samples):
        before = compare.by_id(geom, store.get(("before", i), device))
        if not compare.finite(before):  # the program's own state: no reference step
            _fold(prog, dict.fromkeys(compare.STEP_NUMBERS, math.inf))
            if control:
                _fold(ctl, dict.fromkeys(compare.STEP_NUMBERS, math.inf))
            continue
        after = compare.by_id(geom, store.get(("after", i), device))
        args = (before["x"], before["v"], before["rho"], inputs["m"], wall)
        x_r, v_r, rho_r, _ = wcsph.step(ph, geom, stated, *args)
        ref = (x_r, v_r, rho_r)
        _fold(prog, compare.step_gaps(geom, before, after, ref))
        if control:
            x_c, v_c, rho_c, _ = wcsph.step(ph, geom, lowered, *args)
            _fold(ctl, compare.step_gaps(geom, before, {"x": x_c, "v": v_c, "rho": rho_c}, ref))
    return prog, ctl


def _fold(into: dict, new: dict) -> None:
    for k, v in new.items():
        into[k] = max(into.get(k, -math.inf), v)


def verdict(checks: dict, limits: dict) -> tuple[bool, int, dict]:
    """(correct, checks failed, {name: {value, limit}}): each number at or
    under its limit; a number with no limit fails."""
    out, failed = {}, 0
    for name, value in checks.items():
        limit = limits.get(name)
        ok = limit is not None and value <= limit
        failed += not ok
        out[name] = {"value": value, "limit": limit}
    return failed == 0, failed, out
