"""The SPH step's spans (``core/tracing.py``) on the kernel backend: under
a profiler, nested and counted per step and per rebuild; no
``record_function`` without one; a wrapper of the rebuild (as a benchmark
puts around it) outside its span; and, on the card, as many host syncs
inside the spans of a step's trace as ``torch.cuda.set_sync_debug_mode``
warns of."""
from __future__ import annotations

import collections
import warnings

import pytest
import torch
from test_torch_helpers import one_torch_thread  # noqa: F401  (autouse fixture)

from repro_torch.core import cases, solver
from repro_torch.kernels import ops

#: Parent of each span; None for the step's top level.
NESTING = {"sph.decide": None, "sph.rebuild": None, "sph.rebuild.pack": "sph.rebuild",
           "sph.rebuild.permute": "sph.rebuild", "sph.force": None,
           "rcll.unpack": "sph.force"}
#: Host syncs of a step on the kernel backend, apart from its rebuild: the
#: decision, the unpack's four boolean-mask gathers and eight constants
#: uploaded from pageable memory ...
STEP_SYNCS = 13
#: ... and of a rebuild by the counting sort: the pack's one host read, its
#: kernels' flag of a particle that moved past its neighbor cells.
REBUILD_SYNCS = 1
#: Host calls that wait for the device's queue to drain.
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")


def _taylor_green(device="cpu"):
    """Skin 0: every step after the first pack rebuilds."""
    cfg, st = cases.build_case("taylor_green", ds=1 / 16).build(device=device)
    return cfg, solver.init_persistent(cfg, st)


def _dam(device="cpu"):
    """A skin of 0.05 search radii: the first rebuild comes at step 8."""
    kw = dict(ds=0.1, cell_factor=1.5, v0=1.0, skin=0.05 * 2.0 * 1.2 * 0.1)
    cfg, st = cases.build_case("dam_break", **kw).build(device=device)
    return cfg, solver.init_persistent(cfg, st)


def _neighbor_table(cfg, carry):
    """The force pass's neighbor-cell table on the carry's device,
    uploaded on its first use for a domain and device (cached after)."""
    return ops.nb_with_sentinel(cfg.domain, carry.st.rc.rel.device)


@pytest.fixture(scope="module")
def profiled():
    """Both cases stepped under one CPU profiler: (span events, steps,
    rebuilds) of each."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # as one_torch_thread, which a module fixture precedes
    try:
        return _profile_both()
    finally:
        torch.set_num_threads(threads)


def _profile_both():
    tg, dam = _taylor_green(), _dam()
    cfg, carry = dam
    for _ in range(6):  # up to two steps before the dam's first rebuild
        carry = solver.step_persistent(cfg, carry)
    runs = [(tg, 3), ((cfg, carry), 4)]
    done = []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for (cfg, carry), steps in runs:
            r0 = carry.rebuilds
            for _ in range(steps):
                carry = solver.step_persistent(cfg, carry)
            done.append((steps, carry.rebuilds - r0))
    events = [e for e in prof.events() if e.name in NESTING]
    return events, done


def test_spans_nest_as_the_step_does(profiled):
    events, _ = profiled
    for e in events:
        parent = e.cpu_parent
        while parent is not None and parent.name not in NESTING:
            parent = parent.cpu_parent
        assert (parent.name if parent else None) == NESTING[e.name], e.name


def test_spans_come_once_a_step_and_once_a_rebuild(profiled):
    events, done = profiled
    (tg_steps, tg_rebuilds), (dam_steps, dam_rebuilds) = done
    assert tg_rebuilds == tg_steps - 1  # skin 0: all but the step after the first pack
    assert 0 < dam_rebuilds < dam_steps  # the skin's own cadence
    seen = collections.Counter(e.name for e in events)
    steps, rebuilds = tg_steps + dam_steps, tg_rebuilds + dam_rebuilds
    assert seen == {"sph.decide": steps, "sph.force": steps, "rcll.unpack": steps,
                    "sph.rebuild": rebuilds, "sph.rebuild.pack": rebuilds,
                    "sph.rebuild.permute": rebuilds}


def test_no_record_function_without_a_profiler(monkeypatch):
    entered = []
    real = torch.profiler.record_function

    class Counting(real):
        def __enter__(self):
            entered.append(self.name)
            return super().__enter__()

    monkeypatch.setattr(torch.profiler, "record_function", Counting)
    cfg, carry = _taylor_green()
    for _ in range(2):
        carry = solver.step_persistent(cfg, carry)
    assert entered == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        carry = solver.step_persistent(cfg, carry)
    assert entered == ["sph.decide", "sph.rebuild", "sph.rebuild.pack",
                       "sph.rebuild.permute", "sph.force", "rcll.unpack"]


def test_a_wrapper_of_the_rebuild_holds_its_span(monkeypatch):
    """The spans belong to the functions step_persistent calls by name, so
    a span that a wrapper put in their place opens (as a benchmark's
    does) holds the program's, which stays the innermost around the
    work."""
    for name in ("_rebuild", "_physics_step"):
        def wrapper(*args, _inner=getattr(solver, name), _name=name, **kw):
            with torch.profiler.record_function("outer." + _name):
                return _inner(*args, **kw)

        monkeypatch.setattr(solver, name, wrapper)
    cfg, carry = _taylor_green()
    carry = solver.step_persistent(cfg, carry)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        solver.step_persistent(cfg, carry)
    parents = {e.name: e.cpu_parent.name if e.cpu_parent else None
               for e in prof.events() if e.name in NESTING}
    assert parents == {"sph.decide": None, "sph.rebuild": "outer._rebuild",
                       "sph.rebuild.pack": "sph.rebuild", "sph.rebuild.permute": "sph.rebuild",
                       "sph.force": "outer._physics_step", "rcll.unpack": "sph.force"}


def _traced_step(cfg, carry):
    """One step under a CPU + CUDA profiler and the sync-debug mode:
    (the carry, the synchronizing operations it warned of, the trace's
    host calls in ``SYNC_CALLS`` begun inside one of the program's spans,
    as ``portbench/spans.py`` counts them)."""
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                carry = solver.step_persistent(cfg, carry)
            finally:
                torch.cuda.set_sync_debug_mode(0)
    # Setting the mode also warns, once a process, that it is set: not a sync.
    warned = sum("called a synchronizing CUDA operation" in str(w.message) for w in caught)
    host = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CPU]
    spans = [(e.time_range.start, e.time_range.end) for e in host if e.name in NESTING]
    traced = sum(any(s <= e.time_range.start <= t for s, t in spans)
                 for e in host if e.name in SYNC_CALLS)
    return carry, warned, traced


@pytest.mark.cuda
@pytest.mark.parametrize("build", [_taylor_green, _dam], ids=["rebuild_every_step", "skinned"])
def test_traced_syncs_equal_the_sync_debug_warnings_on_the_card(build):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg, carry = build("cuda")
    assert cfg.resolved_backend == "kernel"
    _neighbor_table(cfg, carry)  # uploaded once, before the steps
    rebuilds = 0
    for _ in range(12):
        r0 = carry.rebuilds
        carry, warned, traced = _traced_step(cfg, carry)
        rebuilt = carry.rebuilds - r0
        assert traced == warned == STEP_SYNCS + REBUILD_SYNCS * rebuilt, (warned, traced)
        rebuilds += rebuilt
    assert rebuilds > 0
