"""The program's spans in a trace (``spans.py``) and the metrics that read
them, on the synthetic trace of ``test_portbench_metrics`` with the
program's spans nested inside the harness's."""
from __future__ import annotations

import copy

import pytest

from portbench import bench, spans, trace
from portbench.tests.test_portbench_metrics import PREFIX, _ctx, _events

OLD = ("rebuild_device_ms", "physics_device_ms", "k2_roofline_pct", "step_mfu_pct",
       "device_idle_pct")
NEW = ("pack_device_ms", "permute_device_ms", "unpack_device_ms", "rebuild_idle_ms",
       "force_idle_ms", "host_syncs_per_step")


def _nested():
    """The synthetic trace with the program's spans inside the harness's
    (us, each step at ``base``): sph.decide [base-6, base-2] holding a 1 us
    cudaStreamSynchronize; sph.rebuild [1, 19] holding the 30 us pack
    kernel's launch (at 5) in its .pack child in the first step and in its
    .permute child in the second; sph.force [31, 69] with rcll.unpack [44,
    46] around the 10 us copy's launch. Nothing is launched in a new place; the
    copy's launch takes the name the runtime gives it, cudaMemcpyAsync."""
    ev = copy.deepcopy(_events())
    copies = {e["args"]["correlation"] for e in ev if e["cat"] == "gpu_memcpy"}
    for e in ev:
        if e["cat"] == "cuda_runtime" and e.get("args", {}).get("correlation") in copies:
            e["name"] = "cudaMemcpyAsync"

    def span(name, ts, dur):
        ev.append({"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur})

    for base, child in ((0.0, (2, 4, 10, 4)), (300.0, (2, 1, 4, 6))):
        span("sph.decide", base - 6, 4)
        ev.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaStreamSynchronize",
                   "ts": base - 5, "dur": 1, "args": {"correlation": 1000 + int(base)}})
        span("sph.rebuild", base + 1, 18)
        span("sph.rebuild.pack", base + child[0], child[1])
        span("sph.rebuild.permute", base + child[2], child[3])
        span("sph.force", base + 31, 38)
        span("rcll.unpack", base + 44, 2)
    return ev


def test_program_spans_leave_the_harness_readers_as_they_were():
    plain = _ctx(trace.parse(_events(), PREFIX))
    nested = _ctx(trace.parse(_nested(), PREFIX))
    assert nested.trace.spans == plain.trace.spans
    for name in OLD:
        assert bench.reader(name)(nested) == bench.reader(name)(plain), name


def test_ops_belong_to_the_spans_that_hold_their_launch():
    tr = trace.parse(_nested(), PREFIX)
    assert spans.count(tr, "sph.rebuild") == 2 and spans.count(tr, "rcll.unpack") == 2
    own = spans.attribute(tr)
    rebuild, force = ("sph.rebuild",), ("sph.force",)
    assert own == [rebuild + ("sph.rebuild.pack",), force, force, force + ("rcll.unpack",),
                   rebuild + ("sph.rebuild.permute",), force, force, force + ("rcll.unpack",)]
    assert spans.device_seconds(tr, "sph.rebuild") == pytest.approx(60e-6)
    assert spans.device_seconds(tr, "sph.force") == pytest.approx(180e-6)  # the unpack's too
    assert spans.device_seconds(tr, "rcll.unpack") == pytest.approx(20e-6)
    assert spans.device_seconds(tr, "sph.decide") == 0.0


def test_new_metrics_on_the_nested_trace():
    ctx = _ctx(trace.parse(_nested(), PREFIX))
    got = {name: bench.reader(name)(ctx) for name in NEW}
    assert got == {
        "pack_device_ms": pytest.approx(0.015),  # one 30 us kernel over 2 rebuilds
        "permute_device_ms": pytest.approx(0.015),
        "unpack_device_ms": pytest.approx(0.010),  # a 10 us copy a force pass
        "rebuild_idle_ms": pytest.approx(0.009),  # [1, 10] of [1, 19] before the kernel
        "force_idle_ms": pytest.approx(0.0),  # the device runs through [31, 69]
        "host_syncs_per_step": pytest.approx(1.0),  # the one inside sph.decide
    }


def test_idle_time_inside_a_span_counts_only_the_device_gaps():
    ev = copy.deepcopy(_events())
    ev.append({"ph": "X", "cat": "user_annotation", "name": "sph.force", "ts": 100, "dur": 250})
    tr = trace.parse(ev, PREFIX)
    # [100, 350] holds device work in [100, 130] and [310, 350]: 180 us idle.
    assert spans.idle_seconds(tr, "sph.force") == pytest.approx(180e-6)


def test_launches_that_do_not_match_the_operations_attribute_nothing():
    ev = [e for e in _nested() if not (e.get("name") == "cudaLaunchKernel" and e["ts"] == 5)]
    tr = trace.parse(ev, PREFIX)
    assert spans.launch_times(tr) is None
    assert bench.reader("pack_device_ms")(_ctx(tr)) is None
    # The second pack run ahead of the first step's force pass, as on
    # another stream: every count matches, but the harness spans the
    # correlation ids gave disagree with the matched launches.
    ev = _nested()
    for e in ev:
        if e.get("cat") == "kernel" and e["ts"] == 310:
            e["ts"] = 35
    assert spans.launch_times(trace.parse(ev, PREFIX)) is None


@pytest.mark.parametrize("name", NEW)
def test_new_metrics_read_nothing_without_program_spans(name):
    assert bench.reader(name)(_ctx(None)) is None
    assert bench.reader(name)(_ctx(trace.parse(_events(), PREFIX))) is None
