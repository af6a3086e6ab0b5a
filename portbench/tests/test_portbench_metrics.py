"""The metric arithmetic on a synthetic trace and window, and the
roofline counts of the two configurations."""
from __future__ import annotations

import pytest

from portbench import bench, trace
from portbench.counts import roofline

PREFIX = "portbench."


def _events():
    """Two steps on a synthetic timeline (us): a rebuild span launching a
    30 us kernel, a physics span launching K2's stage and force kernels
    (20 + 60 us) and a 10 us copy; the device idles 100 us between the
    steps while the host waits in cudaStreamSynchronize."""
    ev, corr = [], [0]

    def host(name, cat, ts, dur):
        ev.append({"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur})

    def launch(ts, name, dev_ts, dur, cat="kernel"):
        corr[0] += 1
        ev.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts,
                   "dur": 2, "args": {"correlation": corr[0]}})
        ev.append({"ph": "X", "cat": cat, "name": name, "ts": dev_ts, "dur": dur,
                   "args": {"correlation": corr[0]}})

    for base in (0.0, 300.0):
        host(PREFIX + "rebuild", "user_annotation", base, 20)
        launch(base + 5, "void (anonymous namespace)::pack(int)", base + 10, 30)
        host(PREFIX + "physics", "user_annotation", base + 30, 40)
        launch(base + 35, "void (anonymous namespace)::stage_kernel<2, __half>(int)",
               base + 40, 20)
        launch(base + 40, "void (anonymous namespace)::force_kernel(float4 const*)",
               base + 60, 60)
        launch(base + 45, "Memcpy DtoH (Device -> Pinned)", base + 120, 10, "gpu_memcpy")
        host("cudaStreamSynchronize", "cuda_runtime", base + 130, 170)
    return ev


def _ctx(tr, **kw):
    conf = bench.load("configs", "taylor_green_4m")
    ctx = bench.Context(conf=conf, n=1000, trace=tr, trace_window_s=600e-6,
                        trace_steps=2, trace_rebuilds=2, trace_pairs=18000)
    for k, v in kw.items():
        setattr(ctx, k, v)
    return ctx


def test_parse_assigns_ops_to_spans_and_reads_busy_and_gaps():
    tr = trace.parse(_events(), PREFIX)
    assert tr.spans == {"rebuild": 2, "physics": 2}
    assert [o.span for o in tr.ops[:4]] == ["rebuild", "physics", "physics", "physics"]
    assert trace.busy_s(tr) == pytest.approx(2 * 120e-6)
    assert trace.device_seconds(tr, "rebuild") == pytest.approx(60e-6)
    assert trace.device_seconds(tr, "physics", ("stage_kernel", "force_kernel")) == \
        pytest.approx(160e-6)
    assert trace.idle_gaps(tr) == [["cudaStreamSynchronize", pytest.approx(180e-6)]]
    names = [n for n, _ in trace.top_ops(tr)]
    assert names[0] == "force_kernel" and "Memcpy DtoH (Device -> Pinned)" in names


def test_layer_metrics_on_the_synthetic_trace():
    ctx = _ctx(trace.parse(_events(), PREFIX))
    assert bench.reader("rebuild_device_ms")(ctx) == pytest.approx(0.030)
    assert bench.reader("physics_device_ms")(ctx) == pytest.approx(0.090)
    assert bench.reader("device_idle_pct")(ctx) == pytest.approx(100 * (1 - 240 / 600))
    k2 = roofline.force_least_seconds(ctx.conf, 1000, 18000) / 80e-6
    assert bench.reader("k2_roofline_pct")(ctx) == pytest.approx(100 * k2)
    least = 2 * roofline.least_seconds(18000 * 44, 4 * 1000 * 29)
    assert bench.reader("step_mfu_pct")(ctx) == pytest.approx(100 * least / 600e-6)


def test_layer_metrics_read_nothing_without_a_trace():
    ctx = _ctx(None)
    for name in ("rebuild_device_ms", "physics_device_ms", "k2_roofline_pct",
                 "step_mfu_pct", "device_idle_pct"):
        assert bench.reader(name)(ctx) is None


def test_end_to_end_metrics_and_the_step_tail():
    ctx = _ctx(None, steps=300, window_s=2.0, setup_seconds=7.5, peak_bytes=2_000_000,
               step_s=[0.001] * 190 + [0.002] * 10)
    assert bench.reader("particle_steps_per_s")(ctx) == pytest.approx(1000 * 300 / 2.0 / 1e6)
    assert bench.reader("peak_bytes_per_particle")(ctx) == pytest.approx(2000.0)
    assert bench.reader("setup_s")(ctx) == 7.5
    assert bench.reader("step_ms_p95")(ctx) == pytest.approx(1.0)
    ctx.step_s = [0.001] * 189 + [0.002] * 11
    assert bench.reader("step_ms_p95")(ctx) == pytest.approx(2.0)
    ctx.step_s = ctx.step_s[:150]
    assert bench.reader("step_ms_p95")(ctx) is None


def test_roofline_counts_of_the_configurations():
    tg = bench.load("configs", "taylor_green_4m")
    dam = bench.load("configs", "dam_break_4m")
    assert roofline.pair_ops(tg["physics"]) == 44
    assert roofline.pair_ops(dam["physics"]) == 55
    assert roofline.force_bytes_per_particle(tg) == 26
    assert roofline.state_bytes_per_particle(tg) == 29
    # a rebuild step moves the state twice: bytes-bound at 4M particles
    n, pairs = 4_194_304, 18 * 4_194_304
    assert roofline.step_least_seconds(tg, n, pairs, 1, 1) == pytest.approx(
        4 * n * 29 / roofline.PEAK_BYTES_PER_S)
