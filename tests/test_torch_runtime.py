"""The port's fault-tolerance runtime: ports of ``tests/test_runtime.py``
(heartbeats, the straggler watchdog, ``plan_elastic_mesh``), the
heartbeat file format shared with the JAX package, and
``plan_elastic_mesh`` and ``TrainGuard`` against JAX's on the same
inputs."""
import json
import os
import time

import pytest

from repro.runtime import fault_tolerance as jft
from repro_torch.runtime.fault_tolerance import (
    HeartbeatMonitor, HeartbeatWriter, StragglerWatchdog, TrainGuard, plan_elastic_mesh)
from test_torch_helpers import one_torch_thread  # noqa: F401  (autouse fixture)


def test_heartbeat_roundtrip(tmp_path):
    HeartbeatWriter(str(tmp_path), 0).beat(5)
    HeartbeatWriter(str(tmp_path), 1).beat(5)
    mon = HeartbeatMonitor(str(tmp_path), timeout_s=60)
    assert sorted(mon.alive_hosts()) == [0, 1]
    assert mon.dead_hosts(expected=3) == [2]


def test_heartbeat_timeout(tmp_path):
    HeartbeatWriter(str(tmp_path), 0).beat(1)
    mon = HeartbeatMonitor(str(tmp_path), timeout_s=0.05, skew_s=0.0)
    time.sleep(0.1)
    assert mon.dead_hosts(expected=1) == [0]


def test_heartbeat_clear_removes_file(tmp_path):
    w = HeartbeatWriter(str(tmp_path), 0)
    w.beat(7)
    with open(w.path + ".tmp", "w") as f:
        f.write("{")  # a torn in-flight write the crash left behind
    w.clear()
    assert not os.path.exists(w.path) and not os.path.exists(w.path + ".tmp")
    w.clear()  # idempotent


def test_host_status_tristate(tmp_path):
    mon = HeartbeatMonitor(str(tmp_path), timeout_s=60)
    assert mon.host_status(0) == "absent"
    w = HeartbeatWriter(str(tmp_path), 0)
    w.beat(1)
    assert mon.host_status(0) == "alive"
    stale = HeartbeatMonitor(str(tmp_path), timeout_s=0.01, skew_s=0.0)
    time.sleep(0.05)
    assert stale.host_status(0) == "dead"
    w.clear()
    assert stale.host_status(0) == "absent"
    with open(w.path, "w") as f:
        f.write("{not json")
    assert mon.host_status(0) == "dead"


def test_heartbeat_staleness_ignores_forged_wall_time(tmp_path):
    """Liveness is judged by the file's mtime, not the recorded wall time."""
    w = HeartbeatWriter(str(tmp_path), 0)
    w.beat(3)
    with open(w.path) as f:
        rec = json.load(f)
    rec["t"] -= 3600.0
    with open(w.path, "w") as f:
        json.dump(rec, f)
    mon = HeartbeatMonitor(str(tmp_path), timeout_s=60)
    assert mon.host_status(0) == "alive"
    assert mon.alive_hosts()[0]["t"] == rec["t"]
    rec["t"] = time.time() + 3600.0
    with open(w.path, "w") as f:
        json.dump(rec, f)
    old = time.time() - 100.0
    os.utime(w.path, (old, old))
    stale = HeartbeatMonitor(str(tmp_path), timeout_s=60, skew_s=2.0)
    assert stale.host_status(0) == "dead" and 0 not in stale.alive_hosts()


def test_heartbeat_skew_allowance(tmp_path):
    w = HeartbeatWriter(str(tmp_path), 0)
    w.beat(1)
    old = time.time() - 5.0
    os.utime(w.path, (old, old))
    assert HeartbeatMonitor(str(tmp_path), timeout_s=4.0, skew_s=2.0).host_status(0) == "alive"
    assert HeartbeatMonitor(str(tmp_path), timeout_s=4.0, skew_s=0.0).host_status(0) == "dead"


def test_straggler_watchdog():
    wd = StragglerWatchdog(threshold=2.0, patience=2)
    for _ in range(10):
        assert not wd.observe(1.0)
    assert wd.observe(5.0)
    assert not wd.flagged
    assert wd.observe(5.0)
    assert wd.flagged
    assert wd.ema < 1.5


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_heartbeats_cross_packages(tmp_path, writer):
    """One package's heartbeat files are read by the other's monitor."""
    w_cls = jft.HeartbeatWriter if writer == "jax" else HeartbeatWriter
    m_cls = HeartbeatMonitor if writer == "jax" else jft.HeartbeatMonitor
    for host in (0, 2):
        w_cls(str(tmp_path), host).beat(9)
    mon = m_cls(str(tmp_path), timeout_s=60)
    assert sorted(mon.alive_hosts()) == [0, 2] and mon.alive_hosts()[2]["step"] == 9
    assert mon.dead_hosts(expected=3) == [1] and mon.host_status(1) == "absent"


def test_watchdog_matches_jax_on_a_trace():
    times = [1.0, 1.1, 0.9, 3.5, 1.0, 4.0, 4.2, 4.4, 1.2]
    a, b = StragglerWatchdog(patience=2), jft.StragglerWatchdog(patience=2)
    assert [a.observe(t) for t in times] == [b.observe(t) for t in times]
    assert (a.ema, a.consecutive_slow, a.flagged) == (b.ema, b.consecutive_slow, b.flagged)


@pytest.mark.parametrize("n,mp,gb", [(256, 16, 256), (240, 16, 256), (17, 16, 256), (8, 16, 256),
                                     (96, 8, 48), (1000, 16, 100), (1, 1, 7), (64, 4, 30)])
def test_plan_elastic_mesh_is_jaxs(n, mp, gb):
    got = plan_elastic_mesh(n, model_parallel=mp, global_batch=gb)
    assert got == jft.plan_elastic_mesh(n, model_parallel=mp, global_batch=gb)
    assert got["mesh_shape"][0] * mp + got["drop_devices"] == n or n < mp
    assert gb % got["mesh_shape"][0] == 0


def test_plan_elastic_mesh_defaults():
    plan = plan_elastic_mesh(256)
    assert plan == {"mesh_shape": (16, 16), "axis_names": ("data", "model"), "drop_devices": 0,
                    "per_device_batch": 16}
    assert plan_elastic_mesh(240)["mesh_shape"] == (8, 16)  # 15 rounds down to a divisor of 256


def test_train_guard_matches_jax(tmp_path):
    """The same step times through both packages' guards (each with its
    own heartbeat directory and monitor expecting two hosts, one of which
    never beats) give the same records, step by step."""
    times = [1.0, 1.05, 0.98, 3.0, 3.1, 2.9, 1.0, 5.0]
    guards = []
    for mod, sub in ((jft, "jax"), (None, "port"), ):
        d = str(tmp_path / sub)
        cls = (mod.TrainGuard, mod.HeartbeatWriter, mod.StragglerWatchdog,
               mod.HeartbeatMonitor) if mod else (TrainGuard, HeartbeatWriter,
                                                  StragglerWatchdog, HeartbeatMonitor)
        guards.append(cls[0](heartbeat=cls[1](d, 0), watchdog=cls[2](),
                             monitor=cls[3](d), expected_hosts=2))
    for step, t in enumerate(times):
        want, got = guards[0].on_step(step, t), guards[1].on_step(step, t)
        assert got == want, (step, got, want)
        with open(tmp_path / "port" / "host_0.hb") as f:
            assert json.load(f)["step"] == step
    assert got["dead_hosts"] == [1] and got["needs_resize"]
    assert guards[1].watchdog.flagged == guards[0].watchdog.flagged


def test_train_guard_without_monitor(tmp_path):
    g = TrainGuard(heartbeat=HeartbeatWriter(str(tmp_path), 0), watchdog=StragglerWatchdog())
    assert g.on_step(0, 1.0) == {"straggler": False, "straggler_flagged": False,
                                 "dead_hosts": [], "needs_resize": False}
