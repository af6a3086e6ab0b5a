"""Fault-tolerance runtime: heartbeats, straggler watchdog, elastic
resize decisions.

Port of ``repro.runtime.fault_tolerance``, plain Python: on a cluster
the heartbeat file is a per-host path on shared storage (or a KV store);
here it's local disk, which exercises the same logic.

Components:
  * HeartbeatWriter  - each host touches <dir>/host_<id>.hb every step.
  * HeartbeatMonitor - a coordinator reads all hb files; hosts silent for
    > timeout are dead -> triggers an elastic restart (fewer hosts).
  * StragglerWatchdog - EMA of step wall-time; a step slower than
    mean * threshold is flagged; persistent stragglers are reported.
  * plan_elastic_mesh - given the surviving device count, the largest
    (data, model) mesh <= available and the batch re-spec.
  * TrainGuard - the per-step bookkeeping of the training driver.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time


class HeartbeatWriter:
    def __init__(self, directory: str, host_id: int):
        self.path = os.path.join(directory, f"host_{host_id}.hb")
        os.makedirs(directory, exist_ok=True)

    def beat(self, step: int):
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"step": step, "t": time.time()}, f)
        os.replace(tmp, self.path)

    def clear(self):
        """Remove the heartbeat file: the clean-shutdown marker.

        A missing file means "never started or exited cleanly"; a STALE
        file means "died mid-run" — so a clean exit must remove its
        file, or every later resume mistakes the previous clean run for
        a dead process."""
        for path in (self.path, self.path + ".tmp"):
            try:
                os.remove(path)
            except FileNotFoundError:
                pass


class HeartbeatMonitor:
    """Staleness is judged by the heartbeat FILE's mtime, not the wall
    time recorded inside it: the writer stamps ``t = time.time()``, so
    an NTP step or suspend/resume between write and read would shift
    the recorded clock and falsely flip hosts dead (or keep a dead one
    alive). ``os.replace`` gives the file a fresh mtime from the same
    filesystem clock the monitor stats it with, so the delta is immune
    to wall-clock jumps; ``skew_s`` absorbs coarse-mtime filesystems
    and NFS-style writer/reader clock offsets. The recorded ``t`` stays
    in the returned record as a diagnostic only.
    """

    def __init__(self, directory: str, timeout_s: float = 60.0,
                 skew_s: float = 2.0):
        self.dir = directory
        self.timeout = timeout_s
        self.skew = skew_s

    def _fresh(self, path: str) -> bool:
        """mtime-based staleness check; False if the file vanished."""
        try:
            age = time.time() - os.stat(path).st_mtime
        except OSError:
            return False
        return age <= self.timeout + self.skew

    def alive_hosts(self) -> dict[int, dict]:
        out = {}
        if not os.path.isdir(self.dir):
            return out
        for name in os.listdir(self.dir):
            if not name.endswith(".hb"):
                continue
            path = os.path.join(self.dir, name)
            try:
                with open(path) as f:
                    rec = json.load(f)
            except (json.JSONDecodeError, OSError):
                continue  # torn read: treat as missing this poll
            host = int(name.split("_")[1].split(".")[0])
            if self._fresh(path):
                out[host] = rec
        return out

    def dead_hosts(self, expected: int) -> list[int]:
        alive = self.alive_hosts()
        return [h for h in range(expected) if h not in alive]

    def host_status(self, host_id: int) -> str:
        """Tri-state for one host: "alive" (fresh heartbeat), "dead"
        (stale heartbeat — the process stopped beating without
        :meth:`HeartbeatWriter.clear`), or "absent" (no file: never
        started, or shut down cleanly)."""
        path = os.path.join(self.dir, f"host_{host_id}.hb")
        try:
            with open(path) as f:
                json.load(f)
        except FileNotFoundError:
            return "absent"
        except (json.JSONDecodeError, OSError):
            return "dead"  # torn/corrupt file from a mid-write kill
        return "alive" if self._fresh(path) else "dead"


@dataclasses.dataclass
class StragglerWatchdog:
    """Flags steps slower than ema * threshold; tracks repeat offenders."""

    threshold: float = 2.0
    decay: float = 0.9
    patience: int = 3

    ema: float | None = None
    consecutive_slow: int = 0
    flagged: bool = False

    def observe(self, step_time_s: float) -> bool:
        """Returns True if this step is a straggler event."""
        if self.ema is None:
            self.ema = step_time_s
            return False
        slow = step_time_s > self.threshold * self.ema
        # slow steps do not poison the baseline
        if not slow:
            self.ema = self.decay * self.ema + (1 - self.decay) * step_time_s
            self.consecutive_slow = 0
        else:
            self.consecutive_slow += 1
            if self.consecutive_slow >= self.patience:
                self.flagged = True
        return slow


def plan_elastic_mesh(n_devices: int, *, model_parallel: int = 16, global_batch: int = 256):
    """Largest power-of-two data axis that fits the surviving devices,
    keeping TP fixed (reshaping TP would re-shard every weight).

    Returns dict(mesh_shape, drop_devices, per_device_batch).
    """
    data = max(1, n_devices // model_parallel)
    # round data axis down to a divisor of the global batch
    while data > 1 and global_batch % data != 0:
        data -= 1
    used = data * model_parallel
    return {
        "mesh_shape": (data, model_parallel),
        "axis_names": ("data", "model"),
        "drop_devices": n_devices - used,
        "per_device_batch": global_batch // data,
    }


@dataclasses.dataclass
class TrainGuard:
    """Bundles the per-step fault-tolerance bookkeeping for a driver."""

    heartbeat: HeartbeatWriter
    watchdog: StragglerWatchdog
    monitor: HeartbeatMonitor | None = None
    expected_hosts: int = 1

    def on_step(self, step: int, step_time_s: float) -> dict:
        self.heartbeat.beat(step)
        slow = self.watchdog.observe(step_time_s)
        dead = (self.monitor.dead_hosts(self.expected_hosts)
                if self.monitor else [])
        return {
            "straggler": slow,
            "straggler_flagged": self.watchdog.flagged,
            "dead_hosts": dead,
            "needs_resize": bool(dead),
        }
