"""Crash-contained multi-process serving: frontend + engine workers.

Port of ``repro.sph.supervisor``. :class:`FrontendServer` is the process
clients connect to. It owns the client listener, frame validation, and
the bounded admission queue (all inherited from
:class:`repro_torch.sph.serve.ServerBase`) — but no tensor: it never
initialises CUDA. Each shape bucket (normalized case+resolution+
overrides, see :func:`repro_torch.sph.serve.request_key`) runs in its
OWN engine-worker process (:mod:`repro_torch.sph.worker`, on ``device``:
CUDA unless the caller names another), spawned on demand, connected
back over a localhost IPC socket speaking the same length-prefixed
frame protocol. A native crash in one bucket (a CUDA fault, an OOM
kill, a wedged launch) kills one worker process; the frontend and every
sibling bucket keep streaming, bit-identical to solo runs.

The supervisor (part of the frontend's engine loop) detects worker
death three ways:

  1. IPC channel EOF / process exit — the fast path for clean crashes;
  2. stale heartbeat — ``HeartbeatMonitor.host_status() == "dead"`` on
     the worker's dir (mtime-based, immune to wall-clock steps): the
     process stopped beating without clearing;
  3. hang watchdog — heartbeat ALIVE but no progress frames past
     ``hang_timeout_s`` while requests are assigned: the engine loop is
     wedged (stuck native call); the supervisor SIGKILLs it. The
     watchdog arms only after the current process has reported at
     least one block of progress, so a long first kernel-library build
     is never mistaken for a hang.

On death the worker is restarted with capped exponential backoff; the
restarted process reclaims the dead pid's lockfiles (quietly — one
summary line, not one warning per lane) and every in-flight request is
re-admitted from its last per-lane block checkpoint (written
continuously, every healthy block — recovery loses at most
``save_every`` blocks). Clients see a streamed ``EVENT recovering``
then seamless OBS continuation. If the worker dies more than
``max_restarts`` times, its in-flight requests get a structured
``RETRY_AFTER`` with a resume token (the lane checkpoints stay on
disk; resubmitting the token respawns a fresh worker and resumes).

Chaos modes (``repro_torch.sph serve --chaos kill|hang|oom-sim``) inject one
real fault into the first busy worker that completes a block: ``kill``
SIGKILLs it from the supervisor, ``hang`` wedges its engine loop while
its heartbeat keeps beating (exercises the hang watchdog), ``oom-sim``
makes it ``os._exit(137)`` right after a block (the OOM-killer shape).
The request must still finish — bit-identical to an uninterrupted run
— with no operator action; ``tests/torch_chaos.py`` drives these.

Monitoring (the stats op's ``workers`` rows) adds, per worker, the
seconds from its latest spawn to its first block of progress
(``first_progress_s``: CUDA context, kernel library load and the first
block included) and the lane-checkpoint ms of its last tick that saved
one (``save_ms``).
"""
from __future__ import annotations

import glob
import json
import logging
import os
import secrets
import socket
import subprocess
import sys
import tempfile
import threading
import time
from collections import deque

import repro_torch
from repro_torch.core import recovery
from repro_torch.runtime.fault_tolerance import HeartbeatMonitor
from repro_torch.sph.serve import (
    ServerBase,
    _Conn,
    _Pending,
    recv_frame,
    request_key,
    worker_tag,
)

log = logging.getLogger("repro_torch.serve")

CHAOS_MODES = ("kill", "hang", "oom-sim")


class WorkerHandle:
    """Supervisor-side state for one engine-worker process."""

    def __init__(self, wid: int, wkey: str, tag: str, wdir: str):
        self.wid = wid
        self.wkey = wkey
        self.tag = tag
        self.dir = wdir
        self.secret: str | None = None
        self.proc: subprocess.Popen | None = None
        self.conn: _Conn | None = None
        self.pid: int | None = None
        # spawning -> ready -> (backoff -> spawning)* ; drained
        self.state = "spawning"
        self.restarts = 0
        self.restart_at = 0.0
        self.spawn_t = 0.0
        self.last_frame = 0.0
        self.blocks = 0
        self.progress_since_spawn = False
        self.first_progress_s: float | None = None
        self.save_ms: float | None = None
        self.eof = False
        self.drained_steps: dict[str, int] | None = None
        self.assigned: dict[str, _Pending] = {}  # rid -> request

    @property
    def alive_proc(self) -> bool:
        return self.proc is not None and self.proc.poll() is None


class FrontendServer(ServerBase):
    """Multi-process SPH service: routing frontend + worker supervisor.

    Drop-in for :class:`SimServer` at the socket: same client protocol,
    same drain semantics, same stats op (plus ``worker_restarts`` /
    ``recovered_lanes`` / ``workers``). Requires a checkpoint root (a
    private tempdir is created when none is given — in-flight recovery
    needs somewhere to write lane checkpoints). ``device`` is handed to
    every worker (``--device``); None leaves the workers on CUDA.
    """

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 0,
        *,
        slots: int = 8,
        queue: int = 32,
        policy: recovery.GuardPolicy | None = None,
        checkpoint_dir: str | None = None,
        heartbeat_timeout_s: float = 60.0,
        max_restarts: int = 3,
        hang_timeout_s: float = 600.0,
        backoff_base_s: float = 0.5,
        backoff_cap_s: float = 10.0,
        save_every: int = 1,
        drain_timeout_s: float = 60.0,
        spawn_timeout_s: float = 120.0,
        worker_hb_timeout_s: float = 10.0,
        chaos: str | None = None,
        device=None,
    ):
        self.device = None if device is None else str(device)
        self.policy = policy or recovery.GuardPolicy()
        self.slots = int(slots)
        self.max_restarts = int(max_restarts)
        self.hang_timeout_s = float(hang_timeout_s)
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_cap_s = float(backoff_cap_s)
        self.save_every = int(save_every)
        self.drain_timeout_s = float(drain_timeout_s)
        self.spawn_timeout_s = float(spawn_timeout_s)
        self.worker_hb_timeout_s = float(worker_hb_timeout_s)
        if chaos is not None and chaos not in CHAOS_MODES:
            raise ValueError(f"chaos mode {chaos!r}; one of {CHAOS_MODES}")
        self.chaos = chaos
        self.chaos_fired_t: float | None = None
        self.last_recovery_s: float | None = None
        self.workers: dict[str, WorkerHandle] = {}  # wkey -> handle
        self.inflight: dict[str, _Pending] = {}     # rid -> request
        self.worker_restarts = 0
        self.recovered_lanes = 0
        self._next_wid = 0
        self._next_rid = 0
        self._by_secret: dict[str, WorkerHandle] = {}
        self._wframes: deque[tuple[WorkerHandle, dict]] = deque()
        self._prewarm_ok = threading.Event()
        self._prewarm_err: str | None = None
        if checkpoint_dir is None:
            checkpoint_dir = tempfile.mkdtemp(prefix="sph-serve-")
            log.warning("serve: no --checkpoint given; lane checkpoints "
                        "under %s (resume tokens die with it)",
                        checkpoint_dir)
        # the worker-facing IPC listener (localhost, secret-handshake)
        self.ipc_sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.ipc_sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.ipc_sock.bind(("127.0.0.1", 0))
        self.ipc_sock.listen(32)
        self.ipc_port = self.ipc_sock.getsockname()[1]
        super().__init__(host, port, queue=queue,
                         checkpoint_dir=checkpoint_dir,
                         heartbeat_timeout_s=heartbeat_timeout_s)
        # started after super().__init__: the loop needs self.stopped
        threading.Thread(target=self._ipc_accept_loop,
                         daemon=True).start()
        log.info("serve: frontend on %s:%d (ipc=%d slots=%d queue=%d "
                 "block=%d max_restarts=%d%s)", self.host, self.port,
                 self.ipc_port, self.slots, self.queue_cap,
                 self.policy.block, self.max_restarts,
                 f" chaos={chaos}" if chaos else "")

    def _has_resumables(self) -> bool:
        return (os.path.isdir(os.path.join(self.ckdir, "drain"))
                or bool(glob.glob(os.path.join(
                    self.ckdir, "workers", "*", "lanes", "*"))))

    # ---- monitoring -----------------------------------------------------
    def _live_steps(self) -> list[int]:
        return sorted(p.steps for p in list(self.inflight.values()))

    def _extra_stats(self) -> dict:
        return {
            "live": len(self.inflight),
            "buckets": len(self.workers),
            "worker_restarts": self.worker_restarts,
            "recovered_lanes": self.recovered_lanes,
            "chaos": self.chaos,
            "chaos_fired": self.chaos_fired_t is not None,
            "recovery_s": self.last_recovery_s,
            "workers": [
                {"wid": h.wid, "tag": h.tag, "pid": h.pid,
                 "state": h.state, "restarts": h.restarts,
                 "blocks": h.blocks, "assigned": len(h.assigned),
                 "first_progress_s": h.first_progress_s,
                 "save_ms": h.save_ms}
                for h in list(self.workers.values())],
        }

    # ---- worker IPC (handshake + reader threads) ------------------------
    def _ipc_accept_loop(self):
        while not self.stopped.is_set():
            try:
                sock, _ = self.ipc_sock.accept()
            except OSError:
                return
            threading.Thread(target=self._ipc_reader, args=(sock,),
                             daemon=True).start()

    def _ipc_reader(self, sock: socket.socket):
        """Authenticate one worker connection, then pump its frames to
        the engine thread. IO only — all state changes happen on the
        engine thread via the _wframes queue."""
        try:
            sock.settimeout(10.0)
            hello = recv_frame(sock)
            if (not isinstance(hello, dict)
                    or hello.get("type") != "hello"):
                sock.close()
                return
            with self.cond:
                h = self._by_secret.pop(hello.get("secret"), None)
            if h is None:
                log.warning("serve: worker connection with unknown "
                            "secret rejected")
                sock.close()
                return
            sock.settimeout(None)
            h.conn = _Conn(sock)
            self._enqueue(h, hello)
            while True:
                f = recv_frame(sock)
                if f is None:
                    break
                self._enqueue(h, f)
        except (ValueError, OSError):
            pass
        if "h" in locals() and h is not None:
            h.eof = True
            with self.cond:
                self.cond.notify()

    def _enqueue(self, h: WorkerHandle, frame: dict):
        with self.cond:
            self._wframes.append((h, frame))
            self.cond.notify()

    def _drain_wframes(self) -> list[tuple[WorkerHandle, dict]]:
        with self.cond:
            out = list(self._wframes)
            self._wframes.clear()
        return out

    # ---- worker lifecycle ----------------------------------------------
    def _workers_root(self) -> str:
        return os.path.join(self.ckdir, "workers")

    def _ensure_worker(self, wkey: str, tag: str) -> WorkerHandle:
        h = self.workers.get(wkey)
        if h is None:
            wdir = os.path.join(self._workers_root(), tag)
            h = WorkerHandle(self._next_wid, wkey, tag, wdir)
            self._next_wid += 1
            self.workers[wkey] = h
            self._spawn(h)
        return h

    def _spawn(self, h: WorkerHandle):
        h.secret = secrets.token_hex(16)
        with self.cond:
            self._by_secret[h.secret] = h
        h.state = "spawning"
        h.spawn_t = time.monotonic()
        h.eof = False
        h.conn = None
        h.pid = None
        h.progress_since_spawn = False
        cmd = [sys.executable, "-m", "repro_torch.sph.worker",
               "--connect", str(self.ipc_port), "--secret", h.secret,
               "--wid", str(h.wid), "--dir", h.dir,
               "--slots", str(self.slots),
               "--block", str(self.policy.block),
               "--save-every", str(self.save_every)]
        if self.device is not None:
            cmd += ["--device", self.device]
        env = dict(os.environ)
        src = os.path.dirname(os.path.dirname(
            os.path.abspath(repro_torch.__file__)))
        env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
        h.proc = subprocess.Popen(cmd, env=env)
        log.info("serve: spawned worker w%d pid=%d for %s%s", h.wid,
                 h.proc.pid, h.tag,
                 f" (restart {h.restarts}/{self.max_restarts})"
                 if h.restarts else "")

    def _send_admit(self, h: WorkerHandle, p: _Pending):
        if h.conn is not None:
            h.conn.send({"type": "admit", "rid": p.rid,
                         "token": p.token, "req": p.req})

    # ---- routing --------------------------------------------------------
    def _resolve_token(self, token: str) -> dict | None:
        """Resume token -> the saved request, located by scanning the
        worker lane dirs (stable across frontend restarts)."""
        hits = glob.glob(os.path.join(
            self._workers_root(), "*", "lanes", token, "token.json"))
        for hit in hits:
            try:
                with open(hit) as f:
                    return json.load(f)["request"]
            except (OSError, json.JSONDecodeError, KeyError):
                continue
        return None

    def _route(self, p: _Pending) -> bool:
        """Try to hand one queued request to its bucket's worker.
        True if it left the queue (sent, or terminally answered);
        False to retry next tick (worker still spawning/backing off)."""
        if p.token is None:
            if "resume_token" in p.req:
                token = p.req["resume_token"]
                saved = self._resolve_token(token)
                if saved is None:
                    p.reply({"type": "error", "reason": "bad_token",
                             "detail": "unknown or corrupt resume "
                             f"token {token!r}"})
                    p.conn.close()
                    return True
                # merge: the original run, with the resubmission's
                # flags (observe/return_state/deadline) on top
                p.req = {**saved,
                         **{k: v for k, v in p.req.items()
                            if k != "resume_token"}}
                p.token = token
            else:
                p.token = secrets.token_hex(8)
        h = self._ensure_worker(request_key(p.req), worker_tag(p.req))
        if h.state != "ready":
            return False  # spawning or in backoff: stays queued
        if p.rid is None:
            p.rid = f"r{self._next_rid}"
            self._next_rid += 1
        p.wkey = h.wkey
        self.inflight[p.rid] = p
        h.assigned[p.rid] = p
        self._send_admit(h, p)
        return True

    # ---- worker frame handling (engine thread) --------------------------
    def _handle_worker_frame(self, h: WorkerHandle, f: dict):
        h.last_frame = time.monotonic()
        kind = f.get("type")
        if kind == "hello":
            h.pid = int(f.get("pid") or 0)
            h.state = "ready"
            log.info("serve: worker w%d (%s) ready, pid=%d", h.wid,
                     h.tag, h.pid)
            # crash recovery: re-admit everything it owed, from the
            # per-lane checkpoints its predecessor wrote
            for p in list(h.assigned.values()):
                self._send_admit(h, p)
            return
        if kind == "progress":
            h.blocks = int(f.get("blocks") or 0)
            if not h.progress_since_spawn:
                h.first_progress_s = time.monotonic() - h.spawn_t
            h.progress_since_spawn = True
            if f.get("save_ms") is not None:
                h.save_ms = float(f["save_ms"])
            for rid, steps in (f.get("steps") or {}).items():
                p = self.inflight.get(rid)
                if p is not None:
                    p.steps = int(steps)
            return
        if kind == "drained":
            h.drained_steps = {str(k): int(v) for k, v in
                               (f.get("steps") or {}).items()}
            h.state = "drained"
            return
        if kind == "prewarmed":
            self._prewarm_ok.set()
            return
        if kind == "pong":
            return
        rid = f.get("rid")
        p = self.inflight.get(rid) if rid is not None else None
        if p is None:
            if kind == "error":  # e.g. prewarm build failure
                log.warning("serve: worker w%d error: %s", h.wid,
                            f.get("detail"))
                if rid is None:
                    self._prewarm_err = str(f.get("detail"))
            return
        if kind == "accepted":
            p.nsteps = int(f.get("nsteps") or 0)
            p.observe = bool(p.req.get("observe"))
            p.return_state = bool(p.req.get("return_state"))
            if p.deadline is None and p.req.get("deadline_s") is not None:
                p.deadline = p.received + float(p.req["deadline_s"])
            if p.recovering:
                # re-admitted after a crash: the client already holds
                # an ACCEPTED; OBS now continues from the checkpoint
                p.recovering = False
                p.recovered = True
                self.recovered_lanes += 1
                log.info("serve: %s resumed on w%d at step %s", p.rid,
                         h.wid, f.get("steps_done"))
            else:
                p.reply({"type": "accepted", "lane": f.get("lane"),
                         "nsteps": p.nsteps, "block": self.policy.block,
                         "bucket": h.tag,
                         "resumed": bool(f.get("resumed"))})
            return
        if kind == "busy":
            # EngineFull/FaultBusy backpressure: back to the queue
            h.assigned.pop(rid, None)
            self.inflight.pop(rid, None)
            p.rid = None
            with self.cond:
                self.pending.append(p)
            return
        if kind == "obs":
            p.steps = int(f.get("step") or p.steps)
            if (self.chaos_fired_t is not None and p.recovered
                    and self.last_recovery_s is None):
                # chaos fire -> first post-restart OBS: the recovery
                # latency the --chaos benchmark records
                self.last_recovery_s = (
                    time.monotonic() - self.chaos_fired_t)
            if p.observe:
                relay = {k: v for k, v in f.items() if k != "rid"}
                if not p.reply(relay):
                    # client hung up mid-stream: free the lane
                    self._retire(h, p, discard=True)
            return
        if kind == "event":
            p.reply({k: v for k, v in f.items() if k != "rid"})
            return
        if kind in ("done", "diverged", "error"):
            p.reply({k: v for k, v in f.items() if k != "rid"})
            if kind == "done":
                self.completed += 1
            p.conn.close()
            h.assigned.pop(rid, None)
            self.inflight.pop(rid, None)
            return
        log.warning("serve: unknown worker frame %r from w%d", kind,
                    h.wid)

    def _retire(self, h: WorkerHandle, p: _Pending, *, discard: bool):
        if h.conn is not None:
            h.conn.send({"type": "retire", "rid": p.rid,
                         "discard": discard})
        h.assigned.pop(p.rid, None)
        self.inflight.pop(p.rid, None)
        p.conn.close()

    # ---- supervision ----------------------------------------------------
    def _supervise(self):
        now = time.monotonic()
        self._maybe_fire_chaos(now)
        for wkey, h in list(self.workers.items()):
            if h.state == "backoff":
                if now >= h.restart_at:
                    self._spawn(h)
                continue
            if h.state == "drained":
                continue
            if h.state == "spawning":
                if not h.alive_proc:
                    self._on_death(h, "exited during spawn")
                elif now - h.spawn_t > self.spawn_timeout_s:
                    self._kill(h)
                    self._on_death(h, "spawn timeout")
                continue
            # state == "ready"
            if h.eof or not h.alive_proc:
                self._on_death(h, "channel EOF" if h.eof
                               else "process exit")
                continue
            hb = HeartbeatMonitor(
                h.dir, timeout_s=self.worker_hb_timeout_s)
            if h.assigned and hb.host_status(0) == "dead":
                self._kill(h)
                self._on_death(h, "heartbeat stale")
                continue
            if (h.assigned and h.progress_since_spawn
                    and now - h.last_frame > self.hang_timeout_s):
                # heartbeat alive but no block progress: wedged engine
                self._kill(h)
                self._on_death(h, "hang (no progress past "
                               f"{self.hang_timeout_s:.0f}s)")

    def _kill(self, h: WorkerHandle):
        if h.alive_proc:
            try:
                h.proc.kill()
                h.proc.wait(timeout=10)
            except OSError:
                pass

    def _on_death(self, h: WorkerHandle, why: str):
        h.restarts += 1
        self.worker_restarts += 1
        if h.alive_proc:  # EOF with the process somehow lingering
            self._kill(h)
        log.warning("serve: worker w%d (%s) died: %s — %d in-flight, "
                    "restart %d/%d", h.wid, h.tag, why, len(h.assigned),
                    h.restarts, self.max_restarts)
        for p in list(h.assigned.values()):
            if not p.recovering:
                p.recovering = True
                p.reply({"type": "event", "action": "recovering",
                         "step": p.steps,
                         "detail": f"engine worker died ({why}); "
                         "restarting from last block checkpoint"})
        if h.restarts > self.max_restarts:
            log.error("serve: worker w%d exceeded max_restarts=%d; "
                      "shedding %d request(s) with resume tokens",
                      h.wid, self.max_restarts, len(h.assigned))
            for p in list(h.assigned.values()):
                p.reply({"type": "retry_after", "token": p.token,
                         "steps_done": p.steps, "nsteps": p.nsteps,
                         "detail": "engine worker exceeded "
                         f"max_restarts={self.max_restarts}; resume "
                         "later with the token"})
                p.conn.close()
                self.inflight.pop(p.rid, None)
            # drop the handle: lane checkpoints stay on disk, and a
            # later request (or token resubmission) starts a fresh
            # worker with a clean restart budget
            del self.workers[h.wkey]
            return
        delay = min(self.backoff_cap_s,
                    self.backoff_base_s * 2 ** (h.restarts - 1))
        h.state = "backoff"
        h.restart_at = time.monotonic() + delay
        log.info("serve: restarting w%d in %.1fs", h.wid, delay)

    def _maybe_fire_chaos(self, now: float):
        if self.chaos is None or self.chaos_fired_t is not None:
            return
        for h in self.workers.values():
            # blocks >= 2: the previous block's async checkpoint has
            # committed, so the kill exercises RESUME (lose <= 1 block),
            # not a from-scratch replay
            if (h.state == "ready" and h.assigned
                    and h.progress_since_spawn and h.blocks >= 2):
                log.warning("serve: CHAOS %s on worker w%d (pid=%s)",
                            self.chaos, h.wid, h.pid)
                self.chaos_fired_t = now
                if self.chaos == "kill":
                    self._kill(h)
                elif h.conn is not None:
                    h.conn.send({"type": "chaos", "mode": self.chaos})
                return

    # ---- the loop -------------------------------------------------------
    def prewarm(self, case: str, **req):
        """Spawn the bucket's worker, build the case and run one block
        (the kernel library built and loaded) before the first request;
        blocks until the worker reports ``prewarmed``, and raises if it
        reports a failed build. Must run before the engine loop
        starts."""
        if self._running:
            raise RuntimeError("prewarm() after the engine loop started")
        req = {"case": case,
               **{k: v for k, v in req.items() if v is not None}}
        h = self._ensure_worker(request_key(req), worker_tag(req))
        sent = False
        deadline = time.monotonic() + self.spawn_timeout_s + 600.0
        while time.monotonic() < deadline:
            for wh, f in self._drain_wframes():
                self._handle_worker_frame(wh, f)
            if h.state == "ready" and not sent:
                h.conn.send({"type": "prewarm", "req": req})
                sent = True
            if self._prewarm_ok.is_set():
                log.info("serve: prewarmed %s on w%d", case, h.wid)
                return
            if self._prewarm_err is not None:
                raise RuntimeError(
                    f"prewarm of {case} failed: {self._prewarm_err}")
            if not h.alive_proc and h.state != "ready":
                raise RuntimeError(
                    f"prewarm worker for {case} died during startup")
            with self.cond:
                self.cond.wait(timeout=0.1)
        raise RuntimeError(f"prewarm of {case} timed out")

    def _tick(self):
        frames = self._drain_wframes()
        for h, f in frames:
            self._handle_worker_frame(h, f)
        with self.cond:
            queued = list(self.pending)
        for p in queued:
            try:
                left = self._route(p)
            except Exception:  # noqa: BLE001 - routing must not kill the loop
                log.exception("serve: routing failed")
                p.reply({"type": "error", "reason": "build_failed",
                         "detail": "request routing failed"})
                p.conn.close()
                left = True
            if left:
                with self.cond:
                    try:
                        self.pending.remove(p)
                    except ValueError:
                        pass
        self._supervise()
        if self.hb is not None:
            self.hb.beat(self.completed)
        now = time.monotonic()
        for rid, p in list(self.inflight.items()):
            if p.deadline is not None and now > p.deadline:
                p.reply({"type": "timeout",
                         "deadline_s": p.req["deadline_s"],
                         "steps_done": p.steps})
                h = self.workers.get(p.wkey)
                if h is not None:
                    self._retire(h, p, discard=True)
                else:
                    p.conn.close()
                    self.inflight.pop(rid, None)
        if not frames:
            with self.cond:
                if (not self.pending and not self._wframes
                        and not self.draining.is_set()):
                    self.cond.wait(timeout=0.05)

    # ---- drain ----------------------------------------------------------
    def _drain(self):
        log.warning("serve: draining (%d in-flight, %d queued, %d "
                    "workers)", len(self.inflight), len(self.pending),
                    len(self.workers))
        for h in self.workers.values():
            if h.state == "ready" and h.conn is not None:
                h.conn.send({"type": "drain"})
        deadline = time.monotonic() + self.drain_timeout_s
        while time.monotonic() < deadline:
            for h, f in self._drain_wframes():
                self._handle_worker_frame(h, f)
            busy = [h for h in self.workers.values()
                    if h.state == "ready" and h.assigned
                    and h.alive_proc]
            if not busy:
                break
            with self.cond:
                self.cond.wait(timeout=0.1)
        # every in-flight request gets its token: the lane checkpoints
        # are already on disk (continuous per-block saves), with the
        # drain's final save on top where the worker answered in time
        for rid, p in list(self.inflight.items()):
            h = self.workers.get(p.wkey)
            steps = p.steps
            if h is not None and h.drained_steps is not None:
                steps = h.drained_steps.get(rid, steps)
            p.reply({"type": "retry_after", "token": p.token,
                     "steps_done": int(steps), "nsteps": p.nsteps})
            p.conn.close()
        self.inflight.clear()
        with self.cond:
            queued, self.pending = list(self.pending), deque()
        for p in queued:
            p.reply({"type": "retry_after", "token": None,
                     "detail": "server is draining; resubmit"})
            p.conn.close()
        if self.hb is not None:
            self.hb.clear()

    def _shutdown(self):
        try:
            self.ipc_sock.close()
        except OSError:
            pass
        for h in self.workers.values():
            if h.alive_proc:
                try:
                    h.proc.terminate()
                except OSError:
                    pass
        for h in self.workers.values():
            if h.proc is not None:
                try:
                    h.proc.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    self._kill(h)
