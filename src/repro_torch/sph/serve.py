"""Online simulation service: live-batch admission over a socket.

Port of ``repro.sph.serve``. ``python -m repro_torch.sph serve`` turns
the ensemble engine into an always-on endpoint: clients submit
case+parameter requests over a length-prefixed JSON protocol, the
server bins them into normalized-config shape buckets, and each bucket
is a live :class:`LaneEngine` batch — free lanes sit masked-inactive,
an admitted request warm-starts its lane at the next block boundary,
and completion/divergence/timeout frees the slot the same way. On the
kernel backend a batched step of a bucket is one K1 and one K2 launch
for every tenant of the bucket.

Wire protocol (stdlib only, byte-compatible with the JAX package's
client and server): each frame is a 4-byte big-endian length followed
by that many bytes of UTF-8 JSON. One request per connection; the
server streams reply frames (ACCEPTED, then OBS/EVENT per block, then
one terminal DONE / DIVERGED / TIMEOUT / RETRY_AFTER / REJECTED / ERROR
frame) and closes.

Request fields (all optional unless noted):
  op            "run" (default) | "stats"
  case          registered case name (required for "run")
  n | ds        resolution (target fluid count, or spacing directly)
  nsteps        steps to advance (default: the case's default_nsteps;
                rounded UP to whole engine blocks)
  overrides     dict of case-field overrides (build_case kwargs)
  backend       "reference" | "xla" | "kernel"; "pallas" (the JAX
                package's name) is taken as "kernel"
  records       "fp32" | "fp16" | "bf16"
  observe       bool: stream an OBS frame per completed block
  deadline_s    wall-clock budget from receipt; exceeded -> TIMEOUT
  inject        {"kind": "nan"|"teleport", "step": int?} fault injection
                (treated as client poison: the disarm rung is skipped,
                so an unrecoverable injection ends in DIVERGED)
  return_state  bool: DONE carries the final state as base64 npz
                (bit-exact; keys, dtypes and bytes as the JAX server's)
  resume_token  token from a RETRY_AFTER reply: resume drained work
  request_id    opaque, echoed on every reply frame

ACCEPTED also carries ``resumed`` (true for a lane admitted from a
resume token), as the JAX frontend's does; a JAX client ignores it.

Robustness semantics:
  * bounded admission queue — a full queue answers REJECTED busy
    immediately (load-shedding, never unbounded growth);
  * malformed frames answer ERROR malformed (structural validation in
    the reader thread; nothing malformed reaches the engine thread);
  * a poisoned request runs the ladder's masked rungs on its own lane
    and dies with a structured DIVERGED reply — healthy in-flight
    requests stay bit-identical to solo runs;
  * per-request deadlines cancel overdue lanes with a TIMEOUT reply;
  * SIGTERM/SIGINT drains gracefully: stop admitting, checkpoint every
    in-flight lane via :class:`CheckpointManager`, reply RETRY_AFTER
    with a resume token honored after restart (queued-but-unadmitted
    requests get RETRY_AFTER with token=null: resubmit). A token names
    this package's checkpoint payload; a JAX server's token is not
    honored here, nor the reverse.

Threading: the accept thread and per-connection reader threads do ONLY
socket IO + structural validation; a single engine thread owns every
torch call (case building, admission splices, block stepping, the host
copies of ``encode_state``), so device state is never touched
concurrently.
"""
from __future__ import annotations

import base64
import dataclasses
import hashlib
import io
import json
import logging
import os
import secrets
import shutil
import socket
import struct
import threading
import time
from collections import deque

import numpy as np
import torch

from repro_torch.checkpoint import manager as ckpt
from repro_torch.core import cases as cases_lib
from repro_torch.core import ensemble, health, recovery, solver
from repro_torch.core.api import Simulation
from repro_torch.core.precision import PrecisionPolicy
from repro_torch.runtime.fault_tolerance import (
    HeartbeatMonitor,
    HeartbeatWriter,
    StragglerWatchdog,
)

log = logging.getLogger("repro_torch.serve")

MAX_FRAME = 64 << 20  # 64 MiB: a return_state reply at ~1M particles
_LEN = struct.Struct(">I")


# --------------------------------------------------------------------------
# Framing (shared with sph/client.py)
# --------------------------------------------------------------------------
def send_frame(sock: socket.socket, obj: dict):
    payload = json.dumps(obj).encode()
    sock.sendall(_LEN.pack(len(payload)) + payload)


def _recv_exact(sock: socket.socket, n: int) -> bytes | None:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(min(n - len(buf), 1 << 20))
        if not chunk:
            return None
        buf += chunk
    return bytes(buf)


def recv_frame(sock: socket.socket, max_frame: int = MAX_FRAME):
    """One frame, parsed; None on clean EOF. Raises ValueError on an
    oversized or non-JSON frame (protocol violation, not EOF)."""
    head = _recv_exact(sock, _LEN.size)
    if head is None:
        return None
    (n,) = _LEN.unpack(head)
    if n > max_frame:
        raise ValueError(f"frame of {n} bytes exceeds cap {max_frame}")
    body = _recv_exact(sock, n)
    if body is None:
        raise ValueError("connection closed mid-frame")
    try:
        return json.loads(body.decode())
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ValueError(f"frame is not JSON: {e}") from e


def _host(v) -> np.ndarray:
    """A host array of one state leaf in its own dtype. A bf16 tensor
    travels as its raw 16-bit words under numpy's ``|V2``, which is what
    ``np.savez`` makes of the JAX package's bf16 arrays."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        if v.dtype == torch.bfloat16:
            return v.view(torch.int16).numpy().view("V2")
        return v.numpy()
    return np.asarray(v)


def state_arrays(state) -> dict:
    """Flat {path: host array} of an SPHState under the JAX package's
    paths (``xn``, ``rc/cell_xy``, ``rc/rel``, ``fluid/v``, ...), each
    array in its own dtype: what :func:`encode_state` ships."""
    return {k: _host(v) for k, v in ckpt._flatten(state).items()}


def encode_state(state) -> str:
    """Final SPHState -> base64 npz of its flat arrays (bit-exact)."""
    bio = io.BytesIO()
    np.savez(bio, **state_arrays(state))
    return base64.b64encode(bio.getvalue()).decode()


def decode_state(blob: str) -> dict:
    """Base64 npz -> flat {path: array} dict (client side)."""
    with np.load(io.BytesIO(base64.b64decode(blob))) as z:
        return {k: z[k] for k in z.files}


# --------------------------------------------------------------------------
# Request plumbing
# --------------------------------------------------------------------------
_INJECT_KINDS = ("nan", "teleport")


def build_overrides(req: dict) -> dict:
    """Request fields -> ``build_case`` override kwargs. Numpy-only
    (``resolve_ds`` builds no tensor), so the multi-process frontend can
    normalize and route requests without touching a device. The JAX
    package's backend name ``"pallas"`` becomes the port's ``"kernel"``."""
    over = dict(req.get("overrides") or {})
    if req.get("ds") is not None:
        over["ds"] = float(req["ds"])
    elif req.get("n") is not None:
        over["ds"] = cases_lib.resolve_ds(req["case"], int(req["n"]))
    if req.get("backend") is not None:
        over["backend"] = req["backend"]
    if over.get("backend") == "pallas":
        over["backend"] = "kernel"
    if req.get("records") is not None:
        over["policy"] = PrecisionPolicy(records=req["records"])
    return over


def request_key(req: dict) -> str:
    """Canonical build/routing key: two requests with the same key
    build byte-identical configs, so they share a build cache entry
    (in-process) or an engine-worker process (multi-process)."""
    over = build_overrides(req)
    return json.dumps({"case": req["case"],
                       "over": {k: repr(v) for k, v in over.items()}},
                      sort_keys=True)


def worker_tag(req: dict) -> str:
    """Filesystem-safe name for the engine worker owning a request's
    shape bucket (stable across frontend restarts: resume tokens are
    located by scanning ``workers/<tag>/lanes/<token>``)."""
    digest = hashlib.sha1(request_key(req).encode()).hexdigest()[:10]
    return f"{req['case']}-{digest}"


def build_request(req: dict, cache: dict, device=None):
    """Case -> (cfg, state, default_nsteps) on ``device`` (CUDA when
    None; raises without it), memoized on :func:`request_key`: repeated
    requests for the same (case, resolution, overrides) reuse the built
    tensors instead of re-running the generator."""
    key = request_key(req)
    if key not in cache:
        sim = Simulation.from_case(req["case"], device=device,
                                   **build_overrides(req))
        cache[key] = (sim.cfg, sim.state,
                      int(getattr(sim.case, "default_nsteps", 400)))
    return cache[key]


def validate_request(req) -> str | None:
    """Structural validation (reader thread — never touches a tensor).
    Returns an error string for a malformed request, else None."""
    if not isinstance(req, dict):
        return "request frame must be a JSON object"
    op = req.get("op", "run")
    if op == "stats":
        return None
    if op != "run":
        return f"unknown op {op!r}"
    if "resume_token" in req:
        tok = req["resume_token"]
        if not isinstance(tok, str) or not tok or "/" in tok or "." in tok:
            return "resume_token must be an opaque token string"
        return None
    case = req.get("case")
    if not isinstance(case, str) or case not in cases_lib.case_names():
        return (f"unknown case {case!r}; one of "
                f"{', '.join(cases_lib.case_names())}")
    for key, typ in (("n", (int,)), ("ds", (int, float)),
                     ("nsteps", (int,)), ("deadline_s", (int, float))):
        if req.get(key) is not None and not isinstance(req[key], typ):
            return f"{key} must be {typ[0].__name__}"
    if req.get("nsteps") is not None and req["nsteps"] < 1:
        return "nsteps must be >= 1"
    if req.get("overrides") is not None and not isinstance(
            req["overrides"], dict):
        return "overrides must be an object"
    inject = req.get("inject")
    if inject is not None:
        if (not isinstance(inject, dict)
                or inject.get("kind") not in _INJECT_KINDS):
            return (f"inject wants {{'kind': one of {_INJECT_KINDS}, "
                    "'step': int?}")
        if inject.get("step") is not None and not isinstance(
                inject["step"], int):
            return "inject.step must be int"
    return None


def lane_fault(cfg, inject: dict | None, nsteps: int, n: int):
    """The FaultSpec a request's ``inject`` arms (None without one)."""
    if inject is None:
        return None
    fault = recovery.apply_named_fault(cfg, inject["kind"], nsteps, n).fault
    if inject.get("step") is not None:
        fault = dataclasses.replace(fault, step=int(inject["step"]))
    return fault


@dataclasses.dataclass
class _Pending:
    """One validated in-flight request."""

    conn: "_Conn"
    req: dict
    received: float
    lane: int | None = None
    bucket: tuple | None = None
    nsteps: int = 0
    observe: bool = False
    return_state: bool = False
    deadline: float | None = None
    meta: dict | None = None  # resume meta (dt_scale, halvings, ...)
    # multi-process routing state (FrontendServer only)
    rid: str | None = None
    token: str | None = None
    wkey: str | None = None
    steps: int = 0
    recovering: bool = False
    recovered: bool = False

    def reply(self, obj: dict) -> bool:
        if "request_id" in self.req:
            obj = {**obj, "request_id": self.req["request_id"]}
        return self.conn.send(obj)


class _Conn:
    """Socket + write lock (reader thread and engine thread both send)."""

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self._wlock = threading.Lock()

    def send(self, obj: dict) -> bool:
        with self._wlock:
            try:
                send_frame(self.sock, obj)
                return True
            except OSError:
                return False

    def close(self):
        try:
            self.sock.close()
        except OSError:
            pass


# --------------------------------------------------------------------------
# The servers
# --------------------------------------------------------------------------
class ServerBase:
    """Shared socket plumbing for the serving processes.

    Owns the listener + accept thread, per-connection reader threads
    (socket IO + structural validation ONLY), the bounded admission
    queue, and the heartbeat/drain lifecycle. Subclasses implement one
    scheduling round (``_tick``), graceful shutdown (``_drain``), and
    the monitoring hooks (``_live_steps`` / ``_extra_stats``):
    :class:`SimServer` runs the engines in-process; the multi-process
    :class:`repro_torch.sph.supervisor.FrontendServer` routes to
    per-bucket engine-worker processes.
    """

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 0,
        *,
        queue: int = 32,
        checkpoint_dir: str | None = None,
        heartbeat_timeout_s: float = 60.0,
    ):
        self.queue_cap = int(queue)
        self.ckdir = checkpoint_dir
        self.pending: deque[_Pending] = deque()
        self.cond = threading.Condition()
        self.draining = threading.Event()
        self.stopped = threading.Event()
        self._thread: threading.Thread | None = None
        self._running = False
        self.completed = 0
        self.rejected = 0
        self.predecessor: str | None = None
        self.hb: HeartbeatWriter | None = None
        self.watchdog = StragglerWatchdog()
        if self.ckdir:
            os.makedirs(self.ckdir, exist_ok=True)
            status = HeartbeatMonitor(
                self.ckdir, timeout_s=heartbeat_timeout_s).host_status(0)
            if status == "dead":
                self.predecessor = "dead"
                log.warning(
                    "serve: stale heartbeat in %s — the previous server "
                    "process died without draining; drained tokens (if "
                    "any) are still honored", self.ckdir)
            elif status == "absent" and self._has_resumables():
                self.predecessor = "clean"
            self.hb = HeartbeatWriter(self.ckdir, 0)
        self.lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.lsock.bind((host, port))
        self.lsock.listen(128)
        self.host, self.port = self.lsock.getsockname()
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True)
        self._accept_thread.start()

    def _has_resumables(self) -> bool:
        """Do resume tokens from a previous (clean) run exist?"""
        return os.path.isdir(os.path.join(self.ckdir, "drain"))

    # ---- socket side (reader threads) ---------------------------------
    def _accept_loop(self):
        while not self.stopped.is_set():
            try:
                sock, _ = self.lsock.accept()
            except OSError:
                return  # listener closed during drain
            threading.Thread(
                target=self._reader, args=(_Conn(sock),),
                daemon=True).start()

    def _reader(self, conn: _Conn):
        try:
            try:
                req = recv_frame(conn.sock)
            except ValueError as e:
                conn.send({"type": "error", "reason": "malformed",
                           "detail": str(e)})
                return
            if req is None:
                return
            err = validate_request(req)
            rid = req.get("request_id") if isinstance(req, dict) else None
            if err is not None:
                reply = {"type": "error", "reason": "malformed",
                         "detail": err}
                if rid is not None:
                    reply["request_id"] = rid
                conn.send(reply)
                return
            if req.get("op") == "stats":
                conn.send({"type": "stats", **self.stats()})
                return
            p = _Pending(conn=conn, req=req, received=time.monotonic())
            with self.cond:
                if self.draining.is_set():
                    p.reply({"type": "retry_after", "token": None,
                             "detail": "server is draining"})
                    return
                if len(self.pending) >= self.queue_cap:
                    self.rejected += 1
                    p.reply({"type": "rejected", "reason": "busy",
                             "queue": self.queue_cap})
                    return
                self.pending.append(p)
                self.cond.notify()
            conn = None  # ownership passed to the engine thread
        finally:
            if conn is not None:
                conn.close()

    def stats(self) -> dict:
        out = {
            "queue": len(self.pending),
            # per-live-lane step counts at the last healthy boundary
            # (reader-thread read of host state: monitoring only)
            "live_steps": self._live_steps(),
            "queue_cap": self.queue_cap,
            "completed": self.completed,
            "rejected": self.rejected,
            "draining": self.draining.is_set(),
            "predecessor": self.predecessor,
        }
        out.update(self._extra_stats())
        return out

    def _live_steps(self) -> list[int]:
        return []

    def _extra_stats(self) -> dict:
        return {}

    # ---- the loop (shared skeleton) ------------------------------------
    def request_drain(self):
        """Programmatic SIGTERM equivalent (tests, embedders)."""
        self.draining.set()
        with self.cond:
            self.cond.notify()

    def start(self):
        self._thread = threading.Thread(
            target=self.serve_forever, daemon=True)
        self._thread.start()
        return self

    def join(self, timeout: float | None = None):
        if self._thread is not None:
            self._thread.join(timeout)

    def serve_forever(self):
        self._running = True
        try:
            while not self.draining.is_set():
                try:
                    self._tick()
                except Exception:  # noqa: BLE001
                    # an engine bug (or a failed kernel launch) must not
                    # strand every connected client on a dead socket:
                    # log, then best-effort drain (checkpoint +
                    # RETRY_AFTER where possible)
                    log.exception("serve: engine tick failed — draining")
                    self.draining.set()
            self._drain()
        finally:
            self.stopped.set()
            try:
                self.lsock.close()
            except OSError:
                pass
            self._shutdown()

    def _shutdown(self):
        """Post-drain cleanup hook (the frontend reaps its workers)."""

    def _tick(self):
        raise NotImplementedError

    def _drain(self):
        raise NotImplementedError


class SimServer(ServerBase):
    """Live-batch SPH service with every engine in-process.

    ``serve_forever()`` runs the engine loop on the CALLING thread (the
    CLI runs it on the main thread so SIGTERM/SIGINT handlers can
    trigger the drain); ``start()`` spawns it on a daemon thread for
    in-process use (tests, the smoke). ``device`` is where every bucket
    lives: CUDA when None (raises without it), as every entry point of
    the port.
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
        device=None,
    ):
        self.device = solver.resolve_device(device)
        self.policy = policy or recovery.GuardPolicy()
        self.slots = int(slots)
        self.buckets: dict[tuple, ensemble.LaneEngine] = {}
        self.live: dict[tuple, _Pending] = {}  # (bucket, lane) -> req
        self._build_cache: dict[str, tuple] = {}
        super().__init__(host, port, queue=queue,
                         checkpoint_dir=checkpoint_dir,
                         heartbeat_timeout_s=heartbeat_timeout_s)
        log.info("serve: listening on %s:%d (slots=%d queue=%d block=%d "
                 "device=%s)", self.host, self.port, self.slots,
                 self.queue_cap, self.policy.block, self.device)

    def _live_steps(self) -> list[int]:
        return sorted(
            int(self.buckets[k].snap_steps[lane])
            for (k, lane) in list(self.live))

    def _extra_stats(self) -> dict:
        return {"live": len(self.live), "buckets": len(self.buckets)}

    # ---- engine side (single thread owns all torch work) ---------------
    def _build(self, req: dict):
        return build_request(req, self._build_cache, self.device)

    def _blocks_of(self, nsteps: int) -> int:
        """Targets are whole blocks: the engine advances every lane in
        lockstep block strides, so a request's step count rounds UP."""
        block = max(1, self.policy.block)
        return -(-int(nsteps) // block) * block

    def _bucket_for(self, cfg, n: int) -> tuple:
        key = (ensemble.member_config(cfg, self.policy), n)
        if key not in self.buckets:
            self.buckets[key] = ensemble.LaneEngine(
                cfg, self.slots, policy=self.policy, device=self.device)
            log.info("serve: new shape bucket n=%d (total %d)",
                     n, len(self.buckets))
        return key

    def _admit(self, p: _Pending) -> bool:
        """Admit one queued request. True if it left the queue (admitted
        or terminally answered); False to retry next loop (EngineFull /
        FaultBusy backpressure)."""
        try:
            if "resume_token" in p.req:
                return self._admit_resume(p)
            cfg, state, default_nsteps = self._build(p.req)
            nsteps = self._blocks_of(p.req.get("nsteps") or default_nsteps)
            n = int(state.xn.shape[0])
            fault = lane_fault(cfg, p.req.get("inject"), nsteps, n)
            key = self._bucket_for(cfg, n)
            lane = self.buckets[key].admit(
                state, nsteps, fault=fault,
                disarmable=fault is None)
        except (ensemble.EngineFull, ensemble.FaultBusy):
            return False  # backpressure: stays queued
        except ensemble.AdmissionError as e:
            p.reply({"type": "diverged", "step": 0, "checks": list(e.checks),
                     "stats": e.stats, "events": [],
                     "detail": "failed init-time health checks"})
            p.conn.close()
            return True
        except Exception as e:  # noqa: BLE001 - a bad build must not kill the loop
            log.exception("serve: request build failed")
            p.reply({"type": "error", "reason": "build_failed",
                     "detail": f"{type(e).__name__}: {e}"})
            p.conn.close()
            return True
        self._register(p, key, lane, nsteps)
        return True

    def _register(self, p: _Pending, key, lane: int, nsteps: int,
                  resumed: bool = False):
        p.bucket, p.lane, p.nsteps = key, lane, nsteps
        p.observe = bool(p.req.get("observe"))
        p.return_state = bool(p.req.get("return_state"))
        if p.req.get("deadline_s") is not None:
            p.deadline = p.received + float(p.req["deadline_s"])
        self.live[(key, lane)] = p
        p.reply({"type": "accepted", "lane": lane, "nsteps": nsteps,
                 "block": self.policy.block, "bucket": f"n{key[1]}",
                 "resumed": resumed})

    # ---- drain / resume -------------------------------------------------
    def _drain_dir(self, token: str) -> str:
        return os.path.join(self.ckdir, "drain", token)

    def _admit_resume(self, p: _Pending) -> bool:
        token = p.req["resume_token"]
        if not self.ckdir:
            p.reply({"type": "error", "reason": "bad_token",
                     "detail": "server has no checkpoint directory"})
            p.conn.close()
            return True
        tdir = self._drain_dir(token)
        try:
            with open(os.path.join(tdir, "token.json")) as f:
                saved = json.load(f)
        except (OSError, json.JSONDecodeError):
            p.reply({"type": "error", "reason": "bad_token",
                     "detail": f"unknown or corrupt resume token {token!r}"})
            p.conn.close()
            return True
        req, meta = saved["request"], saved["meta"]
        cfg, state, _ = self._build(req)
        key = self._bucket_for(cfg, int(state.xn.shape[0]))
        engine = self.buckets[key]
        template = {"carry": solver.init_persistent(engine.cfg, state)}
        mgr = ckpt.CheckpointManager(tdir, keep=0)
        try:
            tree, step = mgr.restore(template)
        finally:
            mgr.close()
        if tree is None:
            p.reply({"type": "error", "reason": "bad_token",
                     "detail": f"resume token {token!r} has no valid "
                     "checkpoint"})
            p.conn.close()
            return True
        try:
            lane = engine.admit(
                None, meta["target"], carry_row=tree["carry"],
                steps_done=meta["steps_done"],
                dt_scale=meta["dt_scale"], halvings=meta["halvings"],
                disarmable=meta.get("disarmable", True))
        except (ensemble.EngineFull, ensemble.FaultBusy):
            return False
        # merge the original run flags (observe/return_state/deadline
        # restart from the resubmission)
        p.req = {**req, **p.req}
        self._register(p, key, lane, meta["target"], resumed=True)
        shutil.rmtree(tdir, ignore_errors=True)
        return True

    def _drain(self):
        """Checkpoint every live lane, hand out resume tokens, flush
        the queue with token-less RETRY_AFTER, stop listening."""
        log.warning("serve: draining (%d live, %d queued)",
                    len(self.live), len(self.pending))
        for (key, lane), p in sorted(self.live.items()):
            token = None
            if self.ckdir:
                token = secrets.token_hex(8)
                row, meta = self.buckets[key].lane_snapshot(lane)
                tdir = self._drain_dir(token)
                mgr = ckpt.CheckpointManager(tdir, keep=1)
                try:
                    mgr.save(meta["steps_done"], {"carry": row})
                finally:
                    mgr.close()
                clean_req = {k: v for k, v in p.req.items()
                             if k != "resume_token"}
                with open(os.path.join(tdir, "token.json"), "w") as f:
                    json.dump({"request": clean_req, "meta": meta}, f)
            p.reply({"type": "retry_after", "token": token,
                     "steps_done": int(self.buckets[key].snap_steps[lane]),
                     "nsteps": p.nsteps})
            p.conn.close()
            self.buckets[key].retire(lane)
        self.live.clear()
        with self.cond:
            queued, self.pending = list(self.pending), deque()
        for p in queued:
            p.reply({"type": "retry_after", "token": None,
                     "detail": "server is draining; resubmit"})
            p.conn.close()
        if self.hb is not None:
            self.hb.clear()  # clean shutdown: no stale-heartbeat ghost

    def prewarm(self, case: str, **req):
        """Build a case and run one throwaway lane to completion, so the
        kernel library is built and loaded (and the allocator warm)
        before the first real request.

        Must run BEFORE the engine loop starts (call it between
        construction and ``start()``/``serve_forever()``): the engine
        thread owns every bucket's batch carry once it is running."""
        if self._running:
            raise RuntimeError("prewarm() after the engine loop started "
                               "would race the engine thread")
        cfg, state, _ = self._build({"case": case, **req})
        key = self._bucket_for(cfg, int(state.xn.shape[0]))
        engine = self.buckets[key]
        lane = engine.admit(state, max(1, self.policy.block))
        for _ in range(64):
            if any(e.lane == lane and e.kind in ("done", "diverged")
                   for e in engine.step_block()):
                break
        log.info("serve: prewarmed %s (n=%d)", case, key[1])

    def _tick(self):
        # 1) admit from the queue (FIFO per bucket; a full bucket does
        #    not head-of-line-block a different bucket's requests)
        with self.cond:
            queued = list(self.pending)
        for p in queued:
            if self._admit(p):
                with self.cond:
                    try:
                        self.pending.remove(p)
                    except ValueError:
                        pass
        # 2) one block per bucket with live lanes
        worked = False
        for key, engine in list(self.buckets.items()):
            if not engine.live_lanes:
                continue
            worked = True
            t0 = time.perf_counter()
            events = engine.step_block()
            slow = self.watchdog.observe(time.perf_counter() - t0)
            if slow:
                log.warning("serve: straggler block on bucket n=%d "
                            "(flagged=%s)", key[1], self.watchdog.flagged)
            for ev in events:
                self._dispatch(key, ev)
        if self.hb is not None:
            self.hb.beat(self.completed)
        # 3) deadlines
        now = time.monotonic()
        for (key, lane), p in list(self.live.items()):
            if p.deadline is not None and now > p.deadline:
                p.reply({"type": "timeout",
                         "deadline_s": p.req["deadline_s"],
                         "steps_done": int(
                             self.buckets[key].snap_steps[lane])})
                p.conn.close()
                self.buckets[key].retire(lane)
                del self.live[(key, lane)]
        if not worked:
            with self.cond:
                if not self.pending and not self.draining.is_set():
                    self.cond.wait(timeout=0.05)

    def _dispatch(self, key, ev: ensemble.LaneEvent):
        p = self.live.get((key, ev.lane))
        if p is None:
            return  # prewarm lane, or client already cancelled
        if ev.kind == "obs":
            if p.observe and not p.reply(
                    {"type": "obs", "step": ev.step, **ev.obs}):
                # client hung up mid-stream: free the lane (host flags
                # only; no tensor is touched)
                self.buckets[key].retire(ev.lane)
                del self.live[(key, ev.lane)]
            return
        if ev.kind == "recovered":
            p.reply({"type": "event", "action": ev.action,
                     "step": ev.step,
                     "checks": list(health.check_names(ev.word))})
            return
        if ev.kind == "done":
            reply = {"type": "done", "steps": ev.step, "obs": ev.obs,
                     "events": [e.to_json() for e in ev.events or []]}
            if p.return_state:
                reply["state_npz"] = encode_state(ev.state)
            p.reply(reply)
            self.completed += 1
        elif ev.kind == "diverged":
            p.reply({"type": "diverged", "step": ev.step,
                     "checks": list(ev.checks), "stats": ev.stats,
                     "detail": ev.detail,
                     "events": [e.to_json() for e in ev.events or []]})
        p.conn.close()
        del self.live[(key, ev.lane)]
