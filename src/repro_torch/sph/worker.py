"""Engine-worker process: one shape bucket's :class:`LaneEngine` behind
a local IPC channel.

Port of ``repro.sph.worker``. ``python -m repro_torch.sph.worker`` is
spawned by the multi-process frontend (:mod:`repro_torch.sph.supervisor`),
connects BACK to the frontend's IPC listener, authenticates with a
one-shot secret, and then serves admit / retire / drain / chaos commands
over the same length-prefixed frame protocol clients speak. The worker
owns its own CUDA context (and loads the kernel library into it), its
own checkpoint directory (``<root>/workers/<tag>/``) with the ``.lock``
exclusivity file, and its own :class:`HeartbeatWriter` — so a native
crash (a CUDA fault, an OOM kill, a wedged launch) takes down ONE shape
bucket while the frontend and every sibling bucket keep streaming.

``--device`` names the worker's device (CUDA by default; ``cpu`` runs
the plain versions, for tests). A request whose case cannot be built
there — no CUDA, a kernel library that fails to build — is answered
``ERROR build_failed``; the worker never carries on through another
device or a plain version on its own.

Crash containment contract:
  * every live lane is checkpointed at every healthy block boundary
    (``LaneEngine.take_dirty`` + :class:`CheckpointManager` under
    ``lanes/<token>/``), so a SIGKILL loses at most ``save_every``
    blocks of progress;
  * checkpoints are written BEFORE the block's frames are streamed — a
    kill between save and send re-delivers a block after restart
    (client-visible duplicate/gap in OBS), but acknowledged progress is
    never lost and the final state is bit-identical either way;
  * an admit for a token whose lane directory already holds a committed
    checkpoint RESUMES it (splice + replay, the drain path) — fresh
    admission, supervisor re-admission after a crash, and client
    ``resume_token`` resubmission are the same code path;
  * the heartbeat is written from a dedicated thread, so a wedged main
    loop (chaos ``hang``, a stuck native call) still beats — that is
    exactly the "heartbeat alive but no block progress" state the
    supervisor's hang watchdog SIGKILLs. The first beat is written before
    the hello: a restarted worker's directory still holds its killed
    predecessor's file, which is stale once a spawn takes longer than
    the frontend's heartbeat timeout (a CUDA context takes seconds);
  * after a crash restart, dead-pid locks are reclaimed QUIETLY
    (``quiet_reclaim``) and reported as one summary line, not one
    warning per resumed lane.

Worker frames (worker -> frontend), all rid-tagged where relevant:
  hello {wid, secret, pid}      authentication, sent once on connect
  accepted {rid, lane, nsteps, steps_done, resumed}
  busy {rid}                    EngineFull/FaultBusy: frontend requeues
  obs / event / done / diverged / error   relayed to the client
  progress {blocks, steps, save_ms}  per engine tick: the hang-watchdog
                                food; save_ms is the ms the loop spent
                                on lane checkpoints in the last tick
                                that saved one
  drained {steps}               final checkpoints committed; exiting
  prewarmed {}                  first block finished (serve CLI startup)
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import shutil
import socket
import sys
import threading
import time
from collections import deque

import numpy as np

from repro_torch.checkpoint import manager as ckpt
from repro_torch.core import ensemble, health, recovery, solver
from repro_torch.runtime.fault_tolerance import HeartbeatWriter
from repro_torch.sph import serve

log = logging.getLogger("repro_torch.worker")


def _meta_tree(meta: dict) -> dict:
    """Lane ladder meta -> numpy scalars stored INSIDE the checkpoint
    tree: atomic with the carry row (no token.json/save race)."""
    return {
        "steps_done": np.array(meta["steps_done"], np.int64),
        "target": np.array(meta["target"], np.int64),
        "dt_scale": np.array(meta["dt_scale"], np.float32),
        "halvings": np.array(meta["halvings"], np.int32),
        "armed": np.array(meta["armed"], bool),
        "disarmable": np.array(meta["disarmable"], bool),
    }


def _meta_template() -> dict:
    return {
        "steps_done": np.zeros((), np.int64),
        "target": np.zeros((), np.int64),
        "dt_scale": np.zeros((), np.float32),
        "halvings": np.zeros((), np.int32),
        "armed": np.zeros((), bool),
        "disarmable": np.zeros((), bool),
    }


class EngineWorker:
    """The worker's engine loop: a single thread owns every torch call."""

    def __init__(self, chan: serve._Conn, wdir: str, *, slots: int,
                 policy: recovery.GuardPolicy, save_every: int = 1,
                 hb_interval_s: float = 0.5, device=None):
        self.chan = chan
        self.wdir = wdir
        self.slots = int(slots)
        self.policy = policy
        self.save_every = max(1, int(save_every))
        self.device = device  # resolved at the first build (CUDA if None)
        self.cmds: deque[dict] = deque()
        self.wake = threading.Event()
        self.eof = threading.Event()
        self.stop = False
        self.hang = False
        self.oom_at_next_block = False
        self.build_cache: dict[str, tuple] = {}
        self.engines: dict[tuple, ensemble.LaneEngine] = {}
        self.live: dict[str, dict] = {}       # rid -> record
        self.lane_rid: dict[tuple, str] = {}  # (key, lane) -> rid
        self.blocks = 0
        self.save_ms = 0.0  # lane-checkpoint ms of the last tick that saved
        os.makedirs(wdir, exist_ok=True)
        # the worker-dir lock: one engine process per bucket directory
        self.dirlock = ckpt.CheckpointManager(wdir, keep=0,
                                              quiet_reclaim=True)
        self.reclaimed = ([self.dirlock.reclaimed_from]
                          if self.dirlock.reclaimed_from is not None
                          else [])
        self.hb = HeartbeatWriter(wdir, 0)
        # a fresh beat before the frontend hears from this process: the
        # file may still be a SIGKILLed predecessor's, stale by the time a
        # restart is up (ROADMAP Queue 3 entry H)
        self.hb.beat(self.blocks)
        self._hb_interval = float(hb_interval_s)
        threading.Thread(target=self._read_loop, daemon=True).start()
        threading.Thread(target=self._beat_loop, daemon=True).start()

    # ---- background threads -------------------------------------------
    def _read_loop(self):
        try:
            while True:
                f = serve.recv_frame(self.chan.sock)
                if f is None:
                    break
                self.cmds.append(f)
                self.wake.set()
        except (ValueError, OSError):
            pass
        self.eof.set()
        self.wake.set()

    def _beat_loop(self):
        # Beats from its own thread so a wedged engine loop still looks
        # "alive" to HeartbeatMonitor — by design: process-death is the
        # heartbeat's job, hangs are the progress watchdog's.
        while not self.stop:
            self.hb.beat(self.blocks)
            time.sleep(self._hb_interval)

    # ---- the loop ------------------------------------------------------
    def run(self) -> int:
        try:
            while not self.stop:
                if self.hang:
                    time.sleep(0.2)  # chaos: wedged, heartbeat beating
                    continue
                if self.eof.is_set() and not self.cmds:
                    # frontend vanished: commit final checkpoints and
                    # exit — lanes are resumable by the next frontend
                    log.warning("worker: IPC channel closed; exiting "
                                "with %d live lane(s) checkpointed",
                                len(self.live))
                    self._final_save()
                    break
                self._handle_cmds()
                if self.stop or self.hang:
                    continue
                worked = self._step_engines()
                if not worked and not self.cmds:
                    self.wake.wait(0.05)
                    self.wake.clear()
        finally:
            self.stop = True
            self.hb.clear()
            for rec in self.live.values():
                if rec.get("mgr") is not None:
                    try:
                        rec["mgr"].close()
                    except Exception:  # noqa: BLE001 - exit path stays best-effort
                        log.exception("worker: lane manager close failed")
            self.dirlock.close()
        return 0

    def _handle_cmds(self):
        while self.cmds and not self.hang:
            c = self.cmds.popleft()
            kind = c.get("type")
            if kind == "admit":
                self._admit(c)
            elif kind == "retire":
                self._retire(c.get("rid"), remove_dir=bool(
                    c.get("discard", True)))
            elif kind == "drain":
                self._drain()
            elif kind == "chaos":
                self._chaos(c.get("mode"))
            elif kind == "prewarm":
                self._prewarm(c)
            elif kind == "ping":
                self.chan.send({"type": "pong"})
            else:
                log.warning("worker: unknown command %r", kind)

    # ---- chaos ---------------------------------------------------------
    def _chaos(self, mode: str):
        log.warning("worker: chaos %r armed", mode)
        if mode == "hang":
            # main loop wedges forever; the heartbeat thread keeps
            # beating -> only the supervisor's hang watchdog frees us
            self.hang = True
        elif mode == "oom-sim":
            # abrupt death right after the next stepped block, no
            # cleanup — the OOM-killer shape (see _step_engines)
            self.oom_at_next_block = True

    # ---- admission -----------------------------------------------------
    def _blocks_of(self, nsteps: int) -> int:
        block = max(1, self.policy.block)
        return -(-int(nsteps) // block) * block

    def _lane_dir(self, token: str) -> str:
        return os.path.join(self.wdir, "lanes", token)

    def _build(self, req: dict):
        return serve.build_request(req, self.build_cache, self.device)

    def _engine_for(self, cfg, state) -> tuple:
        n = int(state.xn.shape[0])
        key = (ensemble.member_config(cfg, self.policy), n)
        if key not in self.engines:
            self.engines[key] = ensemble.LaneEngine(
                cfg, self.slots, policy=self.policy, device=state.xn.device)
        return key

    def _admit(self, c: dict):
        rid, token, req = c["rid"], c["token"], c["req"]
        mgr = None
        try:
            cfg, state, default_nsteps = self._build(req)
            n = int(state.xn.shape[0])
            key = self._engine_for(cfg, state)
            engine = self.engines[key]
            nsteps = self._blocks_of(req.get("nsteps") or default_nsteps)
            fault = serve.lane_fault(cfg, req.get("inject"), nsteps, n)
            lane_dir = self._lane_dir(token)
            mgr = ckpt.CheckpointManager(lane_dir, keep=2,
                                         quiet_reclaim=True)
            if mgr.reclaimed_from is not None:
                self.reclaimed.append(mgr.reclaimed_from)
            template = {
                "carry": solver.init_persistent(engine.cfg, state),
                "meta": _meta_template(),
            }
            tree, _ = mgr.restore(template)
            if tree is not None:
                meta = {k: v.item() for k, v in tree["meta"].items()}
                steps_done, target = int(meta["steps_done"]), int(
                    meta["target"])
                if steps_done >= target:
                    # crashed between the final save and the DONE
                    # frame: finalize straight from the checkpoint
                    self._finalize_from_checkpoint(
                        rid, req, engine, tree, steps_done, mgr,
                        lane_dir, state.xn.device)
                    return
                lane = engine.admit(
                    None, target,
                    fault=fault if meta["armed"] else None,
                    disarmable=bool(meta["disarmable"]),
                    dt_scale=float(meta["dt_scale"]),
                    halvings=int(meta["halvings"]),
                    carry_row=tree["carry"], steps_done=steps_done)
                nsteps, resumed = target, True
            else:
                steps_done, resumed = 0, False
                lane = engine.admit(state, nsteps, fault=fault,
                                    disarmable=fault is None)
                clean_req = {k: v for k, v in req.items()
                             if k != "resume_token"}
                tmp = os.path.join(lane_dir, "token.json.tmp")
                with open(tmp, "w") as f:
                    json.dump({"request": clean_req}, f)
                os.replace(tmp, os.path.join(lane_dir, "token.json"))
        except (ensemble.EngineFull, ensemble.FaultBusy):
            if mgr is not None:
                mgr.close()
            self.chan.send({"type": "busy", "rid": rid})
            return
        except ensemble.AdmissionError as e:
            if mgr is not None:
                mgr.close()
            self.chan.send({"type": "diverged", "rid": rid, "step": 0,
                            "checks": list(e.checks), "stats": e.stats,
                            "events": [],
                            "detail": "failed init-time health checks"})
            return
        except Exception as e:  # noqa: BLE001 - a bad build must not kill the loop
            log.exception("worker: admit failed")
            if mgr is not None:
                mgr.close()
            self.chan.send({"type": "error", "rid": rid,
                            "reason": "build_failed",
                            "detail": f"{type(e).__name__}: {e}"})
            return
        self.live[rid] = {"key": key, "lane": lane, "token": token,
                          "mgr": mgr, "req": req, "target": nsteps}
        self.lane_rid[(key, lane)] = rid
        if self.reclaimed:
            pids, self.reclaimed = sorted(set(self.reclaimed)), []
            log.info("worker: reclaimed checkpoint lock(s) from dead "
                     "process(es) %s", pids)
        self.chan.send({"type": "accepted", "rid": rid, "lane": lane,
                        "nsteps": nsteps, "steps_done": steps_done,
                        "resumed": resumed})

    def _finalize_from_checkpoint(self, rid, req, engine, tree,
                                  steps_done, mgr, lane_dir, device):
        st = solver.finalize_persistent(
            engine.cfg, recovery._to_device(tree["carry"], device))
        obs = dict(zip(("t", "ekin", "vmax", "rho_err"),
                       (float(v) for v in health.observe_state(engine.cfg, st))))
        reply = {"type": "done", "rid": rid, "steps": steps_done,
                 "obs": obs, "events": []}
        if req.get("return_state"):
            reply["state_npz"] = serve.encode_state(st)
        self.chan.send(reply)
        mgr.close()
        shutil.rmtree(lane_dir, ignore_errors=True)

    def _retire(self, rid: str | None, remove_dir: bool = True):
        rec = self.live.get(rid)
        if rec is None:
            return
        self.engines[rec["key"]].retire(rec["lane"])
        self._cleanup(rid, remove_dir=remove_dir)

    def _cleanup(self, rid: str, remove_dir: bool):
        rec = self.live.pop(rid)
        self.lane_rid.pop((rec["key"], rec["lane"]), None)
        if rec["mgr"] is not None:
            rec["mgr"].close()
        if remove_dir:
            shutil.rmtree(self._lane_dir(rec["token"]),
                          ignore_errors=True)

    # ---- stepping ------------------------------------------------------
    def _step_engines(self) -> bool:
        worked = False
        save_s, saved = 0.0, 0
        for key, engine in list(self.engines.items()):
            if not engine.live_lanes:
                continue
            worked = True
            events = engine.step_block()
            self.blocks += 1
            # checkpoint BEFORE streaming: never lose acked progress
            t0 = time.perf_counter()
            saved += self._save_dirty(key, engine)
            save_s += time.perf_counter() - t0
            if self.oom_at_next_block:
                os._exit(137)
            for ev in events:
                self._dispatch(key, engine, ev)
        if saved:
            self.save_ms = 1e3 * save_s
        if worked:
            self.chan.send({
                "type": "progress", "blocks": self.blocks,
                "steps": {
                    rid: int(self.engines[r["key"]].snap_steps[r["lane"]])
                    for rid, r in self.live.items()},
                "save_ms": self.save_ms,
            })
        return worked

    def _save_dirty(self, key, engine, force: bool = False) -> int:
        """Checkpoint the engine's dirty lanes; returns how many were saved
        (the host copy of each row, after the lane's previous async
        write has finished)."""
        if not force and engine.blocks % self.save_every:
            return 0  # dirt accumulates; drained at the next save block
        saved = 0
        for lane in engine.take_dirty():
            rid = self.lane_rid.get((key, lane))
            rec = self.live.get(rid) if rid is not None else None
            if rec is None or rec["mgr"] is None:
                continue  # prewarm lane: nothing to persist
            row, meta = engine.lane_snapshot(lane)
            rec["mgr"].save(int(meta["steps_done"]),
                            {"carry": row, "meta": _meta_tree(meta)},
                            blocking=False)
            saved += 1
        return saved

    def _dispatch(self, key, engine, ev: ensemble.LaneEvent):
        rid = self.lane_rid.get((key, ev.lane))
        if rid is None:
            return  # prewarm lane
        rec = self.live[rid]
        if ev.kind == "obs":
            self.chan.send({"type": "obs", "rid": rid, "step": ev.step,
                            **ev.obs})
        elif ev.kind == "recovered":
            self.chan.send({
                "type": "event", "rid": rid, "action": ev.action,
                "step": ev.step,
                "checks": list(health.check_names(ev.word))})
        elif ev.kind == "done":
            reply = {"type": "done", "rid": rid, "steps": ev.step,
                     "obs": ev.obs,
                     "events": [e.to_json() for e in ev.events or []]}
            if rec["req"].get("return_state"):
                reply["state_npz"] = serve.encode_state(ev.state)
            self.chan.send(reply)
            self._cleanup(rid, remove_dir=True)
        elif ev.kind == "diverged":
            self.chan.send({
                "type": "diverged", "rid": rid, "step": ev.step,
                "checks": list(ev.checks), "stats": ev.stats,
                "detail": ev.detail,
                "events": [e.to_json() for e in ev.events or []]})
            self._cleanup(rid, remove_dir=True)

    # ---- drain / prewarm ----------------------------------------------
    def _final_save(self):
        for rid, rec in list(self.live.items()):
            engine = self.engines[rec["key"]]
            row, meta = engine.lane_snapshot(rec["lane"])
            try:
                rec["mgr"].save(int(meta["steps_done"]),
                                {"carry": row, "meta": _meta_tree(meta)},
                                blocking=True)
            except Exception:  # noqa: BLE001 - drain the rest regardless
                log.exception("worker: final save failed for %s", rid)

    def _drain(self):
        self._final_save()
        self.chan.send({"type": "drained", "steps": {
            rid: int(self.engines[r["key"]].snap_steps[r["lane"]])
            for rid, r in self.live.items()}})
        self.stop = True

    def _prewarm(self, c: dict):
        req = dict(c.get("req") or {})
        try:
            cfg, state, _ = self._build(req)
            key = self._engine_for(cfg, state)
            engine = self.engines[key]
            lane = engine.admit(state, max(1, self.policy.block))
            for _ in range(64):
                if any(e.lane == lane and e.kind in ("done", "diverged")
                       for e in engine.step_block()):
                    break
            log.info("worker: prewarmed %s (n=%d)", req.get("case"),
                     key[1])
            self.chan.send({"type": "prewarmed"})
        except Exception as e:  # noqa: BLE001 - report, don't die
            log.exception("worker: prewarm failed")
            self.chan.send({"type": "error", "reason": "build_failed",
                            "detail": f"{type(e).__name__}: {e}"})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.sph.worker")
    ap.add_argument("--connect", type=int, required=True,
                    help="frontend IPC port on 127.0.0.1")
    ap.add_argument("--secret", required=True)
    ap.add_argument("--wid", type=int, required=True)
    ap.add_argument("--dir", required=True, help="worker state dir")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--block", type=int, default=32)
    ap.add_argument("--save-every", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="torch device of the engines (default: cuda; "
                    "'cpu' runs the kernels' plain versions)")
    args = ap.parse_args(argv)
    logging.basicConfig(
        level=logging.INFO,
        format=f"%(asctime)s w{args.wid} %(name)s %(levelname)s "
               "%(message)s")
    sock = None
    for attempt in range(10):
        try:
            sock = socket.create_connection(
                ("127.0.0.1", args.connect), timeout=10)
            break
        except OSError:
            time.sleep(0.1 * (attempt + 1))
    if sock is None:
        log.error("worker: cannot reach frontend on :%d", args.connect)
        return 1
    sock.settimeout(None)  # connect timeout must not poison blocking reads
    chan = serve._Conn(sock)
    policy = recovery.GuardPolicy(block=args.block, snapshot_every=1)
    w = EngineWorker(chan, args.dir, slots=args.slots, policy=policy,
                     save_every=args.save_every, device=args.device)
    chan.send({"type": "hello", "wid": args.wid, "secret": args.secret,
               "pid": os.getpid()})
    return w.run()


if __name__ == "__main__":
    sys.exit(main())
