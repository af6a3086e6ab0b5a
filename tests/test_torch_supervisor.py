"""The port's crash-contained multi-process serving
(``repro_torch/sph/supervisor.py`` + ``worker.py`` + the resilient
client): a counterpart of every test of ``tests/test_supervisor.py``, on
the CPU (``--device cpu`` workers). ``TestResilientClient``'s
counterparts, which need no server, are in
``tests/test_torch_sph_protocol.py``.

The contract under test, as in JAX:

  * a REAL SIGKILL of an engine worker mid-request is invisible to the
    request's outcome: the supervisor restarts the worker, the lane
    resumes from its last block checkpoint, and the final state is
    BIT-IDENTICAL to an uninterrupted solo run;
  * a sibling shape bucket streams through the whole episode untouched
    (no recovering event, bit-identical state) and the frontend process
    never exits;
  * the restarted worker reclaims its dead predecessor's lockfiles
    QUIETLY — one summary line, no per-lane warning spam;
  * ``--max-restarts`` exhaustion answers RETRY_AFTER with a resume
    token that a later resubmission (fresh worker, fresh restart budget)
    completes from the checkpoint;
  * a worker left on CUDA where there is none answers ERROR build_failed:
    it never carries on on the CPU;
  * a (re)started worker's heartbeat is fresh when its hello arrives,
    whatever its killed predecessor left in the directory (ROADMAP
    Queue 3 entry H).
"""
import os
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

import torch_chaos
from repro_torch.core import ensemble, recovery
from repro_torch.core.api import Simulation
from repro_torch.core.cases import resolve_ds
from repro_torch.sph import client
from repro_torch.runtime.fault_tolerance import HeartbeatMonitor
from repro_torch.sph.serve import recv_frame, request_key, state_arrays, worker_tag
from repro_torch.sph.supervisor import FrontendServer
from test_torch_helpers import one_torch_thread  # noqa: F401  (autouse fixture)

BLOCK = 8
POLICY = recovery.GuardPolicy(block=BLOCK, snapshot_every=1)


def _solo_state(n: int, nsteps: int) -> dict:
    sim = Simulation.from_case("taylor_green", device="cpu", ds=resolve_ds("taylor_green", n))
    mcfg = ensemble.member_config(sim.cfg, POLICY)
    state, _, report, _ = recovery.run_guarded(mcfg, sim.state, nsteps, POLICY)
    assert not report.recovered
    return state_arrays(state)


def _assert_state_equal(done_frame, want, label):
    got = client.final_state(done_frame)
    assert set(got) == set(want), label
    for k in want:
        assert got[k].dtype == want[k].dtype, (label, k)
        assert np.array_equal(got[k], want[k]), (label, k)


def test_request_key_buckets_by_case_and_overrides():
    a = {"case": "taylor_green", "n": 100, "nsteps": 16}
    b = {"case": "taylor_green", "n": 150, "nsteps": 16}
    c = {"case": "taylor_green", "n": 100, "nsteps": 999, "observe": True}
    assert request_key(a) != request_key(b)  # resolution = bucket
    assert request_key(a) == request_key(c)  # nsteps/flags don't
    assert worker_tag(a) != worker_tag(b)
    assert worker_tag(a).startswith("taylor_green-")


def test_worker_without_cuda_answers_build_failed(tmp_path):
    """The frontend touches no device; its worker, left on CUDA, cannot
    build the case on this CPU-only machine and says so."""
    srv = FrontendServer(slots=1, policy=POLICY, checkpoint_dir=str(tmp_path)).start()
    try:
        _, term = client.run_request(
            "127.0.0.1", srv.port, {"case": "taylor_green", "n": 100, "nsteps": 8},
            timeout=300.0)
    finally:
        srv.request_drain()
        srv.join(120)
    assert term["type"] == "error" and term["reason"] == "build_failed"
    assert "CUDA is not available" in term["detail"]


def test_worker_heartbeat_is_fresh_at_hello(tmp_path):
    """The frontend judges a ready worker by its directory's heartbeat
    file; a restarted worker finds its SIGKILLed predecessor's file there,
    stale once the spawn took longer than the timeout. The worker beats
    before its hello, so the frontend never reads the predecessor's."""
    wdir = tmp_path / "w"
    wdir.mkdir()
    hb = wdir / "host_0.hb"
    hb.write_text('{"step": 3, "t": 0.0}')
    os.utime(hb, (time.time() - 3600,) * 2)
    assert HeartbeatMonitor(str(wdir)).host_status(0) == "dead"
    lsock = socket.socket()
    lsock.bind(("127.0.0.1", 0))
    lsock.listen(1)
    env = {**os.environ, "PYTHONPATH": os.path.join(os.path.dirname(__file__), "..", "src"),
           "OMP_NUM_THREADS": "1"}
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.sph.worker", "--connect",
         str(lsock.getsockname()[1]), "--secret", "s", "--wid", "0", "--dir", str(wdir),
         "--device", "cpu"], env=env)
    try:
        lsock.settimeout(120)
        conn, _ = lsock.accept()
        with conn:
            conn.settimeout(120)
            hello = recv_frame(conn)
            # the frontend's tightest reading: fresh within the 2 s skew
            status = HeartbeatMonitor(str(wdir), timeout_s=0.0).host_status(0)
        assert proc.wait(timeout=120) == 0  # EOF on its channel: exits
    finally:
        lsock.close()
        if proc.poll() is None:
            proc.kill()
    assert hello["type"] == "hello" and hello["secret"] == "s"
    assert status == "alive"


@pytest.mark.slow
def test_sigkill_recovery_bit_identical_sibling_unaffected(tmp_path):
    """SIGKILL one engine worker mid-request (the supervisor's
    deterministic chaos-kill, right after a committed block checkpoint):
    its request finishes bit-identical to an uninterrupted run, a request
    in a DIFFERENT bucket streams through undisturbed, and the frontend
    never exits."""
    srv = torch_chaos.ServerProc("--chaos", "kill", checkpoint=str(tmp_path / "ck"),
                                 block=BLOCK)
    try:
        results = {}

        def fire(rid, req):
            results[rid] = client.run_request("127.0.0.1", srv.port, req, timeout=600.0)

        ta = threading.Thread(target=fire, args=("a", {
            "case": "taylor_green", "n": 300, "nsteps": 160,
            "observe": True, "return_state": True}))
        ta.start()
        srv.wait_stats(lambda st: st["chaos_fired"], timeout=300, what="chaos fire")
        assert srv.alive()
        tb = threading.Thread(target=fire, args=("b", {
            "case": "taylor_green", "n": 150, "nsteps": 64,
            "observe": True, "return_state": True}))
        tb.start()
        ta.join(600)
        tb.join(600)
        assert srv.alive(), "frontend died during worker recovery"

        frames_a, term_a = results["a"]
        frames_b, term_b = results["b"]
        assert term_a["type"] == "done" and term_a["steps"] == 160
        assert term_b["type"] == "done" and term_b["steps"] == 64
        assert any(f.get("action") == "recovering" for f in frames_a)
        assert not any(f.get("action") == "recovering" for f in frames_b)
        obs_b = [f["step"] for f in frames_b if f["type"] == "obs"]
        assert obs_b == list(range(BLOCK, 64, BLOCK))
        _assert_state_equal(term_a, _solo_state(300, 160), "killed")
        _assert_state_equal(term_b, _solo_state(150, 64), "sibling")
        obs_a = {f["step"] for f in frames_a if f["type"] == "obs"}
        assert obs_a == set(range(BLOCK, 160, BLOCK))

        st = srv.stats()
        assert st["worker_restarts"] >= 1
        assert st["recovered_lanes"] >= 1
        assert st["recovery_s"] is not None and st["recovery_s"] > 0
        assert all(w["first_progress_s"] > 0 and w["save_ms"] >= 0 for w in st["workers"])
        assert srv.stop() == 0
    finally:
        srv.kill()
    spam = [ln for ln in srv.lines if "checkpoint: reclaiming" in ln]
    assert spam == [], spam
    assert any("reclaimed checkpoint lock(s)" in ln for ln in srv.lines)
    assert any("# drained cleanly" in ln for ln in srv.lines)


@pytest.mark.slow
def test_max_restarts_exhaustion_token_resumes(tmp_path):
    """--max-restarts 0: the first real SIGKILL sheds the in-flight
    request as RETRY_AFTER with a resume token; resubmitting the token
    (fresh worker, fresh budget) finishes from the checkpoint
    bit-identical to an uninterrupted run."""
    srv = torch_chaos.ServerProc("--max-restarts", "0", checkpoint=str(tmp_path / "ck"),
                                 block=BLOCK)
    try:
        box = {}

        def fire():
            box["r"] = client.run_request(
                "127.0.0.1", srv.port,
                {"case": "taylor_green", "n": 300, "nsteps": 160, "return_state": True},
                timeout=600.0)

        t = threading.Thread(target=fire)
        t.start()
        st = srv.wait_stats(
            lambda st: any(w["blocks"] >= 2 and w["assigned"] for w in st["workers"]),
            timeout=300, what="2 blocks of progress")
        pids = srv.worker_pids()
        assert pids, st
        torch_chaos.sigkill(next(iter(pids.values())))
        t.join(120)
        _, term = box["r"]
        assert term["type"] == "retry_after", term
        token = term["token"]
        assert token and term["steps_done"] > 0
        assert srv.alive()

        frames, done = client.run_request_resilient(
            "127.0.0.1", srv.port, {"resume_token": token, "return_state": True},
            retries=3, timeout=600.0)
        assert done["type"] == "done" and done["steps"] == 160
        _assert_state_equal(done, _solo_state(300, 160), "resumed")
        accepted = next(f for f in frames if f["type"] == "accepted")
        assert accepted["resumed"] is True
        assert srv.stop() == 0
    finally:
        srv.kill()
