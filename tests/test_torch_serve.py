"""The port's online simulation service (``repro_torch/sph/serve.py`` +
``client.py``): a counterpart of every test of ``tests/test_serve.py``,
on the CPU, plus the cross-package comparison with a JAX ``SimServer``.

The contract under test, as in JAX:

  * e2e over a REAL socket: concurrent requests across multiple shape
    buckets complete, healthy responses BIT-IDENTICAL to the port's solo
    ``run_guarded`` runs, a poisoned request answered with a structured
    DIVERGED reply (its neighbors untouched);
  * backpressure: a full admission queue answers REJECTED busy, decided
    in the reader thread;
  * malformed frames answer structured ERROR without reaching the engine;
  * deadlines cancel overdue lanes with a TIMEOUT reply; a client that
    hangs up mid-stream frees its lane;
  * SIGTERM drain hands out resume tokens honored by a RESTARTED server
    (subprocess test: real signal, real processes, bit-exact
    continuation to completion);
  * the same requests (fp32 records, ``backend: "xla"``, one poisoned)
    sent to a JAX ``SimServer`` and to a port ``SimServer``, each read
    by the port's client, give the same frame types, ACCEPTED nsteps, OBS
    steps, event actions and checks, and final states within
    ``tests/guard_parity.py``'s fp32-records tolerances.

Every port server here runs on ``device="cpu"`` (the kernels' plain
versions on the default kernel backend).
"""
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from repro.core import ensemble as jens
from repro.core import recovery as jrec
from repro.core.api import Simulation as JSimulation
from repro.sph.serve import SimServer as JSimServer
from repro_torch.core import ensemble, interop, recovery, solver
from repro_torch.core.api import Simulation
from repro_torch.core.cases import resolve_ds
from repro_torch.sph import client
from repro_torch.sph.serve import SimServer, recv_frame, send_frame, state_arrays
from test_torch_helpers import one_torch_thread  # noqa: F401  (autouse fixture)

BLOCK = 8
POLICY = recovery.GuardPolicy(block=BLOCK, snapshot_every=1)
SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def _server(**kw):
    kw.setdefault("slots", 4)
    kw.setdefault("queue", 16)
    kw.setdefault("policy", POLICY)
    kw.setdefault("device", "cpu")
    return SimServer(**kw)


def _solo_state(n: int, nsteps: int, case: str = "taylor_green", **over):
    """The reference a healthy serve reply must bit-match: a solo
    guarded run under the engine's member config."""
    sim = Simulation.from_case(case, device="cpu", ds=resolve_ds(case, n), **over)
    mcfg = ensemble.member_config(sim.cfg, POLICY)
    state, _, report, _ = recovery.run_guarded(mcfg, sim.state, nsteps, POLICY)
    assert not report.recovered  # the oracle itself must stay clean
    return state


def _assert_bit_equal(done_frame, state, label):
    got, want = client.final_state(done_frame), state_arrays(state)
    assert set(got) == set(want), label
    for k in want:
        assert got[k].dtype == want[k].dtype, (label, k)
        assert np.array_equal(got[k], want[k]), (label, k)


def _fire_all(port, reqs, timeout=600.0):
    results = {}

    def fire(req):
        results[req["request_id"]] = client.run_request("127.0.0.1", port, req,
                                                        timeout=timeout)

    threads = [threading.Thread(target=fire, args=(r,)) for r in reqs]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
    return results


# --------------------------------------------------------------------------
# TestE2E
# --------------------------------------------------------------------------
def test_concurrent_buckets_poisoned_member_bit_identity():
    """8 concurrent requests, 2 shape buckets, 1 poisoned: every healthy
    reply bit-matches its solo run, the poisoned one gets a structured
    DIVERGED, and lane reuse never cross-contaminates."""
    srv = _server().start()
    reqs = [{"case": "taylor_green", "n": 100, "nsteps": 16, "return_state": True,
             "request_id": f"a{i}"} for i in range(4)]
    reqs += [{"case": "taylor_green", "n": 150, "nsteps": 16, "return_state": True,
              "request_id": f"b{i}"} for i in range(3)]
    reqs.append({"case": "taylor_green", "n": 100, "nsteps": 16,
                 "inject": {"kind": "nan", "step": 3}, "request_id": "poison"})
    results = {rid: term for rid, (_, term) in _fire_all(srv.port, reqs).items()}
    srv.request_drain()
    srv.join(60)

    assert len(results) == 8
    poisoned = results.pop("poison")
    assert poisoned["type"] == "diverged"
    assert "nan_v" in poisoned["checks"]
    assert poisoned["stats"]["bad_v"] > 0
    actions = [e["action"] for e in poisoned["events"]]
    assert "halve_dt" in actions and actions[-1] == "quarantine"

    assert all(t["type"] == "done" for t in results.values())
    for n, prefix in ((100, "a"), (150, "b")):
        want = _solo_state(n, 16)
        for rid in (r for r in results if r.startswith(prefix)):
            _assert_bit_equal(results[rid], want, rid)


def test_streamed_observables_and_events():
    srv = _server().start()
    frames, term = client.run_request(
        "127.0.0.1", srv.port,
        {"case": "taylor_green", "n": 100, "nsteps": 24, "observe": True}, timeout=600.0)
    srv.request_drain()
    srv.join(60)
    assert frames[0]["type"] == "accepted"
    assert frames[0]["resumed"] is False
    assert term["type"] == "done" and term["steps"] == 24
    obs = [f for f in frames if f["type"] == "obs"]
    assert [f["step"] for f in obs] == [8, 16]
    assert all(np.isfinite(f["ekin"]) for f in obs)
    assert np.isfinite(term["obs"]["ekin"])


def test_nsteps_rounded_up_to_whole_blocks():
    srv = _server().start()
    frames, term = client.run_request(
        "127.0.0.1", srv.port, {"case": "taylor_green", "n": 100, "nsteps": 9},
        timeout=600.0)
    srv.request_drain()
    srv.join(60)
    assert frames[0]["nsteps"] == 16  # 9 -> 2 blocks of 8
    assert term["type"] == "done" and term["steps"] == 16


# --------------------------------------------------------------------------
# TestRobustness
# --------------------------------------------------------------------------
def test_queue_overflow_rejected_busy():
    """Load shedding is the READER's job: with the engine loop not yet
    running nothing drains the queue, so the (queue+1)-th concurrent
    request is rejected — deterministically. The late-started engine
    then completes the queued ones."""
    srv = _server(slots=2, queue=2)  # NOT started yet
    results = []

    def fire(i):
        _, term = client.run_request(
            "127.0.0.1", srv.port,
            {"case": "taylor_green", "n": 100, "nsteps": 8, "request_id": f"q{i}"},
            timeout=600.0)
        results.append(term)

    threads = [threading.Thread(target=fire, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    deadline = time.monotonic() + 10
    while len(srv.pending) < 2 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert len(srv.pending) == 2
    srv.start()
    for t in threads:
        t.join(600)
    srv.request_drain()
    srv.join(60)
    assert sorted(t["type"] for t in results) == ["done", "done", "rejected"]
    rej = next(t for t in results if t["type"] == "rejected")
    assert rej["reason"] == "busy" and rej["queue"] == 2


def test_malformed_requests_structured_error():
    srv = _server().start()
    try:
        for bad, expect in (
            ({"case": "no_such_case"}, "unknown case"),
            ({"case": "taylor_green", "nsteps": 0}, "nsteps"),
            ({"case": "taylor_green", "inject": {"kind": "meteor"}}, "inject"),
            ([1, 2, 3], "JSON object"),
        ):
            with socket.create_connection(("127.0.0.1", srv.port), timeout=30) as s:
                send_frame(s, bad)
                reply = recv_frame(s)
            assert reply["type"] == "error", bad
            assert reply["reason"] == "malformed"
            assert expect in reply["detail"]
        with socket.create_connection(("127.0.0.1", srv.port), timeout=30) as s:
            s.sendall(b"\x00\x00\x00\x02{x")
            reply = recv_frame(s)
        assert reply["type"] == "error"
        _, term = client.run_request(
            "127.0.0.1", srv.port, {"case": "taylor_green", "n": 100, "nsteps": 8},
            timeout=600.0)
        assert term["type"] == "done"
    finally:
        srv.request_drain()
        srv.join(60)


def test_deadline_timeout_cancels_lane():
    # slots=1: the follow-up request can only complete if the timed-out
    # lane was actually retired and its slot freed
    srv = _server(slots=1).start()
    t0 = time.monotonic()
    _, term = client.run_request(
        "127.0.0.1", srv.port,
        {"case": "poiseuille", "n": 400, "nsteps": 800_000, "deadline_s": 1.5},
        timeout=600.0)
    assert term["type"] == "timeout"
    assert 0 < term["steps_done"] < 800_000
    assert time.monotonic() - t0 < 300
    _, term = client.run_request(
        "127.0.0.1", srv.port, {"case": "poiseuille", "n": 400, "nsteps": 8}, timeout=600.0)
    assert term["type"] == "done"
    srv.request_drain()
    srv.join(60)


def test_client_hangup_midstream_frees_lane():
    """A client that hangs up mid-stream frees its lane (the engine
    thread retires it when a send fails): with slots=1 the next request
    can only run if it did."""
    srv = _server(slots=1).start()
    try:
        with socket.create_connection(("127.0.0.1", srv.port), timeout=60) as s:
            send_frame(s, {"case": "taylor_green", "n": 100, "nsteps": 800_000,
                           "observe": True})
            assert recv_frame(s)["type"] == "accepted"
            assert recv_frame(s)["type"] == "obs"
        _, term = client.run_request(
            "127.0.0.1", srv.port, {"case": "taylor_green", "n": 100, "nsteps": 8},
            timeout=300.0)
        assert term["type"] == "done"
    finally:
        srv.request_drain()
        srv.join(60)


def test_unknown_resume_token_structured_error(tmp_path):
    srv = _server(checkpoint_dir=str(tmp_path)).start()
    _, term = client.run_request("127.0.0.1", srv.port, {"resume_token": "deadbeef"},
                                 timeout=60.0)
    srv.request_drain()
    srv.join(60)
    assert term["type"] == "error" and term["reason"] == "bad_token"


def test_stats_op():
    srv = _server().start()
    _, term = client.run_request("127.0.0.1", srv.port, {"op": "stats"}, timeout=60.0)
    srv.request_drain()
    srv.join(60)
    assert term["type"] == "stats"
    assert term["queue_cap"] == 16 and term["draining"] is False
    json.dumps(term)  # every value plain JSON


def test_server_raises_without_cuda(monkeypatch):
    """device=None means CUDA, as every entry point of the port: no
    silent fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SimServer(policy=POLICY)


def test_in_process_drain_resume_bit_exact(tmp_path):
    """request_drain() mid-run: RETRY_AFTER with a token and the
    checkpointed step count; a new server on the same directory resumes
    it (ACCEPTED says resumed, at that step) and finishes bit-equal to
    the uninterrupted run."""
    class DrainAfterTwoBlocks(SimServer):
        def _tick(self):
            super()._tick()
            if any(e.blocks >= 2 for e in self.buckets.values()):
                self.request_drain()

    ck = str(tmp_path / "ck")
    srv = DrainAfterTwoBlocks(slots=2, queue=4, policy=POLICY, device="cpu",
                              checkpoint_dir=ck).start()
    req = {"case": "taylor_green", "n": 100, "nsteps": 40, "return_state": True}
    _, term = client.run_request("127.0.0.1", srv.port, req, timeout=300.0)
    srv.join(60)
    assert term["type"] == "retry_after" and term["token"]
    assert term["steps_done"] == 16 and term["nsteps"] == 40
    assert not os.path.exists(os.path.join(ck, "host_0.hb"))
    srv2 = _server(checkpoint_dir=ck)
    assert srv2.predecessor == "clean"
    srv2.start()
    frames, done = client.run_request(
        "127.0.0.1", srv2.port, {"resume_token": term["token"], "return_state": True},
        timeout=300.0)
    srv2.request_drain()
    srv2.join(60)
    assert frames[0]["type"] == "accepted"
    assert frames[0]["resumed"] is True
    assert done["type"] == "done" and done["steps"] == 40
    _assert_bit_equal(done, _solo_state(100, 40), "resumed")


# --------------------------------------------------------------------------
# ROADMAP Queue 3 entry G: a fault of the reference, mirrored
# --------------------------------------------------------------------------
def test_drain_with_two_live_buckets_raises_like_jax():
    """``SimServer._drain`` walks ``sorted(self.live.items())``, keyed by
    (member config, n): with two live buckets of different resolution
    the sort compares two SPHConfigs, which define no order, and raises
    TypeError, so the drain hands out no token. The JAX package does the
    same (its configs are as unorderable); the port mirrors it."""
    jkeys = [(jens.member_config(JSimulation.from_case(
        "taylor_green", ds=resolve_ds("taylor_green", n)).cfg, jrec.GuardPolicy(block=8)), n)
        for n in (100, 150)]
    with pytest.raises(TypeError, match="'<' not supported"):
        sorted([(jkeys[0], 0), (jkeys[1], 0)])

    srv = _server(slots=2)  # the engine loop is driven by hand below
    results = {}

    def fire(rid, n):
        results[rid] = client.run_request(
            "127.0.0.1", srv.port, {"case": "taylor_green", "n": n, "nsteps": 8000},
            timeout=120.0)

    threads = [threading.Thread(target=fire, args=(f"n{n}", n)) for n in (100, 150)]
    for t in threads:
        t.start()
    deadline = time.monotonic() + 30
    while len(srv.pending) < 2 and time.monotonic() < deadline:
        time.sleep(0.01)
    srv._tick()  # admits both, one block each
    assert len(srv.buckets) == 2 and len(srv.live) == 2
    srv.request_drain()
    with pytest.raises(TypeError, match="'<' not supported"):
        srv._drain()
    for p in srv.live.values():  # the drain answered no one: hang up
        p.conn.close()
    srv.stopped.set()
    srv.lsock.close()
    for t in threads:
        t.join(120)
    assert all(term is None for _, term in results.values())


# --------------------------------------------------------------------------
# the same requests through a JAX SimServer and a port SimServer
# --------------------------------------------------------------------------
CROSS_REQUESTS = [
    {"case": "taylor_green", "n": 100, "nsteps": 16, "request_id": "a0"},
    {"case": "taylor_green", "n": 100, "nsteps": 24, "request_id": "a1"},
    {"case": "taylor_green", "n": 150, "nsteps": 16, "request_id": "b0"},
    {"case": "taylor_green", "n": 100, "nsteps": 16, "request_id": "poison",
     "inject": {"kind": "nan", "step": 3}},
]


def _shape(frames) -> dict:
    return {
        "types": [f["type"] for f in frames],
        "nsteps": frames[0].get("nsteps"),
        "obs": [f["step"] for f in frames if f["type"] == "obs"],
        "events": [(f["action"], f["step"], f["checks"]) for f in frames
                   if f["type"] == "event"],
        "terminal": {k: frames[-1].get(k) for k in ("type", "steps", "step", "checks")},
        "term_events": [(e["action"], e["step"], e["checks"], e["word"])
                        for e in frames[-1].get("events", [])],
    }


def test_same_requests_through_jax_and_port_servers():
    """The port's client reads the JAX server's frames; both servers give
    the same frame sequences and, at fp32 records, final states within
    the fp32-records tolerances."""
    common = {"observe": True, "return_state": True, "records": "fp32", "backend": "xla"}
    reqs = [{**r, **common} for r in CROSS_REQUESTS]
    jpolicy = jrec.GuardPolicy(block=BLOCK, snapshot_every=1)
    servers = {"jax": JSimServer(slots=4, queue=16, policy=jpolicy).start(),
               "torch": _server().start()}
    runs = {}
    for name, srv in servers.items():
        runs[name] = _fire_all(srv.port, reqs)
        srv.request_drain()
        srv.join(60)
    for r in reqs:
        rid = r["request_id"]
        jframes, jterm = runs["jax"][rid]
        tframes, tterm = runs["torch"][rid]
        assert jterm is not None and tterm is not None, rid
        assert _shape(tframes) == _shape(jframes), rid
        assert all(f["request_id"] == rid for f in tframes + jframes)
        if rid == "poison":
            assert tterm["type"] == "diverged" and "nan_v" in tterm["checks"]
            continue
        assert tterm["type"] == "done"
        sim = Simulation.from_case("taylor_green", device="cpu",
                                   ds=resolve_ds("taylor_green", r["n"]), backend="xla")
        cfg = ensemble.member_config(sim.cfg, POLICY)
        states = [interop.state_from_numpy(
            {k.replace("/", "."): v for k, v in client.final_state(term).items()}, "cpu")
            for term in (jterm, tterm)]
        nsteps = tterm["steps"]
        np.testing.assert_allclose(solver.positions(cfg, states[1]).numpy(),
                                   solver.positions(cfg, states[0]).numpy(), atol=1e-6)
        np.testing.assert_allclose(states[1].fluid.rho.numpy(), states[0].fluid.rho.numpy(),
                                   atol=1e-6)
        np.testing.assert_allclose(states[1].fluid.v.numpy(), states[0].fluid.v.numpy(),
                                   atol=nsteps * cfg.dt * 1e-4)


# --------------------------------------------------------------------------
# TestDrain
# --------------------------------------------------------------------------
@pytest.mark.slow
def test_sigterm_drain_restart_resumes_to_completion(tmp_path):
    """Real processes, real SIGTERM: the drained (multi-process) server
    checkpoints the in-flight lane and hands out a resume token; a
    RESTARTED server finishes the work from the checkpoint, bit-equal to
    the uninterrupted run."""
    env = {**os.environ, "PYTHONPATH": SRC, "OMP_NUM_THREADS": "1"}
    ckdir = str(tmp_path / "ck")
    nsteps = 160

    def start_server():
        p = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.sph", "serve", "--port", "0",
             "--slots", "2", "--queue", "4", "--block", "8", "--checkpoint", ckdir,
             "--device", "cpu"],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for line in p.stdout:
            if line.startswith("# serving on"):
                return p, int(line.split()[3].split(":")[1])
        raise AssertionError("server never printed its banner")

    srv, port = start_server()
    try:
        long_req = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.sph", "request", "--port", str(port),
             "poiseuille", "--n", "400", "--nsteps", str(nsteps)],
            env=env, stdout=subprocess.PIPE, text=True)
        deadline = time.monotonic() + 300
        while time.monotonic() < deadline:
            _, st = client.run_request("127.0.0.1", port, {"op": "stats"}, timeout=30.0)
            if st and any(s > 0 for s in st.get("live_steps", [])):
                break
            time.sleep(0.2)
        else:
            raise AssertionError("lane never made progress")
        srv.send_signal(signal.SIGTERM)
        out, _ = long_req.communicate(timeout=120)
        frames = [json.loads(line) for line in out.splitlines()]
        term = frames[-1]
        assert term["type"] == "retry_after"
        token = term["token"]
        assert token and 0 < term["steps_done"] < nsteps
        assert srv.wait(timeout=60) == 0
        assert not os.path.exists(os.path.join(ckdir, "host_0.hb"))
    finally:
        if srv.poll() is None:
            srv.kill()

    srv2, port2 = start_server()
    try:
        r = subprocess.run(
            [sys.executable, "-m", "repro_torch.sph", "request", "--port", str(port2),
             "--resume-token", token, "--timeout", "600"],
            env=env, capture_output=True, text=True, timeout=600)
        frames = [json.loads(line) for line in r.stdout.splitlines()]
        assert frames[-1]["type"] == "done", frames[-1]
        assert frames[-1]["steps"] == nsteps
        assert frames[0]["resumed"] is True
        assert r.returncode == 0
        srv2.send_signal(signal.SIGTERM)
        assert srv2.wait(timeout=60) == 0
    finally:
        if srv2.poll() is None:
            srv2.kill()
