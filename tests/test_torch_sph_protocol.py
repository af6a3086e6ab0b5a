"""The wire of the serving stack against the JAX package's
(``repro_torch/sph/serve.py`` + ``client.py`` against ``repro/sph/``).

The contract under test:

  * framing: the same bytes on the wire for the same frame, each
    package reading the other's frames, and the same errors (oversized,
    non-JSON, cut mid-frame);
  * ``state_npz``: a JAX state carried over by ``interop`` and encoded by
    each package decodes, in each package, to the same keys, dtypes and
    bytes — fp32, fp16 and bf16 records, and bf16 relative coordinates,
    which both packages ship as numpy's ``|V2`` raw 16-bit words;
  * request plumbing: ``validate_request``'s error strings word for word,
    and ``build_overrides`` / ``request_key`` / ``worker_tag`` equal to
    JAX's, with the JAX backend name ``"pallas"`` taken as ``"kernel"``;
  * the resilient client (``TestResilientClient`` of
    ``tests/test_supervisor.py``) against an in-process fake server;
  * JAX's ``repro.sph.client`` driving a port ``SimServer`` to DONE, its
    ``final_state`` bit-equal to the port's own solo run.
"""
import dataclasses
import socket
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import _flatten as jflatten
from repro.core.api import Simulation as JSimulation
from repro.core.precision import PrecisionPolicy as JPolicy
from repro.sph import client as jclient
from repro.sph import serve as jserve
from repro_torch.core import ensemble, interop, recovery
from repro_torch.core.api import Simulation
from repro_torch.core.cases import resolve_ds
from repro_torch.sph import client, serve
from test_torch_helpers import one_torch_thread  # noqa: F401  (autouse fixture)

BLOCK = 8
POLICY = recovery.GuardPolicy(block=BLOCK, snapshot_every=1)


# --------------------------------------------------------------------------
# framing
# --------------------------------------------------------------------------
def _wire_bytes(send, obj) -> bytes:
    a, b = socket.socketpair()
    with a, b:
        send(a, obj)
        a.shutdown(socket.SHUT_WR)
        out = bytearray()
        while chunk := b.recv(65536):
            out += chunk
    return bytes(out)


FRAMES = [
    {"type": "accepted", "lane": 0, "nsteps": 16, "block": 8, "bucket": "n100"},
    {"type": "obs", "step": 8, "t": 0.024, "ekin": 0.15181425213813782, "vmax": 0.737,
     "rho_err": 0.0195, "request_id": "é-ü"},
    {"type": "done", "steps": 16, "obs": {}, "events": [], "state_npz": "A" * 100_000},
]


@pytest.mark.parametrize("frame", FRAMES, ids=["accepted", "obs", "large"])
def test_frames_are_the_same_bytes_and_cross_read(frame):
    wire = _wire_bytes(serve.send_frame, frame)
    assert wire == _wire_bytes(jserve.send_frame, frame)
    assert int.from_bytes(wire[:4], "big") == len(wire) - 4
    for send, recv in ((serve.send_frame, jserve.recv_frame),
                       (jserve.send_frame, serve.recv_frame)):
        a, b = socket.socketpair()
        with a, b:
            send(a, frame)
            assert recv(b) == frame
            a.close()
            assert recv(b) is None  # clean EOF


@pytest.mark.parametrize("raw, match", [
    ((serve.MAX_FRAME + 1).to_bytes(4, "big"), "exceeds cap"),
    (b"\x00\x00\x00\x02{x", "not JSON"),
    (b"\x00\x00\x00\x10{}", "closed mid-frame"),
    (b"\x00\x00\x00\x02\xff\xfe", "not JSON"),
], ids=["oversized", "not_json", "cut", "not_utf8"])
def test_frame_errors_as_jax(raw, match):
    assert serve.MAX_FRAME == jserve.MAX_FRAME == 64 << 20
    for recv in (serve.recv_frame, jserve.recv_frame):
        a, b = socket.socketpair()
        with a, b:
            a.sendall(raw)
            a.close()
            with pytest.raises(ValueError, match=match):
                recv(b)


# --------------------------------------------------------------------------
# state_npz
# --------------------------------------------------------------------------
def _jax_state(case: str, records: str, n: int = 120):
    sim = JSimulation.from_case(case, ds=resolve_ds(case, n),
                                policy=JPolicy(records=records))
    return sim.state


def _carried(jstate):
    """The port's SPHState of a JAX state, through ``interop`` (a bf16
    ``rc.rel`` carried as its raw bits)."""
    flat = {k.replace("/", "."): np.asarray(v) for k, v in jflatten(jstate).items()}
    rel = flat.pop("rc.rel")
    st = interop.state_from_numpy({**flat, "rc.rel": np.zeros(rel.shape, np.float16)}, "cpu")
    if rel.dtype.name == "bfloat16":
        trel = torch.from_numpy(rel.view(np.int16).copy()).view(torch.bfloat16)
    else:
        trel = torch.from_numpy(rel.copy())
    return st._replace(rc=st.rc._replace(rel=trel))


def _same_arrays(a: dict, b: dict):
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        assert a[k].shape == b[k].shape, k
        assert a[k].tobytes() == b[k].tobytes(), k


@pytest.mark.parametrize("records", ["fp32", "fp16", "bf16"])
@pytest.mark.parametrize("case", ["taylor_green", "cavity"])
def test_state_npz_same_keys_dtypes_bytes(case, records):
    jstate = _jax_state(case, records)
    tstate = _carried(jstate)
    blobs = (serve.encode_state(tstate), jserve.encode_state(jstate))
    decoded = [dec(blob) for blob in blobs for dec in (serve.decode_state, jserve.decode_state)]
    want = {k: np.asarray(v) for k, v in jflatten(jstate).items()}
    assert {"xn", "rc/cell_xy", "rc/rel", "fluid/v", "fluid/rho", "fluid/m", "fixed", "t",
            "kind"} <= set(want)
    assert ("v_wall" in want) == (case == "cavity")
    for d in decoded:
        _same_arrays(d, decoded[0])
    assert all(np.array_equal(decoded[0][k], want[k]) for k in want)
    assert str(decoded[0]["rc/rel"].dtype) == "float16"


@pytest.mark.parametrize("case", ["taylor_green", "cavity"])
def test_state_npz_bf16_coordinates_travel_as_raw_words(case):
    """bf16 leaves: JAX's ``np.savez`` of an ml_dtypes bf16 array stores
    ``|V2`` raw words; the port writes a bf16 tensor the same way (never
    widened to fp32), so both decode to the same ``|V2`` bytes."""
    jstate = _jax_state(case, "fp16")
    jstate = jstate._replace(rc=jstate.rc._replace(rel=jstate.rc.rel.astype(jnp.bfloat16)))
    tstate = _carried(jstate)
    assert tstate.rc.rel.dtype == torch.bfloat16
    assert serve.state_arrays(tstate)["rc/rel"].dtype == np.dtype("V2")
    decoded = [dec(enc) for enc in (serve.encode_state(tstate), jserve.encode_state(jstate))
               for dec in (serve.decode_state, jserve.decode_state)]
    for d in decoded:
        _same_arrays(d, decoded[0])
    assert decoded[0]["rc/rel"].dtype == np.dtype("V2")
    bits = np.asarray(jstate.rc.rel).view(np.uint16)
    assert np.array_equal(decoded[0]["rc/rel"].view(np.uint16), bits)


# --------------------------------------------------------------------------
# request plumbing
# --------------------------------------------------------------------------
REQUESTS = [
    {"case": "taylor_green", "n": 100, "nsteps": 16},
    {"case": "taylor_green", "n": 150, "nsteps": 16, "observe": True},
    {"case": "taylor_green", "ds": 0.05, "records": "fp32", "backend": "xla"},
    {"case": "dam_break", "n": 300, "backend": "pallas", "records": "bf16"},
    {"case": "dam_break", "n": 300, "backend": "kernel"},
    {"case": "poiseuille", "n": 400, "overrides": {"nu": 0.5}, "deadline_s": 1.5},
    {"case": "cavity", "n": 200, "inject": {"kind": "nan", "step": 3}},
    {"case": "cavity", "inject": {"kind": "teleport"}, "request_id": "x"},
    {"resume_token": "deadbeef"},
    {"op": "stats"},
    {"case": "no_such_case"},
    {"case": 7},
    {"case": "taylor_green", "nsteps": 0},
    {"case": "taylor_green", "nsteps": 2.5},
    {"case": "taylor_green", "n": "100"},
    {"case": "taylor_green", "ds": "x"},
    {"case": "taylor_green", "deadline_s": []},
    {"case": "taylor_green", "overrides": [1]},
    {"case": "taylor_green", "inject": {"kind": "meteor"}},
    {"case": "taylor_green", "inject": "nan"},
    {"case": "taylor_green", "inject": {"kind": "nan", "step": "3"}},
    {"resume_token": "a/b"},
    {"resume_token": ""},
    {"resume_token": 5},
    {"op": "drop"},
    [1, 2, 3],
    "run",
]


def _as_jax(req: dict) -> dict:
    """The request as the JAX package names its port's backend."""
    return {**req, "backend": "kernel"} if req.get("backend") == "pallas" else req


def _over(over: dict) -> dict:
    return {k: (dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v)
            for k, v in over.items()}


@pytest.mark.parametrize("req", REQUESTS, ids=range(len(REQUESTS)))
def test_request_plumbing_as_jax(req):
    err = serve.validate_request(req)
    assert err == jserve.validate_request(req)
    if err is not None or not isinstance(req, dict) or "case" not in req:
        return
    assert _over(serve.build_overrides(req)) == _over(jserve.build_overrides(_as_jax(req)))
    assert serve.request_key(req) == jserve.request_key(_as_jax(req))
    assert serve.worker_tag(req) == jserve.worker_tag(_as_jax(req))
    if req.get("backend") in ("pallas", "kernel"):
        assert serve.build_overrides(req)["backend"] == "kernel"
    assert serve._INJECT_KINDS == jserve._INJECT_KINDS


def test_pallas_and_kernel_share_a_bucket():
    a = {"case": "dam_break", "n": 300, "backend": "pallas"}
    b = {**a, "backend": "kernel"}
    assert serve.request_key(a) == serve.request_key(b)
    assert serve.worker_tag(a) == serve.worker_tag(b)


# --------------------------------------------------------------------------
# TestResilientClient (tests/test_supervisor.py), against a fake server
# --------------------------------------------------------------------------
class _FakeServer:
    """Scripted frame server: each accepted connection plays the next
    scenario entry — a list of frames to send (after reading the
    request), or the string "eof" to hang up mid-stream."""

    def __init__(self, scenario):
        self.scenario = list(scenario)
        self.requests = []
        self.sock = socket.socket()
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(8)
        self.port = self.sock.getsockname()[1]
        threading.Thread(target=self._serve, daemon=True).start()

    def _serve(self):
        for entry in self.scenario:
            try:
                conn, _ = self.sock.accept()
            except OSError:
                return
            with conn:
                self.requests.append(serve.recv_frame(conn))
                if entry == "eof":
                    continue  # close without a terminal frame
                for frame in entry:
                    serve.send_frame(conn, frame)
        self.sock.close()


def test_retry_after_token_resubmitted():
    fake = _FakeServer([
        [{"type": "retry_after", "token": "tok-1", "steps_done": 8}],
        [{"type": "obs", "step": 16, "ekin": 1.0},
         {"type": "done", "steps": 16, "obs": {}}],
    ])
    frames, term = client.run_request_resilient(
        "127.0.0.1", fake.port,
        {"case": "taylor_green", "nsteps": 16, "observe": True},
        retries=3, backoff_s=0.01)
    assert term["type"] == "done"
    assert fake.requests[1] == {"resume_token": "tok-1", "observe": True}
    assert [f["type"] for f in frames] == ["retry_after", "obs", "done"]


def test_midstream_eof_reconnects():
    fake = _FakeServer(["eof", [{"type": "done", "steps": 8, "obs": {}}]])
    frames, term = client.run_request_resilient(
        "127.0.0.1", fake.port, {"case": "taylor_green", "nsteps": 8},
        retries=2, backoff_s=0.01)
    assert term["type"] == "done"
    assert len(fake.requests) == 2
    assert fake.requests[0] == fake.requests[1]


def test_retry_budget_exhausted_returns_last_terminal():
    fake = _FakeServer([[{"type": "retry_after", "token": None}],
                        [{"type": "retry_after", "token": None}]])
    _, term = client.run_request_resilient(
        "127.0.0.1", fake.port, {"case": "taylor_green"}, retries=1, backoff_s=0.01)
    assert term["type"] == "retry_after"
    assert len(fake.requests) == 2


def test_nonrecoverable_terminal_passes_through():
    fake = _FakeServer([[{"type": "rejected", "reason": "busy", "queue": 1}]])
    _, term = client.run_request_resilient(
        "127.0.0.1", fake.port, {"case": "taylor_green"}, retries=3, backoff_s=0.01)
    assert term["type"] == "rejected"
    assert len(fake.requests) == 1
    assert client.TERMINAL == jclient.TERMINAL


# --------------------------------------------------------------------------
# JAX's client against a port server
# --------------------------------------------------------------------------
def test_jax_client_drives_port_server_bit_exact():
    srv = serve.SimServer(slots=2, queue=4, policy=POLICY, device="cpu").start()
    try:
        req = {"case": "taylor_green", "n": 100, "nsteps": 16, "observe": True,
               "return_state": True, "request_id": "jax-client"}
        frames, term = jclient.run_request("127.0.0.1", srv.port, req, timeout=300.0)
    finally:
        srv.request_drain()
        srv.join(60)
    assert [f["type"] for f in frames] == ["accepted", "obs", "done"]
    assert all(f["request_id"] == "jax-client" for f in frames)
    assert term["steps"] == 16 and frames[1]["step"] == 8
    sim = Simulation.from_case("taylor_green", device="cpu", ds=resolve_ds("taylor_green", 100))
    mcfg = ensemble.member_config(sim.cfg, POLICY)
    state, _, report, _ = recovery.run_guarded(mcfg, sim.state, 16, POLICY)
    assert not report.recovered
    got, want = jclient.final_state(term), serve.state_arrays(state)
    _same_arrays(dict(sorted(got.items())), dict(sorted(want.items())))
