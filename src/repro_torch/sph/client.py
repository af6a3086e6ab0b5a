"""Client helper for the ``repro_torch.sph serve`` endpoint.

Port of ``repro.sph.client``; it speaks the same frames, so it drives a
JAX server as well as a port server.

One request per connection: :func:`request` opens a socket, sends the
request frame, and yields reply frames until a TERMINAL frame arrives
(done / diverged / timeout / retry_after / rejected / error);
:func:`run_request` collects them and returns ``(frames, terminal)``.
The CLI's ``python -m repro_torch.sph request`` subcommand and
``chip_smoke.py`` phase 13 sit on these.

:func:`run_request_resilient` survives worker crashes end-to-end: a
``RETRY_AFTER`` carrying a resume token is resubmitted as a token
request after capped exponential backoff (the server resumes the lane
from its last block checkpoint, bit-identical), and a mid-stream EOF
(the server died before its supervisor could recover) reconnects and
re-requests the same way.
"""
from __future__ import annotations

import logging
import socket
import time

from repro_torch.sph.serve import decode_state, recv_frame, send_frame

log = logging.getLogger("repro_torch.client")

TERMINAL = frozenset({"done", "diverged", "timeout", "retry_after",
                      "rejected", "error", "stats"})


def request(host: str, port: int, req: dict, *, timeout: float = 300.0):
    """Generator of reply frames for one request; stops after the
    terminal frame (or on EOF — a server killed without drain)."""
    with socket.create_connection((host, port), timeout=timeout) as sock:
        send_frame(sock, req)
        while True:
            frame = recv_frame(sock)
            if frame is None:
                return
            yield frame
            if frame.get("type") in TERMINAL:
                return


def run_request(host: str, port: int, req: dict, *,
                timeout: float = 300.0) -> tuple[list, dict | None]:
    """All frames + the terminal frame (None if the connection died
    before one arrived)."""
    frames = list(request(host, port, req, timeout=timeout))
    last = frames[-1] if frames else None
    return frames, (last if last and last.get("type") in TERMINAL else None)


def run_request_resilient(
    host: str, port: int, req: dict, *,
    retries: int = 3, backoff_s: float = 0.5, backoff_cap_s: float = 8.0,
    timeout: float = 300.0,
) -> tuple[list, dict | None]:
    """:func:`run_request` with crash auto-recovery.

    Up to ``retries`` reconnect attempts (capped exponential backoff)
    are spent on the recoverable outcomes:

      * ``RETRY_AFTER`` with a resume token — resubmit the token (the
        server resumes the drained/shed lane from its checkpoint);
      * ``RETRY_AFTER`` without a token (queued work was flushed, or
        the server is draining) — resubmit the original request;
      * mid-stream EOF or a refused connection (server/worker died) —
        reconnect and re-request.

    Every other terminal (done/diverged/timeout/rejected/error) returns
    immediately. Returns the ACCUMULATED frames across attempts plus
    the final terminal frame (None only when the retry budget is
    exhausted without one).
    """
    all_frames: list = []
    cur = dict(req)
    attempt = 0
    while True:
        try:
            frames, term = run_request(host, port, cur, timeout=timeout)
            all_frames.extend(frames)
        except OSError as e:
            # refused/reset during server restart: retry like an EOF
            term = None
            log.warning("client: connection failed (%s)", e)
        if term is not None and term.get("type") != "retry_after":
            return all_frames, term
        if attempt >= retries:
            return all_frames, term
        token = term.get("token") if term is not None else None
        if token:
            cur = {"resume_token": token,
                   **{k: v for k, v in req.items()
                      if k in ("observe", "return_state", "deadline_s",
                               "request_id")}}
        elif "resume_token" not in cur:
            cur = dict(req)
        delay = min(backoff_cap_s, backoff_s * 2 ** attempt)
        attempt += 1
        log.warning(
            "client: %s — retry %d/%d in %.1fs%s",
            "server closed mid-stream" if term is None
            else "got RETRY_AFTER", attempt, retries, delay,
            f" (resume token {token})" if token else "")
        time.sleep(delay)


def final_state(done_frame: dict) -> dict:
    """Flat {path: array} dict of a DONE frame's ``state_npz`` payload
    (requested via ``return_state``) — bit-exact against the flattened
    solo-run state."""
    return decode_state(done_frame["state_npz"])
