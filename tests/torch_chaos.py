"""Chaos harness for the port's multi-process serve stack.

The port's copy of ``tests/chaos.py``. Importable as ``import
torch_chaos`` (pytest inserts tests/ into sys.path) and runnable
standalone::

    PYTHONPATH=src python tests/torch_chaos.py --mode kill --nsteps 96
    PYTHONPATH=src python tests/torch_chaos.py --device cuda   # on a GPU

Drives a REAL ``python -m repro_torch.sph serve`` subprocess
(multi-process frontend + engine workers, on ``device``: the CPU unless
asked) and injects real faults mid-request — the supervisor's built-in
``--chaos kill|hang|oom-sim`` modes for deterministic engine-thread
timing, or :func:`sigkill` / :func:`sigstop` on a worker pid looked up
through the stats op for test-driven injection.
``tests/test_torch_supervisor.py`` sits on these helpers. The server and
its workers run torch on one thread (``OMP_NUM_THREADS=1`` unless the
caller's environment sets it): the suite runs several test processes at
once.
"""
from __future__ import annotations

import os
import signal
import subprocess
import sys
import threading
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.sph import client  # noqa: E402


class ServerProc:
    """A ``repro_torch.sph serve`` subprocess: banner-parsed port,
    captured output, SIGTERM drain."""

    def __init__(self, *extra_args: str, checkpoint: str,
                 block: int = 8, slots: int = 2, queue: int = 8,
                 device: str = "cpu", env: dict | None = None,
                 banner_timeout: float = 120.0):
        env = dict(env or os.environ)
        env.setdefault("PYTHONPATH", os.path.join(
            os.path.dirname(__file__), "..", "src"))
        env.setdefault("OMP_NUM_THREADS", "1")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.sph", "serve",
             "--port", "0", "--slots", str(slots),
             "--queue", str(queue), "--block", str(block),
             "--checkpoint", checkpoint, "--device", device,
             *extra_args],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        self.lines: list[str] = []
        self.port: int | None = None
        deadline = time.monotonic() + banner_timeout
        while time.monotonic() < deadline:
            line = self.proc.stdout.readline()
            if not line:
                raise AssertionError(
                    "server exited before its banner: "
                    + "\n".join(self.lines))
            self.lines.append(line.rstrip())
            if line.startswith("# serving on"):
                self.port = int(line.split()[3].split(":")[1])
                break
        if self.port is None:
            raise AssertionError("server never printed its banner")
        threading.Thread(target=self._pump, daemon=True).start()

    def _pump(self):
        for line in self.proc.stdout:
            self.lines.append(line.rstrip())

    def stats(self, timeout: float = 30.0) -> dict:
        _, st = client.run_request(
            "127.0.0.1", self.port, {"op": "stats"}, timeout=timeout)
        assert st is not None and st["type"] == "stats"
        return st

    def wait_stats(self, pred, timeout: float = 300.0,
                   what: str = "condition") -> dict:
        """Poll the stats op until ``pred(stats)`` is truthy."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            st = self.stats()
            if pred(st):
                return st
            time.sleep(0.1)
        raise AssertionError(f"server never reached {what}; last: {st}")

    def worker_pids(self) -> dict[str, int]:
        """tag -> pid of every live worker (via the stats op)."""
        return {w["tag"]: w["pid"] for w in self.stats()["workers"]
                if w["pid"] is not None and w["state"] == "ready"}

    def alive(self) -> bool:
        return self.proc.poll() is None

    def stop(self, timeout: float = 120.0) -> int:
        """SIGTERM drain; returns the exit code."""
        self.proc.send_signal(signal.SIGTERM)
        return self.proc.wait(timeout=timeout)

    def kill(self):
        if self.alive():
            self.proc.kill()
            self.proc.wait(timeout=30)


def sigkill(pid: int):
    """The real thing: what the OOM killer / a segfault looks like."""
    os.kill(pid, signal.SIGKILL)


def sigstop(pid: int):
    """Freeze a worker without killing it (exercises hang detection
    end-to-end: the process stops beating AND stops progressing)."""
    os.kill(pid, signal.SIGSTOP)


def sigcont(pid: int):
    os.kill(pid, signal.SIGCONT)


def main(argv=None) -> int:
    import argparse
    import tempfile

    ap = argparse.ArgumentParser(prog="tests/torch_chaos.py", description=(
        "drive one chaos scenario against a live multi-process server"))
    ap.add_argument("--mode", default="kill",
                    choices=["kill", "hang", "oom-sim"])
    ap.add_argument("--case", default="taylor_green")
    ap.add_argument("--n", type=int, default=300)
    ap.add_argument("--nsteps", type=int, default=96)
    ap.add_argument("--block", type=int, default=8)
    ap.add_argument("--hang-timeout", type=float, default=8.0)
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args(argv)

    ck = tempfile.mkdtemp(prefix="chaos-ck-")
    srv = ServerProc("--chaos", args.mode,
                     "--hang-timeout", str(args.hang_timeout),
                     checkpoint=ck, block=args.block, device=args.device)
    print(f"# chaos {args.mode}: server on :{srv.port}", flush=True)
    frames, term = client.run_request(
        "127.0.0.1", srv.port,
        {"case": args.case, "n": args.n, "nsteps": args.nsteps,
         "observe": True}, timeout=600.0)
    recovering = [f for f in frames if f.get("action") == "recovering"]
    st = srv.stats()
    rc = srv.stop()
    ok = (term is not None and term["type"] == "done" and recovering
          and st["worker_restarts"] >= 1 and rc == 0)
    print(f"# terminal={term and term['type']} "
          f"recovering_events={len(recovering)} "
          f"worker_restarts={st['worker_restarts']} "
          f"recovery_s={st['recovery_s']} drain_rc={rc}", flush=True)
    print("# chaos", "PASS" if ok else "FAIL", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
