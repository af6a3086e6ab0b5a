"""Atomic, async checkpointing with CRC verification.

Port of ``repro.checkpoint.manager``, with the same on-disk layout, so a
directory written by either package restores in the other.

Layout: <dir>/step_<N>/
  manifest.json          - pytree structure, shapes, dtypes, crc32, step
  arrays.npz             - flat {path: array} (host-gathered)
  .COMPLETE              - commit marker (written last, after fsync)

Atomicity: writes go to step_<N>.tmp/ then os.replace() to step_<N>
and the .COMPLETE marker is written inside. Readers ignore directories
without the marker, so a killed writer never corrupts restore.

Integrity: the manifest records a CRC32 per array; restore() verifies
every array against it and — when picking the step itself — falls back
to the previous .COMPLETE step with a loud warning on any mismatch or
unreadable payload (torn storage AFTER commit: a .COMPLETE marker only
proves the writer finished, not that the bytes survived).

Async: save() can hand off to a background thread (the train loop keeps
stepping); wait() joins before the next save or on exit. A process is
joined at interpreter exit too (atexit), so an async save that failed
after the last explicit wait() is reported instead of silently dropped.

Trees are nested dicts, lists, tuples and NamedTuples whose leaves are
numpy arrays, host scalars or torch tensors (copied to the host at save).
restore() returns host numpy; :func:`reshard` puts a host tree on one
device, or lays it out on a mesh's shardings as DTensors.
"""
from __future__ import annotations

import atexit
import json
import logging
import os
import shutil
import sys
import threading
import time
import weakref
import zlib

import numpy as np
import torch

log = logging.getLogger("repro_torch.checkpoint")

SEP = "/"


class CheckpointCorruptError(RuntimeError):
    """An explicitly requested checkpoint step failed CRC verification."""


class CheckpointLockError(RuntimeError):
    """The checkpoint directory is locked by another LIVE process.

    Two writers interleaving saves into one directory silently corrupt
    each other's GC and step ordering, so opening is exclusive. The
    error carries the owner pid so callers (and their users) can see
    who holds it."""

    def __init__(self, directory: str, owner_pid: int):
        super().__init__(
            f"checkpoint directory {directory!r} is locked by live "
            f"process {owner_pid} — two writers would interleave saves; "
            "pick a different directory or stop the other process")
        self.directory = directory
        self.owner_pid = owner_pid


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True  # exists, owned by someone else
    return True


def _flatten(tree, prefix=""):
    out = {}
    if tree is None:
        # Empty subtree (e.g. a PersistentCarry's unused optional
        # fields): nothing to persist — restore rebuilds it from the
        # template's matching None.
        return out
    if isinstance(tree, dict):
        it = tree.items()
    elif isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        it = ((str(i), v) for i, v in enumerate(tree))
    elif hasattr(tree, "_fields"):  # NamedTuple
        it = zip(tree._fields, tree)
    else:
        return {prefix or "leaf": tree}
    for k, v in it:
        p = f"{prefix}{SEP}{k}" if prefix else str(k)
        out.update(_flatten(v, p))
    return out


def _unflatten_into(template, flat, prefix=""):
    """Rebuild a pytree shaped like `template` from the flat dict."""
    if template is None:
        return None
    if isinstance(template, dict):
        return {
            k: _unflatten_into(v, flat, f"{prefix}{SEP}{k}" if prefix else k)
            for k, v in template.items()
        }
    if hasattr(template, "_fields"):
        vals = [
            _unflatten_into(v, flat,
                            f"{prefix}{SEP}{f}" if prefix else f)
            for f, v in zip(template._fields, template)
        ]
        return type(template)(*vals)
    if isinstance(template, (list, tuple)):
        return type(template)(
            _unflatten_into(v, flat,
                            f"{prefix}{SEP}{i}" if prefix else str(i))
            for i, v in enumerate(template))
    return flat[prefix or "leaf"]


def _host_array(v) -> np.ndarray:
    """A host numpy copy of one leaf (a torch tensor or an array-like)."""
    if isinstance(v, torch.Tensor):
        return v.detach().to("cpu", copy=True).numpy()
    return np.array(v)


def _crc(a: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(a).tobytes()) & 0xFFFFFFFF


def _atexit_join(ref):
    """Join a dangling async save at interpreter exit. Never raises
    (atexit swallows nothing gracefully) — a deferred save error is
    logged AND printed to stderr so it cannot vanish with the process."""
    mgr = ref()
    if mgr is None:
        return
    try:
        mgr.close()
    except Exception as e:  # pragma: no cover - exercised via unit test
        log.error("checkpoint: async save failed at process exit: %s", e)
        print(f"checkpoint: async save FAILED at process exit: {e}",
              file=sys.stderr)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3,
                 quiet_reclaim: bool = False):
        """``keep``: retain the newest ``keep`` committed steps, garbage-
        collecting older ones after each save. ``keep=0`` explicitly
        means KEEP ALL (no GC ever) — it is not "keep none".

        ``quiet_reclaim``: demote the dead-pid lock-reclaim warning to
        DEBUG. A supervisor restarting a killed worker reopens one
        manager per resumed lane — every one reclaims the dead pid's
        lock, and that is the EXPECTED recovery path, not an anomaly
        worth a warning per lane. The caller reports one summary line
        instead (``reclaimed_from`` records the dead owner's pid)."""
        self.dir = directory
        self.keep = keep
        self.quiet_reclaim = quiet_reclaim
        self.reclaimed_from: int | None = None
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None
        self._lock_path: str | None = None
        self._acquire_lock()
        atexit.register(_atexit_join, weakref.ref(self))

    # ---- exclusivity -------------------------------------------------------
    def _acquire_lock(self):
        """Take the directory's exclusive ``.lock`` file.

        Same-process re-open adopts the existing lock (re-entrant: the
        sweep service opens per-bucket managers under one root, and
        tests reopen directories to resume). A lock owned by a DEAD
        pid is reclaimed with a warning — a crashed writer must not
        brick its directory. A live foreign owner raises
        :class:`CheckpointLockError`."""
        path = os.path.join(self.dir, ".lock")
        payload = json.dumps({"pid": os.getpid(), "t": time.time()})
        for _ in range(3):
            try:
                fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
                with os.fdopen(fd, "w") as f:
                    f.write(payload)
                self._lock_path = path
                return
            except FileExistsError:
                pass
            try:
                with open(path) as f:
                    owner = int(json.load(f)["pid"])
            except (OSError, ValueError, KeyError,
                    json.JSONDecodeError):
                # torn write by a dying owner: give it a beat, then
                # treat unreadable as dead
                time.sleep(0.05)
                owner = None
            if owner == os.getpid():
                self._lock_path = path  # re-entrant adopt
                return
            if owner is not None and _pid_alive(owner):
                raise CheckpointLockError(self.dir, owner)
            (log.debug if self.quiet_reclaim else log.warning)(
                "checkpoint: reclaiming %s from dead process %s",
                path, owner)
            self.reclaimed_from = owner
            try:
                os.remove(path)
            except FileNotFoundError:
                pass  # the dead owner's reaper beat us to it
        raise CheckpointLockError(self.dir, -1)

    def close(self):
        """Join any async save and release the directory lock."""
        self.wait()
        if self._lock_path is not None:
            try:
                os.remove(self._lock_path)
            except FileNotFoundError:
                pass
            self._lock_path = None

    # ---- write ------------------------------------------------------------
    def save(self, step: int, tree, blocking: bool = True):
        """Host-gather and persist `tree` at `step`.

        Host numpy leaves are COPIED (np.array), not aliased: with
        ``blocking=False`` the write races the caller's next mutation
        of those arrays otherwise (the ensemble runner mutates its lane
        vectors in place between blocks).
        """
        self.wait()
        host = {k: _host_array(v) for k, v in _flatten(tree).items()}

        def work():
            try:
                self._write(step, host)
                self._gc()
            except Exception as e:  # surfaced on next wait()
                self._error = e

        if blocking:
            work()
            self.wait()
        else:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()

    def _write(self, step: int, host: dict):
        final = os.path.join(self.dir, f"step_{step:08d}")
        tmp = final + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "arrays.npz"), **host)
        manifest = {
            "step": step,
            "arrays": {k: {"shape": list(v.shape), "dtype": str(v.dtype),
                           "crc32": _crc(v)}
                       for k, v in host.items()},
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        with open(os.path.join(tmp, ".COMPLETE"), "w") as f:
            f.write("ok")
            f.flush()
            os.fsync(f.fileno())
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        # keep=0 means keep all (see __init__) — the falsy short-circuit
        # below is that contract, not an accident.
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(
                os.path.join(self.dir, f"step_{s:08d}"),
                ignore_errors=True)

    # ---- read -------------------------------------------------------------
    def all_steps(self) -> list[int]:
        out = []
        for name in sorted(os.listdir(self.dir)):
            full = os.path.join(self.dir, name)
            if (name.startswith("step_") and not name.endswith(".tmp")
                    and os.path.exists(os.path.join(full, ".COMPLETE"))):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _load_verified(self, step: int) -> dict | None:
        """Load + CRC-verify one committed step. None on corruption."""
        path = os.path.join(self.dir, f"step_{step:08d}")
        try:
            with open(os.path.join(path, "manifest.json")) as f:
                manifest = json.load(f)
            with np.load(os.path.join(path, "arrays.npz")) as z:
                flat = {k: z[k] for k in z.files}
        except Exception as e:
            log.warning("checkpoint step %d unreadable (%s: %s)",
                        step, type(e).__name__, e)
            return None
        meta = manifest.get("arrays", {})
        if set(meta) != set(flat):
            log.warning(
                "checkpoint step %d: array set mismatch (manifest %d, "
                "payload %d)", step, len(meta), len(flat))
            return None
        for k, info in meta.items():
            want = info.get("crc32")
            if want is None:
                continue  # pre-integrity checkpoint: nothing to verify
            if _crc(flat[k]) != want:
                log.warning(
                    "checkpoint step %d: CRC mismatch on %r", step, k)
                return None
        return flat

    def restore(self, template, step: int | None = None):
        """Load into host numpy, shaped like `template`. Returns
        (tree, step) or (None, None) when no checkpoint exists.

        Every array is CRC-verified against the manifest. When ``step``
        is None (pick latest), a corrupt step falls back to the
        previous .COMPLETE step with a loud warning — torn storage
        after commit must cost one checkpoint interval, not the run.
        An explicitly requested corrupt ``step`` raises
        :class:`CheckpointCorruptError` instead (the caller asked for
        those bytes specifically)."""
        self.wait()
        if step is not None:
            flat = self._load_verified(step)
            if flat is None:
                raise CheckpointCorruptError(
                    f"checkpoint step {step} in {self.dir} failed "
                    "integrity verification")
            return _unflatten_into(template, flat), step
        for s in reversed(self.all_steps()):
            flat = self._load_verified(s)
            if flat is not None:
                return _unflatten_into(template, flat), s
            log.warning(
                "checkpoint: step %d failed integrity verification — "
                "falling back to the previous .COMPLETE step", s)
        return None, None


def reshard(tree_host, device=None):
    """Put a host tree on ``device`` as torch tensors (every array copied,
    None subtrees kept), or, given a tree of ``partitioning.NamedSharding``
    of the same structure (or one sharding for every leaf), lay each array
    out on its mesh as a DTensor (``launch.shardings.distribute``: a
    collective every rank runs, rank 0's values broadcast or scattered).
    On one device this is the identity of the values."""
    from repro_torch.models.partitioning import NamedSharding, tree_map

    if isinstance(device, (dict, tuple, list, NamedSharding)):
        from repro_torch.launch import shardings as sh

        host = tree_map(lambda a: None if a is None else a.detach() if isinstance(a, torch.Tensor)
                        else torch.as_tensor(np.array(a)), tree_host)
        return sh.distribute(host, device)
    dev = torch.device(device) if device is not None else torch.device("cpu")

    def put(tree):
        if tree is None:
            return None
        if isinstance(tree, dict):
            return {k: put(v) for k, v in tree.items()}
        if hasattr(tree, "_fields"):
            return type(tree)(*(put(v) for v in tree))
        if isinstance(tree, (list, tuple)):
            return type(tree)(put(v) for v in tree)
        return torch.tensor(np.asarray(tree), device=dev)

    return put(tree_host)
