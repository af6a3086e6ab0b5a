"""The port's checkpoint manager: ports of ``tests/test_checkpoint.py``
(atomicity, CRC fallback, keep-k GC, async save, the directory lock,
carry resume), the layout shared with the JAX package (a directory
written by either restores in the other, arrays and CRCs equal), and the
guarded run's resume. ``reshard`` is the identity of the values on one
device. Carries are compared bit for bit."""
import json
import os
import subprocess
import sys
from typing import NamedTuple

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import faults
import torch_faults
from repro.checkpoint import manager as jmanager
from repro.core import solver as jsolver
from repro_torch.checkpoint.manager import (
    CheckpointCorruptError, CheckpointLockError, CheckpointManager, _crc, reshard)
from repro_torch.core import interop
from repro_torch.core import recovery as trec
from repro_torch.core import solver as tsolver
from test_torch_helpers import one_torch_thread  # noqa: F401  (autouse fixture)


class OptState(NamedTuple):
    step: torch.Tensor
    mu: dict
    nu: dict


def _tree(seed=0):
    """A tree whose first array fills most of the file, so the byte
    :func:`_corrupt_one_array` flips lands in array data."""
    rng = np.random.default_rng(seed)
    return {"a": torch.tensor(rng.normal(size=(64, 48)), dtype=torch.float32),
            "nested": {"b": torch.arange(5)},
            "opt": OptState(step=torch.tensor(7), mu={"a": torch.ones(2)},
                            nu={"a": torch.zeros(2)})}


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [] if tree is None else [np.asarray(tree)]


def _assert_trees_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape and x.tobytes() == y.tobytes()


def test_save_restore_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    tree = _tree()
    mgr.save(10, tree)
    restored, step = mgr.restore(tree)
    assert step == 10
    _assert_trees_equal(tree, restored)
    assert isinstance(restored["opt"], OptState)
    assert isinstance(restored["a"], np.ndarray)


def test_incomplete_checkpoint_ignored(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    tree = _tree()
    mgr.save(1, tree)
    broken = tmp_path / "step_00000002"
    broken.mkdir()
    (broken / "arrays.npz").write_bytes(b"garbage")
    assert mgr.latest_step() == 1
    assert mgr.restore(tree)[1] == 1


def test_keep_k_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, _tree())
    assert mgr.all_steps() == [3, 4]


def test_async_save(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(5, _tree(), blocking=False)
    mgr.wait()
    assert mgr.latest_step() == 5


def test_restore_empty(tmp_path):
    restored, step = CheckpointManager(str(tmp_path)).restore(_tree())
    assert restored is None and step is None


def test_persistent_carry_roundtrip_bit_identical_resume(tmp_path):
    """A kernel-backend PersistentCarry (None optional fields included)
    survives save -> restore, and a resumed run bit-matches the
    uninterrupted one: 5 steps + checkpoint + 5 steps == 10 straight."""
    cfg, st = torch_faults.lattice(dict(backend="kernel"))
    mgr = CheckpointManager(str(tmp_path))
    template = interop.carry_to_numpy(tsolver.init_persistent(cfg, st))
    carry = tsolver.run_persistent(cfg, tsolver.init_persistent(cfg, st), 5)
    snap = interop.carry_to_numpy(carry)
    mgr.save(int(snap.steps), snap)
    final_a = tsolver.finalize_persistent(cfg, tsolver.run_persistent(cfg, carry, 5))
    restored, step = mgr.restore(template)
    assert step == 5
    assert restored.idx_dummy is None and restored.nl.trunc is None
    resumed = interop.carry_from_numpy(restored, "cpu")
    assert resumed.steps == 5 and isinstance(resumed.steps, int)
    final_b = tsolver.finalize_persistent(cfg, tsolver.run_persistent(cfg, resumed, 5))
    _assert_trees_equal(interop.state_to_numpy(final_a), interop.state_to_numpy(final_b))


def test_reshard_is_the_identity_on_one_device(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    tree = {"w": torch.tensor(np.random.default_rng(1).normal(size=(8, 4)), dtype=torch.float32),
            "none": None}
    mgr.save(1, tree)
    host, _ = mgr.restore(tree)
    dev = reshard(host, "cpu")
    assert isinstance(dev["w"], torch.Tensor) and dev["none"] is None
    assert torch.equal(dev["w"], tree["w"])
    assert not np.shares_memory(dev["w"].numpy(), host["w"])


def _corrupt_one_array(step_dir):
    p = os.path.join(step_dir, "arrays.npz")
    data = bytearray(open(p, "rb").read())
    data[len(data) // 2] ^= 0xFF
    open(p, "wb").write(bytes(data))


def test_crc_mismatch_falls_back_to_previous_step(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=0)
    tree = _tree()
    mgr.save(1, tree)
    mgr.save(2, tree)
    _corrupt_one_array(str(tmp_path / "step_00000002"))
    assert mgr.latest_step() == 2
    restored, step = mgr.restore(tree)
    assert step == 1
    _assert_trees_equal(tree, restored)


def test_truncated_npz_falls_back(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=0)
    mgr.save(1, _tree())
    mgr.save(2, _tree())
    p = tmp_path / "step_00000002" / "arrays.npz"
    p.write_bytes(p.read_bytes()[: p.stat().st_size // 2])
    restored, step = mgr.restore(_tree())
    assert step == 1 and restored is not None


def test_explicit_corrupt_step_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, _tree())
    _corrupt_one_array(str(tmp_path / "step_00000003"))
    with pytest.raises(CheckpointCorruptError):
        mgr.restore(_tree(), step=3)


def test_keep_semantics(tmp_path):
    """keep=1 retains exactly the newest step; keep=0 means keep all."""
    m1 = CheckpointManager(str(tmp_path / "one"), keep=1)
    m0 = CheckpointManager(str(tmp_path / "all"), keep=0)
    for s in (1, 2, 3):
        m1.save(s, _tree())
        m0.save(s, _tree())
    assert m1.all_steps() == [3] and m0.all_steps() == [1, 2, 3]


@pytest.mark.parametrize("kind", ["numpy", "torch"])
def test_async_save_copies_host_arrays(tmp_path, kind):
    """save(blocking=False) copies its leaves: the caller mutating them
    right after the call cannot leak into the written checkpoint."""
    mgr = CheckpointManager(str(tmp_path))
    lane = np.ones(4, np.float32) if kind == "numpy" else torch.ones(4)
    mgr.save(1, {"lane": lane}, blocking=False)
    lane[:] = -1.0  # mutate immediately, racing the writer thread
    mgr.wait()
    restored, _ = mgr.restore({"lane": lane})
    np.testing.assert_array_equal(restored["lane"], np.ones(4, np.float32))


def test_async_save_error_surfaces_on_wait(tmp_path, monkeypatch):
    mgr = CheckpointManager(str(tmp_path))

    def boom(step, host):
        raise OSError("disk full")

    monkeypatch.setattr(mgr, "_write", boom)
    mgr.save(1, {"x": np.zeros(2)}, blocking=False)
    with pytest.raises(OSError, match="disk full"):
        mgr.wait()
    mgr.wait()  # the error is consumed


def test_lock_conflict_with_live_foreign_owner(tmp_path):
    proc = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(60)"])
    try:
        with open(tmp_path / ".lock", "w") as f:
            json.dump({"pid": proc.pid, "t": 0.0}, f)
        with pytest.raises(CheckpointLockError) as exc:
            CheckpointManager(str(tmp_path))
        assert exc.value.owner_pid == proc.pid
        assert str(tmp_path) in str(exc.value)
    finally:
        proc.kill()
        proc.wait()


def test_lock_dead_owner_reclaimed(tmp_path):
    proc = subprocess.Popen([sys.executable, "-c", "pass"])
    proc.wait()
    with open(tmp_path / ".lock", "w") as f:
        json.dump({"pid": proc.pid, "t": 0.0}, f)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _tree())
    assert mgr.all_steps() == [1] and mgr.reclaimed_from == proc.pid
    with open(tmp_path / ".lock") as f:
        assert json.load(f)["pid"] == os.getpid()
    mgr.close()


def test_lock_reentrant_same_process_and_close_releases(tmp_path):
    mgr1 = CheckpointManager(str(tmp_path))
    mgr2 = CheckpointManager(str(tmp_path))
    mgr2.save(1, _tree())
    mgr1.close()
    mgr2.close()
    assert not os.path.exists(tmp_path / ".lock")
    CheckpointManager(str(tmp_path)).close()


def test_lock_torn_unreadable_lockfile_reclaimed(tmp_path):
    with open(tmp_path / ".lock", "w") as f:
        f.write("{pid: 12")
    mgr = CheckpointManager(str(tmp_path))
    assert os.path.exists(tmp_path / ".lock")
    mgr.close()


# --------------------------------------------------------------------------
# the layout shared with the JAX package
# --------------------------------------------------------------------------
def _numpy_tree(seed=3):
    rng = np.random.default_rng(seed)
    return {"x": rng.normal(size=(6, 2)).astype(np.float32),
            "h": rng.normal(size=5).astype(np.float16),
            "ids": np.arange(7, dtype=np.int32), "flag": np.array(True),
            "inner": [np.int32(4), {"u": np.array([1, 2], np.uint32)}]}


def _manifest(directory, step):
    with open(os.path.join(directory, f"step_{step:08d}", "manifest.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_directory_restores_across_packages(tmp_path, writer):
    """A numpy tree written by one package's manager restores in the
    other's with equal arrays; the manifests' CRCs equal both packages'
    CRC of the arrays, and the two writers' manifests are identical."""
    tree = _numpy_tree()
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jm, tm = jmanager.CheckpointManager(jdir), CheckpointManager(tdir)
    jm.save(4, tree)
    tm.save(4, tree)
    jm.close()
    tm.close()
    assert _manifest(jdir, 4) == _manifest(tdir, 4)
    src = jdir if writer == "jax" else tdir
    reader = (CheckpointManager if writer == "jax" else jmanager.CheckpointManager)(src)
    restored, step = reader.restore(tree)
    assert step == 4
    _assert_trees_equal(tree, restored)
    for key, info in _manifest(src, 4)["arrays"].items():
        flat = jmanager._flatten(restored)[key]
        assert info["crc32"] == _crc(flat) == jmanager._crc(flat), key


def test_carry_layout_shared_with_jax(tmp_path):
    """The same lattice on the list backend: the port's carry and JAX's
    write the same array paths, shapes and dtypes (JAX's uint32 flags
    aside), and the port resumes from JAX's checkpoint with the arrays
    JAX saved (flags as int32, the step counters as host ints)."""
    cj, sj = faults.lattice()
    ct, st = torch_faults.lattice(dict(backend="xla"))
    jcarry = jsolver.run_persistent(cj, jsolver.init_persistent(cj, sj), 3)
    jsnap = jax.tree.map(np.asarray, jcarry)
    jm = jmanager.CheckpointManager(str(tmp_path / "jax"))
    jm.save(3, jsnap)
    tcarry = tsolver.run_persistent(ct, tsolver.init_persistent(ct, st), 3)
    tm = CheckpointManager(str(tmp_path / "port"))
    tm.save(3, interop.carry_to_numpy(tcarry))
    ja, ta = (_manifest(str(tmp_path / d), 3)["arrays"] for d in ("jax", "port"))
    assert ja.keys() == ta.keys()
    for k in ja:
        want = dict(ja[k], dtype="int32") if k == "flags" else ja[k]
        assert (ta[k]["shape"], ta[k]["dtype"]) == (want["shape"], want["dtype"]), k
    template = interop.carry_to_numpy(tsolver.init_persistent(ct, st))
    tm2 = CheckpointManager(str(tmp_path / "jax"))
    restored, step = tm2.restore(template)
    carry = interop.carry_from_numpy(restored, "cpu")
    assert step == 3 and carry.steps == 3 and carry.flags.dtype == torch.int32
    np.testing.assert_array_equal(carry.st.fluid.v.numpy(), np.asarray(jcarry.st.fluid.v))
    np.testing.assert_array_equal(carry.binning.counts.numpy(),
                                  np.asarray(jcarry.binning.counts))
    assert jnp.asarray(jcarry.steps) == carry.steps


def test_guarded_run_resume_bitmatches_uninterrupted(tmp_path):
    """A guarded run saves its healthy snapshot every block; the newest
    step restored into a fresh carry and run to the end bit-matches the
    uninterrupted guarded run; with the newest file truncated the
    manager falls back to the step before it."""
    cfg, st = torch_faults.lattice(dict(backend="kernel"))
    mgr = CheckpointManager(str(tmp_path), keep=0)
    policy = trec.GuardPolicy(block=4)
    out, stats, rep, _ = trec.run_guarded(cfg, st, 12, policy, checkpoint=mgr,
                                          checkpoint_every=1)
    assert mgr.all_steps() == [4, 8, 12] and rep.events == []
    template = interop.carry_to_numpy(tsolver.init_persistent(cfg, st))
    for truncate in (False, True):
        if truncate:
            p = tmp_path / "step_00000012" / "arrays.npz"
            p.write_bytes(p.read_bytes()[: p.stat().st_size // 2])
        restored, step = mgr.restore(template, step=None if truncate else 8)
        assert step == 8
        carry = interop.carry_from_numpy(restored, "cpu")
        carry = tsolver.run_persistent(cfg, carry, 12 - step)
        assert carry.steps == stats.steps and carry.rebuilds == stats.rebuilds
        _assert_trees_equal(interop.state_to_numpy(out),
                            interop.state_to_numpy(tsolver.finalize_persistent(cfg, carry)))
