"""Deterministic synthetic data pipeline, shardable and restartable.

Port of ``repro.data.pipeline``. Tokens are a pure function of (seed,
step, position) via a counter-mode integer hash computed host-side with
numpy (this module keeps its own copy of the hash), so any host can
materialize exactly its shard of any global batch, and restart with
skip-ahead is O(1): just set the step. The tokens are bit-equal to the
JAX package's ``global_batch_np``.

This is the honest stand-in for a real corpus reader: the *contract*
(global batch -> per-host shard -> device layout, deterministic resume)
is the part the framework needs; the bytes themselves are synthetic.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    # repeat-block structure so cross-entropy has learnable signal:
    # each fresh token repeats `repeat` times -> next-token prediction
    # succeeds (repeat-1)/repeat of the time for a model that learns copy
    repeat: int = 4


def _hash_u32(a: np.ndarray) -> np.ndarray:
    """xxhash-ish integer mix, vectorized (deterministic across hosts)."""
    x = a.astype(np.uint64)
    x = (x ^ (x >> 33)) * np.uint64(0xFF51AFD7ED558CCD)
    x = (x ^ (x >> 33)) * np.uint64(0xC4CEB9FE1A85EC53)
    x = x ^ (x >> 33)
    return (x & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def global_batch_np(cfg: DataConfig, step: int) -> np.ndarray:
    """(global_batch, seq_len) int32 tokens for a given step."""
    B, L, V = cfg.global_batch, cfg.seq_len, cfg.vocab
    rows = np.arange(B, dtype=np.uint64)[:, None]
    cols = np.arange(L, dtype=np.uint64)[None, :]
    base = (np.uint64(cfg.seed) << np.uint64(32)) + np.uint64(step)
    r = max(1, cfg.repeat)
    block_cols = cols // np.uint64(r)
    h = _hash_u32(base * np.uint64(1_000_003) + rows * np.uint64(L) + block_cols)
    return (h % np.uint32(V)).astype(np.int32)


def host_shard(cfg: DataConfig, step: int, host_id: int, n_hosts: int) -> np.ndarray:
    """This host's contiguous rows of the global batch."""
    assert cfg.global_batch % n_hosts == 0
    per = cfg.global_batch // n_hosts
    full = global_batch_np(cfg, step)
    return full[host_id * per:(host_id + 1) * per]


def make_batch(cfg: DataConfig, step: int, device="cpu") -> dict:
    """Device-ready {"tokens", "labels"} int32 (B, L) on ``device``
    (labels = tokens; the loss shifts). JAX's ``sharding`` argument is a
    placement on a mesh; one card holds the whole batch."""
    tok = torch.from_numpy(global_batch_np(cfg, step)).to(device)
    return {"tokens": tok, "labels": tok}


class DataIterator:
    """Stateful wrapper with O(1) skip-ahead for checkpoint resume."""

    def __init__(self, cfg: DataConfig, start_step: int = 0, device="cpu"):
        self.cfg = cfg
        self.step = start_step
        self.device = device

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        b = make_batch(self.cfg, self.step, self.device)
        self.step += 1
        return b

    def skip_to(self, step: int):
        self.step = step
