"""Port parity of the synthetic data pipeline (``repro_torch.data.
pipeline``): tokens bit-equal to JAX's ``global_batch_np`` for any
(seed, step, shape, vocab, repeat), the same host shards and iterator
skip-ahead, and JAX's own properties of the pipeline
(``tests/test_data.py``) on the port."""
import numpy as np
import pytest
import torch

from repro.data import pipeline as jpipe
from repro_torch.data import pipeline as tpipe
from test_torch_helpers import one_torch_thread  # noqa: F401  (autouse fixture)

CASES = [  # vocab, seq_len, global_batch, seed, repeat, step
    (1000, 32, 8, 3, 4, 7), (128256, 1024, 2, 0, 4, 0), (512, 64, 4, 0, 1, 5),
    (50, 64, 32, 9, 4, 123456789), (102400, 17, 3, 2**31 - 1, 3, 2**32 - 1),
]


@pytest.mark.parametrize("vocab,seq,batch,seed,repeat,step", CASES)
def test_tokens_bit_equal_to_jax(vocab, seq, batch, seed, repeat, step):
    cj = jpipe.DataConfig(vocab=vocab, seq_len=seq, global_batch=batch, seed=seed, repeat=repeat)
    ct = tpipe.DataConfig(vocab=vocab, seq_len=seq, global_batch=batch, seed=seed, repeat=repeat)
    want = jpipe.global_batch_np(cj, step)
    got = tpipe.global_batch_np(ct, step)
    assert got.dtype == want.dtype == np.int32 and got.shape == (batch, seq)
    np.testing.assert_array_equal(got, want)
    b = tpipe.make_batch(ct, step, "cpu")
    assert b["tokens"].dtype == torch.int32 and b["labels"] is b["tokens"]
    np.testing.assert_array_equal(b["tokens"].numpy(), np.asarray(jpipe.make_batch(cj, step)["tokens"]))


def test_hash_is_jaxs():
    a = np.arange(0, 2**40, 2**40 // 4097, dtype=np.uint64)
    np.testing.assert_array_equal(tpipe._hash_u32(a), jpipe._hash_u32(a))


@pytest.mark.parametrize("n_hosts", [1, 2, 4, 8])
def test_host_shards_are_jaxs(n_hosts):
    cj = jpipe.DataConfig(vocab=100, seq_len=16, global_batch=8)
    ct = tpipe.DataConfig(vocab=100, seq_len=16, global_batch=8)
    parts = [tpipe.host_shard(ct, 3, h, n_hosts) for h in range(n_hosts)]
    for h, part in enumerate(parts):
        np.testing.assert_array_equal(part, jpipe.host_shard(cj, 3, h, n_hosts))
    np.testing.assert_array_equal(np.concatenate(parts, 0), tpipe.global_batch_np(ct, 3))


def test_iterator_skip_ahead_and_jaxs_sequence():
    cj = jpipe.DataConfig(vocab=100, seq_len=16, global_batch=4)
    ct = tpipe.DataConfig(vocab=100, seq_len=16, global_batch=4)
    it_j, it_t = jpipe.DataIterator(cj), tpipe.DataIterator(ct)
    for _ in range(5):
        last = next(it_t)
        np.testing.assert_array_equal(last["tokens"].numpy(), np.asarray(next(it_j)["tokens"]))
    it2 = tpipe.DataIterator(ct, start_step=4)
    np.testing.assert_array_equal(last["tokens"].numpy(), next(it2)["tokens"].numpy())
    it2.skip_to(1)
    np.testing.assert_array_equal(next(it2)["tokens"].numpy(), tpipe.global_batch_np(ct, 1))


def test_determinism_and_range():
    cfg = tpipe.DataConfig(vocab=1000, seq_len=32, global_batch=8, seed=3)
    a, b = tpipe.global_batch_np(cfg, 7), tpipe.global_batch_np(cfg, 7)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, tpipe.global_batch_np(cfg, 8))
    assert a.min() >= 0 and a.max() < 1000


def test_structure_learnable():
    """repeat-block structure: copying the previous token beats chance."""
    cfg = tpipe.DataConfig(vocab=50, seq_len=64, global_batch=32, repeat=4)
    toks = tpipe.global_batch_np(cfg, 0)
    assert (toks[:, 1:] == toks[:, :-1]).mean() > 0.6
