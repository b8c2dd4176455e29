"""The port's step-keyed token pipeline against the reference's
``repro.data.pipeline``: bit for bit (the same threefry2x32 stream), its
determinism and host sharding, and ``host_batch_iterator``."""
import jax
import numpy as np
import pytest
import torch

from repro.data.pipeline import DataConfig as RefDataConfig
from repro.data.pipeline import batch_at_step as ref_batch_at_step
from repro_torch.data import pipeline as P


@pytest.mark.parametrize("seed,step,host_id,n_hosts,vocab,seq_len", [
    (3, 17, 0, 1, 1000, 16),        # the reference test's config
    (0, 0, 0, 1, 49155, 33),        # granite's vocabulary, odd T
    (7, 123456, 1, 2, 100000, 32),  # span > 2**16: the multiplier wraps
    (2 ** 31 - 1, 5, 3, 4, 8192, 7),
    (1, 2, 0, 1, 65536, 10),
    (5, 2 ** 31 + 9, 0, 1, 70000, 11),
    (0, 3, 0, 1, 2, 5),
    (11, 400, 2, 4, 151936, 64),
])
def test_batch_at_step_bit_equal_to_reference(seed, step, host_id, n_hosts,
                                              vocab, seq_len):
    want = ref_batch_at_step(RefDataConfig(vocab, 8, seq_len, seed), step,
                             host_id, n_hosts)
    got = P.batch_at_step(P.DataConfig(vocab, 8, seq_len, seed), step,
                          host_id, n_hosts)
    for k in ("tokens", "labels"):
        assert got[k].dtype == torch.int64
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


@pytest.mark.parametrize("seed,data", [(0, 0), (42, 7), (2 ** 31 - 1, 2 ** 32 - 1)])
def test_key_functions_match_jax(seed, data):
    key = jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(P.prng_key(seed), np.asarray(key))
    np.testing.assert_array_equal(P.fold_in(P.prng_key(seed), data),
                                  np.asarray(jax.random.fold_in(key, data)))
    np.testing.assert_array_equal(P.split(P.prng_key(seed), 3),
                                  np.asarray(jax.random.split(key, 3)))
    np.testing.assert_array_equal(
        P.randint(P.prng_key(seed), (4, 5), 3, 1000),
        np.asarray(jax.random.randint(key, (4, 5), 3, 1000)))


def test_pipeline_deterministic_and_host_sharded():
    """Mirror of test_substrate.py's test."""
    dc = P.DataConfig(vocab_size=1000, global_batch=8, seq_len=16, seed=3)
    b1 = P.batch_at_step(dc, step=17)
    b2 = P.batch_at_step(dc, step=17)
    assert torch.equal(b1["tokens"], b2["tokens"])
    b3 = P.batch_at_step(dc, step=18)
    assert not torch.equal(b1["tokens"], b3["tokens"])
    h0 = P.batch_at_step(dc, 17, host_id=0, n_hosts=2)
    h1 = P.batch_at_step(dc, 17, host_id=1, n_hosts=2)
    assert h0["tokens"].shape == (4, 16)
    assert not torch.equal(h0["tokens"], h1["tokens"])
    assert torch.equal(b1["tokens"][:, 1:], b1["labels"][:, :-1])


def test_batches_echo_their_first_half():
    dc = P.DataConfig(vocab_size=97, global_batch=2, seq_len=12, seed=1)
    t = P.batch_at_step(dc, 4)["tokens"]
    assert torch.equal(t[:, 7:], t[:, 1:6])


def test_host_batch_iterator():
    dc = P.DataConfig(vocab_size=500, global_batch=4, seq_len=8, seed=2)
    it = P.host_batch_iterator(dc, start_step=5, host_id=1, n_hosts=2)
    for want_step in (5, 6, 7):
        step, batch = next(it)
        assert step == want_step
        ref = ref_batch_at_step(RefDataConfig(500, 4, 8, 2), step, 1, 2)
        np.testing.assert_array_equal(batch["tokens"].numpy(),
                                      np.asarray(ref["tokens"]))
