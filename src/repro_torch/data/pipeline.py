"""Deterministic stateless token pipeline and the WMD request stream (port
of ``repro.data.pipeline``).

``batch_at_step`` is a pure function of (seed, step, host, shape): a job
resumed from a checkpoint at step k replays the identical stream with no
pipeline state in the checkpoint. It returns the reference's tokens bit
for bit: the reference draws them with ``jax.random`` (threefry2x32 with
``jax_threefry_partitionable``: ``PRNGKey(seed)``, ``fold_in(step)``,
``fold_in(host_id)``, ``randint``), and this module computes the same
hash in numpy uint32 arithmetic (:func:`threefry2x32`, :func:`fold_in`,
:func:`split`, :func:`random_bits`, :func:`randint`).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

_U32 = np.uint32
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: np.ndarray, d: int) -> np.ndarray:
    return (x << _U32(d)) | (x >> _U32(32 - d))


def threefry2x32(key: np.ndarray, x0: np.ndarray,
                 x1: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The Threefry-2x32 block cipher (20 rounds) of the counter pairs
    (x0, x1) under ``key`` (2,) uint32; every sum wraps mod 2**32."""
    k0, k1 = _U32(key[0]), _U32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _U32(0x1BD11BDA))
    x0 = np.asarray(x0, _U32) + ks[0]
    x1 = np.asarray(x1, _U32) + ks[1]
    with np.errstate(over="ignore"):
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, r) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + _U32(i + 1)
    return x0, x1


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)``: (seed >> 32, seed & 0xFFFFFFFF)."""
    return np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF], _U32)


def fold_in(key: np.ndarray, data: int) -> np.ndarray:
    """``jax.random.fold_in``: the hash of the pair (0, data) under key."""
    y0, y1 = threefry2x32(key, np.array([0], _U32),
                          np.array([data & 0xFFFFFFFF], _U32))
    return np.array([y0[0], y1[0]], _U32)


def _iota_2x32(n: int) -> tuple[np.ndarray, np.ndarray]:
    """A 64-bit iota of n as (high, low) uint32 words."""
    i = np.arange(n, dtype=np.uint64)
    return (i >> np.uint64(32)).astype(_U32), (i & np.uint64(0xFFFFFFFF)
                                               ).astype(_U32)


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """``jax.random.split`` in its partitionable form: key i is the hash
    of the 64-bit counter i. (num, 2) uint32."""
    b0, b1 = threefry2x32(key, *_iota_2x32(num))
    return np.stack([b0, b1], axis=1)


def random_bits(key: np.ndarray, shape: tuple) -> np.ndarray:
    """32 random bits per element in the partitionable form: the two words
    of the hash of each element's 64-bit row-major index, XORed."""
    b0, b1 = threefry2x32(key, *_iota_2x32(int(np.prod(shape))))
    return (b0 ^ b1).reshape(shape)


def randint(key: np.ndarray, shape: tuple, minval: int,
            maxval: int) -> np.ndarray:
    """``jax.random.randint(key, shape, minval, maxval, int32)`` for int32
    bounds: two draws of 32 bits combined modulo the span, as
    ``jax._src.random._randint`` does in uint32 arithmetic (wrapping)."""
    k1, k2 = split(key)
    hi, lo = random_bits(k1, shape), random_bits(k2, shape)
    span = _U32(maxval - minval if maxval > minval else 1)
    with np.errstate(over="ignore"):
        mult = _U32(2 ** 16) % span
        mult = (mult * mult) % span
        off = ((hi % span) * mult + lo % span) % span
    return (np.int64(minval) + off.astype(np.int64)).astype(np.int32)


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    global_batch: int
    seq_len: int
    seed: int = 0


def batch_at_step(dc: DataConfig, step: int, host_id: int = 0,
                  n_hosts: int = 1) -> dict:
    """Synthetic-corpus batch for ``step`` (this host's slice of the global
    batch): ``{"tokens", "labels"}``, int64 (B, T) tensors on the host,
    labels the next-token shift. The second half of each row echoes its
    first half, so there is something to learn."""
    per_host = dc.global_batch // n_hosts
    key = fold_in(fold_in(prng_key(dc.seed), step), host_id)
    base = randint(key, (per_host, dc.seq_len + 1), 0, dc.vocab_size)
    half = dc.seq_len // 2
    echoed = base.copy()
    echoed[:, half + 1:] = base[:, 1:dc.seq_len - half + 1]
    out = torch.from_numpy(echoed.astype(np.int64))
    return {"tokens": out[:, :-1], "labels": out[:, 1:]}


def host_batch_iterator(dc: DataConfig, start_step: int = 0,
                        host_id: int = 0, n_hosts: int = 1):
    """(step, batch) from ``start_step`` on, forever."""
    step = start_step
    while True:
        yield step, batch_at_step(dc, step, host_id, n_hosts)
        step += 1


def wmd_request_stream(corpus, seed: int = 0):
    """Batched WMD serving requests: yields full-vocab query histograms
    drawn from the corpus query set (:func:`.corpus.make_corpus`)."""
    rng = np.random.default_rng(seed)
    n = corpus.queries.shape[0]
    while True:
        yield corpus.queries[rng.integers(0, n)]
