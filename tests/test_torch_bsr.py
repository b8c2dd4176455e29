"""The port's ``BlockSparse`` and block-sparse SDDMM (K6's plain path on
the CPU) against the reference's: the same numpy inputs go to
``repro.core.sparse.block_sparse_from_dense`` /
``repro.kernels.bsr_sddmm.bsr_sddmm`` (Pallas in interpret mode, as the
reference's own test runs it) and to the port.

Tolerance: the reference's own, ``tests/test_kernels.py::test_bsr_sddmm``'s
1e-5 (rtol and atol): both sides sum a v_r = 24 long fp32 product, in
other orders.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core.sparse import block_density as ref_block_density
from repro.core.sparse import block_sparse_from_dense as ref_bsr_from_dense
from repro.kernels.bsr_sddmm import bsr_sddmm as ref_bsr_sddmm
from repro_torch.core.sparse import (BlockSparse, block_density,
                                     block_sparse_from_dense)
from repro_torch.kernels import ops, ref

TOL = dict(rtol=1e-5, atol=1e-5)
# tests/test_kernels.py::test_bsr_sddmm's two parameter sets
CASES = [(256, 128, 64, 32, 0.0008), (512, 256, 128, 128, 0.00004)]


def _c(rng, v, n, density):
    return np.where(rng.random((v, n)) < density,
                    rng.random((v, n)), 0.0).astype(np.float32)


def _carry(ref_bsr) -> BlockSparse:
    """The reference's BlockSparse as the port's, through its arrays."""
    return BlockSparse(blocks=torch.as_tensor(np.array(ref_bsr.blocks)),
                       brow=torch.as_tensor(np.array(ref_bsr.brow)),
                       bcol=torch.as_tensor(np.array(ref_bsr.bcol)),
                       shape=tuple(ref_bsr.shape))


def _assert_equal(got: BlockSparse, want) -> None:
    np.testing.assert_array_equal(got.blocks.numpy(),
                                  np.asarray(want.blocks))
    np.testing.assert_array_equal(got.brow.numpy(), np.asarray(want.brow))
    np.testing.assert_array_equal(got.bcol.numpy(), np.asarray(want.bcol))
    assert got.brow.dtype == got.bcol.dtype == torch.int32
    assert tuple(got.shape) == tuple(want.shape)
    assert got.block_shape == want.block_shape


@pytest.mark.parametrize("pad", [None, 40])
@pytest.mark.parametrize("v,n,bv,bn,density", CASES)
def test_block_sparse_matches_reference(rng, v, n, bv, bn, density, pad):
    c = _c(rng, v, n, density)
    want = ref_bsr_from_dense(c, bv, bn, pad_blocks_to=pad)
    _assert_equal(block_sparse_from_dense(c, bv, bn, pad_blocks_to=pad),
                  want)
    # a tensor input gives the same, and the carried arrays are equal
    _assert_equal(block_sparse_from_dense(torch.as_tensor(c), bv, bn,
                                          pad_blocks_to=pad), want)
    _assert_equal(_carry(want), want)


@pytest.mark.parametrize("v,n,bv,bn,density", CASES + [(300, 100, 64, 48,
                                                        0.0005)])
def test_block_density_matches_reference(rng, v, n, bv, bn, density):
    """The last case has ragged edges (V, N not whole tiles)."""
    c = _c(rng, v, n, density)
    assert block_density(c, bv, bn) == ref_block_density(c, bv, bn)
    assert block_density(torch.as_tensor(c), bv, bn) == \
        ref_block_density(c, bv, bn)
    assert 0.0 < block_density(c, bv, bn) < 1.0


@pytest.mark.parametrize("v,n,bv,bn,density", CASES)
def test_bsr_sddmm_matches_reference(rng, v, n, bv, bn, density):
    c = _c(rng, v, n, density)
    ref_bsr = ref_bsr_from_dense(c, bv, bn)
    kt = rng.standard_normal((v, 24)).astype(np.float32)
    u = rng.standard_normal((24, n)).astype(np.float32)
    want = np.asarray(ref_bsr_sddmm(jnp.asarray(kt), jnp.asarray(u),
                                    ref_bsr, interpret=True))
    before = ops.bsr_sddmm_blocks.launches
    got = ops.bsr_sddmm(torch.as_tensor(kt), torch.as_tensor(u),
                        block_sparse_from_dense(c, bv, bn))
    assert ops.bsr_sddmm_blocks.launches == before    # CPU: plain version
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # the dense oracle and the plain blocks version agree with it too
    cb = _carry(ref_bsr)
    np.testing.assert_allclose(
        ref.bsr_sddmm_ref(torch.as_tensor(kt), torch.as_tensor(u),
                          cb).numpy(), want, **TOL)
    ktb, ub = ref.bsr_panels(torch.as_tensor(kt), torch.as_tensor(u),
                             cb.brow, cb.bcol, bv, bn)
    np.testing.assert_allclose(
        ops.bsr_sddmm_blocks(ktb.contiguous(), ub.contiguous(),
                             cb.blocks).numpy(), want, **TOL)


def test_bsr_sddmm_unpadded_operands(rng):
    """kt and u need not be padded to whole tiles: the missing rows and
    columns read as zero (V=300, N=100 with 128 x 64 tiles)."""
    c = _c(rng, 300, 100, 0.01)
    kt = torch.as_tensor(rng.standard_normal((300, 7)).astype(np.float32))
    u = torch.as_tensor(rng.standard_normal((7, 100)).astype(np.float32))
    cb = block_sparse_from_dense(c, 128, 64)
    assert cb.shape == (384, 128)
    got = ops.bsr_sddmm(kt, u, cb)
    full = torch.as_tensor(c) * (kt @ u)
    dense = torch.zeros(cb.shape)
    for b in range(cb.blocks.shape[0]):
        i, j = int(cb.brow[b]), int(cb.bcol[b])
        dense[i * 128:(i + 1) * 128, j * 64:(j + 1) * 64] += got[b]
    torch.testing.assert_close(dense[:300, :100], full, **TOL)


def test_pad_blocks_are_inert(rng):
    """Pad tiles (zero content at (0, 0)) give zero output and leave the
    live tiles' output as it was."""
    c = _c(rng, 256, 128, 0.0008)
    kt = torch.as_tensor(rng.standard_normal((256, 24)).astype(np.float32))
    u = torch.as_tensor(rng.standard_normal((24, 128)).astype(np.float32))
    plain = block_sparse_from_dense(c, 64, 32)
    nb = plain.blocks.shape[0]
    padded = block_sparse_from_dense(c, 64, 32, pad_blocks_to=nb + 9)
    assert padded.blocks.shape[0] == nb + 9
    assert (padded.brow[nb:] == 0).all() and (padded.bcol[nb:] == 0).all()
    w = ops.bsr_sddmm(kt, u, padded)
    assert (w[nb:] == 0).all()
    torch.testing.assert_close(w[:nb], ops.bsr_sddmm(kt, u, plain),
                               rtol=0, atol=0)


def test_zero_times_inf_is_nan():
    """The product is taken at every element, also where c = 0: an inf
    product times a zero c is NaN, as in the reference."""
    c = np.zeros((64, 32), np.float32)
    c[3, 5] = 0.5
    kt = torch.zeros((64, 2))
    kt[3, 0] = float("inf")
    u = torch.ones((2, 32))
    w = ops.bsr_sddmm(kt, u, block_sparse_from_dense(c, 64, 32))
    assert torch.isinf(w[0, 3, 5])
    assert torch.isnan(w[0, 3, 6])
    assert (w[0, 4] == 0).all()


def test_pad_blocks_to_too_small_raises(rng):
    c = _c(rng, 256, 128, 0.0008)
    n_live = block_sparse_from_dense(c, 64, 32).blocks.shape[0]
    with pytest.raises(ValueError, match="pad_blocks_to"):
        block_sparse_from_dense(c, 64, 32, pad_blocks_to=n_live - 1)
    with pytest.raises(ValueError):
        ref_bsr_from_dense(c, 64, 32, pad_blocks_to=n_live - 1)


def test_wrappers_check_their_inputs(rng):
    cb = block_sparse_from_dense(_c(rng, 128, 64, 0.01), 64, 32)
    kt, u = torch.zeros((128, 4)), torch.zeros((4, 64))
    with pytest.raises(ValueError, match="shape"):
        ops.bsr_sddmm(kt, torch.zeros((5, 64)), cb)
    with pytest.raises(ValueError, match="shape"):
        ops.bsr_sddmm(torch.zeros((200, 4)), u, cb)
    with pytest.raises(TypeError):
        ops.bsr_sddmm(kt.double(), u, cb)
    nb = cb.blocks.shape[0]
    with pytest.raises(ValueError, match="shape"):
        ops.bsr_sddmm_blocks(torch.zeros((nb, 64, 4)),
                             torch.zeros((nb, 5, 32)), cb.blocks)
