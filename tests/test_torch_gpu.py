"""The port's Hopper kernels against their plain PyTorch versions on the
card. Marked ``gpu``: each test skips, from inside, when no CUDA device is
present. Imports nothing of JAX, so it runs on a machine without it:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("b", [8, 24, 48, 100, 200])
def test_rwmd_min_cdist_matches_plain(rng, b):
    """b=200 runs as two launches (128 + 72 support rows)."""
    dev = _card()
    q, w, v = 4, 300, 5000
    a = torch.tensor(rng.standard_normal((q, b, w)), dtype=torch.float32,
                     device=dev)
    mask = torch.tensor(rng.random((q, b)) > 0.3, dtype=torch.float32,
                        device=dev)
    mask[:, 0] = 1.0
    mask[-1] = 0.0                            # an all-masked (filler) row
    vocab = torch.tensor(rng.standard_normal((v, w)), dtype=torch.float32,
                         device=dev)
    before = ops.rwmd_min_cdist.launches
    got = ops.rwmd_min_cdist(a, mask, vocab)
    torch.cuda.synchronize()
    assert ops.rwmd_min_cdist.launches == before + -(-b // 128)
    want = ref.rwmd_min_cdist_ref(a, mask, vocab)
    assert torch.isinf(got[-1]).all()
    fin = torch.isfinite(want)
    assert torch.equal(torch.isfinite(got), fin)
    # no query word is a vocabulary word here, so no d ~ 0 cancellation
    torch.testing.assert_close(got[fin], want[fin], rtol=1e-5, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("log_domain", [False, True])
@pytest.mark.parametrize("v_r,length,tile", [
    (24, 28, "auto"), (48, 48, "auto"), (96, 40, "auto"),
    (24, 28, "shared")])
def test_sinkhorn_fused_matches_plain(rng, log_domain, v_r, length, tile):
    """(96, 40) and tile="shared" take the shared-memory variant, the
    others the register-resident one."""
    dev = _card()
    q, n, lam = 3, 700, 4.0
    m = rng.uniform(0.1, 1.5, (q, v_r, n, length))
    g = (-lam * m) if log_domain else np.exp(-lam * m)
    r = np.ones((q, v_r))
    for qi, nr in enumerate([v_r, v_r - 5, v_r // 2]):
        g[qi, nr:] = -np.inf if log_domain else 0.0
        r[qi, :nr] = rng.uniform(0.1, 1.0, nr)
        r[qi, :nr] /= r[qi, :nr].sum()
    val = np.where(rng.random((n, length)) > 0.4, rng.random((n, length)),
                   0.0)
    val[:, 0] = np.maximum(val[:, 0], 0.05)
    val[n - 30:] = 0.0                        # pad docs
    val /= np.maximum(val.sum(1, keepdims=True), 1e-9)
    gt, vt, rt = (torch.tensor(x, dtype=torch.float32, device=dev)
                  for x in (g, val, r))
    got, iters = ops.sinkhorn_fused_all_batched(
        gt, vt, rt, lam, 15, log_domain=log_domain, with_iters=True,
        tile=tile)
    torch.cuda.synchronize()
    want, want_iters = ref.sinkhorn_fused_all_batched_ref(
        gt, vt, rt, lam, 15, log_domain=log_domain)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    assert torch.equal(iters, want_iters)
    assert (got[:, n - 30:] == 0).all()
