"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU with ``nvcc`` (marker ``cuda``) and
skips without one: a CUDA kernel has no CPU mode. The file imports no JAX,
so it runs on a machine that has only the port's dependencies:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels import pairwise_l2 as pairwise_l2_mod
from repro_torch.kernels.pairwise_l2 import pairwise_l2_cuda
from repro_torch.kernels.router_xattn import router_xattn_cuda

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(seed, b, k, d, device, dq=768, dm=20):
    """Engine-like operands: unit-norm query rows (as the featurizer gives),
    model embeddings in [0, 1), fan-in-scaled weights except Wq, which is
    N(0, 1) so the softmax over members is far from uniform."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(device)  # noqa: E731
    q = rng.standard_normal((b, dq))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    w = lambda i, o: rng.standard_normal((i, o)) / np.sqrt(i)  # noqa: E731
    m = t(rng.uniform(size=(k, dm)))
    kt, vt = ops.pool_projections(t(w(dm, d)), t(w(dm, d)), m)
    wq = t(rng.standard_normal((dq, d)))
    wo = t(w(d, k))
    return t(q), wq, kt, vt, wo, t(rng.standard_normal(k) * 0.1)


@pytest.mark.parametrize("b", [1, 37, 64, 256, 1000])
@pytest.mark.parametrize("k", [2, 5, 11, 64])
@pytest.mark.parametrize("d", [4, 20, 64])
def test_router_xattn_kernel_matches_plain(cuda, b, k, d):
    q, wq, kt, vt, wo, bo = _inputs(b + 7 * k + d, b, k, d, cuda)
    before = router_xattn_cuda.launches
    out = ops.router_xattn_pool(q, wq, kt, vt, wo, bo)
    torch.cuda.synchronize()
    assert router_xattn_cuda.launches == before + 1
    expect = ref.router_xattn_pool_ref(q, wq, kt, vt, wo, bo)
    torch.testing.assert_close(out, expect, rtol=1e-5, atol=1e-5)
    out_bf16 = ops.router_xattn_pool(q.to(torch.bfloat16), wq, kt, vt, wo, bo)
    expect_bf16 = ref.router_xattn_pool_ref(q.to(torch.bfloat16), wq, kt, vt, wo, bo)
    torch.testing.assert_close(out_bf16, expect_bf16, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("dq", [1, 31, 300, 2048])
def test_router_xattn_kernel_any_query_width(cuda, dq):
    q, wq, kt, vt, wo, bo = _inputs(dq, 19, 5, 20, cuda, dq=dq)
    torch.testing.assert_close(router_xattn_cuda(q, wq, kt, vt, wo, bo),
                               ref.router_xattn_pool_ref(q, wq, kt, vt, wo, bo),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("k", [2, 11, 64])
@pytest.mark.parametrize("d", [20, 64])
def test_router_xattn_kernel_wide_inputs(cuda, k, d):
    """N(0, 1) queries and large weights: logits spread by tens, so the
    summation order of the dq loop shows in the scores."""
    rng = np.random.default_rng(k * 100 + d)
    t = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32)).to(cuda)
    q, wq, m = t(256, 768), t(768, d) * 0.05, t(k, 20)
    kt, vt = ops.pool_projections(t(20, d) * 0.3, t(20, d) * 0.3, m)
    wo, bo = t(d, k) * 0.3, t(k) * 0.1
    torch.testing.assert_close(router_xattn_cuda(q, wq, kt, vt, wo, bo),
                               ref.router_xattn_pool_ref(q, wq, kt, vt, wo, bo),
                               rtol=1e-5, atol=1e-5)


def _points(seed, n, k, d, device):
    rng = np.random.default_rng(seed)
    t = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32)).to(device)
    return t(n, d), t(k, d)


@pytest.mark.parametrize("n,k,d", [(1, 1, 8), (8, 3, 16), (100, 20, 768), (256, 256, 64),
                                   (300, 37, 128), (65, 129, 33), (48, 20, 768),
                                   (64, 4096, 768), (1000, 1000, 1024), (7, 5, 2049)])
def test_pairwise_l2_kernel_matches_plain(cuda, n, k, d):
    """Ragged N, K and d on every side of the 64-row tiles and 32-wide slices."""
    x, c = _points(n * 7 + k + d, n, k, d, cuda)
    before = pairwise_l2_cuda.launches
    out = ops.pairwise_l2(x, c)
    torch.cuda.synchronize()
    assert pairwise_l2_cuda.launches == before + 1
    assert out.shape == (n, k) and out.dtype == torch.float32
    torch.testing.assert_close(out, ref.pairwise_l2_ref(x, c), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("x_bf16,c_bf16", [(True, True), (True, False), (False, True)])
def test_pairwise_l2_kernel_bf16(cuda, x_bf16, c_bf16):
    x, c = _points(11, 130, 70, 256, cuda)
    x = x.to(torch.bfloat16) if x_bf16 else x
    c = c.to(torch.bfloat16) if c_bf16 else c
    torch.testing.assert_close(pairwise_l2_cuda(x, c), ref.pairwise_l2_ref(x, c),
                               rtol=5e-2, atol=5e-2)


def test_pairwise_l2_kernel_identical_rows_are_exactly_zero(cuda):
    ones = torch.ones((8, 32), device=cuda)
    assert torch.equal(pairwise_l2_cuda(ones, ones), torch.zeros((8, 8), device=cuda))
    rng = np.random.default_rng(0)
    e = rng.standard_normal((64, 768))
    e /= np.linalg.norm(e, axis=1, keepdims=True)
    x = torch.from_numpy(e.astype(np.float32)).to(cuda)
    assert torch.equal(torch.diagonal(pairwise_l2_cuda(x, x)), torch.zeros(64, device=cuda))


def test_pairwise_l2_kernel_refuses_what_it_does_not_take(cuda):
    x, c = _points(1, 4, 3, 8, cuda)
    before = pairwise_l2_cuda.launches
    with pytest.raises(ValueError, match="on cpu"):
        pairwise_l2_cuda(x, c.cpu())
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        pairwise_l2_cuda(x.double(), c)
    with pytest.raises(ValueError, match="contiguous"):
        pairwise_l2_cuda(x.T, c[:, :4])
    with pytest.raises(ValueError, match="N <="):
        pairwise_l2_cuda(torch.empty((64 * 65536, 1), device=cuda), c[:, :1].contiguous())
    assert pairwise_l2_cuda.launches == before


def test_pairwise_l2_refused_launch_raises(cuda, monkeypatch):
    """A launch the runtime refuses never runs; the C entry point returns
    cudaGetLastError() and the wrapper raises with its message."""
    class Refusing:
        def pairwise_l2_launch(self, *args):
            return 9

        def pairwise_l2_error_string(self, err):
            return b"invalid configuration argument"

    x, c = _points(2, 4, 3, 8, cuda)
    before = pairwise_l2_cuda.launches
    monkeypatch.setattr(pairwise_l2_mod, "_library", Refusing)
    with pytest.raises(RuntimeError, match="launch failed: invalid configuration"):
        pairwise_l2_cuda(x, c)
    assert pairwise_l2_cuda.launches == before
