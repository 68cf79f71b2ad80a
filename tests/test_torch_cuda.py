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
from repro_torch.kernels.router_xattn import router_xattn_cuda

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the router_xattn kernel has no CPU mode")
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
