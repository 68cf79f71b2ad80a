"""The port's ``pairwise_l2`` entry point against the JAX reference.

On the CPU ``ops.pairwise_l2`` runs the kernel's plain PyTorch version;
the reference runs its Pallas kernel in interpret mode and its jnp oracle.
Inputs are numpy, seeded, over the shapes of tests/test_kernels.py.
Tolerances are that file's: 1e-4 for fp32 (the two frameworks sum the
cross term in different orders) and 5e-2 for bf16 inputs. The CUDA kernel
itself is held against the plain version on the card in
tests/test_torch_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.clustering import pairwise_sq_dists as jax_pairwise_sq_dists
from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro_torch.core.clustering import pairwise_sq_dists
from repro_torch.kernels import ops
from repro_torch.kernels.pairwise_l2 import pairwise_l2_cuda


def _inputs(seed, n, k, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d)).astype(np.float32),
            rng.standard_normal((k, d)).astype(np.float32))


@pytest.mark.parametrize("n,k,d", [(8, 3, 16), (100, 20, 768), (256, 256, 64),
                                   (300, 37, 128), (1, 1, 8)])
def test_pairwise_l2_shape_sweep(n, k, d):
    x, c = _inputs(n * 7 + k, n, k, d)
    before = pairwise_l2_cuda.launches
    out = ops.pairwise_l2(torch.from_numpy(x), torch.from_numpy(c))
    assert pairwise_l2_cuda.launches == before, "a CPU tensor launches nothing"
    assert out.shape == (n, k) and out.dtype == torch.float32
    jx, jc = jnp.asarray(x), jnp.asarray(c)
    np.testing.assert_allclose(
        out.numpy(), np.asarray(jax_ops.pairwise_l2(jx, jc, interpret=True)),
        rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(out.numpy(), np.asarray(jax_ref.pairwise_l2_ref(jx, jc)),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pairwise_l2_dtypes(dtype):
    x, c = _inputs(0, 64, 16, 256)
    tx, tc = torch.from_numpy(x), torch.from_numpy(c)
    jx, jc = jnp.asarray(x), jnp.asarray(c)
    if dtype == "bfloat16":
        tx, tc = tx.to(torch.bfloat16), tc.to(torch.bfloat16)
        jx, jc = jx.astype(jnp.bfloat16), jc.astype(jnp.bfloat16)
    out = ops.pairwise_l2(tx, tc)
    assert out.dtype == torch.float32
    tol = 1e-4 if dtype == "float32" else 5e-2
    np.testing.assert_allclose(
        out.numpy(), np.asarray(jax_ops.pairwise_l2(jx, jc, interpret=True)),
        rtol=tol, atol=tol)
    np.testing.assert_allclose(out.numpy(), np.asarray(jax_ref.pairwise_l2_ref(jx, jc)),
                               rtol=tol, atol=tol)


def test_pairwise_l2_zero_distance_on_identical_rows():
    x = torch.ones((8, 32))
    out = ops.pairwise_l2(x, x)
    assert torch.equal(out, torch.zeros((8, 8)))


def test_pairwise_l2_clamps_at_zero():
    """Rounding in x2 - 2 x.c + c2 can go below zero for near-equal rows;
    the result is clamped, as the reference's is."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((16, 768)).astype(np.float32) * 30.0
    c = x + rng.standard_normal(x.shape).astype(np.float32) * 1e-6
    tx, tc = torch.from_numpy(x), torch.from_numpy(c)
    raw = (tx * tx).sum(1, keepdim=True) - 2.0 * (tx @ tc.T) + (tc * tc).sum(1)
    assert float(raw.min()) < 0.0, "the input must round below zero somewhere"
    out = ops.pairwise_l2(tx, tc)
    assert float(out.min()) == 0.0
    np.testing.assert_array_equal(out.numpy(), torch.clamp(raw, min=0.0).numpy())


def test_pairwise_l2_matches_clustering_module():
    x, c = _inputs(5, 50, 7, 96)
    np.testing.assert_allclose(
        ops.pairwise_l2(torch.from_numpy(x), torch.from_numpy(c)).numpy(),
        pairwise_sq_dists(torch.from_numpy(x), torch.from_numpy(c)).numpy(),
        rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(
        pairwise_sq_dists(torch.from_numpy(x), torch.from_numpy(c)).numpy(),
        np.asarray(jax_pairwise_sq_dists(jnp.asarray(x), jnp.asarray(c))),
        rtol=1e-4, atol=1e-4)


def test_pairwise_l2_rejects_mismatched_widths():
    with pytest.raises(RuntimeError):
        ops.pairwise_l2(torch.ones(4, 8), torch.ones(3, 9))
