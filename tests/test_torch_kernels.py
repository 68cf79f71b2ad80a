"""The port's ``router_xattn`` entry points against the JAX reference.

On the CPU the wrappers run the kernel's plain PyTorch version; the
reference runs its Pallas kernel in interpret mode and its jnp oracle.
Inputs are numpy, seeded. Tolerances are those of tests/test_kernels.py:
1e-5 for fp32 and 2e-2 for bf16 q. The CUDA kernel itself is held against
the plain version on the card in tests/test_torch_cuda.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.predictors import PREDICTORS as JAX_PREDICTORS
from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro_torch import bridge
from repro_torch.core.predictors import PREDICTORS
from repro_torch.kernels import ops, ref
from repro_torch.kernels import router_xattn as router_xattn_mod
from repro_torch.kernels.router_xattn import router_xattn_cuda


def _inputs(seed, b, k, d, dq=768, dm=20):
    """(q, wq, wk, wv, wo, bo, m_emb) as float32 numpy arrays."""
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return (n(b, dq), n(dq, d) * 0.05, n(dm, d) * 0.3, n(dm, d) * 0.3,
            n(d, k) * 0.3, n(k) * 0.1, n(k, dm))


def _both(arrays, q_dtype=np.float32):
    """The same inputs as torch tensors and jnp arrays; q cast to q_dtype."""
    q, *rest = arrays
    tq = torch.from_numpy(q)
    jq = jnp.asarray(q)
    if q_dtype != np.float32:
        tq, jq = tq.to(torch.bfloat16), jq.astype(jnp.bfloat16)
    return ([tq] + [torch.from_numpy(a) for a in rest],
            [jq] + [jnp.asarray(a) for a in rest])


@pytest.mark.parametrize("b", [1, 8, 100, 256, 300])
@pytest.mark.parametrize("k", [2, 5, 11])
def test_router_xattn_shape_sweep(b, k):
    t_in, j_in = _both(_inputs(b * 31 + k, b, k, 20))
    out = ops.router_xattn(*t_in)
    assert out.shape == (b, k) and out.dtype == torch.float32
    np.testing.assert_allclose(
        out.numpy(), np.asarray(jax_ops.router_xattn(*j_in, interpret=True)),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(jax_ref.router_xattn_ref(*j_in)),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d_latent", [4, 20, 64, 128])
def test_router_xattn_dtype_latent_sweep(dtype, d_latent):
    q_dtype = np.float32 if dtype == "float32" else "bf16"
    t_in, j_in = _both(_inputs(d_latent, 64, 5, d_latent, dq=256), q_dtype)
    out = ops.router_xattn(*t_in)
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(
        out.numpy(), np.asarray(jax_ops.router_xattn(*j_in, interpret=True)),
        rtol=tol, atol=tol)
    np.testing.assert_allclose(out.numpy(), np.asarray(jax_ref.router_xattn_ref(*j_in)),
                               rtol=tol, atol=tol)


def test_router_xattn_pool_matches_pool_projection_path():
    """router_xattn_pool on pool_projections == router_xattn == the oracle."""
    q, wq, wk, wv, wo, bo, m = (torch.from_numpy(a) for a in _inputs(9, 37, 5, 20))
    kt, vt = ops.pool_projections(wk, wv, m)
    jkt, jvt = jax_ops.pool_projections(jnp.asarray(wk.numpy()), jnp.asarray(wv.numpy()),
                                        jnp.asarray(m.numpy()))
    np.testing.assert_allclose(kt.numpy(), np.asarray(jkt), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(vt.numpy(), np.asarray(jvt), rtol=1e-6, atol=1e-6)
    pooled = ops.router_xattn_pool(q, wq, kt, vt, wo, bo)
    np.testing.assert_array_equal(pooled.numpy(),
                                  ops.router_xattn(q, wq, wk, wv, wo, bo, m).numpy())
    np.testing.assert_allclose(pooled.numpy(),
                               ref.router_xattn_ref(q, wq, wk, wv, wo, bo, m).numpy(),
                               rtol=1e-6, atol=1e-6)


def test_router_xattn_matches_predictor_modules():
    """Kernel semantics == the attention predictor, in both packages."""
    params = jax.tree.map(np.asarray,
                          JAX_PREDICTORS["attn"].init(jax.random.key(0), 768, 5, 20))
    rng = np.random.default_rng(1)
    q = rng.standard_normal((40, 768)).astype(np.float32)
    m = rng.standard_normal((5, 20)).astype(np.float32)
    tp = bridge.router_params_from_jax(params, "cpu")
    kern = ops.router_xattn(torch.from_numpy(q), tp["wq"], tp["wk"], tp["wv"],
                            tp["wo"], tp["bo"], torch.from_numpy(m)).numpy()
    port = PREDICTORS["attn"].apply(tp, torch.from_numpy(q), torch.from_numpy(m))
    jax_core = JAX_PREDICTORS["attn"].apply(params, jnp.asarray(q), jnp.asarray(m))
    np.testing.assert_allclose(kern, port.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(port.numpy(), np.asarray(jax_core), rtol=1e-5, atol=1e-5)


def test_predictor_init_shapes_and_device():
    gen = torch.Generator().manual_seed(0)
    p = PREDICTORS["attn"].init(gen, 768, 3, 20)
    ref_p = JAX_PREDICTORS["attn"].init(jax.random.key(0), 768, 3, 20)
    assert {k: tuple(v.shape) for k, v in p.items()} == \
        {k: tuple(v.shape) for k, v in ref_p.items()}
    assert all(v.device.type == "cpu" and v.dtype == torch.float32
               for v in p.values())


@pytest.mark.parametrize("bad", ["cpu_operand", "k_too_wide", "d_too_wide",
                                 "wo_shape", "q_dtype"])
def test_cuda_wrapper_rejects_what_the_kernel_does_not_take(bad):
    """The launch wrapper checks device, shape, dtype before building anything."""
    k, d = {"k_too_wide": (65, 20), "d_too_wide": (5, 65)}.get(bad, (5, 20))
    q, wq, wk, wv, wo, bo, m = (torch.from_numpy(a) for a in _inputs(0, 4, k, d))
    kt, vt = ops.pool_projections(wk, wv, m)
    if bad == "wo_shape":
        wo = wo.T.contiguous()
    if bad == "q_dtype":
        q = q.double()
    with pytest.raises((ValueError, TypeError)):
        router_xattn_cuda(q, wq, kt, vt, wo, bo)


# Launch plans of the CUDA kernel (pure Python, no card): every shape of the
# sweeps in chip_smoke.py and tests/test_torch_cuda.py, the serving path's
# shapes (B 8 per serve, up to 64 per trace batch, 256 timed; dq 768, d 20,
# K 2) and the seams of the split: dq one below, at and one above a 32-row
# tile and a rank's slice, B on both sides of the rows per cluster.
_ROWS = router_xattn_mod.ROWS
_PLAN_SHAPES = sorted(
    {(b, 768, d, k) for b in (1, 37, 64, 256, 1000) for k in (2, 5, 11, 64)
     for d in (4, 20, 64)}
    | {(19, dq, 20, 5) for dq in (1, 31, 300, 2048)}
    | {(b, dq, 20, 5) for b in (1, _ROWS - 1, _ROWS, _ROWS + 1)
       for dq in (1, 7, 31, 32, 33, 95, 96, 97, 767, 768, 769, 2048, 5000)}
    | {(256, 2048, d, 11) for d in (20, 64)} | {(256, 768, d, k) for d in (20, 64)
                                                for k in (2, 11, 64)}
    | {(b, 768, 20, 2) for b in (8, 64, 256)}
    | {(3, 5000, 64, 64), (8, 768, 20, 5), (1, 1, 1, 1)})


@pytest.mark.parametrize("b,dq,d,k", _PLAN_SHAPES)
def test_router_xattn_plan(b, dq, d, k):
    pl = router_xattn_mod.plan(b, dq, d, k)
    assert 1 <= pl.cluster <= 8 and pl.grid % pl.cluster == 0
    assert pl.threads == 32 * pl.rows <= 1024
    assert pl.smem <= 232_448
    assert pl.slice % 32 == 0 and 32 <= pl.chunk <= min(pl.slice, 256)
    # Cluster c writes query rows [c * rows, (c + 1) * rows): every row of
    # the output exactly once.
    written = [r for c in range(pl.grid // pl.cluster)
               for r in range(c * pl.rows, min(b, (c + 1) * pl.rows))]
    assert written == list(range(b))
    assert (pl.grid // pl.cluster - 1) * pl.rows < b
    # The ranks' slices of dq cover it exactly once, none empty; each is
    # whole 32-row tiles, so the blocked sum's tiles do not move.
    rows = [[r for r in range(s * pl.slice, min(dq, (s + 1) * pl.slice))]
            for s in range(pl.cluster)]
    assert all(rows) and sum(rows, []) == list(range(dq))


def test_router_xattn_plan_at_the_serving_shape():
    """dq = 768 over eight ranks of 96 rows, 4 query rows per cluster: 16
    blocks at B 8, 512 at B 256. A query narrower than one tile takes
    cluster 1."""
    assert router_xattn_mod.plan(8, 768, 20, 2) == router_xattn_mod.Plan(
        cluster=8, rows=4, slice=96, chunk=96, grid=16, threads=128, smem=14_264)
    assert router_xattn_mod.plan(256, 768, 20, 2).grid == 512
    assert router_xattn_mod.plan(8, 1, 20, 2).cluster == 1
    assert router_xattn_mod.plan(8, 32, 20, 2).cluster == 1
