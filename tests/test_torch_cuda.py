"""The port's CUDA kernels against their plain versions, training, the
mixture-of-experts member, sliding-window and long-prompt attention, the
recurrent members (xlstm-1.3b, the jamba hybrid), the last three
configs (musicgen-large, llama4-maverick, cross attention with
llama-3.2-vision and its stub media), the Mamba scan's gradient, the
online adaptation and cascade layers, the kernel-dispatch profiler, the
socket fleet's two processes, an LM train step, the train, prefill
and decode steps on a 1x1 NCCL mesh, and a pool served on that mesh, on
the card.

Every test here needs an NVIDIA GPU with ``nvcc`` (marker ``cuda``) and
skips without one: a CUDA kernel has no CPU mode. The file imports no JAX,
so it runs on a machine that has only the port's dependencies:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core.predictors import PREDICTORS
from repro_torch.core.router import PredictiveRouter
from repro_torch.data.routerbench import generate
from repro_torch.kernels import ops, ref
from repro_torch.kernels import pairwise_l2 as pairwise_l2_mod
from repro_torch.kernels import router_xattn as router_xattn_mod
from repro_torch.kernels.pairwise_l2 import pairwise_l2_cuda
from repro_torch.kernels.router_xattn import router_xattn_cuda
from repro_torch.common.tree import tree_map
from repro_torch.configs import get_smoke_config
from repro_torch.launch.serve import DEFAULT_POOL, build_engine, stub_media, synthetic_requests
from repro_torch.configs.base import ATTN, MLP, XATTN, LayerSpec
from repro_torch.models import attention as attn_mod
from repro_torch.models import lm, moe, ssm, xlstm
from repro_torch.serving.engine import RoutedEngine, pad_prompts, prompt_pad_mask
from repro_torch.training import TrainConfig, train_dual_predictors, train_predictor

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
@pytest.mark.parametrize("k", [2, 3, 5, 11, 64])
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


_ROWS = router_xattn_mod.ROWS


@pytest.mark.parametrize("b", [1, _ROWS - 1, _ROWS, _ROWS + 1])
@pytest.mark.parametrize("dq", [1, 7, 31, 32, 33, 95, 96, 97, 767, 768, 769, 2048, 5000])
def test_router_xattn_kernel_cluster_edges(cuda, dq, b):
    """dq one below, at and one above a 32-row tile and a rank's slice (96
    rows at dq = 768; 5000: three chunks per rank); B on both sides of the
    rows per cluster. One launch per call."""
    q, wq, kt, vt, wo, bo = _inputs(dq * 10 + b, b, 5, 20, cuda, dq=dq)
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        before = router_xattn_cuda.launches
        out = router_xattn_cuda(q.to(dtype), wq, kt, vt, wo, bo)
        torch.cuda.synchronize()
        assert router_xattn_cuda.launches == before + 1
        torch.testing.assert_close(
            out, ref.router_xattn_pool_ref(q.to(dtype), wq, kt, vt, wo, bo),
            rtol=tol, atol=tol)


@pytest.mark.parametrize("d", [20, 64])
def test_router_xattn_kernel_wide_inputs_long_query(cuda, d):
    """N(0, 1) queries of width 2048 split over eight ranks: the rank-order
    sum of the partials holds 1e-5."""
    rng = np.random.default_rng(d)
    t = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32)).to(cuda)
    q, wq, m = t(256, 2048), t(2048, d) * 0.05, t(11, 20)
    kt, vt = ops.pool_projections(t(20, d) * 0.3, t(20, d) * 0.3, m)
    wo, bo = t(d, 11) * 0.3, t(11) * 0.1
    assert router_xattn_mod.plan(256, 2048, d, 11).cluster == 8
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


@pytest.mark.parametrize("n,k", [(1, 4096), (48, 20)])
@pytest.mark.parametrize("d", [1, 31, 32, 33, 95, 96, 97, 767, 768, 769, 1000])
def test_pairwise_l2_kernel_split_d(cuda, n, k, d):
    """d one below, at and one above a slice of 32 and a rank's share (96
    features at d = 768 in the drift window), split over the ranks of a
    cluster (S > 1 wherever d has more than one slice), odd widths on the
    4-byte copy path; one launch."""
    pl = pairwise_l2_mod.plan(n, k, d)
    assert pl.cluster > 1 or d <= 32
    x, c = _points(d + n, n, k, d, cuda)
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 5e-2)):
        before = pairwise_l2_cuda.launches
        out = pairwise_l2_cuda(x.to(dtype), c.to(dtype))
        torch.cuda.synchronize()
        assert pairwise_l2_cuda.launches == before + 1
        torch.testing.assert_close(out, ref.pairwise_l2_ref(x.to(dtype), c.to(dtype)),
                                   rtol=tol, atol=tol)


@pytest.mark.parametrize("d", [768, 1000])
def test_pairwise_l2_kernel_identical_rows_exactly_zero_under_split(cuda, d):
    rng = np.random.default_rng(d)
    e = rng.standard_normal((64, d))
    e /= np.linalg.norm(e, axis=1, keepdims=True)
    x = torch.from_numpy(e.astype(np.float32)).to(cuda)
    assert pairwise_l2_mod.plan(64, 64, d).cluster == 8
    assert torch.equal(torch.diagonal(pairwise_l2_cuda(x, x)), torch.zeros(64, device=cuda))
    assert torch.equal(torch.diagonal(pairwise_l2_cuda(x[:1], x[:1])),
                       torch.zeros(1, device=cuda))
    xb = x.to(torch.bfloat16)
    assert torch.equal(torch.diagonal(pairwise_l2_cuda(xb, xb)), torch.zeros(64, device=cuda))


def test_pairwise_l2_kernel_wide_k(cuda):
    """K walks gridDim.x, clusters and all, so 64 x 65536 centroids launch
    (N walks gridDim.y and is refused above 65535 tiles)."""
    k = 64 * 65536
    c = torch.arange(k, device=cuda, dtype=torch.float32)[:, None] / k
    x = torch.tensor([[0.5], [0.25]], device=cuda)
    assert pairwise_l2_mod.plan(2, k, 1).grid == (65536, 1)
    before = pairwise_l2_cuda.launches
    out = pairwise_l2_cuda(x, c)
    torch.cuda.synchronize()
    assert pairwise_l2_cuda.launches == before + 1
    torch.testing.assert_close(out, ref.pairwise_l2_ref(x, c), rtol=1e-4, atol=1e-4)


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


def test_pairwise_l2_refused_cluster_does_not_resurface(cuda, monkeypatch):
    """A cluster above the portable 8 blocks is refused by the runtime: the
    wrapper raises, and the next good launch neither fails nor reports the
    refused one's error."""
    x, c = _points(4, 48, 20, 768, cuda)
    good = pairwise_l2_mod.plan
    monkeypatch.setattr(pairwise_l2_mod, "plan",
                        lambda *a: good(*a)._replace(cluster=16, spr=2))
    before = pairwise_l2_cuda.launches
    with pytest.raises(RuntimeError, match="pairwise_l2 launch failed"):
        pairwise_l2_cuda(x, c)
    assert pairwise_l2_cuda.launches == before
    monkeypatch.setattr(pairwise_l2_mod, "plan", good)
    out = pairwise_l2_cuda(x, c)
    torch.cuda.synchronize()
    assert pairwise_l2_cuda.launches == before + 1
    torch.testing.assert_close(out, ref.pairwise_l2_ref(x, c), rtol=1e-4, atol=1e-4)


def test_router_xattn_refused_launch_raises_after_the_cap_is_raised(cuda, monkeypatch):
    """The shared-memory cap is raised once per instance; a launch the
    runtime refuses later (a plan above the card's 227 KB) still never runs,
    the wrapper raises each time, and the next good plan launches."""
    q, wq, kt, vt, wo, bo = _inputs(3, 8, 5, 20, cuda)
    expect = ref.router_xattn_pool_ref(q, wq, kt, vt, wo, bo)
    torch.testing.assert_close(router_xattn_cuda(q, wq, kt, vt, wo, bo), expect,
                               rtol=1e-5, atol=1e-5)
    good = router_xattn_mod.plan
    monkeypatch.setattr(router_xattn_mod, "plan",
                        lambda *a: good(*a)._replace(smem=232_448 + 1024))
    before = router_xattn_cuda.launches
    for _ in range(2):
        with pytest.raises(RuntimeError, match="router_xattn launch failed"):
            router_xattn_cuda(q, wq, kt, vt, wo, bo)
    assert router_xattn_cuda.launches == before
    monkeypatch.setattr(router_xattn_mod, "plan", good)
    torch.testing.assert_close(router_xattn_cuda(q, wq, kt, vt, wo, bo), expect,
                               rtol=1e-5, atol=1e-5)
    assert router_xattn_cuda.launches == before + 1


def test_router_xattn_kernel_above_48kb_of_shared_memory(cuda):
    """d = K = 64 at dq = 5000 stages 256-row chunks: 136 KB of shared memory
    per block, which the raised cap admits."""
    assert router_xattn_mod.plan(3, 5000, 64, 64).smem > 48 * 1024
    q, wq, kt, vt, wo, bo = _inputs(5, 3, 64, 64, cuda, dq=5000)
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        torch.testing.assert_close(
            router_xattn_cuda(q.to(dtype), wq, kt, vt, wo, bo),
            ref.router_xattn_pool_ref(q.to(dtype), wq, kt, vt, wo, bo), rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# Training on the card, and the kernel on trained params
# ---------------------------------------------------------------------------

def _corpus(k):
    """Embeddings and the first k quality and cost columns of the synthetic
    corpus (k = 5 is pool1's size, 11 every model), split 75/5/20."""
    data = generate(400, seed=0)
    tr, va, te = data.split(seed=0)
    return data.emb, data.quality[:, :k], data.cost[:, :k], tr, va, te


def _trained_router(k, device, epochs=20):
    emb, quality, cost, tr, va, _ = _corpus(k)
    memb = np.random.default_rng(k).uniform(size=(k, 20)).astype(np.float32)
    qp, cp, scaler, _ = train_dual_predictors(
        "attn", "attn", emb[tr], quality[tr], cost[tr], memb, q_emb_val=emb[va],
        quality_val=quality[va], cost_val=cost[va], epochs=epochs, seed=0, device=device)
    return PredictiveRouter("attn", "attn", qp, cp, memb, cost_scaler=scaler)


def test_training_steps_on_the_card_equal_the_cpus(cuda):
    """Same initial params and batches: the card's loss histories stay within
    rtol 1e-3 of the CPU's (cuBLAS and the CPU sum in other orders)."""
    emb, quality, _, tr, va, _ = _corpus(5)
    memb = np.random.default_rng(0).uniform(size=(5, 20)).astype(np.float32)
    init = PREDICTORS["attn"].init(torch.Generator().manual_seed(0), 768, 5, 20)
    cfg = TrainConfig(batch_size=64, epochs=6, eval_every=2)
    runs = {dev: train_predictor("attn", emb[tr], quality[tr], memb, cfg,
                                 (emb[va], quality[va]), init_params=init, device=dev)
            for dev in ("cpu", "cuda")}
    assert all(t.device.type == "cuda" for t in runs["cuda"][0].values())
    for key in ("train_loss", "val_loss"):
        np.testing.assert_allclose(runs["cuda"][1][key], runs["cpu"][1][key], rtol=1e-3)


def test_train_predictor_without_device_raises_without_cuda(monkeypatch):
    """Runs without a card too: training has no silent CPU path."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    emb, quality = np.ones((8, 768)), np.ones((8, 2))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_predictor("attn", emb, quality, np.ones((2, 20), np.float32), TrainConfig(epochs=1))


@pytest.mark.parametrize("k", [2, 3, 5, 11])
def test_kernel_equals_plain_predictor_on_trained_params(cuda, k):
    router = _trained_router(k, cuda)
    emb, *_, te = _corpus(k)
    engine = RoutedEngine(router=router, pool=[], device=cuda)
    before = router_xattn_cuda.launches
    s_kernel, c_kernel = engine.score_emb(emb[te])
    assert router_xattn_cuda.launches == before + 1
    s_plain, c_plain = router.predict(emb[te])
    np.testing.assert_allclose(s_kernel, s_plain, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(c_kernel, c_plain)


def test_router_grown_past_64_members_raises_on_the_kernel_path(cuda):
    """``add_member`` can grow a pool past the kernel's K <= 64; scoring it
    through the kernel raises and names the limit."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    qp = PREDICTORS["attn"].init(gen, 768, 64, 20)
    cp = PREDICTORS["attn"].init(gen, 768, 64, 20)
    memb = np.random.default_rng(0).uniform(size=(64, 20)).astype(np.float32)
    router = PredictiveRouter("attn", "attn", qp, cp, memb)
    q = _corpus(2)[0][:8]
    RoutedEngine(router=router, pool=[], device=cuda).score_emb(q)
    grown = router.add_member()
    assert grown.n_members == 65
    with pytest.raises(ValueError, match="K <= 64"):
        RoutedEngine(router=grown, pool=[], device=cuda).score_emb(q)


def test_build_engine_trains_the_router_on_the_card(cuda):
    engine = build_engine(["qwen3-0.6b", "granite-3-8b"], smoke=True, device=cuda, epochs=3)
    assert engine.router.device.type == "cuda"
    assert engine.router.centroids.shape == (20, 768)
    s, c = engine.score_texts(["prove the integral converges", "write a short poem"])
    assert s.shape == c.shape == (2, 2) and np.isfinite(s).all()


# ---------------------------------------------------------------------------
# The mixture-of-experts member on the card
# ---------------------------------------------------------------------------

def test_moe_member_on_the_card_equals_the_cpu(cuda, monkeypatch):
    """Smoke granite-moe: prefill and decode logits on the card within 1e-4
    of the CPU's, greedy tokens equal, and the decode path logs one drop
    count per MoE layer and step, every one 0."""
    cfg = get_smoke_config("granite-moe-1b-a400m")
    params = lm.init_lm(torch.Generator().manual_seed(5), cfg)
    params_gpu = tree_map(lambda t: t.to(cuda), params)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, size=n, dtype=np.int32) for n in (5, 17, 9)]
    tok, mask = pad_prompts(prompts, cfg), prompt_pad_mask(prompts, cfg)
    with torch.inference_mode():
        caches = {d: lm.init_caches(cfg, 3, 20, d) for d in ("cpu", cuda)}
        lg_cpu, _ = lm.apply_lm_prefill(cfg, params, tok, caches["cpu"], mask)
        lg_gpu, _ = lm.apply_lm_prefill(cfg, params_gpu, tok.to(cuda), caches[cuda],
                                        mask.to(cuda))
        torch.testing.assert_close(lg_gpu.cpu(), lg_cpu, rtol=1e-4, atol=1e-4)
        nxt = torch.argmax(lg_cpu[:, -1, :cfg.vocab_size], -1)[:, None].to(torch.int32)
        for i in range(2):
            lg_cpu, _ = lm.apply_lm_decode(cfg, params, nxt, caches["cpu"], 17 + i)
            lg_gpu, _ = lm.apply_lm_decode(cfg, params_gpu, nxt.to(cuda), caches[cuda], 17 + i)
            torch.testing.assert_close(lg_gpu.cpu(), lg_cpu, rtol=1e-4, atol=1e-4)
    monkeypatch.setattr(moe, "DECODE_DROP_LOG", [])
    t_gpu = lm.greedy_generate(cfg, params_gpu, tok.to(cuda), 6, attn_mask=mask.to(cuda))
    assert moe.DECODE_DROP_LOG == [0] * (cfg.n_layers * 5)
    t_cpu = lm.greedy_generate(cfg, params, tok, 6, attn_mask=mask)
    assert torch.equal(t_gpu.cpu(), t_cpu)


def test_build_engine_serves_the_default_pool_on_the_card(cuda):
    """The three-member default pool, smoke size: the router trains for
    K = 3 on the card, scores through the kernel, and granite-moe generates."""
    names = DEFAULT_POOL.split(",")
    engine = build_engine(names, smoke=True, device=cuda, epochs=3)
    texts, prompts = synthetic_requests(6, 512, seed=1, min_len=3, max_len=20)
    before = router_xattn_cuda.launches
    res = engine.serve(texts, prompts, max_new=4)
    assert router_xattn_cuda.launches == before + 1
    assert engine.router.n_members == 3 and len(res["per_member_counts"]) == 3
    mi = names.index("granite-moe-1b-a400m")
    outs, costs = engine.generate_member(mi, prompts, max_new=4)
    assert all(len(o) == 4 and 0 <= o.min() and o.max() < 512 for o in outs)
    assert np.all(costs > 0)


# ---------------------------------------------------------------------------
# Sliding-window and long-prompt attention on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window", [0, 16, 100])
def test_flash_equals_dense_on_the_card(cuda, window):
    """Banded flash against dense with the window mask on the card, with
    softcap and left pads (real query rows), and against the CPU's flash."""
    rng = np.random.default_rng(window)
    b, s, hq, hkv, hd = 2, 256, 4, 2, 32
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               for shape in ((b, s, hq, hd), (b, s, hkv, hd), (b, s, hkv, hd)))
    valid = torch.ones((b, s), dtype=torch.bool)
    valid[0, :70] = False
    kw = dict(window=window, q_chunk=64, k_chunk=64, softcap=30.0)
    got = attn_mod.flash_attention(q.to(cuda), k.to(cuda), v.to(cuda),
                                   kv_valid=valid.to(cuda), **kw)
    mask = attn_mod.causal_mask(s, s, cuda, window=window) & valid.to(cuda)[:, None, :]
    dense = attn_mod.dense_attention(q.to(cuda), k.to(cuda), v.to(cuda), mask, 30.0)
    torch.testing.assert_close(got[valid.to(cuda)], dense[valid.to(cuda)],
                               rtol=2e-4, atol=2e-5)
    cpu = attn_mod.flash_attention(q, k, v, kv_valid=valid, **kw)
    torch.testing.assert_close(got.cpu(), cpu, rtol=2e-4, atol=2e-5)


def test_ring_cache_equals_full_cache_on_the_card(cuda):
    """A ring of 8 slots and a 24-slot linear cache, both masked to the
    window, give equal decode outputs across three wraps."""
    cfg = get_smoke_config("gemma3-27b")
    spec = LayerSpec(mixer=ATTN, ffn=MLP, window=8)
    p = attn_mod.init_attention(torch.Generator(device=cuda).manual_seed(0), cfg, spec)
    b, steps = 2, 24
    xs = torch.randn((b, steps, cfg.d_model), generator=torch.Generator(device=cuda)
                     .manual_seed(1), device=cuda) * 0.3
    ring = attn_mod.init_kv_cache(cfg, spec, b, 8, cuda)
    full = attn_mod.init_kv_cache(cfg, LayerSpec(mixer=ATTN, ffn=MLP), b, steps, cuda)
    for t in range(steps):
        o_ring, ring = attn_mod.self_attention_decode(cfg, spec, p, xs[:, t:t + 1], ring, t)
        o_full, full = attn_mod.self_attention_decode(cfg, spec, p, xs[:, t:t + 1], full, t)
        torch.testing.assert_close(o_ring, o_full, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name", ["qwen1.5-4b", "gemma3-27b"])
@pytest.mark.parametrize("lengths", [(5, 17, 9), (2048, 1500)])
def test_attention_members_on_the_card_equal_the_cpu(cuda, name, lengths):
    """Smoke qwen1.5-4b (nonzero QKV biases) and gemma3-27b (window 8):
    17-token prompts wrap the window in prefill and decode, 2048 takes
    flash; prefill and two decode steps' logits within 1e-4 of the CPU's,
    greedy tokens equal."""
    cfg = get_smoke_config(name)
    params = lm.seed_qkv_biases(lm.init_lm(torch.Generator().manual_seed(5), cfg), cfg)
    params_gpu = tree_map(lambda t: t.to(cuda), params)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, size=n, dtype=np.int32) for n in lengths]
    tok, mask = pad_prompts(prompts, cfg), prompt_pad_mask(prompts, cfg)
    s = tok.shape[1]
    with torch.inference_mode():
        caches = {d: lm.init_caches(cfg, len(prompts), s + 3, d) for d in ("cpu", cuda)}
        lg_cpu, _ = lm.apply_lm_prefill(cfg, params, tok, caches["cpu"], mask)
        lg_gpu, _ = lm.apply_lm_prefill(cfg, params_gpu, tok.to(cuda), caches[cuda],
                                        mask.to(cuda))
        torch.testing.assert_close(lg_gpu.cpu(), lg_cpu, rtol=1e-4, atol=1e-4)
        nxt = torch.argmax(lg_cpu[:, -1, :cfg.vocab_size], -1)[:, None].to(torch.int32)
        for i in range(2):
            lg_cpu, _ = lm.apply_lm_decode(cfg, params, nxt, caches["cpu"], s + i)
            lg_gpu, _ = lm.apply_lm_decode(cfg, params_gpu, nxt.to(cuda), caches[cuda], s + i)
            torch.testing.assert_close(lg_gpu.cpu(), lg_cpu, rtol=1e-4, atol=1e-4)
    t_gpu = lm.greedy_generate(cfg, params_gpu, tok.to(cuda), 4, attn_mask=mask.to(cuda))
    t_cpu = lm.greedy_generate(cfg, params, tok, 4, attn_mask=mask)
    assert torch.equal(t_gpu.cpu(), t_cpu)


# ---------------------------------------------------------------------------
# Recurrent members on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["xlstm-1.3b", "jamba-1.5-large-398b"])
@pytest.mark.parametrize("lengths", [(5, 17, 9), (600, 40)])
def test_recurrent_members_on_the_card_equal_the_cpu(cuda, name, lengths):
    """Smoke xlstm-1.3b (600 tokens pad to 768, three mLSTM chunks) and
    jamba (Mamba, attention, MoE): prefill and two decode steps' logits
    within 1e-4 of the CPU's, greedy tokens equal."""
    _card_equals_cpu(cuda, get_smoke_config(name), lengths)


def _card_equals_cpu(cuda, cfg, lengths):
    """Seeded params (and stub media, for cross layers) on the card and on
    the CPU: prefill of left-padded prompts of ``lengths`` and two decode
    steps within 1e-4, greedy tokens equal."""
    gen = torch.Generator().manual_seed(5)
    params = lm.init_lm(gen, cfg)
    params_gpu = tree_map(lambda t: t.to(cuda), params)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, size=n, dtype=np.int32) for n in lengths]
    tok, mask = pad_prompts(prompts, cfg), prompt_pad_mask(prompts, cfg)
    s = tok.shape[1]
    media = stub_media(cfg, gen)
    media = None if media is None else media.expand(len(prompts), -1, -1)
    media_gpu = None if media is None else media.to(cuda)
    with torch.inference_mode():
        caches = {d: lm.init_caches(cfg, len(prompts), s + 3, d) for d in ("cpu", cuda)}
        lg_cpu, _ = lm.apply_lm_prefill(cfg, params, tok, caches["cpu"], mask, media=media)
        lg_gpu, _ = lm.apply_lm_prefill(cfg, params_gpu, tok.to(cuda), caches[cuda],
                                        mask.to(cuda), media=media_gpu)
        torch.testing.assert_close(lg_gpu.cpu(), lg_cpu, rtol=1e-4, atol=1e-4)
        nxt = torch.argmax(lg_cpu[:, -1, :cfg.vocab_size], -1)[:, None].to(torch.int32)
        for i in range(2):
            lg_cpu, _ = lm.apply_lm_decode(cfg, params, nxt, caches["cpu"], s + i)
            lg_gpu, _ = lm.apply_lm_decode(cfg, params_gpu, nxt.to(cuda), caches[cuda], s + i)
            torch.testing.assert_close(lg_gpu.cpu(), lg_cpu, rtol=1e-4, atol=1e-4)
    t_gpu = lm.greedy_generate(cfg, params_gpu, tok.to(cuda), 4, attn_mask=mask.to(cuda),
                               media=media_gpu)
    t_cpu = lm.greedy_generate(cfg, params, tok, 4, attn_mask=mask, media=media)
    assert torch.equal(t_gpu.cpu(), t_cpu)


def test_mlstm_chunkwise_equals_the_step_recurrence_on_the_card(cuda):
    """Chunks of 64 over 256 tokens against ``mlstm_step`` token by token,
    on the card (h 3e-5, C 1e-5), and the card's chunkwise against the CPU's."""
    rng = np.random.default_rng(4)
    b, t, h, dh = 2, 256, 4, 64
    args = [torch.from_numpy(a.astype(np.float32)) for a in (
        rng.standard_normal((b, t, h, dh)), rng.standard_normal((b, t, h, dh)) / 8,
        rng.standard_normal((b, t, h, dh)), rng.standard_normal((b, t, h)) - 2.0,
        -np.logaddexp(0.0, -(rng.standard_normal((b, t, h)) + 2.0)))]
    dev = [a.to(cuda) for a in args]
    h_chunk, final = xlstm.mlstm_chunkwise(*dev, chunk=64)
    state = {"C": torch.zeros((b, h, dh, dh), device=cuda),
             "n": torch.zeros((b, h, dh), device=cuda),
             "m": torch.full((b, h), xlstm.NEG_INF, device=cuda)}
    hs = []
    for i in range(t):
        h_i, state = xlstm.mlstm_step(*(a[:, i] for a in dev), state)
        hs.append(h_i)
    assert float((torch.stack(hs, 1) - h_chunk).abs().max()) < 3e-5
    assert float((state["C"] - final["C"]).abs().max()) < 1e-5
    h_cpu, _ = xlstm.mlstm_chunkwise(*args, chunk=64)
    torch.testing.assert_close(h_chunk.cpu(), h_cpu, rtol=1e-5, atol=3e-5)


def test_mamba_chunked_scan_equals_the_step_recurrence_on_the_card(cuda):
    """Smoke jamba's Mamba layer over 150 tokens (chunks 128 + 22) against
    its decode step token by token, on the card, and against the CPU."""
    cfg = get_smoke_config("jamba-1.5-large-398b")
    p = ssm.init_mamba(torch.Generator().manual_seed(0), cfg)
    pg = tree_map(lambda a: a.to(cuda), p)
    x = torch.randn((2, 150, cfg.d_model), generator=torch.Generator().manual_seed(1)) * 0.5
    out, state = ssm.apply_mamba_prefill(cfg, pg, x.to(cuda))
    cache = ssm.init_mamba_cache(cfg, 2, cuda)
    steps = [ssm.apply_mamba_decode(cfg, pg, x[:, i:i + 1].to(cuda), cache)[0]
             for i in range(150)]
    torch.testing.assert_close(torch.cat(steps, 1), out, rtol=1e-5, atol=2e-5)
    torch.testing.assert_close(cache["h"], state["h"], rtol=1e-5, atol=2e-5)
    out_cpu, _ = ssm.apply_mamba_prefill(cfg, p, x)
    torch.testing.assert_close(out.cpu(), out_cpu, rtol=1e-5, atol=2e-5)


def test_build_engine_serves_the_recurrent_pool_on_the_card(cuda):
    """qwen3-0.6b, xlstm-1.3b and jamba at smoke size: the router trains for
    K = 3 on the card and scores through the kernel; the recurrent members
    generate a 300-token prompt (xlstm pads it to 512)."""
    names = ["qwen3-0.6b", "xlstm-1.3b", "jamba-1.5-large-398b"]
    engine = build_engine(names, smoke=True, device=cuda, epochs=3)
    texts, prompts = synthetic_requests(6, 512, seed=1, min_len=3, max_len=20)
    before = router_xattn_cuda.launches
    engine.serve(texts, prompts, max_new=4)
    assert router_xattn_cuda.launches == before + 1
    long = [np.arange(300, dtype=np.int32) % 512, np.arange(7, dtype=np.int32)]
    for mi in (1, 2):
        outs, costs = engine.generate_member(mi, long, max_new=3)
        assert all(len(o) == 3 and 0 <= o.min() and o.max() < 512 for o in outs)
        assert np.all(costs > 0)


# ---------------------------------------------------------------------------
# musicgen-large, llama4-maverick and cross attention on the card
# ---------------------------------------------------------------------------

MULTIMODAL = ["musicgen-large", "llama4-maverick-400b-a17b", "llama-3.2-vision-90b"]


@pytest.mark.parametrize("name", MULTIMODAL)
@pytest.mark.parametrize("lengths", [(5, 17, 9), (600, 40)])
def test_multimodal_members_on_the_card_equal_the_cpu(cuda, name, lengths):
    """Smoke musicgen, llama4 (top-1 MoE with a shared expert) and
    llama-3.2-vision with its stub media: prefill and two decode steps'
    logits within 1e-4 of the CPU's, greedy tokens equal."""
    _card_equals_cpu(cuda, get_smoke_config(name), lengths)


def test_cross_decode_equals_the_full_sequence_on_the_card(cuda):
    """Smoke vision's cross layer: the decode step on the prefilled media
    cache equals the full sequence's last position (1e-5), and the card's
    full sequence the CPU's."""
    cfg = get_smoke_config("llama-3.2-vision-90b")
    p = attn_mod.init_attention(torch.Generator().manual_seed(0), cfg, LayerSpec(mixer=XATTN))
    pg = tree_map(lambda a: a.to(cuda), p)
    gen = torch.Generator().manual_seed(1)
    x = torch.randn((3, 40, cfg.d_model), generator=gen)
    media = torch.randn((3, cfg.n_frontend_tokens, cfg.frontend_dim), generator=gen)
    full = attn_mod.cross_attention_full_seq(cfg, pg, x.to(cuda), media.to(cuda))
    cache = attn_mod.prefill_cross_cache(
        cfg, pg, media.to(cuda), attn_mod.init_kv_cache(cfg, LayerSpec(mixer=XATTN), 3, 1, cuda))
    step, _ = attn_mod.cross_attention_decode(cfg, pg, x[:, -1:].to(cuda), cache)
    torch.testing.assert_close(step, full[:, -1:], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(full.cpu(), attn_mod.cross_attention_full_seq(cfg, p, x, media),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("names", [["qwen3-0.6b", "musicgen-large", "llama-3.2-vision-90b"],
                                   ["qwen3-0.6b", "llama4-maverick-400b-a17b"]],
                         ids=["pool-A", "pool-B"])
def test_build_engine_serves_the_multimodal_pools_on_the_card(cuda, names, monkeypatch):
    """Pools A and B at smoke size: the router trains on the card and
    scores through the kernel; the vision member's stub media lies on the
    card; every member but qwen3 generates, llama4's decode drops nothing."""
    engine = build_engine(names, smoke=True, device=cuda, epochs=3)
    for m in engine.pool:
        assert (m.media is not None) == m.cfg.has_mixer(XATTN)
        assert m.media is None or m.media.device.type == "cuda"
    texts, prompts = synthetic_requests(6, 512, seed=1, min_len=3, max_len=20)
    monkeypatch.setattr(moe, "DECODE_DROP_LOG", [])
    before = router_xattn_cuda.launches
    engine.serve(texts, prompts, max_new=4)
    assert router_xattn_cuda.launches == before + 1
    for mi in range(1, len(names)):
        outs, costs = engine.generate_member(mi, prompts, max_new=3)
        assert all(len(o) == 3 and 0 <= o.min() and o.max() < 512 for o in outs)
        assert np.all(costs > 0)
    assert not any(moe.DECODE_DROP_LOG)
    assert ("llama4-maverick-400b-a17b" in names) == bool(moe.DECODE_DROP_LOG)


def test_mamba_prefill_gradient_on_the_card_equals_the_cpu(cuda):
    """The out-of-place scan while autograd records: d loss / d x and / d
    A_log over two chunks with left pads, card against CPU (rel 1e-4)."""
    cfg = get_smoke_config("jamba-1.5-large-398b")
    p = ssm.init_mamba(torch.Generator().manual_seed(0), cfg)
    gen = torch.Generator().manual_seed(2)
    x = torch.randn((2, 256, cfg.d_model), generator=gen) * 0.5
    w = torch.randn((2, 256, cfg.d_model), generator=gen)
    mask = torch.ones((2, 256), dtype=torch.bool)
    mask[0, :130] = False

    def grads(device):
        pd = tree_map(lambda a: a.to(device).requires_grad_(True), p)
        xd = x.to(device).requires_grad_(True)
        out, _ = ssm.apply_mamba_prefill(cfg, pd, xd, mask=mask.to(device))
        return [g.cpu() for g in torch.autograd.grad((out * w.to(device)).sum(),
                                                     [xd, pd["A_log"], pd["dt_bias"]])]

    for got, want in zip(grads(cuda), grads("cpu")):
        assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


# ---------------------------------------------------------------------------
# Online adaptation and cascade routing on the card
# ---------------------------------------------------------------------------

def test_online_updater_steps_on_the_card_equal_the_cpus(cuda):
    """8 masked Adam steps on one replay from one router, on the card and on
    the CPU: losses within 1e-5, params within rtol 1e-3 / atol 1e-5 (Adam's
    normalized step turns a gradient's last-bit difference near 0 into a
    step of up to lr); the live router's tensors unchanged."""
    from repro_torch.launch.serve import init_router
    from repro_torch.online import IncrementalUpdater, ReplayBuffer

    base = init_router(3, seed=4, device="cpu")

    def run(device):
        router = base.with_updates(
            quality_params=tree_map(lambda a: a.to(device), base.quality_params),
            cost_params=tree_map(lambda a: a.to(device), base.cost_params))
        router.cost_scaler = {"mu": np.asarray([0.1, 1.0, 5.0]), "sd": np.ones(3)}
        live = {k: v.clone() for k, v in router.quality_params.items()}
        rng = np.random.default_rng(0)
        replay = ReplayBuffer(capacity=64, seed=0)
        for i in range(48):
            q = rng.standard_normal(768)
            replay.add(q / np.linalg.norm(q), i % 3, float(rng.uniform()), 0.5 * (i % 3))
        upd = IncrementalUpdater(router)
        res = upd.run_steps(replay, router.model_emb, 8)
        assert all(torch.equal(router.quality_params[k], v) for k, v in live.items())
        return res, tree_map(lambda a: a.cpu(), upd.q_params)

    (res_g, got), (res_c, want) = run(cuda), run("cpu")
    assert res_g["steps"] == res_c["steps"] == 8
    assert abs(res_g["quality_loss"] - res_c["quality_loss"]) <= 1e-5
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("flags", [["--trace", "drift", "--online", "--feedback-delay", "0.001"],
                                   ["--trace", "neardup", "--cascade", "--semcache",
                                    "--lam", "0.0005"],
                                   ["--trace", "poisson", "--online", "--cascade"]],
                         ids=["online", "cascade", "online-cascade"])
def test_serve_online_and_cascade_on_the_card(cuda, flags, capsys):
    """The serve entry point's trace mode on the smoke default pool, on the
    card: the adapter updates the router; the cascade finalizes every
    request once, each cache stop or a first leg (whether a smoke router
    escalates depends on its seeded training; ``chip_smoke.py``'s
    ``[cascade]`` checks escalations at published size)."""
    from repro_torch.launch.serve import main

    main(["--smoke", "--device", "cuda", "--epochs", "3", "--requests", "48",
          "--max-new", "2", *flags])
    lines = capsys.readouterr().out.splitlines()
    if "--online" in flags:
        line = next(x for x in lines if x.startswith("online: "))
        assert int(line.split("updates ")[1].split()[0]) > 0, line
    if "--cascade" in flags:
        line = next(x for x in lines if x.startswith("cascade: legs "))
        field = lambda name: int(line.split(name + " ")[1].split()[0])  # noqa: E731
        assert field("finalized") == 48, line
        assert field("legs") == 48 - field("cache-stops") + field("escalations"), line


def test_kernel_profiler_counts_one_call_per_launch_on_the_card(cuda, monkeypatch):
    """With the dispatch profiler installed, each ``router_xattn_pool`` and
    ``pairwise_l2`` call on CUDA tensors launches its kernel once and lands
    as one profiled call with its rows, synced to the device inside the
    span; the result is the plain version's. A refused launch still raises
    through the profiled wrapper. The profiler is removed in the end."""
    from repro_torch.obs import KernelProfiler, TraceRecorder

    q, wq, kt, vt, wo, bo = _inputs(5, 37, 3, 20, cuda)
    x, c = _points(6, 48, 20, 768, cuda)
    rec = TraceRecorder()
    prof = KernelProfiler(tracer=rec)
    rx0, pl0 = router_xattn_cuda.launches, pairwise_l2_cuda.launches
    ops.set_kernel_profiler(prof)
    try:
        for _ in range(3):
            s = ops.router_xattn_pool(q, wq, kt, vt, wo, bo)
            d2 = ops.pairwise_l2(x, c)
        torch.testing.assert_close(s, ref.router_xattn_pool_ref(q, wq, kt, vt, wo, bo),
                                   rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(d2, ref.pairwise_l2_ref(x, c), rtol=1e-4, atol=1e-4)

        class Refusing:
            def pairwise_l2_launch(self, *args):
                return 9

            def pairwise_l2_error_string(self, err):
                return b"invalid configuration argument"

        monkeypatch.setattr(pairwise_l2_mod, "_library", Refusing)
        with pytest.raises(RuntimeError, match="launch failed: invalid configuration"):
            ops.pairwise_l2(x, c)
    finally:
        ops.set_kernel_profiler(None)
    assert router_xattn_cuda.launches - rx0 == 3
    assert pairwise_l2_cuda.launches - pl0 == 3
    summary = prof.summary()
    assert summary["router_xattn_pool"]["calls"] == 3
    assert summary["router_xattn_pool"]["elements"] == 3 * 37
    assert summary["pairwise_l2"]["calls"] == 4      # three launches and the refused one
    assert summary["pairwise_l2"]["elements"] == 4 * 48
    assert all(v["p50_us"] > 0 for v in summary.values())
    assert sum(1 for e in rec.events if e[1] == "kernel") == 7
    assert rec.to_json() == TraceRecorder().to_json()   # wall spans stay out
    assert ops.get_kernel_profiler() is None


def test_serve_socket_fleet_on_the_card(cuda, tmp_path, capfd):
    """``--transport socket`` with two OS processes on the card (smoke
    default pool): the follower trains the controller's router bit for bit
    (equal digests when ready and at the end), and both kernels launch in
    the follower, counted from its profiler's kernel spans (pid 1) in the
    merged trace."""
    import json
    import re

    from repro_torch.launch.serve import run_cli

    trace_out = str(tmp_path / "t.json")
    summary = run_cli(["--smoke", "--device", "cuda", "--trace", "drift", "--online",
                       "--workers", "2", "--transport", "socket", "--requests", "48",
                       "--epochs", "2", "--max-new", "2", "--max-wait", "0.01",
                       "--trace-out", trace_out, "--trace-profile"])
    out = capfd.readouterr().out.splitlines()
    digest = re.compile(r"router v(\d+) digest ([0-9a-f]{16})")
    find = lambda prefix: digest.search(  # noqa: E731
        next(x[x.index(prefix):] for x in out if prefix in x)).groups()
    assert find("[w1] ready") == find("socket plane: controller")
    assert find("[w1] done") == find("socket plane: w0")
    assert summary["completed"] == 48 and len(set(summary["pids"].values())) == 2
    kernels = {}
    for e in json.load(open(trace_out))["traceEvents"]:
        if e.get("cat") == "kernel":
            kernels[(e["pid"], e["name"])] = kernels.get((e["pid"], e["name"]), 0) + 1
    for pid in (0, 1):
        for name in ("kernel:router_xattn_pool", "kernel:pairwise_l2"):
            assert kernels.get((pid, name), 0) > 0, (pid, name, kernels)


# ---------------------------------------------------------------------------
# LM training on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["qwen3-0.6b", "granite-moe-1b-a400m"])
def test_train_step_on_the_card_equals_the_cpu(cuda, name):
    """One ``make_train_step`` step at smoke size from the same params and
    batch, card against CPU: the loss within 1e-5 relative; each moment
    leaf within 1e-4 of its largest magnitude; the new params within lr
    everywhere and within 1e-6 in all but 1e-4 of their entries (Adam
    moves an entry whose gradient is at the rounding level by up to lr on
    either device; ``tests/test_torch_launch.py`` holds the CPU to the
    reference so). MoE at capacity factor 8.0, so no assignment is
    dropped."""
    import dataclasses

    from repro_torch.common.tree import flatten_with_paths
    from repro_torch.data.lm_data import MarkovCorpus
    from repro_torch.launch.steps import TRAIN_ADAM, make_train_step
    from repro_torch.training.optim import adam_init

    cfg = dataclasses.replace(get_smoke_config(name), capacity_factor=8.0)
    params = lm.init_lm(torch.Generator().manual_seed(0), cfg)
    tok, lab = next(MarkovCorpus(cfg.vocab_size, seed=0).batches(4, 64, seed=1))
    out = {}
    for device in ("cpu", cuda):
        p = tree_map(lambda a: a.to(device, copy=True), params)   # the step updates in place
        batch = {"tokens": torch.from_numpy(tok).to(device),
                 "labels": torch.from_numpy(lab).to(device)}
        loss, new, state = make_train_step(cfg)(p, adam_init(TRAIN_ADAM, p), batch)
        out[str(device)] = (float(loss), *(flatten_with_paths(tree_map(lambda a: a.cpu(), t))
                                           for t in (new, state.m, state.v)))
    (loss_c, new_c, m_c, v_c), (loss_g, new_g, m_g, v_g) = out["cpu"], out["cuda"]
    assert abs(loss_g - loss_c) <= 1e-5 * abs(loss_c)
    for got, want in ((m_g, m_c), (v_g, v_c)):
        for key in want:
            err = float((got[key] - want[key]).abs().max())
            assert err <= 1e-4 * float(want[key].abs().max()), (key, err)
    diff = torch.cat([(new_g[k] - new_c[k]).abs().flatten() for k in new_c])
    assert float(diff.max()) <= TRAIN_ADAM.lr
    assert float((diff > 1e-6).float().mean()) <= 1e-4


@pytest.fixture
def nccl_mesh(cuda):
    """A 1x1 mesh over NCCL on the card; its process group is destroyed
    after the test."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_debug_mesh

    assert not dist.is_initialized()
    mesh = make_debug_mesh(1, 1)
    yield mesh
    dist.destroy_process_group()


@pytest.mark.parametrize("name", ["qwen3-0.6b", "granite-moe-1b-a400m"])
def test_mesh_steps_on_an_nccl_1x1_mesh_equal_the_plain_steps(nccl_mesh, cuda, name):
    """The train step's loss and gradients, the prefill logits and two
    decode steps' logits at smoke size, with DTensor params, moments,
    batch and caches on a 1x1 NCCL mesh against the plain steps on the
    card: the loss within 1e-6 relative, each gradient leaf within 1e-5
    of its largest magnitude, logits within 1e-5 (on a mesh the cross
    entropy is vocab-parallel and the MoE dispatches by one-hot einsums,
    so sums run in another order)."""
    from repro_torch.common.tree import flatten_with_paths
    from repro_torch.data.lm_data import MarkovCorpus
    from repro_torch.launch import sharding, steps
    from repro_torch.training.optim import adam_init

    mesh = nccl_mesh
    cfg = get_smoke_config(name)
    params = lm.init_lm(torch.Generator("cuda").manual_seed(0), cfg)
    tok, lab = (torch.from_numpy(a).to(cuda) for a in
                next(MarkovCorpus(cfg.vocab_size, seed=0).batches(4, 64, seed=1)))
    batch = {"tokens": tok, "labels": lab}
    dparams = sharding.distribute_params(cfg, mesh, tree_map(torch.clone, params))
    loss_p, grads_p = steps.make_grad_step(cfg)(params, batch)
    loss_m, grads_m = steps.make_grad_step(cfg, mesh)(dparams, sharding.distribute_batch(mesh, batch))
    assert abs(float(loss_m) - float(loss_p)) <= 1e-6 * abs(float(loss_p))
    got = flatten_with_paths(grads_m)
    for key, want in flatten_with_paths(grads_p).items():
        err = float((got[key].full_tensor() - want).abs().max())
        assert err <= 1e-5 * float(want.abs().max()), (key, err)
    loss, dparams, state = steps.make_train_step(cfg, mesh)(
        dparams, adam_init(steps.TRAIN_ADAM, dparams), sharding.distribute_batch(mesh, batch))
    assert np.isfinite(float(loss)) and float(state.step) == 1

    caches_p = lm.init_caches(cfg, 4, 68, cuda)
    caches_m = sharding.distribute_caches(cfg, mesh, lm.init_caches(cfg, 4, 68, cuda))
    dparams = sharding.distribute_params(cfg, mesh, tree_map(torch.clone, params))
    out_p, caches_p = steps.make_prefill_step(cfg)(params, {"tokens": tok, "caches": caches_p})
    out_m, caches_m = steps.make_prefill_step(cfg, mesh)(
        dparams, {**sharding.distribute_batch(mesh, {"tokens": tok}), "caches": caches_m})
    torch.testing.assert_close(out_m.full_tensor(), out_p, rtol=0, atol=1e-5)
    nxt = lab[:, -1:]
    for i in range(2):
        out_p, caches_p = steps.make_decode_step(cfg)(
            params, {"token": nxt, "caches": caches_p, "pos": 64 + i})
        out_m, caches_m = steps.make_decode_step(cfg, mesh)(
            dparams, {"token": sharding.distribute_batch(mesh, {"t": nxt})["t"],
                      "caches": caches_m, "pos": 64 + i})
        torch.testing.assert_close(out_m.full_tensor(), out_p, rtol=0, atol=1e-5)


def test_mesh_served_tokens_on_an_nccl_1x1_mesh_equal_the_cpus(nccl_mesh, cuda):
    """The default smoke pool, seeded on the CPU, moved to the card and laid
    out by ``shard_pool(..., mesh=...)`` on a 1x1 NCCL mesh: every member's
    ``generate_member`` tokens and $ equal the CPU pool's, the params are
    DTensors whose shards lie on the card, the router still scores through
    the kernel."""
    from torch.distributed.tensor import DTensor

    from repro_torch.common.tree import flatten_with_paths
    from repro_torch.distributed.shard import shard_pool
    from repro_torch.launch.serve import build_pool, init_router

    names = DEFAULT_POOL.split(",")
    cpu = RoutedEngine(router=init_router(3, device="cpu"),
                       pool=build_pool(names, device="cpu", smoke=True), device="cpu")
    card = RoutedEngine(router=init_router(3, device=cuda),
                        pool=build_pool(names, device="cpu", smoke=True), device=cuda)
    shard_pool(card.pool, 0, 1, device=cuda)
    assert shard_pool(card.pool, 0, 1, mesh=nccl_mesh) == [0, 1, 2]
    rng = np.random.default_rng(3)
    for mi, member in enumerate(card.pool):
        assert member.device.type == "cuda"
        assert all(isinstance(t, DTensor) for t in flatten_with_paths(member.params).values())
        prompts = [rng.integers(0, member.cfg.vocab_size, size=n, dtype=np.int32)
                   for n in (5, 17, 9, 12)]
        want, want_costs = cpu.generate_member(mi, prompts, max_new=6)
        got, costs = card.generate_member(mi, prompts, max_new=6)
        np.testing.assert_array_equal(np.stack(got), np.stack(want))
        np.testing.assert_array_equal(costs, want_costs)
    before = router_xattn_cuda.launches
    texts, prompts = synthetic_requests(4, 64, seed=1, min_len=3, max_len=12)
    res = card.serve(texts, prompts, max_new=3)
    assert router_xattn_cuda.launches == before + 1 and len(res["outputs"]) == 4
