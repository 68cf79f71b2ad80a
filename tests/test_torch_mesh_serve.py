"""Serving on a device mesh: ``shard_pool(..., mesh=...)`` and generation on
DTensor params, against the JAX reference.

Smoke configs on a 1x1 gloo mesh in this process:

  * the reference's default three-member smoke pool, its params carried
    into the port (``bridge.py``) and laid out by ``shard_pool`` on the
    mesh: ``generate_member`` on ragged left-padded prompts gives the
    reference's ``greedy_generate`` tokens with the same ``attn_mask`` and
    the reference engine's $ costs; ``serve`` gives the plain pool's
    choices, tokens and $;
  * the layout: every owned leaf a DTensor under ``param_shardings``,
    evicted members holding ``None``, ``pool_param_bytes`` reading the
    shards, a vlm member's stub media replicated;
  * what is refused: a mesh that is not a ``DeviceMesh``, one without the
    ``data``/``model`` dims, an owned member with no params;
  * ``make_prefill_step`` with an ``attn_mask``: on the mesh it equals the
    reference's masked prefill; without a mesh it is the plain prefill bit
    for bit.

The 2x2 mesh over four gloo processes is in ``tests/test_torch_mesh.py``.
The file holds torch at two threads and destroys the process group it
starts.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Replicate

from repro.configs import get_smoke_config as jax_get_smoke
from repro.launch.serve import build_pool as jax_build_pool
from repro.models import lm as jax_lm
from repro.serving.engine import RoutedEngine as JaxEngine
from repro_torch import bridge
from repro_torch.common.tree import flatten_with_paths
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.distributed.shard import pool_param_bytes, shard_pool
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import serve, sharding, steps
from repro_torch.models import lm
from repro_torch.serving.engine import PoolMember, RoutedEngine, arch_cost_rate

NAMES = ["qwen3-0.6b", "granite-moe-1b-a400m", "granite-3-8b"]
MAX_NEW = 4


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads while this file runs, so that parallel test
    workers do not each start one per core."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def mesh11():
    """A 1x1 gloo mesh in this process; its process group is destroyed
    after the module's tests."""
    assert not dist.is_initialized()
    mesh = mesh_mod.make_debug_mesh(1, 1, device="cpu")
    yield mesh
    dist.destroy_process_group()


def _port_pool(jax_pool):
    return [PoolMember(name=m.name, cfg=get_smoke_config(m.name),
                       params=bridge.lm_params_from_jax(
                           get_smoke_config(m.name), jax.tree.map(np.asarray, m.params), "cpu"),
                       cost_rate=arch_cost_rate(get_config(m.name)))
            for m in jax_pool]


def _prompts(vocab, lens=(3, 11, 6, 14), seed=7):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n, dtype=np.int32) for n in lens]


@pytest.fixture(scope="module")
def pools(mesh11):
    """(reference engine, plain port engine, mesh port engine) over the
    reference's default smoke pool, seed 0."""
    jax_pool = jax_build_pool(NAMES, seed=0)
    plain = RoutedEngine(router=serve.init_router(3, device="cpu"),
                         pool=_port_pool(jax_pool), device="cpu")
    meshed = RoutedEngine(router=serve.init_router(3, device="cpu"),
                          pool=_port_pool(jax_pool), device="cpu")
    assert shard_pool(meshed.pool, 0, 1, mesh=mesh11) == [0, 1, 2]
    return JaxEngine(router=None, pool=jax_pool), plain, meshed


@pytest.mark.parametrize("name", NAMES)
def test_mesh_member_generates_the_references_tokens_and_costs(pools, name):
    jax_engine, _, meshed = pools
    mi = NAMES.index(name)
    member = meshed.pool[mi]
    prompts = _prompts(member.cfg.vocab_size)
    want, want_costs = jax_engine.generate_member(mi, prompts, max_new=MAX_NEW)
    outs, costs = meshed.generate_member(mi, prompts, max_new=MAX_NEW)
    np.testing.assert_array_equal(np.stack(outs), np.stack(want))
    np.testing.assert_allclose(costs, want_costs, rtol=1e-12)
    # The reference's greedy loop on the same left-padded batch and mask.
    s = max(map(len, prompts))
    mask = np.arange(s)[None, :] >= s - np.array([len(p) for p in prompts])[:, None]
    tok = np.zeros(mask.shape, np.int32)
    tok[mask] = np.concatenate(prompts)
    direct = jax_lm.greedy_generate(jax_engine.pool[mi].cfg, jax_engine.pool[mi].params,
                                    jnp.asarray(tok), MAX_NEW, attn_mask=jnp.asarray(mask))
    np.testing.assert_array_equal(np.stack(outs), np.asarray(direct))
    # One greedy loop for both layouts, its mesh steps built once by shard_pool.
    assert member.greedy.func is lm.greedy_generate and member.greedy.args == (member.cfg,)
    greedy = member.greedy
    meshed.generate_member(mi, prompts[:2], max_new=2)
    assert member.greedy is greedy
    assert member.device == torch.device("cpu")


def test_serve_on_the_mesh_equals_the_plain_pool(pools):
    """The router's scoring path is unchanged: the same choices, and the
    mesh members give the plain members' tokens and $."""
    _, plain, meshed = pools
    texts, prompts = serve.synthetic_requests(6, 512, seed=3, min_len=2, max_len=12)
    want = plain.serve(texts, prompts, max_new=3)
    got = meshed.serve(texts, prompts, max_new=3)
    np.testing.assert_array_equal(got["choices"], want["choices"])
    assert [o.tolist() for o in got["outputs"]] == [o.tolist() for o in want["outputs"]]
    assert got["total_cost"] == want["total_cost"]


def test_shard_pool_lays_out_owned_members_and_evicts_the_rest(mesh11):
    pool = serve.build_pool(NAMES, seed=0, device="cpu", smoke=True)
    whole = [pool_param_bytes([m]) for m in pool]
    assert shard_pool(pool, 0, 2, mesh=mesh11) == [0, 2]
    assert pool[1].params is None and pool[1].mesh is None
    for mi in (0, 2):
        member = pool[mi]
        assert member.mesh is mesh11
        want = flatten_with_paths(sharding.param_shardings(member.cfg, mesh11, member.params))
        for key, leaf in flatten_with_paths(member.params).items():
            assert isinstance(leaf, DTensor), key
            assert tuple(leaf.placements) == tuple(want[key].placements), key
    local = sum(int(t.to_local().numel()) * 4 for mi in (0, 2)
                for t in flatten_with_paths(pool[mi].params).values())
    assert pool_param_bytes(pool) == local == whole[0] + whole[2]


def test_a_vlm_members_media_is_replicated_and_it_serves_the_plain_tokens(mesh11):
    names = ["qwen3-0.6b", "llama-3.2-vision-90b"]
    plain = RoutedEngine(router=serve.init_router(2, device="cpu"),
                         pool=serve.build_pool(names, seed=0, device="cpu", smoke=True),
                         device="cpu")
    meshed = RoutedEngine(router=serve.init_router(2, device="cpu"),
                          pool=serve.build_pool(names, seed=0, device="cpu", smoke=True),
                          device="cpu")
    media_bytes = pool_param_bytes(meshed.pool)
    shard_pool(meshed.pool, 0, 1, mesh=mesh11)
    media = meshed.pool[1].media
    assert isinstance(media, DTensor) and tuple(media.placements) == (Replicate(), Replicate())
    assert pool_param_bytes(meshed.pool) == media_bytes
    prompts = _prompts(meshed.pool[1].cfg.vocab_size, lens=(5, 9))
    want, want_costs = plain.generate_member(1, prompts, max_new=3)
    got, costs = meshed.generate_member(1, prompts, max_new=3)
    np.testing.assert_array_equal(np.stack(got), np.stack(want))
    np.testing.assert_array_equal(costs, want_costs)


def test_shard_pool_refuses_a_bad_mesh_and_an_owned_member_without_params(mesh11):
    with pytest.raises(TypeError, match="DeviceMesh"):
        shard_pool([], 0, 1, mesh=object())
    flat = init_device_mesh("cpu", (1,), mesh_dim_names=("data",))
    with pytest.raises(ValueError, match="mesh dims"):
        shard_pool([], 0, 1, mesh=flat)
    build = lambda: serve.build_pool(NAMES[:2], seed=0, device="cpu", smoke=True,  # noqa: E731
                                     owned=[0])
    with pytest.raises(ValueError, match="member 1 .* holds no params"):
        shard_pool(build(), 1, 2, mesh=mesh11)
    assert shard_pool(build(), 0, 2, mesh=mesh11) == [0]


def _masked_batch(cfg, lens=(3, 10, 7, 10)):
    s = max(lens)
    mask = np.arange(s)[None, :] >= s - np.asarray(lens)[:, None]
    tok = np.random.default_rng(5).integers(0, cfg.vocab_size, (len(lens), s)).astype(np.int32)
    return np.where(mask, tok, 0).astype(np.int32), mask


@pytest.mark.parametrize("name", ["qwen3-0.6b", "granite-moe-1b-a400m", "xlstm-1.3b",
                                  "jamba-1.5-large-398b"])
def test_masked_prefill_step_on_the_mesh_equals_the_references(mesh11, name):
    """Last logits within 1e-4 of the reference's masked
    ``apply_lm_prefill`` on carried params (the mesh's sums run in another
    order than XLA's)."""
    jcfg, cfg = jax_get_smoke(name), get_smoke_config(name)
    jp = jax_lm.init_lm(jax.random.key(0), jcfg)
    tok, mask = _masked_batch(cfg)
    b, s = tok.shape
    want, _ = jax_lm.apply_lm_prefill(jcfg, jp, jnp.asarray(tok),
                                      jax_lm.init_caches(jcfg, b, s + 2), None,
                                      attn_mask=jnp.asarray(mask))
    params = sharding.distribute_params(
        cfg, mesh11, bridge.lm_params_from_jax(cfg, jax.tree.map(np.asarray, jp), "cpu"))
    caches = sharding.distribute_caches(cfg, mesh11, lm.init_caches(cfg, b, s + 2, "cpu"))
    batch = sharding.distribute_batch(mesh11, {"tokens": torch.from_numpy(tok),
                                               "attn_mask": torch.from_numpy(mask)})
    got, _ = steps.make_prefill_step(cfg, mesh11)(params, {**batch, "caches": caches})
    np.testing.assert_allclose(got.full_tensor().numpy(), np.asarray(want), rtol=0, atol=1e-4)


@pytest.mark.parametrize("masked", [False, True])
def test_prefill_step_without_a_mesh_is_the_plain_prefill_bit_for_bit(masked):
    cfg = get_smoke_config("granite-moe-1b-a400m")
    params = lm.init_lm(torch.Generator().manual_seed(0), cfg)
    tok, mask = (torch.from_numpy(a) for a in _masked_batch(cfg))
    extra = {"attn_mask": mask} if masked else {}
    b, s = tok.shape
    got, got_caches = steps.make_prefill_step(cfg)(
        params, {"tokens": tok, "caches": lm.init_caches(cfg, b, s + 2, "cpu"), **extra})
    with torch.no_grad():
        want, want_caches = lm.apply_lm_prefill(cfg, params, tok,
                                                lm.init_caches(cfg, b, s + 2, "cpu"), **extra)
    assert torch.equal(got, want)
    for key, leaf in flatten_with_paths(want_caches).items():
        assert torch.equal(flatten_with_paths(got_caches)[key], leaf), key
