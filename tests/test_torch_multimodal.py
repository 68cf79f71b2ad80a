"""The last three of the reference's configs on the port, against the JAX
reference: musicgen-large, llama4-maverick-400b-a17b (MLP and MoE layers in
turn, 128 experts top-1 with a shared expert at full size) and cross
attention with llama-3.2-vision-90b.

Smoke configs only. Reference params come from ``repro.models`` and cross
through ``repro_torch.bridge``; token ids and media are numpy, seeded.
Logits and cross-attention outputs agree within 2e-5 abs in fp32 (the two
frameworks sum matmuls in different orders), greedy tokens exactly. The
masked-compute contract of ``tests/test_masked_prefill.py`` holds on the
port for the top-1 MoE member and the vision member with its media: a
request alone generates its tokens in any batch, and a masked left-padded
prefill gives the unpadded logits within rtol 2e-4, atol 2e-5.
``DECODE_DROP_LOG`` is set through ``monkeypatch`` in both packages.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_get_smoke
from repro.configs.base import LayerSpec as JaxLayerSpec
from repro.launch.serve import build_pool as jax_build_pool
from repro.models import attention as jax_attn
from repro.models import lm as jax_lm
from repro.models import moe as jax_moe
from repro.serving.engine import arch_cost_rate as jax_arch_cost_rate
from repro.serving.engine import pad_prompts as jax_pad_prompts
from repro.serving.engine import prompt_pad_mask as jax_prompt_pad_mask
from repro_torch import bridge
from repro_torch.common.tree import flatten_with_paths, tree_map
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.configs.base import MOE, XATTN, LayerSpec
from repro_torch.launch.serve import build_pool, init_router, stub_media
from repro_torch.models import attention as attn_mod
from repro_torch.models import lm, moe
from repro_torch.serving.engine import (
    PoolMember, RoutedEngine, arch_cost_rate, pad_prompts, prompt_pad_mask,
)

VISION, MUSIC, LLAMA4 = "llama-3.2-vision-90b", "musicgen-large", "llama4-maverick-400b-a17b"
ATOL = 2e-5
MASKED_TOL = dict(rtol=2e-4, atol=2e-5)


def _np(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _media(cfg, batch, seed=11):
    return _np(seed, batch, cfg.n_frontend_tokens, cfg.frontend_dim)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=atol)


# ---------------------------------------------------------------------------
# Configs and their cost
# ---------------------------------------------------------------------------

def test_every_reference_config_is_registered():
    assert sorted(ARCH_IDS) == sorted(JAX_ARCH_IDS)


@pytest.mark.parametrize("name", JAX_ARCH_IDS)
def test_costs_of_all_ten_configs_equal_the_references(name):
    """param_count and active_param_count, published and smoke, exactly:
    the $ rates derive from them (the projector term of a cross layer and
    llama4's shared expert included)."""
    for mine, ref in [(get_config(name), jax_get_config(name)),
                      (get_smoke_config(name), jax_get_smoke(name))]:
        assert mine.param_count() == ref.param_count()
        assert mine.active_param_count() == ref.active_param_count()
        assert (mine.n_frontend_tokens, mine.frontend_dim) == (ref.n_frontend_tokens,
                                                               ref.frontend_dim)
    assert arch_cost_rate(get_config(name)) == jax_arch_cost_rate(jax_get_config(name))


def test_published_sizes_of_the_three_configs():
    """musicgen-large fits at published size; one published block of
    llama-3.2-vision (4 self, 1 cross) and llama4's first two layers are
    the cuts the card holds. Counts by the reference's rule."""
    counts = {name: get_config(name).param_count() for name in (VISION, MUSIC, LLAMA4)}
    assert counts[MUSIC] == 3_229_810_688
    assert counts[LLAMA4] == 397_693_911_040
    vis = get_config(VISION)
    block = dataclasses.replace(vis, n_repeats=1, n_layers=5)
    assert block.param_count() == 6_390_104_064
    assert [s.mixer for s in block.layer_plan()] == ["attn"] * 4 + ["xattn"]
    l4 = get_config(LLAMA4)
    pair = dataclasses.replace(l4, n_repeats=1, n_layers=2)
    assert pair.param_count() == 18_555_228_160
    assert [s.ffn for s in pair.layer_plan()] == ["mlp", "moe"]


# ---------------------------------------------------------------------------
# Cross attention
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=[0.0, 5.0], ids=["plain", "softcap"])
def xattn_layer(request):
    """(jax cfg, jax params, port cfg, port params) of one smoke XATTN layer."""
    jcfg = dataclasses.replace(jax_get_smoke(VISION), attn_logit_softcap=request.param)
    cfg = dataclasses.replace(get_smoke_config(VISION), attn_logit_softcap=request.param)
    jp = jax_attn.init_attention(jax.random.key(5), jcfg, JaxLayerSpec(mixer="xattn"))
    tp = tree_map(lambda a: torch.from_numpy(np.array(a)), jax.tree.map(np.asarray, jp))
    return jcfg, jp, cfg, tp


def test_cross_attention_full_seq_matches_reference(xattn_layer):
    jcfg, jp, cfg, tp = xattn_layer
    x, media = _np(1, 2, 7, cfg.d_model), _media(cfg, 2)
    want = jax_attn.cross_attention_full_seq(jcfg, jp, jnp.asarray(x), jnp.asarray(media))
    got = attn_mod.cross_attention_full_seq(cfg, tp, torch.from_numpy(x),
                                            torch.from_numpy(media))
    _close(got, want)


def test_cross_cache_and_decode_match_reference(xattn_layer):
    """The cross cache holds one slot per media token, k and v only (no
    positions, no pads); decode reads it and equals the reference's step
    and the full sequence's last position."""
    jcfg, jp, cfg, tp = xattn_layer
    spec, jspec = LayerSpec(mixer=XATTN), JaxLayerSpec(mixer="xattn")
    b, media = 3, _media(cfg, 3, seed=12)
    cache = attn_mod.init_kv_cache(cfg, spec, b, 9, "cpu")
    jcache = jax_attn.init_kv_cache(jcfg, jspec, b, 9)
    assert sorted(cache) == sorted(jcache) == ["k", "v"]
    assert {k: tuple(v.shape) for k, v in cache.items()} == \
        {k: tuple(v.shape) for k, v in jcache.items()} == \
        {k: (b, cfg.n_frontend_tokens, cfg.n_kv_heads, cfg.resolved_head_dim) for k in "kv"}
    cache = attn_mod.prefill_cross_cache(cfg, tp, torch.from_numpy(media), cache)
    jcache = jax_attn.prefill_cross_cache(jcfg, jp, jnp.asarray(media), jcache)
    for key in "kv":
        _close(cache[key], jcache[key])
    x = _np(2, b, 5, cfg.d_model)
    full = attn_mod.cross_attention_full_seq(cfg, tp, torch.from_numpy(x), torch.from_numpy(media))
    out, _ = attn_mod.cross_attention_decode(cfg, tp, torch.from_numpy(x[:, -1:]), cache)
    jout, _ = jax_attn.cross_attention_decode(jcfg, jp, jnp.asarray(x[:, -1:]), jcache)
    _close(out, jout)
    _close(out, full[:, -1:], atol=1e-6)
    # The prefill path projects the media once and writes the same cache.
    fresh = attn_mod.init_kv_cache(cfg, spec, b, 9, "cpu")
    y, fresh = attn_mod.cross_attention_prefill(cfg, tp, torch.from_numpy(x),
                                                torch.from_numpy(media), fresh)
    torch.testing.assert_close(y, full, rtol=0, atol=0)
    torch.testing.assert_close(fresh["k"], cache["k"], rtol=0, atol=0)


# ---------------------------------------------------------------------------
# The three members end to end
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=[MUSIC, LLAMA4, VISION])
def member(request):
    """(name, jax cfg, jax params, port cfg, port params) on the CPU."""
    name = request.param
    jcfg, cfg = jax_get_smoke(name), get_smoke_config(name)
    jparams = jax_lm.init_lm(jax.random.key(3), jcfg)
    tparams = bridge.lm_params_from_jax(cfg, jax.tree.map(np.asarray, jparams), "cpu")
    return name, jcfg, jparams, cfg, tparams


def _prompts(seed, vocab, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n, dtype=np.int32) for n in lengths]


def _media_pair(cfg, b):
    if not cfg.frontend_dim:
        return None, None
    m = _media(cfg, b)
    return jnp.asarray(m), torch.from_numpy(m)


def test_prefill_and_decode_logits_match(member):
    _, jcfg, jparams, cfg, tparams = member
    prompts = _prompts(0, cfg.vocab_size, [9, 4, 12])
    b, s, n_dec = len(prompts), 12, 3
    jmedia, media = _media_pair(cfg, b)
    jc = jax_lm.init_caches(jcfg, b, s + n_dec)
    tc = lm.init_caches(cfg, b, s + n_dec, "cpu")
    jl, jc = jax_lm.apply_lm_prefill(jcfg, jparams, jax_pad_prompts(prompts), jc, jmedia,
                                     attn_mask=jax_prompt_pad_mask(prompts))
    with torch.inference_mode():
        tl, tc = lm.apply_lm_prefill(cfg, tparams, pad_prompts(prompts, cfg), tc,
                                     attn_mask=prompt_pad_mask(prompts, cfg), media=media)
    _close(tl, jl)
    feed = np.random.default_rng(1).integers(0, cfg.vocab_size, (n_dec, b, 1), dtype=np.int32)
    for i in range(n_dec):
        jl, jc = jax_lm.apply_lm_decode(jcfg, jparams, jnp.asarray(feed[i]), jc,
                                        jnp.int32(s + i))
        with torch.inference_mode():
            tl, tc = lm.apply_lm_decode(cfg, tparams, torch.from_numpy(feed[i]), tc, s + i)
        _close(tl, jl)


def test_greedy_tokens_equal_on_left_padded_batch(member):
    _, jcfg, jparams, cfg, tparams = member
    prompts = _prompts(2, cfg.vocab_size, [5, 11, 3, 8])
    jmedia, media = _media_pair(cfg, len(prompts))
    jt = jax_lm.greedy_generate(jcfg, jparams, jax_pad_prompts(prompts), 5, media=jmedia,
                                attn_mask=jax_prompt_pad_mask(prompts))
    tt = lm.greedy_generate(cfg, tparams, pad_prompts(prompts, cfg), 5,
                            attn_mask=prompt_pad_mask(prompts, cfg), media=media)
    assert tt.dtype == torch.int32 and tt.shape == (4, 5)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


def test_bridge_carries_every_leaf_in_plan_order(member):
    """The XATTN layer's projector and norm, llama4's MoE router, experts
    and shared expert on its odd layers: every reference leaf lands on its
    layer of the plan, unchanged, and the port's own init has the same tree."""
    name, jcfg, jparams, cfg, tparams = member
    np_params = jax.tree.map(np.asarray, jparams)
    plan = cfg.layer_plan()
    for r in range(cfg.n_repeats):
        for j, spec in enumerate(cfg.pattern):
            layer = flatten_with_paths(tparams["layers"][r * len(cfg.pattern) + j])
            ref = flatten_with_paths(jax.tree.map(lambda a, r=r: a[r], np_params["pattern"][j]))
            assert sorted(layer) == sorted(ref)
            for path, leaf in layer.items():
                np.testing.assert_array_equal(leaf.numpy(), ref[path])
            assert ("mixer/w_proj" in layer) == (spec.mixer == XATTN)
            assert ("ffn/shared/w_gate" in layer) == (spec.ffn == MOE)
    mine = lm.init_lm(torch.Generator().manual_seed(0), cfg)
    assert ({k: v.shape for k, v in flatten_with_paths(mine).items()}
            == {k: v.shape for k, v in flatten_with_paths(tparams).items()})
    assert len(plan) == len(tparams["layers"])


def test_llama4_plan_alternates_mlp_and_moe_across_repeats():
    """Two repeats of llama4's (MLP, MoE) pattern: layers 1 and 3 carry
    the reference's MoE params of repeats 0 and 1, layers 0 and 2 its MLPs."""
    jcfg = dataclasses.replace(jax_get_smoke(LLAMA4), n_repeats=2, n_layers=4)
    cfg = dataclasses.replace(get_smoke_config(LLAMA4), n_repeats=2, n_layers=4)
    ref = jax.tree.map(np.asarray, jax_lm.init_lm(jax.random.key(4), jcfg))
    layers = bridge.lm_params_from_jax(cfg, ref, "cpu")["layers"]
    assert [s.ffn for s in cfg.layer_plan()] == ["mlp", "moe", "mlp", "moe"]
    for i, layer in enumerate(layers):
        r, j = divmod(i, 2)
        key = "router" if j else "w_gate"
        np.testing.assert_array_equal(layer["ffn"][key].numpy(),
                                      ref["pattern"][j]["ffn"][key][r])


# ---------------------------------------------------------------------------
# Top-1 MoE: decode keeps every token (reference: TestMoEDecodeNoDrop)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shared", [0, 1], ids=["routed", "shared-expert"])
def test_top1_decode_keeps_every_token_as_the_reference(shared, monkeypatch):
    """E 8, top-1, capacity factor 1 (the llama4 shape, reduced), with and
    without llama4's shared expert: 16 identical rows all route to one
    expert; no real token is dropped in either package, every row equals
    the solo run, and the outputs equal the reference's."""
    changes = dict(n_experts=8, top_k=1, capacity_factor=1.0, n_shared_experts=shared)
    jcfg = dataclasses.replace(jax_get_smoke(LLAMA4), **changes)
    cfg = dataclasses.replace(get_smoke_config(LLAMA4), **changes)
    jp = jax_moe.init_moe(jax.random.key(21), jcfg)
    tp = tree_map(lambda a: torch.from_numpy(np.array(a)), jax.tree.map(np.asarray, jp))
    x = np.tile(_np(22, 1, cfg.d_model), (16, 1))[:, None, :]
    monkeypatch.setattr(moe, "DECODE_DROP_LOG", [])
    monkeypatch.setattr(jax_moe, "DECODE_DROP_LOG", [])
    gate = torch.topk(moe._router_probs(tp, torch.from_numpy(x[:, 0])), 1)[1]
    assert len(set(gate[:, 0].tolist())) == 1
    assert moe._capacity(16, cfg, 4.0) < 16          # the old factor-4 rule dropped
    out = moe.apply_moe_decode(cfg, tp, torch.from_numpy(x))
    solo = moe.apply_moe_decode(cfg, tp, torch.from_numpy(x[:1]))
    jout = jax_moe.apply_moe_decode(jcfg, jp, jnp.asarray(x))
    assert moe.DECODE_DROP_LOG == [0, 0]
    assert jax_moe.DECODE_DROP_LOG == [0]
    _close(out, jout)
    for i in (0, 8, 15):
        np.testing.assert_allclose(out[i].numpy(), solo[0].numpy(), rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# Masked-compute contract (reference: TestCrossMixerInvariance)
# ---------------------------------------------------------------------------

VOCAB = 64


@pytest.fixture(scope="module", params=[LLAMA4, VISION])
def contract_member(request):
    """A port-alone member, seeded, with its stub media when it has cross
    layers: llama4 at E 8 top-1 with its shared expert, and vision."""
    cfg = get_smoke_config(request.param)
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, n_experts=8, capacity_factor=1.0)
    gen = torch.Generator().manual_seed(0)
    return cfg, lm.init_lm(gen, cfg), stub_media(cfg, gen)


def _gen(cfg, params, media, prompts, max_new=4):
    m = None if media is None else media.expand(len(prompts), -1, -1)
    return lm.greedy_generate(cfg, params, pad_prompts(prompts, cfg), max_new,
                              attn_mask=prompt_pad_mask(prompts, cfg), media=m).numpy()


def test_batch_composition_invariance(contract_member):
    cfg, params, media = contract_member
    p_short, p_long, p_other = _prompts(0, VOCAB, (5, 17, 11))
    alone = _gen(cfg, params, media, [p_short])
    with_long = _gen(cfg, params, media, [p_short, p_long])
    with_two = _gen(cfg, params, media, [p_short, p_other, p_long])
    np.testing.assert_array_equal(alone[0], with_long[0])
    np.testing.assert_array_equal(alone[0], with_two[0])
    np.testing.assert_array_equal(with_long[1], with_two[2])


def test_pad_count_invariance(contract_member):
    cfg, params, media = contract_member
    prompt = _prompts(3, VOCAB, (7,))[0]
    ref = _gen(cfg, params, media, [prompt])[0]
    for pad in (4, 9):
        toks = torch.from_numpy(np.pad(prompt, (pad, 0))[None])
        mask = torch.from_numpy((np.arange(pad + len(prompt)) >= pad)[None])
        out = lm.greedy_generate(cfg, params, toks, 4, attn_mask=mask, media=media).numpy()
        np.testing.assert_array_equal(out[0], ref)


def _prefill(cfg, params, media, tok, mask=None):
    with torch.inference_mode():
        return lm.apply_lm_prefill(cfg, params, tok, lm.init_caches(cfg, 1, tok.shape[1] + 4, "cpu"),
                                   attn_mask=mask, media=media)[0]


def test_masked_prefill_matches_unpadded_logits(contract_member):
    """Left pads and the mask give the unpadded prefill's logits; without
    the mask the pads leak into them (the control)."""
    cfg, params, media = contract_member
    prompt = _prompts(1, VOCAB, (7,))[0]
    ref = _prefill(cfg, params, media, torch.from_numpy(prompt[None]))
    pad = 6
    padded = torch.from_numpy(np.pad(prompt, (pad, 0))[None])
    mask = torch.from_numpy((np.arange(pad + len(prompt)) >= pad)[None])
    masked = _prefill(cfg, params, media, padded, mask)
    np.testing.assert_allclose(masked.numpy(), ref.numpy(), **MASKED_TOL)
    unmasked = _prefill(cfg, params, media, padded)
    assert not np.allclose(unmasked.numpy(), masked.numpy(), **MASKED_TOL)


# ---------------------------------------------------------------------------
# Serving a vlm member
# ---------------------------------------------------------------------------

def test_build_pool_gives_a_vlm_member_seeded_stub_media():
    """Only the member with cross layers gets media: (1, n_frontend_tokens,
    frontend_dim) on the pool's device, the same for the same seed."""
    names = [MUSIC, VISION, LLAMA4]
    pool = build_pool(names, seed=0, device="cpu", smoke=True)
    again = build_pool(names[:2], seed=0, device="cpu", smoke=True)
    other = build_pool(names[:2], seed=1, device="cpu", smoke=True)
    cfg = pool[1].cfg
    assert pool[0].media is None and pool[2].media is None
    assert tuple(pool[1].media.shape) == (1, cfg.n_frontend_tokens, cfg.frontend_dim)
    assert pool[1].media.device.type == "cpu"
    torch.testing.assert_close(pool[1].media, again[1].media, rtol=0, atol=0)
    assert not torch.equal(pool[1].media, other[1].media)
    assert tuple(pool[1].batch_media(5).shape) == (5, cfg.n_frontend_tokens, cfg.frontend_dim)
    assert pool[1].batch_media(5).data_ptr() == pool[1].media.data_ptr()   # a view
    assert pool[1].cost_rate == jax_arch_cost_rate(jax_get_config(VISION))


def test_generate_member_serves_a_vlm_member_the_references_tokens():
    """The reference's smoke vision member carried across, with the port's
    stub media: ``generate_member`` on a left-padded batch gives the
    reference's ``greedy_generate`` tokens with the same media over the
    batch (the reference's own ``generate_member`` passes no media and
    raises, ROADMAP.md Queue 3), and ``serve`` routes and generates."""
    jax_pool = jax_build_pool([MUSIC, VISION], seed=0)
    port = build_pool([MUSIC, VISION], seed=0, device="cpu", smoke=True)
    pool = [PoolMember(name=m.name, cfg=get_smoke_config(m.name),
                       params=bridge.lm_params_from_jax(get_smoke_config(m.name),
                                                        jax.tree.map(np.asarray, m.params),
                                                        "cpu"),
                       cost_rate=p.cost_rate, media=p.media)
            for m, p in zip(jax_pool, port)]
    engine = RoutedEngine(router=init_router(2, device="cpu"), pool=pool, device="cpu")
    cfg, jmember = pool[1].cfg, jax_pool[1]
    prompts = _prompts(17, cfg.vocab_size, (13, 4, 9))
    outs, costs = engine.generate_member(1, prompts, max_new=3)
    media = np.broadcast_to(pool[1].media.numpy(), (3,) + tuple(pool[1].media.shape[1:]))
    want = np.asarray(jax_lm.greedy_generate(
        jmember.cfg, jmember.params, jax_pad_prompts(prompts), 3, media=jnp.asarray(media),
        attn_mask=jax_prompt_pad_mask(prompts)))
    np.testing.assert_array_equal(np.stack(outs), want)
    np.testing.assert_allclose(costs, [pool[1].cost_rate / 256 * (len(p) + 3) for p in prompts],
                               rtol=1e-12)
    texts = ["describe the image", "write a poem", "prove the limit"]
    res = engine.serve(texts, prompts, max_new=2)
    assert all(len(o) == 2 for o in res["outputs"])
    assert int(res["per_member_counts"].sum()) == 3
