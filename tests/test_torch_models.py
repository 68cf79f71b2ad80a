"""The port's pool LMs against the JAX reference, on smoke configs.

Params come from ``repro.models.lm.init_lm`` and cross through
``repro_torch.bridge``; inputs are numpy, seeded. Logits agree within
rtol/atol 1e-4 in fp32 (the two frameworks sum matmuls in different
orders); greedy tokens agree exactly. granite-moe-1b-a400m runs the MoE
FFN (capacity-dispatched prefill, no-drop decode): its logits hold the
same 1e-4, and its tokens are equal. qwen1.5-4b adds QKV bias; gemma3-27b
sliding-window locals (window 8 at smoke size) on ring caches, which the
mixed prompts and their decode steps wrap, and one 2048-token prompt
that takes the flash path. xlstm-1.3b (sLSTM and mLSTM, no FFN) and the
jamba hybrid (Mamba, attention, MLP and MoE) decode from recurrent
states; a 300-token xlstm prompt is served padded to the mLSTM chunk.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_get_smoke
from repro.models import layers as jax_layers
from repro.models import lm as jax_lm
from repro.serving.engine import pad_prompts as jax_pad_prompts
from repro.serving.engine import prompt_pad_mask as jax_prompt_pad_mask
from repro_torch import bridge
from repro_torch.common.tree import flatten_with_paths
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import ATTN, LayerSpec
from repro_torch.models import attention as attn_mod
from repro_torch.models import layers
from repro_torch.models import lm
from repro_torch.launch.serve import init_router
from repro_torch.serving.engine import (
    PoolMember, RoutedEngine, arch_cost_rate, pad_prompts, prompt_pad_mask,
)

NAMES = ["qwen3-0.6b", "granite-moe-1b-a400m", "granite-3-8b", "qwen1.5-4b", "gemma3-27b",
         "xlstm-1.3b", "jamba-1.5-large-398b"]
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module", params=NAMES)
def member(request):
    """(name, jax cfg, jax params, port cfg, port params) on the CPU."""
    name = request.param
    jcfg = jax_get_smoke(name)
    jparams = jax_lm.init_lm(jax.random.key(3), jcfg)
    cfg = get_smoke_config(name)
    tparams = bridge.lm_params_from_jax(
        cfg, jax.tree.map(np.asarray, jparams), "cpu")
    if cfg.qkv_bias:
        # Seeded nonzero QKV biases in both packages: the reference's zeros
        # would test nothing. The smoke plan is one pattern entry, repeated.
        assert len(cfg.pattern) == 1 and not cfg.remainder
        lm.seed_qkv_biases(tparams, cfg)
        mixer = jparams["pattern"][0]["mixer"]
        for key in ("bq", "bk", "bv"):
            mixer[key] = jnp.asarray(np.stack(
                [layer["mixer"][key].numpy() for layer in tparams["layers"]]))
    return name, jcfg, jparams, cfg, tparams


def _mixed_prompts(seed, vocab, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n, dtype=np.int32) for n in lengths]


def test_prefill_and_decode_logits_match(member):
    _, jcfg, jparams, cfg, tparams = member
    prompts = _mixed_prompts(0, cfg.vocab_size, [9, 4, 12])
    b, s, n_dec = len(prompts), 12, 3
    jmask, mask = jax_prompt_pad_mask(prompts), prompt_pad_mask(prompts, cfg)
    jtok, tok = jax_pad_prompts(prompts), pad_prompts(prompts, cfg)
    jc = jax_lm.init_caches(jcfg, b, s + n_dec)
    tc = lm.init_caches(cfg, b, s + n_dec, "cpu")
    jl, jc = jax_lm.apply_lm_prefill(jcfg, jparams, jtok, jc, attn_mask=jmask)
    with torch.inference_mode():
        tl, tc = lm.apply_lm_prefill(cfg, tparams, tok, tc, attn_mask=mask)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    feed = np.random.default_rng(1).integers(0, cfg.vocab_size, (n_dec, b, 1),
                                             dtype=np.int32)
    for i in range(n_dec):
        jl, jc = jax_lm.apply_lm_decode(jcfg, jparams, jnp.asarray(feed[i]), jc,
                                        jnp.int32(s + i))
        with torch.inference_mode():
            tl, tc = lm.apply_lm_decode(cfg, tparams, torch.from_numpy(feed[i]),
                                        tc, s + i)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


def test_greedy_tokens_equal_on_left_padded_batch(member):
    _, jcfg, jparams, cfg, tparams = member
    prompts = _mixed_prompts(2, cfg.vocab_size, [5, 11, 3, 8])
    np.testing.assert_array_equal(pad_prompts(prompts, cfg).numpy(),
                                  np.asarray(jax_pad_prompts(prompts)))
    jt = jax_lm.greedy_generate(jcfg, jparams, jax_pad_prompts(prompts), 5,
                                attn_mask=jax_prompt_pad_mask(prompts))
    tt = lm.greedy_generate(cfg, tparams, pad_prompts(prompts, cfg), 5,
                            attn_mask=prompt_pad_mask(prompts, cfg))
    assert tt.dtype == torch.int32 and tt.shape == (4, 5)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


def test_request_alone_equals_request_in_batch(member):
    _, _, _, cfg, tparams = member
    prompts = _mixed_prompts(4, cfg.vocab_size, [7, 2, 10])
    batch = lm.greedy_generate(cfg, tparams, pad_prompts(prompts, cfg), 4,
                               attn_mask=prompt_pad_mask(prompts, cfg))
    for i, p in enumerate(prompts):
        alone = lm.greedy_generate(cfg, tparams, pad_prompts([p], cfg), 4,
                                   attn_mask=prompt_pad_mask([p], cfg))
        np.testing.assert_array_equal(alone[0].numpy(), batch[i].numpy())


def test_bridge_keeps_every_reference_weight(member):
    _, jcfg, jparams, cfg, tparams = member
    assert len(tparams["layers"]) == cfg.n_layers
    np_params = jax.tree.map(np.asarray, jparams)
    assert ("remainder" in np_params) == bool(cfg.remainder)
    for r in range(cfg.n_repeats):
        for j, spec in enumerate(cfg.pattern):
            layer = tparams["layers"][r * len(cfg.pattern) + j]
            if spec.mixer == ATTN:
                np.testing.assert_array_equal(layer["mixer"]["wq"].numpy(),
                                              np_params["pattern"][j]["mixer"]["wq"][r])
            # Every leaf of the layer: the MoE router (d, E) and experts
            # (E, d, fe) / (E, fe, d), the recurrent mixers' gates and
            # states' parameters included; an FFN-less block has none.
            mine = flatten_with_paths(layer)
            ref = flatten_with_paths(jax.tree.map(lambda a, r=r: a[r],
                                                  np_params["pattern"][j]))
            assert mine.keys() == ref.keys()
            assert ("ffn" in layer) == (spec.ffn != "none")
            for path, leaf in ref.items():
                np.testing.assert_array_equal(mine[path].numpy(), leaf)
    np.testing.assert_array_equal(tparams["embedding"]["head"].numpy(),
                                  np_params["embedding"]["head"])


@pytest.mark.parametrize("name", NAMES)
def test_param_counts_match_reference(name):
    for port_cfg, ref_cfg in [(get_config(name), jax_get_config(name)),
                              (get_smoke_config(name), jax_get_smoke(name))]:
        assert port_cfg.param_count() == ref_cfg.param_count()
        assert port_cfg.active_param_count() == ref_cfg.active_param_count()
        assert port_cfg.resolved_head_dim == ref_cfg.resolved_head_dim
        assert port_cfg.padded_vocab == ref_cfg.padded_vocab


@pytest.mark.parametrize("name", NAMES)
def test_port_init_matches_reference_layout(name):
    cfg = get_smoke_config(name)
    ref = jax.tree.map(np.asarray, jax_lm.init_lm(jax.random.key(0),
                                                  jax_get_smoke(name)))
    ported = bridge.lm_params_from_jax(cfg, ref, "cpu")
    gen = torch.Generator().manual_seed(0)
    mine = lm.init_lm(gen, cfg)
    shapes = lambda t: {k: v.shape for k, v in  # noqa: E731
                        flatten_with_paths(t).items()}
    assert shapes(mine) == shapes(ported)
    # QKV biases start at zero, as in the reference.
    biases = [leaf for path, leaf in flatten_with_paths(mine).items()
              if path.rsplit("/", 1)[-1] in ("bq", "bk", "bv")]
    assert len(biases) == (3 * cfg.n_layers if cfg.qkv_bias else 0)
    assert not any(b.any() for b in biases)
    # Truncated-normal fan-in weights stay inside ±3σ, σ = 1/sqrt(d_in):
    # the first layer's MLP, or its mixer's input projection without one.
    layer = mine["layers"][0]
    w = (layer["ffn"]["w_gate"] if "ffn" in layer
         else next(layer["mixer"][k] for k in ("wq", "in_proj", "up_proj", "w")
                   if k in layer["mixer"]))
    bound = 3.0 / np.sqrt(cfg.d_model)
    assert float(w.abs().max()) <= bound * (1 + 1e-6)
    assert 0.5 * bound / 3 < float(w.std()) < bound / 3


def test_rmsnorm_rope_mlp_match_reference():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 6, 4, 16)).astype(np.float32)
    scale = rng.standard_normal(16).astype(np.float32)
    pos = np.broadcast_to(np.arange(6, dtype=np.int32), (2, 6))
    np.testing.assert_allclose(
        layers.apply_rmsnorm({"scale": torch.from_numpy(scale)},
                             torch.from_numpy(x), 1e-6).numpy(),
        np.asarray(jax_layers.apply_rmsnorm({"scale": jnp.asarray(scale)},
                                            jnp.asarray(x), 1e-6)),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos.copy()),
                          1_000_000.0).numpy(),
        np.asarray(jax_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                         1_000_000.0)),
        rtol=1e-5, atol=1e-5)
    p = {k: rng.standard_normal(s).astype(np.float32) * 0.1
         for k, s in [("w_gate", (16, 24)), ("w_up", (16, 24)), ("w_down", (24, 16))]}
    h = x[:, :, 0]
    np.testing.assert_allclose(
        layers.apply_mlp({k: torch.from_numpy(v) for k, v in p.items()},
                         torch.from_numpy(h)).numpy(),
        np.asarray(jax_layers.apply_mlp({k: jnp.asarray(v) for k, v in p.items()},
                                        jnp.asarray(h))),
        rtol=1e-5, atol=1e-5)


def test_unported_options_raise():
    """Every config and mixer of the reference is ported; what the port
    still refuses is a cross-attention (XATTN) config run without its
    media, and an XATTN layer in a config with no frontend. Prefill or
    generation of smoke llama-3.2-vision without ``media`` (or with media
    of the wrong shape) raises ``ValueError`` naming the rule, where the
    reference fails on ``None @ w_proj``; an XATTN layer with
    ``frontend_dim`` 0 raises at init, as a block, a cache and an
    attention layer, where the reference would fail later with a
    ``KeyError`` on ``w_proj``. The count prices it as the reference does."""
    cfg = get_smoke_config("llama-3.2-vision-90b")
    params = lm.init_lm(torch.Generator().manual_seed(0), cfg)
    tok = torch.zeros((2, 5), dtype=torch.int32)
    with pytest.raises(ValueError, match="XATTN.*media"):
        lm.apply_lm_prefill(cfg, params, tok, lm.init_caches(cfg, 2, 6, "cpu"))
    with pytest.raises(ValueError, match="XATTN.*media"):
        lm.greedy_generate(cfg, params, tok, 2)
    wrong = torch.zeros((1, cfg.n_frontend_tokens, cfg.frontend_dim))
    with pytest.raises(ValueError, match=r"\(2, 16, 64\), got \(1, 16, 64\)"):
        lm.greedy_generate(cfg, params, tok, 2, media=wrong)
    no_frontend = dataclasses.replace(cfg, frontend_dim=0)
    xattn = LayerSpec(mixer="xattn", ffn="mlp")
    with pytest.raises(ValueError, match="XATTN.*frontend_dim"):
        attn_mod.init_kv_cache(no_frontend, xattn, 1, 4, "cpu")
    with pytest.raises(ValueError, match="XATTN.*frontend_dim"):
        attn_mod.init_attention(torch.Generator(), no_frontend, xattn)
    for ffn in ("mlp", "moe", "none"):
        spec = LayerSpec(mixer="xattn", ffn=ffn)
        with pytest.raises(ValueError, match="frontend_dim > 0"):
            lm.init_block(torch.Generator(), no_frontend, spec)
        with pytest.raises(ValueError, match="frontend_dim > 0"):
            lm.init_block_cache(no_frontend, spec, 1, 4, "cpu")
        plan = dict(pattern=(spec,), n_layers=1)
        assert (dataclasses.replace(no_frontend, **plan).param_count()
                == dataclasses.replace(jax_get_smoke("llama-3.2-vision-90b"), frontend_dim=0,
                                       **plan).param_count())
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("llama-3.2-vision-11b")


def test_bridge_orders_a_remainder_after_the_repeats():
    """gemma3-27b's plan with a remainder (5 local + 1 global, twice, then
    2 local): the bridge lays the reference's stacked pattern and its
    remainder out in plan order, each layer's leaves unchanged."""
    base = jax_get_smoke("gemma3-27b")
    local, glob = base.pattern[0], base.pattern[2]
    plan = dict(pattern=(local,) * 5 + (glob,), n_repeats=2, remainder=(local, local),
                n_layers=14)
    jcfg = dataclasses.replace(base, **plan)
    cfg = dataclasses.replace(get_smoke_config("gemma3-27b"), **plan)
    ref = jax.tree.map(np.asarray, jax_lm.init_lm(jax.random.key(4), jcfg))
    tparams = bridge.lm_params_from_jax(cfg, ref, "cpu")
    assert len(tparams["layers"]) == len(cfg.layer_plan()) == 14
    expect = [jax.tree.map(lambda a, r=r: a[r], ref["pattern"][j])
              for r in range(2) for j in range(6)] + list(ref["remainder"])
    for i, (mine, want) in enumerate(zip(tparams["layers"], expect)):
        mine, want = flatten_with_paths(mine), flatten_with_paths(want)
        assert mine.keys() == want.keys(), i
        for path, leaf in want.items():
            np.testing.assert_array_equal(mine[path].numpy(), leaf, err_msg=f"{i}{path}")
    caches = lm.init_caches(cfg, 1, 20, "cpu")
    assert [c["k"].shape[1] for c in caches] == [8] * 5 + [20] + [8] * 5 + [20] + [8, 8]


def test_gemma3_2048_token_prompt_takes_flash_and_matches_reference():
    """One 2048-token gemma3 smoke prompt (flash prefill, window 8 on two
    of three layers) through both packages: prefill and two decode steps'
    logits within 1e-4, greedy tokens equal."""
    name = "gemma3-27b"
    jcfg, cfg = jax_get_smoke(name), get_smoke_config(name)
    jparams = jax_lm.init_lm(jax.random.key(3), jcfg)
    tparams = bridge.lm_params_from_jax(cfg, jax.tree.map(np.asarray, jparams), "cpu")
    s, n_new = 2048, 3
    prompt = np.random.default_rng(11).integers(0, cfg.vocab_size, (1, s), dtype=np.int32)
    jc = jax_lm.init_caches(jcfg, 1, s + n_new)
    tc = lm.init_caches(cfg, 1, s + n_new, "cpu")
    jl, jc = jax_lm.apply_lm_prefill(jcfg, jparams, jnp.asarray(prompt), jc)
    with torch.inference_mode():
        tl, tc = lm.apply_lm_prefill(cfg, tparams, torch.from_numpy(prompt), tc)
    for i in range(n_new):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        jt = np.asarray(jnp.argmax(jl[:, -1, :cfg.vocab_size], axis=-1))
        tt = torch.argmax(tl[:, -1, :cfg.vocab_size], dim=-1)
        np.testing.assert_array_equal(tt.numpy(), jt)
        if i == n_new - 1:
            break
        jl, jc = jax_lm.apply_lm_decode(jcfg, jparams, jnp.asarray(jt)[:, None], jc,
                                        jnp.int32(s + i))
        with torch.inference_mode():
            tl, tc = lm.apply_lm_decode(cfg, tparams, tt[:, None], tc, s + i)


def test_serving_a_prompt_off_the_flash_chunk_pads_it_and_matches_reference():
    """``RoutedEngine.serve`` takes a 2500-token prompt, which flash alone
    refuses (not a multiple of its 1024 chunk): the engine left-pads the
    batch to 3072, and the served tokens, alone and beside a short prompt,
    equal the reference's greedy generation of that padded batch."""
    name = "gemma3-27b"
    jcfg, cfg = jax_get_smoke(name), get_smoke_config(name)
    jparams = jax_lm.init_lm(jax.random.key(3), jcfg)
    tparams = bridge.lm_params_from_jax(cfg, jax.tree.map(np.asarray, jparams), "cpu")
    engine = RoutedEngine(
        router=init_router(1, device="cpu"),
        pool=[PoolMember(name=name, cfg=cfg, params=tparams, cost_rate=arch_cost_rate(cfg))],
        device="cpu")
    rng = np.random.default_rng(12)
    prompts = [rng.integers(0, cfg.vocab_size, size=n, dtype=np.int32) for n in (2500, 40)]
    tok, mask = pad_prompts(prompts, cfg), prompt_pad_mask(prompts, cfg)
    assert tok.shape == mask.shape == (2, 3072)
    with pytest.raises(ValueError, match="multiple of its chunks"):
        lm.apply_lm_prefill(cfg, tparams, tok[:1, 3072 - 2500:],
                            lm.init_caches(cfg, 1, 2501, "cpu"))
    n_new = 3
    want = np.asarray(jax_lm.greedy_generate(jcfg, jparams, jnp.asarray(tok.numpy()), n_new,
                                             attn_mask=jnp.asarray(mask.numpy())))
    batch = engine.serve(["long", "short"], prompts, max_new=n_new)["outputs"]
    alone = engine.serve(["long"], prompts[:1], max_new=n_new)["outputs"]
    np.testing.assert_array_equal(np.stack(batch), want)
    np.testing.assert_array_equal(alone[0], want[0])


def test_serving_a_300_token_xlstm_prompt_pads_it_to_the_mlstm_chunk():
    """``RoutedEngine.serve`` takes a 300-token prompt on smoke xlstm-1.3b,
    which ``mlstm_chunkwise`` alone refuses (not a multiple of its 256
    chunk): the engine left-pads the batch to 512, and the served tokens,
    alone and beside a short prompt, equal the reference's greedy
    generation of that padded batch."""
    name = "xlstm-1.3b"
    jcfg, cfg = jax_get_smoke(name), get_smoke_config(name)
    jparams = jax_lm.init_lm(jax.random.key(3), jcfg)
    tparams = bridge.lm_params_from_jax(cfg, jax.tree.map(np.asarray, jparams), "cpu")
    engine = RoutedEngine(
        router=init_router(1, device="cpu"),
        pool=[PoolMember(name=name, cfg=cfg, params=tparams, cost_rate=arch_cost_rate(cfg))],
        device="cpu")
    rng = np.random.default_rng(13)
    prompts = [rng.integers(0, cfg.vocab_size, size=n, dtype=np.int32) for n in (300, 40)]
    tok, mask = pad_prompts(prompts, cfg), prompt_pad_mask(prompts, cfg)
    assert tok.shape == mask.shape == (2, 512)
    n_new = 3
    want = np.asarray(jax_lm.greedy_generate(jcfg, jparams, jnp.asarray(tok.numpy()), n_new,
                                             attn_mask=jnp.asarray(mask.numpy())))
    batch = engine.serve(["long", "short"], prompts, max_new=n_new)["outputs"]
    alone = engine.serve(["long"], prompts[:1], max_new=n_new)["outputs"]
    np.testing.assert_array_equal(np.stack(batch), want)
    np.testing.assert_array_equal(alone[0], want[0])
