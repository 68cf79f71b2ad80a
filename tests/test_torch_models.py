"""The port's pool LMs against the JAX reference, on smoke configs.

Params come from ``repro.models.lm.init_lm`` and cross through
``repro_torch.bridge``; inputs are numpy, seeded. Logits agree within
rtol/atol 1e-4 in fp32 (the two frameworks sum matmuls in different
orders); greedy tokens agree exactly.
"""
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
from repro_torch.serving.engine import pad_prompts, prompt_pad_mask

NAMES = ["qwen3-0.6b", "granite-3-8b"]
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
    return name, jcfg, jparams, cfg, tparams


def _mixed_prompts(seed, vocab, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n, dtype=np.int32) for n in lengths]


def test_prefill_and_decode_logits_match(member):
    _, jcfg, jparams, cfg, tparams = member
    prompts = _mixed_prompts(0, cfg.vocab_size, [9, 4, 12])
    b, s, n_dec = len(prompts), 12, 3
    jmask, mask = jax_prompt_pad_mask(prompts), prompt_pad_mask(prompts)
    jtok, tok = jax_pad_prompts(prompts), pad_prompts(prompts)
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
    np.testing.assert_array_equal(pad_prompts(prompts).numpy(),
                                  np.asarray(jax_pad_prompts(prompts)))
    jt = jax_lm.greedy_generate(jcfg, jparams, jax_pad_prompts(prompts), 5,
                                attn_mask=jax_prompt_pad_mask(prompts))
    tt = lm.greedy_generate(cfg, tparams, pad_prompts(prompts), 5,
                            attn_mask=prompt_pad_mask(prompts))
    assert tt.dtype == torch.int32 and tt.shape == (4, 5)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


def test_request_alone_equals_request_in_batch(member):
    _, _, _, cfg, tparams = member
    prompts = _mixed_prompts(4, cfg.vocab_size, [7, 2, 10])
    batch = lm.greedy_generate(cfg, tparams, pad_prompts(prompts), 4,
                               attn_mask=prompt_pad_mask(prompts))
    for i, p in enumerate(prompts):
        alone = lm.greedy_generate(cfg, tparams, pad_prompts([p]), 4,
                                   attn_mask=prompt_pad_mask([p]))
        np.testing.assert_array_equal(alone[0].numpy(), batch[i].numpy())


def test_bridge_keeps_every_reference_weight(member):
    _, jcfg, jparams, cfg, tparams = member
    assert len(tparams["layers"]) == cfg.n_layers
    np_params = jax.tree.map(np.asarray, jparams)
    for r in range(cfg.n_repeats):
        layer = tparams["layers"][r]
        ref_w = np_params["pattern"][0]["mixer"]["wq"][r]
        np.testing.assert_array_equal(layer["mixer"]["wq"].numpy(), ref_w)
        np.testing.assert_array_equal(layer["ffn"]["w_down"].numpy(),
                                      np_params["pattern"][0]["ffn"]["w_down"][r])
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
    # Truncated-normal fan-in weights stay inside ±3σ, σ = 1/sqrt(d_in).
    w = mine["layers"][0]["ffn"]["w_gate"]
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
    cfg = get_smoke_config("qwen3-0.6b")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        get_config("gemma3-27b")
    with pytest.raises(NotImplementedError, match="sliding-window"):
        attn_mod.init_kv_cache(cfg, LayerSpec(mixer=ATTN, window=8), 1, 4, "cpu")
    with pytest.raises(NotImplementedError, match="mamba"):
        lm.init_block(torch.Generator(), cfg, LayerSpec(mixer="mamba"))
