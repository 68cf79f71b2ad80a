"""The port's self attention against the JAX reference, on the CPU.

Banded ``flash_attention`` against the reference's and against the port's
``dense_attention`` with the window mask (the reference's own tolerance,
rtol 2e-4 / atol 2e-5); ring-cache prefill and decode slot for slot
against the reference's caches; QKV bias with nonzero values; the
logit softcap; and the flash length rule. Inputs are seeded numpy; the
reference runs eagerly on the CPU.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_get_smoke
from repro.models import attention as jax_attn
from repro.serving.engine import pad_prompts as jax_pad_prompts
from repro.serving.engine import prompt_pad_mask as jax_prompt_pad_mask
from repro_torch import bridge
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ATTN, MLP, LayerSpec
from repro_torch.models import attention as attn_mod
from repro_torch.serving.engine import pad_prompts, prompt_pad_mask

FLASH_TOL = dict(rtol=2e-4, atol=2e-5)
TOL = dict(rtol=1e-4, atol=1e-5)


def _qkv(seed, b=2, s=256, hq=4, hkv=2, hd=32):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, s, hq, hd), (b, s, hkv, hd), (b, s, hkv, hd))]


def _left_pad_valid(b, s, pads):
    valid = np.ones((b, s), bool)
    for i, n in enumerate(pads):
        valid[i, :n] = False
    return valid


@pytest.mark.parametrize("softcap,kv_valid", [(0.0, False), (30.0, True)],
                         ids=["plain", "softcap-left-pads"])
@pytest.mark.parametrize("window", [0, 16, 64, 100])
def test_flash_matches_reference_and_dense(window, softcap, kv_valid):
    q, k, v = _qkv(window + int(softcap))
    b, s = q.shape[:2]
    # Row 0 keeps 70 pads, more than one 64-key chunk: its real queries'
    # bands start in fully masked chunks.
    valid = _left_pad_valid(b, s, (70, 9)) if kv_valid else None
    t = torch.from_numpy
    got = attn_mod.flash_attention(
        t(q), t(k), t(v), window=window, q_chunk=64, k_chunk=64, softcap=softcap,
        kv_valid=None if valid is None else t(valid))
    want = jax_attn.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window=window, q_chunk=64,
        k_chunk=64, softcap=softcap,
        kv_valid=None if valid is None else jnp.asarray(valid))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FLASH_TOL)
    mask = attn_mod.causal_mask(s, s, "cpu", window=window)
    if valid is not None:
        mask = mask & t(valid)[:, None, :]
    dense = attn_mod.dense_attention(t(q), t(k), t(v), mask, softcap).numpy()
    # Pad queries see no key: both paths give finite filler there, not
    # the same filler (dense averages every key, flash its band's).
    real = np.ones((b, s), bool) if valid is None else valid
    np.testing.assert_allclose(got.numpy()[real], dense[real], **FLASH_TOL)


def test_flash_skips_chunks_left_of_the_window():
    """A q chunk's band starts at (q_lo - window) // k_chunk: NaN keys and
    values left of the last chunk's band leave its output bit for bit as it
    was. A loop that read those chunks would give NaN (0 * NaN in probs @ v)."""
    q, k, v = _qkv(3, s=256)
    t = torch.from_numpy
    out = attn_mod.flash_attention(t(q), t(k), t(v), window=16, q_chunk=64, k_chunk=64)
    k2, v2 = k.copy(), v.copy()
    k2[:, :128] = np.nan
    v2[:, :128] = np.nan
    out2 = attn_mod.flash_attention(t(q), t(k2), t(v2), window=16, q_chunk=64, k_chunk=64)
    torch.testing.assert_close(out2[:, 192:], out[:, 192:], rtol=0, atol=0)


def test_flash_length_rule_raises():
    q, k, v = (torch.from_numpy(a) for a in _qkv(4, s=96))
    with pytest.raises(ValueError, match="multiple of its chunks"):
        attn_mod.flash_attention(q, k, v, q_chunk=64, k_chunk=64)
    cfg = get_smoke_config("qwen3-0.6b")
    spec = cfg.pattern[0]
    p = attn_mod.init_attention(torch.Generator().manual_seed(0), cfg, spec)
    s = attn_mod.FLASH_MIN_SEQ + 8
    x = torch.zeros((1, s, cfg.d_model))
    pos = torch.arange(s, dtype=torch.int32)[None]
    with pytest.raises(ValueError, match=f"S = {s}"):
        attn_mod.self_attention_prefill(
            cfg, spec, p, x, pos, attn_mod.init_kv_cache(cfg, spec, 1, s + 1, "cpu"))


def test_causal_mask_and_softcap_dense_match_reference():
    for window in (0, 5):
        np.testing.assert_array_equal(
            attn_mod.causal_mask(7, 12, "cpu", window=window).numpy(),
            np.asarray(jax_attn.causal_mask(7, 12, window=window)))
    q, k, v = _qkv(6, s=24)
    mask = np.asarray(jax_attn.causal_mask(24, 24, window=6))
    t = torch.from_numpy
    np.testing.assert_allclose(
        attn_mod.dense_attention(t(q), t(k), t(v), t(mask), softcap=5.0).numpy(),
        np.asarray(jax_attn.dense_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                            jnp.asarray(mask), softcap=5.0)),
        rtol=1e-5, atol=1e-5)


def _layer(name, window, bias_seed=None, softcap=0.0):
    """(jax cfg, port cfg, spec, jax params, port params) of one attention
    layer of ``name``'s smoke config; ``bias_seed`` gives the QKV biases
    seeded nonzero values (the reference initialises them to zero)."""
    jcfg = dataclasses.replace(jax_get_smoke(name), attn_logit_softcap=softcap)
    cfg = dataclasses.replace(get_smoke_config(name), attn_logit_softcap=softcap)
    spec = LayerSpec(mixer=ATTN, ffn=MLP, window=window)
    jp = jax.tree.map(np.asarray, jax_attn.init_attention(jax.random.key(1), jcfg, spec))
    if bias_seed is not None:
        rng = np.random.default_rng(bias_seed)
        for name_b in ("bq", "bk", "bv"):
            jp[name_b] = (rng.standard_normal(jp[name_b].shape) * 0.5).astype(np.float32)
    return jcfg, cfg, spec, jp, bridge.router_params_from_jax(jp, "cpu")


def _cache_equal(tc, jc, what):
    for key in ("slot_pos", "pad_valid"):
        np.testing.assert_array_equal(tc[key].numpy(), np.asarray(jc[key]),
                                      err_msg=f"{what}: {key}")
    for key in ("k", "v"):
        np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]), **TOL,
                                   err_msg=f"{what}: {key}")


@pytest.mark.parametrize("lengths", [(5, 3), (8, 2), (12, 5), (19, 19)])
def test_ring_prefill_and_decode_match_reference(lengths):
    """Window 8 on the gemma3 smoke layer: prompts shorter than, equal to
    and longer than the ring, left-padded, then decode steps across the
    wrap; caches equal slot for slot, outputs within 1e-4."""
    jcfg, cfg, spec, jp, tp = _layer("gemma3-27b", window=8)
    rng = np.random.default_rng(sum(lengths))
    prompts = [np.zeros(n, np.int32) for n in lengths]
    b, s, n_dec = len(lengths), max(lengths), 7
    xs = rng.standard_normal((b, s + n_dec, cfg.d_model)).astype(np.float32) * 0.5
    jmask, mask = jax_prompt_pad_mask(prompts), prompt_pad_mask(prompts, cfg)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))
    jc = jax_attn.init_kv_cache(jcfg, spec, b, s + n_dec)
    tc = attn_mod.init_kv_cache(cfg, spec, b, s + n_dec, "cpu")
    assert tc["k"].shape == jc["k"].shape == (b, min(8, s + n_dec), cfg.n_kv_heads, 64)
    x = jnp.asarray(xs[:, :s])
    jy = jax_attn.self_attention_full_seq(jcfg, spec, jp, x, jnp.asarray(pos), kv_valid=jmask)
    jc = jax_attn.prefill_self_cache(jcfg, spec, jp, x, jnp.asarray(pos), jc, kv_valid=jmask)
    ty, tc = attn_mod.self_attention_prefill(cfg, spec, tp, torch.from_numpy(xs[:, :s]),
                                             torch.from_numpy(pos.copy()), tc, kv_valid=mask)
    np.testing.assert_allclose(ty.numpy()[mask.numpy()], np.asarray(jy)[np.asarray(jmask)],
                               **TOL)
    _cache_equal(tc, jc, "prefill")
    for i in range(n_dec):
        xt = xs[:, s + i:s + i + 1]
        jy, jc = jax_attn.self_attention_decode(jcfg, spec, jp, jnp.asarray(xt), jc,
                                                jnp.int32(s + i))
        ty, tc = attn_mod.self_attention_decode(cfg, spec, tp, torch.from_numpy(xt), tc, s + i)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
        _cache_equal(tc, jc, f"decode step {i}")


def test_ring_cache_equals_full_cache_with_window_mask():
    """The reference's ring-vs-full property on the port: a ring of 8 and a
    24-slot linear cache, both masked to the window, give equal outputs."""
    cfg = dataclasses.replace(get_smoke_config("gemma3-27b"), qk_norm=False)
    spec = LayerSpec(mixer=ATTN, ffn=MLP, window=8)
    p = attn_mod.init_attention(torch.Generator().manual_seed(0), cfg, spec)
    b, steps = 2, 24
    gen = torch.Generator().manual_seed(1)
    xs = torch.randn((b, steps, cfg.d_model), generator=gen) * 0.3
    ring = attn_mod.init_kv_cache(cfg, spec, b, 8, "cpu")
    full = attn_mod.init_kv_cache(cfg, dataclasses.replace(spec, window=0), b, steps, "cpu")
    assert ring["k"].shape[1] == 8 and full["k"].shape[1] == steps
    for t in range(steps):
        o_ring, ring = attn_mod.self_attention_decode(cfg, spec, p, xs[:, t:t + 1], ring, t)
        # The windowed spec masks the long cache too; pos % 24 is pos there.
        o_full, full = attn_mod.self_attention_decode(cfg, spec, p, xs[:, t:t + 1], full, t)
        torch.testing.assert_close(o_ring, o_full, rtol=1e-4, atol=1e-5)


def test_linear_cache_refuses_a_position_past_its_end():
    cfg = get_smoke_config("qwen3-0.6b")
    spec = cfg.pattern[0]
    p = attn_mod.init_attention(torch.Generator().manual_seed(0), cfg, spec)
    cache = attn_mod.init_kv_cache(cfg, spec, 1, 4, "cpu")
    with pytest.raises(ValueError, match="outside the cache's 4 slots"):
        attn_mod.self_attention_decode(cfg, spec, p, torch.zeros((1, 1, cfg.d_model)),
                                       cache, 4)


@pytest.mark.parametrize("window,softcap", [(0, 0.0), (8, 0.0), (0, 20.0)])
def test_qkv_bias_nonzero_matches_reference(window, softcap):
    """qwen1.5-4b's QKV bias with seeded nonzero values (zeros test
    nothing), prefill and decode, optionally windowed and softcapped."""
    jcfg, cfg, spec, jp, tp = _layer("qwen1.5-4b", window, bias_seed=7, softcap=softcap)
    assert cfg.qkv_bias and float(tp["bk"].abs().max()) > 0.1
    rng = np.random.default_rng(8)
    prompts = [np.zeros(n, np.int32) for n in (10, 4)]
    b, s, n_dec = 2, 10, 4
    xs = rng.standard_normal((b, s + n_dec, cfg.d_model)).astype(np.float32) * 0.5
    jmask, mask = jax_prompt_pad_mask(prompts), prompt_pad_mask(prompts, cfg)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))
    x = jnp.asarray(xs[:, :s])
    jy = jax_attn.self_attention_full_seq(jcfg, spec, jp, x, jnp.asarray(pos), kv_valid=jmask)
    jc = jax_attn.prefill_self_cache(jcfg, spec, jp, x, jnp.asarray(pos),
                                     jax_attn.init_kv_cache(jcfg, spec, b, s + n_dec),
                                     kv_valid=jmask)
    ty, tc = attn_mod.self_attention_prefill(
        cfg, spec, tp, torch.from_numpy(xs[:, :s]), torch.from_numpy(pos.copy()),
        attn_mod.init_kv_cache(cfg, spec, b, s + n_dec, "cpu"), kv_valid=mask)
    np.testing.assert_allclose(ty.numpy()[mask.numpy()], np.asarray(jy)[np.asarray(jmask)],
                               **TOL)
    _cache_equal(tc, jc, "prefill")
    for i in range(n_dec):
        xt = xs[:, s + i:s + i + 1]
        jy, jc = jax_attn.self_attention_decode(jcfg, spec, jp, jnp.asarray(xt), jc,
                                                jnp.int32(s + i))
        ty, tc = attn_mod.self_attention_decode(cfg, spec, tp, torch.from_numpy(xt), tc, s + i)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)


def test_flash_prefill_of_a_left_padded_batch_matches_reference():
    """One gemma3 smoke layer (window 8) prefilled at S 2048 through flash
    with left pads, caches and real rows against the reference."""
    jcfg, cfg, spec, jp, tp = _layer("gemma3-27b", window=8)
    s = attn_mod.FLASH_MIN_SEQ
    prompts = [np.zeros(n, np.int32) for n in (s, s - 1100)]
    rng = np.random.default_rng(9)
    xs = rng.standard_normal((2, s, cfg.d_model)).astype(np.float32) * 0.5
    jmask, mask = jax_prompt_pad_mask(prompts), prompt_pad_mask(prompts, cfg)
    np.testing.assert_array_equal(pad_prompts(prompts, cfg).numpy(),
                                  np.asarray(jax_pad_prompts(prompts)))
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (2, s))
    x = jnp.asarray(xs)
    jy = jax_attn.self_attention_full_seq(jcfg, spec, jp, x, jnp.asarray(pos), kv_valid=jmask)
    jc = jax_attn.prefill_self_cache(jcfg, spec, jp, x, jnp.asarray(pos),
                                     jax_attn.init_kv_cache(jcfg, spec, 2, s + 4),
                                     kv_valid=jmask)
    ty, tc = attn_mod.self_attention_prefill(
        cfg, spec, tp, torch.from_numpy(xs), torch.from_numpy(pos.copy()),
        attn_mod.init_kv_cache(cfg, spec, 2, s + 4, "cpu"), kv_valid=mask)
    real = mask.numpy()
    np.testing.assert_allclose(ty.numpy()[real], np.asarray(jy)[real], **FLASH_TOL)
    _cache_equal(tc, jc, "flash prefill")
