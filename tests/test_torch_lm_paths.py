"""The paths of the port's LM training loss against the JAX reference:
full logits and aux (``apply_lm_train``), the masked (left-padded) loss in
every mixer family, the two-chunk loss over a padded vocab, the sLSTM's
checkpointed segments, and banded flash attention.

Params cross from the reference through ``repro_torch.bridge``; tokens,
labels, masks and media are numpy (the masks and rows from the port's
``MarkovCorpus.padded_batches``, which equals the reference's). MoE
configs run at capacity factor 8.0. Tolerances as in
``tests/test_torch_lm_train.py``: the loss within 1e-5 relative, each
gradient leaf within 1e-4 of its largest magnitude; logits within 2e-5
abs and the aux within 1e-5 relative.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_get_smoke
from repro.configs.base import ATTN as JAX_ATTN
from repro.configs.base import MLP as JAX_MLP
from repro.configs.base import LayerSpec as JaxLayerSpec
from repro.models import lm as jax_lm
from repro_torch import bridge
from repro_torch.common.tree import flatten_with_paths
from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.configs.base import ATTN, MLP, MOE, LayerSpec
from repro_torch.data.lm_data import MarkovCorpus
from repro_torch.models import lm
from repro_torch.training.optim import value_and_grad

LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
LOGIT_ATOL = 2e-5
AUX_RTOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads while this file runs, so that parallel test
    workers do not each start one per core."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _configs(name, **change):
    jcfg, cfg = jax_get_smoke(name), get_smoke_config(name)
    if cfg.has_ffn(MOE):
        change = {"capacity_factor": 8.0, **change}
    return dataclasses.replace(jcfg, **change), dataclasses.replace(cfg, **change)


def _params(jcfg, cfg):
    jp = jax_lm.init_lm(jax.random.key(0), jcfg)
    return jp, bridge.lm_params_from_jax(cfg, jax.tree.map(np.asarray, jp), "cpu")


def _media(cfg, b, seed=3):
    if cfg.arch_type != "vlm":
        return None
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, cfg.n_frontend_tokens, cfg.frontend_dim)).astype(np.float32)


def _jnp(a):
    return None if a is None else jnp.asarray(a)


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _check_loss_and_grads(jcfg, cfg, jp, tp, tok, lab, mask=None, media=None):
    f = jax.jit(jax.value_and_grad(lambda p: jax_lm.lm_loss(
        jcfg, p, jnp.asarray(tok), jnp.asarray(lab), media=_jnp(media),
        attn_mask=_jnp(mask))))
    jloss, jgrads = f(jp)
    jgrads = flatten_with_paths(
        bridge.lm_params_from_jax(cfg, jax.tree.map(np.asarray, jgrads), "cpu"))
    loss, grads = value_and_grad(lambda p: lm.lm_loss(
        cfg, p, _t(tok), _t(lab), media=_t(media), attn_mask=_t(mask)), tp)
    assert abs(float(loss) - float(jloss)) <= LOSS_RTOL * abs(float(jloss))
    grads = flatten_with_paths(grads)
    assert grads.keys() == jgrads.keys()
    for key, w in jgrads.items():
        err, scale = float((grads[key] - w).abs().max()), float(w.abs().max())
        assert err <= GRAD_TOL * scale, (key, err, scale)
    return float(loss)


@pytest.mark.parametrize("name", ARCH_IDS)
def test_apply_lm_train_logits_and_aux_match_reference(name):
    jcfg, cfg = _configs(name)
    jp, tp = _params(jcfg, cfg)
    rng = np.random.default_rng(7)
    tok = rng.integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)
    media = _media(cfg, 2)
    jlogits, jaux = jax.jit(lambda p: jax_lm.apply_lm_train(
        jcfg, p, jnp.asarray(tok), media=_jnp(media)))(jp)
    with torch.no_grad():
        logits, aux = lm.apply_lm_train(cfg, tp, torch.from_numpy(tok), media=_t(media))
    assert logits.shape == (2, 24, cfg.padded_vocab)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=0, atol=LOGIT_ATOL)
    if cfg.has_ffn(MOE):
        assert float(aux) > 0.0
        np.testing.assert_allclose(float(aux), float(jaux), rtol=AUX_RTOL)
    else:
        assert float(aux) == float(jaux) == 0.0


# One config per mixer family: attention, MoE, mLSTM and sLSTM, Mamba.
@pytest.mark.parametrize("name", ["qwen3-0.6b", "granite-moe-1b-a400m", "xlstm-1.3b",
                                  "jamba-1.5-large-398b"])
def test_masked_loss_and_grads_match_reference(name):
    """Left-padded ``padded_batches`` rows (lengths 16..64): pads leave the
    cross entropy, the MoE capacity and aux, and every mixer's state."""
    jcfg, cfg = _configs(name)
    jp, tp = _params(jcfg, cfg)
    tok, lab, mask = next(MarkovCorpus(cfg.vocab_size, seed=0).padded_batches(3, 64, seed=1))
    assert not mask.all() and mask.any(axis=1).all()
    masked = _check_loss_and_grads(jcfg, cfg, jp, tp, tok, lab, mask=mask)
    with torch.no_grad():
        unmasked = float(lm.lm_loss(cfg, tp, torch.from_numpy(tok), torch.from_numpy(lab)))
    assert masked != unmasked


def test_two_chunk_loss_over_a_padded_vocab_matches_reference():
    """qwen3 smoke at S 1024 takes two 512-position loss chunks; vocab 500
    is padded to 512 columns, whose logits are pushed down by 1e30; a
    remainder layer runs after the two checkpointed repeats."""
    jcfg, cfg = _configs("qwen3-0.6b", vocab_size=500)
    jcfg = dataclasses.replace(jcfg, n_layers=3,
                               remainder=(JaxLayerSpec(mixer=JAX_ATTN, ffn=JAX_MLP),))
    cfg = dataclasses.replace(cfg, n_layers=3, remainder=(LayerSpec(mixer=ATTN, ffn=MLP),))
    assert cfg.padded_vocab == 512 and len(cfg.layer_plan()) == 3
    jp, tp = _params(jcfg, cfg)
    rng = np.random.default_rng(5)
    tok = rng.integers(0, cfg.vocab_size, (1, 1024)).astype(np.int32)
    lab = rng.integers(0, cfg.vocab_size, (1, 1024)).astype(np.int32)
    assert 1024 // lm.LOSS_SEQ_CHUNK == 2
    _check_loss_and_grads(jcfg, cfg, jp, tp, tok, lab)


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
def test_slstm_segments_match_reference(masked):
    """xlstm smoke at T 128: the sLSTM runs two checkpointed segments of 64
    steps, the reference's two-level scan."""
    from repro_torch.models import xlstm

    assert 128 % xlstm.SLSTM_SEG == 0 and 128 > xlstm.SLSTM_SEG
    jcfg, cfg = _configs("xlstm-1.3b")
    jp, tp = _params(jcfg, cfg)
    if masked:
        tok, lab, mask = next(MarkovCorpus(cfg.vocab_size, seed=2).padded_batches(
            2, 128, seed=3))
    else:
        tok, lab = next(MarkovCorpus(cfg.vocab_size, seed=2).batches(2, 128, seed=3))
        mask = None
    _check_loss_and_grads(jcfg, cfg, jp, tp, tok, lab, mask=mask)


def test_banded_flash_loss_and_grads_match_reference():
    """gemma3 smoke at S 2048: flash attention (window 8 on the local
    layers) in the forward and the backward pass."""
    jcfg, cfg = _configs("gemma3-27b")
    jp, tp = _params(jcfg, cfg)
    tok, lab = next(MarkovCorpus(cfg.vocab_size, seed=4).batches(1, 2048, seed=5))
    _check_loss_and_grads(jcfg, cfg, jp, tp, tok, lab)
