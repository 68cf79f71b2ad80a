"""The port's LM training loss and its gradients against the JAX reference.

For each of the ten smoke configs, ``repro_torch.models.lm.lm_loss`` and
its gradient with respect to every parameter are held against
``jax.value_and_grad`` of the reference's ``lm_loss`` on params carried
over by ``repro_torch.bridge`` (MoE configs at capacity factor 8.0, as
``tests/test_arch_smoke.py`` runs them, so no assignment is dropped).
Token ids, labels and media are numpy, seeded; B 2, S 64.

Tolerances: the loss within 1e-5 relative; each gradient leaf's largest
error within 1e-4 of that leaf's largest magnitude (fp32 with other
summation orders: the errors seen are 2e-6 to 1e-5 of it). With ``remat``
off the port gives the same loss and grads as with it on, within float
rounding of the recompute (1e-6 of the largest magnitude), and the
reference's within the same tolerances. ``softmax_cross_entropy`` with
``seq_chunk`` and a tail matches the reference's within 1e-6.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_get_smoke
from repro.models import layers as jax_layers
from repro.models import lm as jax_lm
from repro_torch import bridge
from repro_torch.common.tree import flatten_with_paths
from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.configs.base import MOE
from repro_torch.models import layers, lm
from repro_torch.training.optim import value_and_grad

B, S = 2, 64
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
REMAT_TOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads while this file runs, so that parallel test
    workers do not each start one per core."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def configs(name):
    """(reference cfg, port cfg); MoE at capacity factor 8.0."""
    jcfg, cfg = jax_get_smoke(name), get_smoke_config(name)
    if cfg.has_ffn(MOE):
        jcfg = dataclasses.replace(jcfg, capacity_factor=8.0)
        cfg = dataclasses.replace(cfg, capacity_factor=8.0)
    return jcfg, cfg


def inputs(cfg, b, s, seed=1):
    """Seeded numpy tokens, labels and (for a vlm config) media."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    lab = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    media = None
    if cfg.arch_type == "vlm":
        media = rng.standard_normal((b, cfg.n_frontend_tokens, cfg.frontend_dim)).astype(
            np.float32)
    return tok, lab, media


def _jnp(a):
    return None if a is None else jnp.asarray(a)


def _t(a):
    return None if a is None else torch.from_numpy(a)


def reference_loss_and_grads(jcfg, cfg, jp, tok, lab, media=None, mask=None):
    """The reference's (loss, grads in the port's per-layer layout)."""
    f = jax.jit(jax.value_and_grad(lambda p: jax_lm.lm_loss(
        jcfg, p, jnp.asarray(tok), jnp.asarray(lab), media=_jnp(media),
        attn_mask=_jnp(mask))))
    loss, grads = f(jp)
    return float(loss), bridge.lm_params_from_jax(cfg, jax.tree.map(np.asarray, grads), "cpu")


def port_loss_and_grads(cfg, tp, tok, lab, media=None, mask=None, remat=True):
    loss, grads = value_and_grad(lambda p: lm.lm_loss(
        cfg, p, _t(tok), _t(lab), media=_t(media), attn_mask=_t(mask), remat=remat), tp)
    return float(loss), grads


def assert_grads_close(got, want, tol=GRAD_TOL):
    """Each leaf's largest error within ``tol`` of its largest magnitude."""
    got, want = flatten_with_paths(got), flatten_with_paths(want)
    assert got.keys() == want.keys()
    for key, w in want.items():
        g = got[key]
        assert g.shape == w.shape, key
        assert torch.isfinite(g).all(), key
        scale = float(w.abs().max())
        err = float((g - w).abs().max())
        assert err <= tol * scale, (key, err, scale)


@pytest.fixture(scope="module", params=ARCH_IDS)
def trained(request):
    """Per config: the reference's and the port's loss and grads (remat on)."""
    name = request.param
    jcfg, cfg = configs(name)
    jp = jax_lm.init_lm(jax.random.key(0), jcfg)
    tp = bridge.lm_params_from_jax(cfg, jax.tree.map(np.asarray, jp), "cpu")
    tok, lab, media = inputs(cfg, B, S)
    want = reference_loss_and_grads(jcfg, cfg, jp, tok, lab, media)
    got = port_loss_and_grads(cfg, tp, tok, lab, media)
    return {"name": name, "cfg": cfg, "tp": tp, "batch": (tok, lab, media),
            "want": want, "got": got}


def test_lm_loss_and_grads_match_reference(trained):
    (loss, grads), (jloss, jgrads) = trained["got"], trained["want"]
    assert abs(loss - jloss) <= LOSS_RTOL * abs(jloss), (trained["name"], loss, jloss)
    assert_grads_close(grads, jgrads)


def test_remat_off_gives_the_same_loss_and_grads(trained):
    loss_on, grads_on = trained["got"]
    jloss, jgrads = trained["want"]
    loss_off, grads_off = port_loss_and_grads(trained["cfg"], trained["tp"], *trained["batch"],
                                              remat=False)
    assert abs(loss_off - loss_on) <= REMAT_TOL * abs(loss_on)
    assert_grads_close(grads_off, grads_on, tol=REMAT_TOL)
    assert abs(loss_off - jloss) <= LOSS_RTOL * abs(jloss)
    assert_grads_close(grads_off, jgrads)


@pytest.mark.parametrize("mask", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("s,chunk", [(50, 16), (48, 16), (40, 0)],
                         ids=["chunks-and-tail", "chunks", "unchunked"])
def test_softmax_cross_entropy_matches_reference(s, chunk, mask):
    """Vocab 260 padded to 300 columns: the pad columns are pushed down."""
    rng = np.random.default_rng(s)
    logits = (rng.standard_normal((2, s, 300)) * 3).astype(np.float32)
    labels = rng.integers(0, 260, (2, s)).astype(np.int32)
    m = rng.random((2, s)) < 0.7 if mask else None
    want = jax_layers.softmax_cross_entropy(jnp.asarray(logits), jnp.asarray(labels), 260,
                                            mask=_jnp(m), seq_chunk=chunk)
    got = layers.softmax_cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                                       260, mask=_t(m), seq_chunk=chunk)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_softmax_cross_entropy_all_pad_mask_is_zero():
    """An all-pad mask divides by max(sum(mask), 1) = 1, not 0."""
    logits = torch.randn(1, 4, 8, generator=torch.Generator().manual_seed(0))
    got = layers.softmax_cross_entropy(logits, torch.zeros(1, 4, dtype=torch.int32), 8,
                                       mask=torch.zeros(1, 4, dtype=torch.bool))
    assert float(got) == 0.0
