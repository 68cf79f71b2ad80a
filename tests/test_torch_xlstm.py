"""The port's xLSTM blocks (mLSTM and sLSTM) against the JAX reference, and
the masked-compute contract on the port alone.

Smoke xlstm-1.3b (d_model 256, 4 heads of 128); params from the
reference's ``init_mlstm`` / ``init_slstm`` / ``init_lm`` carried across
leaf by leaf, inputs numpy, seeded. Tolerances: mixer outputs and decode
states within 2e-5 abs (rtol 1e-5); ``mlstm_chunkwise`` within the
chunk-decomposition bounds of ``tests/test_chunk_characterization.py``
(h 3e-5, C 1e-5), against the reference at each chunk, across its own
chunks, and against ``mlstm_step`` run token by token. The masked
contract (``tests/test_masked_prefill.py``) keeps its rtol 2e-4 / atol
2e-5: batch composition, pad count, masked equals unpadded.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.configs import get_smoke_config as jax_get_smoke
from repro.models import lm as jax_lm
from repro.models import xlstm as jax_xlstm
from repro_torch import bridge
from repro_torch.common.tree import flatten_with_paths, tree_map
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import lm, xlstm
from repro_torch.serving.engine import pad_prompts, prompt_pad_mask

NAME = "xlstm-1.3b"
TOL = dict(rtol=1e-5, atol=2e-5)
MLSTM_H_BOUND = 3e-5
MLSTM_C_BOUND = 1e-5
MASK_TOL = dict(rtol=2e-4, atol=2e-5)


def _ported(jparams):
    return tree_map(lambda a: torch.from_numpy(np.array(a)),
                    jax.tree.map(np.asarray, jparams))


def _x(seed, *shape, scale=0.5):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _mask(b, s, pads):
    mask = np.ones((b, s), bool)
    for i, n in enumerate(pads):
        mask[i, :n] = False
    return mask


def _close(got, want, **tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **(tol or TOL))


# ---------------------------------------------------------------------------
# mlstm_chunkwise and mlstm_step
# ---------------------------------------------------------------------------

def _mlstm_inputs(b=2, t=64, h=2, dh=16, seed=5):
    """The reference test's shapes and scales, from numpy."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, t, h, dh))
    k = rng.standard_normal((b, t, h, dh)) * dh ** -0.5
    v = rng.standard_normal((b, t, h, dh))
    log_i = rng.standard_normal((b, t, h)) - 2.0
    log_f = -np.logaddexp(0.0, -(rng.standard_normal((b, t, h)) + 2.0))
    return [np.asarray(a, np.float32) for a in (q, k, v, log_i, log_f)]


@pytest.mark.parametrize("chunk", [8, 16, 64])
def test_mlstm_chunkwise_matches_reference(chunk):
    args = _mlstm_inputs()
    jh, jstate = jax_xlstm.mlstm_chunkwise(*map(jnp.asarray, args), chunk=chunk)
    th, tstate = xlstm.mlstm_chunkwise(*map(torch.from_numpy, args), chunk=chunk)
    assert np.abs(th.numpy() - np.asarray(jh)).max() < MLSTM_H_BOUND
    assert np.abs(tstate["C"].numpy() - np.asarray(jstate["C"])).max() < MLSTM_C_BOUND
    _close(tstate["n"], jstate["n"])
    _close(tstate["m"], jstate["m"])


def test_mlstm_chunkwise_from_a_carried_state_matches_reference():
    """A second sequence continued from the first's state (the ``state``
    argument), chunk 16."""
    first, second = _mlstm_inputs(seed=5), _mlstm_inputs(seed=6, t=32)
    _, jstate = jax_xlstm.mlstm_chunkwise(*map(jnp.asarray, first), chunk=16)
    _, tstate = xlstm.mlstm_chunkwise(*map(torch.from_numpy, first), chunk=16)
    jh, jf = jax_xlstm.mlstm_chunkwise(*map(jnp.asarray, second), state=jstate, chunk=16)
    th, tf = xlstm.mlstm_chunkwise(*map(torch.from_numpy, second), state=tstate, chunk=16)
    assert np.abs(th.numpy() - np.asarray(jh)).max() < MLSTM_H_BOUND
    assert np.abs(tf["C"].numpy() - np.asarray(jf["C"])).max() < MLSTM_C_BOUND


def test_mlstm_chunk_decomposition_gap_is_bounded():
    """The port's own chunk sizes reassociate the recurrence within the
    reference's pinned bounds."""
    args = list(map(torch.from_numpy, _mlstm_inputs()))
    res = {c: xlstm.mlstm_chunkwise(*args, chunk=c) for c in (8, 16, 64)}
    for a, b in ((8, 64), (16, 64), (8, 16)):
        assert float((res[a][0] - res[b][0]).abs().max()) < MLSTM_H_BOUND
        assert float((res[a][1]["C"] - res[b][1]["C"]).abs().max()) < MLSTM_C_BOUND


def test_mlstm_step_matches_reference():
    q, k, v, li, lf = (a[:, 0] for a in _mlstm_inputs(t=4))
    b, h, dh = q.shape
    rng = np.random.default_rng(9)
    state = {"C": rng.standard_normal((b, h, dh, dh)).astype(np.float32),
             "n": rng.standard_normal((b, h, dh)).astype(np.float32),
             "m": rng.standard_normal((b, h)).astype(np.float32)}
    jh, jstate = jax_xlstm.mlstm_step(*map(jnp.asarray, (q, k, v, li, lf)),
                                      {k_: jnp.asarray(a) for k_, a in state.items()})
    tstate_in = {k_: torch.from_numpy(a) for k_, a in state.items()}
    th, tstate = xlstm.mlstm_step(*map(torch.from_numpy, (q, k, v, li, lf)), tstate_in)
    _close(th, jh)
    for key in ("C", "n", "m"):
        _close(tstate[key], jstate[key])
    np.testing.assert_array_equal(tstate_in["C"].numpy(), state["C"])   # not modified


@pytest.mark.parametrize("chunk", [8, 64])
def test_mlstm_chunkwise_equals_the_step_recurrence(chunk):
    """The oracle: ``mlstm_step`` token by token from the empty state."""
    args = list(map(torch.from_numpy, _mlstm_inputs()))
    h_chunk, final = xlstm.mlstm_chunkwise(*args, chunk=chunk)
    b, t, nh, dh = args[0].shape
    state = {"C": torch.zeros((b, nh, dh, dh)), "n": torch.zeros((b, nh, dh)),
             "m": torch.full((b, nh), xlstm.NEG_INF)}
    hs = []
    for i in range(t):
        h_i, state = xlstm.mlstm_step(*(a[:, i] for a in args), state)
        hs.append(h_i)
    assert float((torch.stack(hs, 1) - h_chunk).abs().max()) < MLSTM_H_BOUND
    assert float((state["C"] - final["C"]).abs().max()) < MLSTM_C_BOUND


def test_mlstm_length_rule_raises_on_an_unpadded_300_token_batch():
    """T = 300 is not a multiple of min(256, 300); the reference asserts,
    the port raises naming the rule. The engine's padding makes the batch
    512 wide for this plan."""
    cfg = get_smoke_config(NAME)
    params = lm.init_lm(torch.Generator().manual_seed(0), cfg)
    tok = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (1, 300), dtype=np.int32))
    with pytest.raises(ValueError, match="multiple of its chunk.*T = 300, chunk = 256"):
        lm.apply_lm_prefill(cfg, params, tok, lm.init_caches(cfg, 1, 301, "cpu"))
    prompts = [tok[0].numpy()]
    assert pad_prompts(prompts, cfg).shape == prompt_pad_mask(prompts, cfg).shape == (1, 512)


@settings(max_examples=60, deadline=None, derandomize=True)
@given(s=st.integers(1, 5000))
def test_prefill_width_meets_every_rule_of_the_plan(s):
    """The least width >= s that the plan's layers take: mLSTM a multiple
    of 256 above 256, attention a multiple of 1024 from 2048, Mamba any."""
    xl, jamba, qwen = (get_config(n) for n in (NAME, "jamba-1.5-large-398b", "qwen3-0.6b"))
    w = lm.prefill_width(xl, s)
    assert w >= s and (w == s if s <= 256 else w % 256 == 0) and w - s < 256
    assert lm.prefill_width(jamba, s) == lm.prefill_width(qwen, s)
    assert lm.prefill_width(qwen, s) == (s if s < 2048 else -(-s // 1024) * 1024)
    mixed = dataclasses.replace(jamba, pattern=jamba.pattern + xl.pattern,
                                n_repeats=1, n_layers=16)
    w = lm.prefill_width(mixed, s)
    assert w >= s and (w <= 256 or w % 256 == 0) and (w < 2048 or w % 1024 == 0)


# ---------------------------------------------------------------------------
# The mLSTM and sLSTM mixers
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mixers():
    """(jax cfg, port cfg, {kind: (jax params, port params)}); nonzero
    conv biases, so a pad's key is not zero and the all-pad chunk carries a
    nonzero n that only the next real chunk's rescale wipes."""
    jcfg, cfg = jax_get_smoke(NAME), get_smoke_config(NAME)
    jm = jax_xlstm.init_mlstm(jax.random.key(2), jcfg)
    jm["conv_b"] = jnp.asarray(_x(3, cfg.xlstm_d_inner))
    js = jax_xlstm.init_slstm(jax.random.key(4), jcfg)
    return jcfg, cfg, {"mlstm": (jm, _ported(jm)), "slstm": (js, _ported(js))}


@pytest.mark.parametrize("t,pads", [(12, None), (12, (5, 0)), (2, (1, 0)), (128, (70, 3))],
                         ids=["unmasked", "left-pads", "shorter-than-conv", "two-level-scan"])
@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_mixer_prefill_matches_reference(mixers, kind, t, pads):
    jcfg, cfg, ps = mixers
    jp, tp = ps[kind]
    x = _x(10 + t, 2, t, cfg.d_model)
    mask = None if pads is None else _mask(2, t, pads)
    jfn = getattr(jax_xlstm, f"apply_{kind}_train")
    jout, jstate = jfn(jcfg, jp, jnp.asarray(x), return_state=True,
                       mask=None if mask is None else jnp.asarray(mask))
    tfn = getattr(xlstm, f"apply_{kind}_prefill")
    tout, tstate = tfn(cfg, tp, torch.from_numpy(x),
                       mask=None if mask is None else torch.from_numpy(mask))
    _close(tout, jout)
    assert tstate.keys() == jstate.keys()
    for key in jstate:
        _close(tstate[key], jstate[key])


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_mixer_decode_matches_reference(mixers, kind):
    """Three decode steps from a prefilled state; the cache dict is updated
    in place and keeps the reference's keys."""
    jcfg, cfg, ps = mixers
    jp, tp = ps[kind]
    x = _x(20, 2, 9, cfg.d_model)
    mask = _mask(2, 9, (4, 0))
    _, jstate = getattr(jax_xlstm, f"apply_{kind}_train")(
        jcfg, jp, jnp.asarray(x), return_state=True, mask=jnp.asarray(mask))
    _, tstate = getattr(xlstm, f"apply_{kind}_prefill")(
        cfg, tp, torch.from_numpy(x), mask=torch.from_numpy(mask))
    jcache = {**getattr(jax_xlstm, f"init_{kind}_cache")(jcfg, 2), **jstate}
    tcache = {**getattr(xlstm, f"init_{kind}_cache")(cfg, 2, "cpu"), **tstate}
    assert tcache.keys() == jcache.keys()
    for i in range(3):
        xi = _x(30 + i, 2, 1, cfg.d_model)
        jout, jcache = getattr(jax_xlstm, f"apply_{kind}_decode")(jcfg, jp, jnp.asarray(xi),
                                                                  jcache)
        tout, same = getattr(xlstm, f"apply_{kind}_decode")(cfg, tp, torch.from_numpy(xi),
                                                            tcache)
        assert same is tcache
        _close(tout, jout)
        for key in jcache:
            _close(tcache[key], jcache[key])


def test_all_pad_leading_chunk_leaves_no_nan(mixers):
    """512 tokens, the first 300 pads: chunk 0 is all pads (m = NEG_INF, its
    pad sources weighted exp(0) = 1, a nonzero n from the conv bias). The
    real rows and the final state equal the unpadded 212-token run's, and
    the reference's on the padded batch."""
    jcfg, cfg, ps = mixers
    jp, tp = ps["mlstm"]
    real = _x(40, 1, 212, cfg.d_model)
    x = np.concatenate([_x(41, 1, 300, cfg.d_model), real], axis=1)
    mask = _mask(1, 512, (300,))
    out, state = xlstm.apply_mlstm_prefill(cfg, tp, torch.from_numpy(x),
                                           mask=torch.from_numpy(mask))
    assert torch.isfinite(out).all()
    assert all(torch.isfinite(v).all() for v in state.values())
    solo, solo_state = xlstm.apply_mlstm_prefill(cfg, tp, torch.from_numpy(real))
    np.testing.assert_allclose(out[:, 300:].numpy(), solo.numpy(), **MASK_TOL)
    for key in solo_state:
        np.testing.assert_allclose(state[key].numpy(), solo_state[key].numpy(), **MASK_TOL)
    jout, _ = jax_xlstm.apply_mlstm_train(jcfg, jp, jnp.asarray(x), return_state=True,
                                          mask=jnp.asarray(mask))
    _close(out[:, 300:], np.asarray(jout)[:, 300:])


def test_slstm_ffn_is_the_tanh_gelu(mixers):
    """``jax.nn.gelu`` defaults to the tanh approximation, and so does the
    port's sLSTM FFN. Inputs of scale 2 put the gate's pre-activations where
    torch's default (erf) GELU parts from it by far more than the tolerance."""
    jcfg, cfg, ps = mixers
    jp, tp = ps["slstm"]
    x = _x(60, 2, 5, cfg.d_model, scale=2.0)
    want = np.asarray(jax_xlstm._slstm_ffn(jp, jnp.asarray(x)))
    _close(xlstm._slstm_ffn(tp, torch.from_numpy(x)), want)
    a, g = (torch.from_numpy(x) @ tp["ff_up"]).chunk(2, dim=-1)
    erf = (torch.nn.functional.gelu(a) * g) @ tp["ff_down"]
    assert np.abs(erf.numpy() - want).max() > 1e-3


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_init_matches_reference_layout(kind):
    jcfg, cfg = jax_get_smoke(NAME), get_smoke_config(NAME)
    ref = jax.tree.map(np.asarray, getattr(jax_xlstm, f"init_{kind}")(jax.random.key(0), jcfg))
    mine = getattr(xlstm, f"init_{kind}")(torch.Generator().manual_seed(0), cfg)
    assert ({k: tuple(v.shape) for k, v in flatten_with_paths(mine).items()}
            == {k: v.shape for k, v in flatten_with_paths(ref).items()})
    for key in ("b_igate", "b_fgate", "skip", "conv_b", "b"):
        if key in ref:
            np.testing.assert_array_equal(mine[key].numpy(), ref[key])
    if kind == "slstm":
        for key in xlstm.R_KEYS:          # N(0, 1/dh)
            dh = mine[key].shape[-1]
            assert abs(float(mine[key].std()) * dh ** 0.5 - 1.0) < 0.05
    else:
        assert abs(float(mine["conv_w"].std()) - 0.1) < 0.01


# ---------------------------------------------------------------------------
# The masked-compute contract on the LM (reference: TestCrossMixerInvariance)
# ---------------------------------------------------------------------------

VOCAB = 64


@pytest.fixture(scope="module")
def xlstm_lm():
    cfg = get_smoke_config(NAME)
    return cfg, lm.init_lm(torch.Generator().manual_seed(0), cfg)


def _gen(cfg, params, prompts, max_new=4):
    return lm.greedy_generate(cfg, params, pad_prompts(prompts, cfg), max_new,
                              attn_mask=prompt_pad_mask(prompts, cfg)).numpy()


def test_lm_batch_composition_invariance(xlstm_lm):
    cfg, params = xlstm_lm
    rng = np.random.default_rng(0)
    p_short, p_long, p_other = (rng.integers(0, VOCAB, size=n).astype(np.int32)
                                for n in (5, 17, 11))
    alone = _gen(cfg, params, [p_short])
    with_long = _gen(cfg, params, [p_short, p_long])
    with_two = _gen(cfg, params, [p_short, p_other, p_long])
    np.testing.assert_array_equal(alone[0], with_long[0])
    np.testing.assert_array_equal(alone[0], with_two[0])
    np.testing.assert_array_equal(with_long[1], with_two[2])


def test_lm_pad_count_invariance(xlstm_lm):
    cfg, params = xlstm_lm
    prompt = np.random.default_rng(3).integers(0, VOCAB, size=7).astype(np.int32)
    ref = _gen(cfg, params, [prompt])[0]
    for pad in (4, 9):
        toks = torch.from_numpy(np.pad(prompt, (pad, 0))[None])
        mask = torch.from_numpy((np.arange(pad + len(prompt)) >= pad)[None])
        out = lm.greedy_generate(cfg, params, toks, 4, attn_mask=mask).numpy()
        np.testing.assert_array_equal(out[0], ref)


def test_lm_masked_prefill_matches_unpadded_logits(xlstm_lm):
    cfg, params = xlstm_lm
    prompt = np.random.default_rng(1).integers(0, VOCAB, size=7).astype(np.int32)
    pad = 6
    padded = torch.from_numpy(np.pad(prompt, (pad, 0))[None])
    mask = torch.from_numpy((np.arange(pad + len(prompt)) >= pad)[None])
    with torch.inference_mode():
        ref, ref_c = lm.apply_lm_prefill(cfg, params, torch.from_numpy(prompt[None]),
                                         lm.init_caches(cfg, 1, 11, "cpu"))
        out, out_c = lm.apply_lm_prefill(cfg, params, padded,
                                         lm.init_caches(cfg, 1, 17, "cpu"), attn_mask=mask)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), **MASK_TOL)
    for a, b in zip(ref_c, out_c):          # the recurrent states handed to decode
        for key in a:
            np.testing.assert_allclose(b[key].numpy(), a[key].numpy(), **MASK_TOL)


def test_lm_unmasked_padded_prefill_differs(xlstm_lm):
    """Control: without the mask, the pad steps leak into the logits."""
    cfg, params = xlstm_lm
    prompt = np.random.default_rng(2).integers(1, VOCAB, size=7).astype(np.int32)
    padded = torch.from_numpy(np.pad(prompt, (6, 0))[None])
    mask = torch.from_numpy((np.arange(13) >= 6)[None])
    with torch.inference_mode():
        masked, _ = lm.apply_lm_prefill(cfg, params, padded, lm.init_caches(cfg, 1, 17, "cpu"),
                                        attn_mask=mask)
        unmasked, _ = lm.apply_lm_prefill(cfg, params, padded,
                                          lm.init_caches(cfg, 1, 17, "cpu"))
    assert not np.allclose(masked.numpy(), unmasked.numpy(), **MASK_TOL)


def test_bridge_carries_the_xlstm_tree():
    """The reference stacks the 2-layer smoke pattern (sLSTM, mLSTM) on a
    repeat axis with no remainder and no FFN; the bridge lays it out per
    layer, every leaf unchanged, and the port's init has the same tree."""
    jcfg, cfg = jax_get_smoke(NAME), get_smoke_config(NAME)
    ref = jax.tree.map(np.asarray, jax_lm.init_lm(jax.random.key(0), jcfg))
    assert "remainder" not in ref and len(ref["pattern"]) == 2
    ported = bridge.lm_params_from_jax(cfg, ref, "cpu")
    for j, layer in enumerate(ported["layers"]):
        assert "ffn" not in layer and "norm2" not in layer
        want = flatten_with_paths(jax.tree.map(lambda a: a[0], ref["pattern"][j]))
        got = flatten_with_paths(layer)
        assert got.keys() == want.keys()
        for path, leaf in want.items():
            np.testing.assert_array_equal(got[path].numpy(), leaf)
    mine = lm.init_lm(torch.Generator().manual_seed(0), cfg)
    assert ({k: v.shape for k, v in flatten_with_paths(mine).items()}
            == {k: v.shape for k, v in flatten_with_paths(ported).items()})
