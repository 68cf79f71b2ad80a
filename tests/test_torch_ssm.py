"""The port's Mamba block against the JAX reference, and the masked-compute
contract on the port alone.

Smoke jamba-1.5-large-398b (d_model 256, d_inner 512, d_state 16); params
from the reference's ``init_mamba`` / ``init_lm`` carried across leaf by
leaf, inputs numpy, seeded. Tolerances: outputs and decode states within
2e-5 abs (rtol 1e-5); at the reference's chunk-characterisation shapes
(B 2, S 64, x ~ N(0, 0.25)) the port's output within the reference's
SSM bound, 1e-7, of the reference's at the same chunk. The port runs the
recurrence step by step inside each chunk, so its chunk size bounds
memory only and its outputs are bitwise the same for every chunk. The
masked contract (``tests/test_masked_prefill.py``) keeps its rtol 2e-4 /
atol 2e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_get_smoke
from repro.models import lm as jax_lm
from repro.models import ssm as jax_ssm
from repro_torch import bridge
from repro_torch.common.tree import flatten_with_paths, nest_flat, tree_map
from repro_torch.configs import get_smoke_config
from repro_torch.models import lm, ssm
from repro_torch.serving.engine import pad_prompts, prompt_pad_mask

NAME = "jamba-1.5-large-398b"
TOL = dict(rtol=1e-5, atol=2e-5)
SSM_BOUND = 1e-7
MASK_TOL = dict(rtol=2e-4, atol=2e-5)


def _x(seed, *shape, scale=0.5):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _mask(b, s, pads):
    mask = np.ones((b, s), bool)
    for i, n in enumerate(pads):
        mask[i, :n] = False
    return mask


def _close(got, want, **tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **(tol or TOL))


@pytest.fixture(scope="module")
def mamba():
    """(jax cfg, jax params, port cfg, port params)."""
    jcfg, cfg = jax_get_smoke(NAME), get_smoke_config(NAME)
    jp = jax_ssm.init_mamba(jax.random.key(0), jcfg)
    return jcfg, jp, cfg, tree_map(lambda a: torch.from_numpy(np.array(a)),
                                   jax.tree.map(np.asarray, jp))


@pytest.mark.parametrize("s,pads", [(12, None), (12, (5, 0)), (2, (1, 0)), (200, None),
                                    (256, (130, 7))],
                         ids=["unmasked", "left-pads", "shorter-than-conv",
                              "off-the-chunk", "two-chunks-left-pads"])
def test_mamba_prefill_matches_reference(mamba, s, pads):
    """200 tokens: the reference takes one chunk of 200, the port chunks of
    128 and 72; 256 with 130 pads: the first chunk is all pads."""
    jcfg, jp, cfg, tp = mamba
    x = _x(10 + s, 2, s, cfg.d_model)
    mask = None if pads is None else _mask(2, s, pads)
    jout, jstate = jax_ssm.apply_mamba_train(jcfg, jp, jnp.asarray(x), return_state=True,
                                             mask=None if mask is None else jnp.asarray(mask))
    tout, tstate = ssm.apply_mamba_prefill(cfg, tp, torch.from_numpy(x),
                                           mask=None if mask is None else torch.from_numpy(mask))
    _close(tout, jout)
    assert tstate.keys() == jstate.keys()
    for key in jstate:
        _close(tstate[key], jstate[key])


@pytest.mark.parametrize("chunk", [16, 32, 64])
def test_chunked_scan_within_the_references_ssm_bound(monkeypatch, chunk):
    """The reference's chunk-characterisation inputs: each chunk size of the
    reference within 1e-7 of the port's, and the port's bitwise the same
    for every chunk (its chunks bound memory, not the arithmetic)."""
    jcfg, cfg = jax_get_smoke(NAME), get_smoke_config(NAME)
    jp = jax_ssm.init_mamba(jax.random.key(0), jcfg)
    tp = tree_map(lambda a: torch.from_numpy(np.array(a)), jax.tree.map(np.asarray, jp))
    x = _x(1, 2, 64, cfg.d_model)
    monkeypatch.setattr(jax_ssm, "SSM_CHUNK", chunk)
    want = np.asarray(jax_ssm.apply_mamba_train(jcfg, jp, jnp.asarray(x)))
    other, _ = ssm.apply_mamba_prefill(cfg, tp, torch.from_numpy(x))     # one chunk of 64
    monkeypatch.setattr(ssm, "SSM_CHUNK", chunk)
    got, _ = ssm.apply_mamba_prefill(cfg, tp, torch.from_numpy(x))
    assert np.abs(got.numpy() - want).max() < SSM_BOUND
    np.testing.assert_array_equal(got.numpy(), other.numpy())


def test_mamba_decode_matches_reference(mamba):
    """Three decode steps from a left-padded prefill's state; the cache
    dict is updated in place and keeps the reference's keys."""
    jcfg, jp, cfg, tp = mamba
    x = _x(20, 2, 9, cfg.d_model)
    mask = _mask(2, 9, (4, 0))
    _, jstate = jax_ssm.apply_mamba_train(jcfg, jp, jnp.asarray(x), return_state=True,
                                          mask=jnp.asarray(mask))
    _, tstate = ssm.apply_mamba_prefill(cfg, tp, torch.from_numpy(x),
                                        mask=torch.from_numpy(mask))
    jcache = {**jax_ssm.init_mamba_cache(jcfg, 2), **jstate}
    tcache = {**ssm.init_mamba_cache(cfg, 2, "cpu"), **tstate}
    assert tcache.keys() == jcache.keys()
    for i in range(3):
        xi = _x(30 + i, 2, 1, cfg.d_model)
        jout, jcache = jax_ssm.apply_mamba_decode(jcfg, jp, jnp.asarray(xi), jcache)
        tout, same = ssm.apply_mamba_decode(cfg, tp, torch.from_numpy(xi), tcache)
        assert same is tcache
        _close(tout, jout)
        for key in jcache:
            _close(tcache[key], jcache[key])


def test_chunked_scan_equals_the_step_recurrence(mamba):
    """Prefill over 150 tokens (chunks 128 + 22) against the decode step run
    token by token from the empty state."""
    _, _, cfg, tp = mamba
    x = torch.from_numpy(_x(50, 2, 150, cfg.d_model))
    out, state = ssm.apply_mamba_prefill(cfg, tp, x)
    cache = ssm.init_mamba_cache(cfg, 2, "cpu")
    steps = [ssm.apply_mamba_decode(cfg, tp, x[:, i:i + 1], cache)[0] for i in range(150)]
    np.testing.assert_allclose(torch.cat(steps, 1).numpy(), out.numpy(), **TOL)
    for key in state:
        np.testing.assert_allclose(cache[key].numpy(), state[key].numpy(), **TOL)


def test_init_matches_reference_layout():
    jcfg, cfg = jax_get_smoke(NAME), get_smoke_config(NAME)
    ref = jax.tree.map(np.asarray, jax_ssm.init_mamba(jax.random.key(0), jcfg))
    mine = ssm.init_mamba(torch.Generator().manual_seed(0), cfg)
    assert ({k: tuple(v.shape) for k, v in flatten_with_paths(mine).items()}
            == {k: v.shape for k, v in flatten_with_paths(ref).items()})
    for key in ("A_log", "D", "conv_b"):
        np.testing.assert_allclose(mine[key].numpy(), ref[key], rtol=1e-6)
    dt = torch.nn.functional.softplus(mine["dt_bias"])       # spans (1e-3, 1e-1)
    assert 1e-3 * (1 - 1e-5) <= float(dt.min()) and float(dt.max()) <= 0.1 * (1 + 1e-5)
    assert abs(float(mine["dt_proj"].std()) - float(ref["dt_proj"].std())) < 0.05


# ---------------------------------------------------------------------------
# The jamba hybrid's LM and its masked-compute contract
# ---------------------------------------------------------------------------

VOCAB = 64


@pytest.fixture(scope="module")
def jamba_lm():
    cfg = get_smoke_config(NAME)
    return cfg, lm.init_lm(torch.Generator().manual_seed(0), cfg)


def _gen(cfg, params, prompts, max_new=4):
    return lm.greedy_generate(cfg, params, pad_prompts(prompts, cfg), max_new,
                              attn_mask=prompt_pad_mask(prompts, cfg)).numpy()


def test_lm_batch_composition_invariance(jamba_lm):
    cfg, params = jamba_lm
    rng = np.random.default_rng(0)
    p_short, p_long, p_other = (rng.integers(0, VOCAB, size=n).astype(np.int32)
                                for n in (5, 17, 11))
    alone = _gen(cfg, params, [p_short])
    with_long = _gen(cfg, params, [p_short, p_long])
    with_two = _gen(cfg, params, [p_short, p_other, p_long])
    np.testing.assert_array_equal(alone[0], with_long[0])
    np.testing.assert_array_equal(alone[0], with_two[0])
    np.testing.assert_array_equal(with_long[1], with_two[2])


def test_lm_pad_count_invariance(jamba_lm):
    cfg, params = jamba_lm
    prompt = np.random.default_rng(3).integers(0, VOCAB, size=7).astype(np.int32)
    ref = _gen(cfg, params, [prompt])[0]
    for pad in (4, 9):
        toks = torch.from_numpy(np.pad(prompt, (pad, 0))[None])
        mask = torch.from_numpy((np.arange(pad + len(prompt)) >= pad)[None])
        out = lm.greedy_generate(cfg, params, toks, 4, attn_mask=mask).numpy()
        np.testing.assert_array_equal(out[0], ref)


def test_lm_masked_prefill_matches_unpadded_logits(jamba_lm):
    cfg, params = jamba_lm
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
    for spec, a, b in zip(cfg.layer_plan(), ref_c, out_c):
        if spec.mixer == "mamba":           # the recurrent states handed to decode
            for key in a:
                np.testing.assert_allclose(b[key].numpy(), a[key].numpy(), **MASK_TOL)


def test_lm_unmasked_padded_prefill_differs(jamba_lm):
    """Control: without the mask, the pad steps leak into the logits."""
    cfg, params = jamba_lm
    prompt = np.random.default_rng(2).integers(1, VOCAB, size=7).astype(np.int32)
    padded = torch.from_numpy(np.pad(prompt, (6, 0))[None])
    mask = torch.from_numpy((np.arange(13) >= 6)[None])
    with torch.inference_mode():
        masked, _ = lm.apply_lm_prefill(cfg, params, padded, lm.init_caches(cfg, 1, 17, "cpu"),
                                        attn_mask=mask)
        unmasked, _ = lm.apply_lm_prefill(cfg, params, padded,
                                          lm.init_caches(cfg, 1, 17, "cpu"))
    assert not np.allclose(masked.numpy(), unmasked.numpy(), **MASK_TOL)


def test_bridge_carries_the_jamba_tree():
    """The reference stacks the 4-layer smoke pattern (mamba+MLP, attn+MoE,
    mamba+MLP, mamba+MoE) with no remainder; the bridge lays it out per
    layer, every leaf unchanged, and the port's init has the same tree."""
    jcfg, cfg = jax_get_smoke(NAME), get_smoke_config(NAME)
    ref = jax.tree.map(np.asarray, jax_lm.init_lm(jax.random.key(0), jcfg))
    assert "remainder" not in ref and len(ref["pattern"]) == 4
    ported = bridge.lm_params_from_jax(cfg, ref, "cpu")
    assert [sorted(layer["mixer"])[0] for layer in ported["layers"]] == \
        ["A_log", "wk", "A_log", "A_log"]
    for j, layer in enumerate(ported["layers"]):
        want = flatten_with_paths(jax.tree.map(lambda a: a[0], ref["pattern"][j]))
        got = flatten_with_paths(layer)
        assert got.keys() == want.keys()
        for path, leaf in want.items():
            np.testing.assert_array_equal(got[path].numpy(), leaf)
    mine = lm.init_lm(torch.Generator().manual_seed(0), cfg)
    assert ({k: v.shape for k, v in flatten_with_paths(mine).items()}
            == {k: v.shape for k, v in flatten_with_paths(ported).items()})


def test_mamba_prefill_gradient_matches_jax_grad(mamba):
    """The scan differentiates: two chunks of 128 with left pads (the first
    row's first chunk all pads), d loss / d x and / d every param against
    ``jax.grad`` of the reference's ``apply_mamba_train``, each within
    1e-4 of its largest entry. Without autograd recording the outputs are
    bitwise those of the recording pass (the serving path is unchanged)."""
    jcfg, jp, cfg, tp = mamba
    s = 2 * ssm.SSM_CHUNK
    x, w = _x(70, 2, s, cfg.d_model), _x(71, 2, s, cfg.d_model, scale=1.0)
    mask = _mask(2, s, (130, 7))

    def jloss(p, xj):
        out = jax_ssm.apply_mamba_train(jcfg, p, xj, mask=jnp.asarray(mask))
        return jnp.sum(out * w)

    jg_p, jg_x = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    leaves = {k: v.clone().requires_grad_(True) for k, v in flatten_with_paths(tp).items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    out, _ = ssm.apply_mamba_prefill(cfg, nest_flat(leaves), xt, mask=torch.from_numpy(mask))
    grads = torch.autograd.grad((out * torch.from_numpy(w)).sum(), [xt, *leaves.values()])
    want = {"x": np.asarray(jg_x), **{k: np.asarray(v) for k, v in
                                      flatten_with_paths(jg_p).items()}}
    got = dict(zip(["x", *leaves], (g.numpy() for g in grads)))
    assert got.keys() == want.keys()
    for key, g in got.items():
        scale = np.abs(want[key]).max()
        assert scale > 0, key
        assert np.abs(g - want[key]).max() <= 1e-4 * scale, key
    with torch.inference_mode():
        served, _ = ssm.apply_mamba_prefill(cfg, tp, torch.from_numpy(x),
                                            mask=torch.from_numpy(mask))
    np.testing.assert_array_equal(served.numpy(), out.detach().numpy())
