"""The port's mixture-of-experts FFN against the JAX reference, and the
reference's MoE properties held on the port alone.

Smoke granite-moe-1b-a400m (4 experts, top-2, d_model 256); params from
``repro.models.moe.init_moe`` carried across leaf by leaf, inputs numpy,
seeded. Tolerances: MoE outputs within rtol/atol 1e-5 of the reference's
(the two frameworks sum matmuls in different orders), aux losses within
1e-6, dropped-assignment counts exactly equal. Every parity input is
checked to have its k-th and (k+1)-th router probabilities more than 1e-5
apart at every token, so no near tie can pick another expert in one
package. The port-alone properties keep the reference tests' own
tolerances (``tests/test_models_units.py``, ``tests/test_masked_prefill.py``).
``DECODE_DROP_LOG`` is set through ``monkeypatch`` in both packages, so
it is restored after each test.
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
from repro.models import moe as jax_moe
from repro_torch.common.tree import flatten_with_paths, tree_map
from repro_torch.configs import get_smoke_config
from repro_torch.models import lm, moe
from repro_torch.serving.engine import pad_prompts, prompt_pad_mask

NAME = "granite-moe-1b-a400m"
TOL = dict(rtol=1e-5, atol=1e-5)
AUX_TOL = 1e-6
MARGIN = 1e-5


def _cfgs(**changes):
    return (dataclasses.replace(jax_get_smoke(NAME), **changes),
            dataclasses.replace(get_smoke_config(NAME), **changes))


def _ported(jparams):
    return tree_map(lambda a: torch.from_numpy(np.array(a)),
                    jax.tree.map(np.asarray, jparams))


@pytest.fixture(scope="module", params=[0, 1], ids=["routed", "shared-expert"])
def pair(request):
    """(jax cfg, jax params, port cfg, port params); the second variant adds
    one shared expert."""
    jcfg, cfg = _cfgs(n_shared_experts=request.param)
    jparams = jax_moe.init_moe(jax.random.key(3), jcfg)
    return jcfg, jparams, cfg, _ported(jparams)


def _assert_no_near_ties(jparams, x, k):
    probs = np.sort(np.asarray(jax_moe._router_probs(
        jparams, jnp.asarray(x.reshape(-1, x.shape[-1])))), axis=-1)[:, ::-1]
    gap = probs[:, k - 1] - probs[:, k]
    assert gap.min() > MARGIN, f"near tie in the router inputs: {gap.min():.3g}"


def _x(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("masked", [False, True], ids=["all-valid", "valid-mask"])
@pytest.mark.parametrize("cf", [0.1, 1.25, 32.0])
def test_dispatch_combine_matches_reference(pair, cf, masked):
    jcfg, jparams, cfg, tparams = pair
    x = _x(10, 64, cfg.d_model)
    _assert_no_near_ties(jparams, x, cfg.top_k)
    valid = np.random.default_rng(11).uniform(size=64) > 0.3 if masked else None
    jo, ja, jd = jax_moe._dispatch_combine(
        jcfg, jparams, jnp.asarray(x), capacity_factor=cf,
        valid=None if valid is None else jnp.asarray(valid), return_drops=True)
    to, ta, td = moe._dispatch_combine(
        cfg, tparams, torch.from_numpy(x), capacity_factor=cf,
        valid=None if valid is None else torch.from_numpy(valid), return_drops=True)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    assert abs(float(ta) - float(ja)) <= AUX_TOL
    assert int(td) == int(jd)
    if cf == 0.1:
        assert int(td) > 0, "capacity factor 0.1 must bind"
    if cf == 32.0:
        assert int(td) == 0


def _train_case(case, d):
    """(x, mask, seq_chunk) for each branch of apply_moe_train."""
    if case == "unmasked":
        return _x(20, 2, 12, d), None, 512
    if case == "unmasked-chunked":            # S > seq_chunk, S % seq_chunk == 0
        return _x(21, 2, 16, d), None, 8
    if case == "unmasked-ragged":             # S % seq_chunk != 0: one group per row
        return _x(22, 2, 12, d), None, 8
    if case == "masked-one-group":
        mask = np.ones((2, 12), bool)
        mask[0, :5] = False
        return _x(23, 2, 12, d), mask, 512
    if case == "masked-rank-chunks":          # rows of 20 real tokens after 6 pads
        mask = np.ones((2, 26), bool)
        mask[:, :6] = False
        mask[1, :2] = True
        return _x(24, 2, 26, d), mask, 8
    if case == "masked-pad-crosses-chunk":    # 10 real after 7 pads, chunks of 8
        mask = np.ones((1, 17), bool)
        mask[0, :7] = False
        return _x(25, 1, 17, d), mask, 8
    raise ValueError(case)


@pytest.mark.parametrize("case", ["unmasked", "unmasked-chunked", "unmasked-ragged",
                                  "masked-one-group", "masked-rank-chunks",
                                  "masked-pad-crosses-chunk"])
def test_apply_moe_train_matches_reference(pair, case):
    jcfg, jparams, cfg, tparams = pair
    x, mask, chunk = _train_case(case, cfg.d_model)
    _assert_no_near_ties(jparams, x, cfg.top_k)
    jo, ja = jax_moe.apply_moe_train(jcfg, jparams, jnp.asarray(x), seq_chunk=chunk,
                                     mask=None if mask is None else jnp.asarray(mask))
    to, ta = moe.apply_moe_train(cfg, tparams, torch.from_numpy(x), seq_chunk=chunk,
                                 mask=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    assert abs(float(ta) - float(ja)) <= AUX_TOL


def test_apply_moe_decode_matches_reference(pair, monkeypatch):
    """Batch rows beyond one DECODE_CHUNK: no drops, one log entry per call."""
    jcfg, jparams, cfg, tparams = pair
    x = _x(30, moe.DECODE_CHUNK + 40, 1, cfg.d_model)
    _assert_no_near_ties(jparams, x, cfg.top_k)
    monkeypatch.setattr(jax_moe, "DECODE_DROP_LOG", [])
    monkeypatch.setattr(moe, "DECODE_DROP_LOG", [])
    jo = jax_moe.apply_moe_decode(jcfg, jparams, jnp.asarray(x))
    to = moe.apply_moe_decode(cfg, tparams, torch.from_numpy(x))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    assert len(moe.DECODE_DROP_LOG) == 1
    assert moe.DECODE_DROP_LOG == [0] == jax_moe.DECODE_DROP_LOG


@pytest.mark.parametrize("shared", [0, 1])
def test_init_moe_matches_reference_layout(shared):
    jcfg, cfg = _cfgs(n_shared_experts=shared)
    ref = jax.tree.map(np.asarray, jax_moe.init_moe(jax.random.key(0), jcfg))
    mine = moe.init_moe(torch.Generator().manual_seed(0), cfg)
    assert ({k: tuple(v.shape) for k, v in flatten_with_paths(mine).items()}
            == {k: v.shape for k, v in flatten_with_paths(ref).items()})
    assert ("shared" in mine) == bool(shared)
    for path, w in flatten_with_paths(mine).items():    # fan-in truncated normal
        bound = 3.0 / np.sqrt(w.shape[-2])
        assert float(w.abs().max()) <= bound * (1 + 1e-6), path
        assert 0.5 * bound / 3 < float(w.std()) < bound / 3, path


# ---------------------------------------------------------------------------
# The reference's MoE properties, held on the port alone
# ---------------------------------------------------------------------------

def _port_moe(seed, **changes):
    cfg = dataclasses.replace(get_smoke_config(NAME), **changes)
    return cfg, moe.init_moe(torch.Generator().manual_seed(seed), cfg)


def _t(seed, *shape, scale=1.0):
    return torch.from_numpy(_x(seed, *shape) * scale)


def test_dispatch_matches_dense_when_capacity_ample():
    cfg, p = _port_moe(0, capacity_factor=32.0)
    x = _t(1, 16, cfg.d_model, scale=0.5)
    out, _ = moe._dispatch_combine(cfg, p, x, capacity_factor=32.0)
    probs = moe._router_probs(p, x).numpy()
    gate_idx = np.argsort(-probs, axis=1)[:, : cfg.top_k]
    expect = np.zeros(tuple(x.shape), np.float32)
    for t in range(x.shape[0]):
        gv = probs[t, gate_idx[t]] / probs[t, gate_idx[t]].sum()
        for g, e in zip(gv, gate_idx[t]):
            h = torch.nn.functional.silu(x[t] @ p["w_gate"][e]) * (x[t] @ p["w_up"][e])
            expect[t] += g * (h @ p["w_down"][e]).numpy()
    np.testing.assert_allclose(out.numpy(), expect, rtol=2e-3, atol=2e-4)


def test_capacity_drops_tokens():
    cfg, p = _port_moe(0)
    x = _t(1, 64, cfg.d_model)
    small, _, dropped = moe._dispatch_combine(cfg, p, x, capacity_factor=0.1,
                                              return_drops=True)
    big, _ = moe._dispatch_combine(cfg, p, x, capacity_factor=32.0)
    assert int(dropped) > 0
    assert not np.allclose(small.numpy(), big.numpy())


def test_aux_loss_uniform_router_is_one():
    e = 8
    probs = torch.full((128, e), 1.0 / e)
    mask = torch.nn.functional.one_hot(torch.arange(128) % e, e).float()
    assert abs(float(moe.aux_load_balance_loss(probs, mask)) - 1.0) <= 1e-5


def test_train_decode_consistency():
    cfg, p = _port_moe(2, capacity_factor=16.0)
    x = _t(3, 2, 4, cfg.d_model, scale=0.5)
    out_train, _ = moe.apply_moe_train(cfg, p, x)
    np.testing.assert_allclose(out_train.numpy(), moe.apply_moe_decode(cfg, p, x).numpy(),
                               rtol=2e-3, atol=2e-4)


def _kept(gate_idx, n_experts, cap, counted):
    """The dispatcher's flattened (token-major, slot-minor) position
    accounting in plain numpy."""
    counts = np.zeros(n_experts, np.int64)
    kept = np.zeros(gate_idx.shape, bool)
    for t in range(gate_idx.shape[0]):
        if not counted[t]:
            continue
        for j, ex in enumerate(gate_idx[t]):
            kept[t, j] = counts[ex] < cap
            counts[ex] += 1
    return kept


class TestPadCapacity:
    """Pads take no expert capacity, shift no real token's buffer position,
    and stay out of the aux loss (reference: TestMoEPadCapacity)."""

    T, REAL = 16, 4

    def _setup(self, cf=1.0):
        cfg, p = _port_moe(7, capacity_factor=cf)
        xr = _t(8, self.REAL, cfg.d_model)
        padvec = _t(9, 1, cfg.d_model).expand(self.T - self.REAL, -1)
        x = torch.cat([padvec, xr], dim=0)
        valid = torch.from_numpy(np.arange(self.T) >= self.T - self.REAL)
        return cfg, p, x, xr, valid

    def test_old_accounting_drops_real_token_new_does_not(self):
        cfg, p, x, _, valid = self._setup()
        gate_idx = torch.topk(moe._router_probs(p, x), cfg.top_k)[1].numpy()
        kept_old = _kept(gate_idx, cfg.n_experts, moe._capacity(self.T, cfg),
                         np.ones(self.T, bool))
        cap_new = moe._capacity(self.REAL, cfg)
        kept_new = _kept(gate_idx, cfg.n_experts, cap_new, valid.numpy())
        kept_solo = _kept(gate_idx[self.T - self.REAL:], cfg.n_experts, cap_new,
                          np.ones(self.REAL, bool))
        real = slice(self.T - self.REAL, self.T)
        assert (~kept_old[real] & kept_new[real]).any()
        np.testing.assert_array_equal(kept_new[real], kept_solo)
        # The port's own drop count is the numpy rule's.
        _, _, dropped = moe._dispatch_combine(cfg, p, x, valid=valid, return_drops=True)
        assert int(dropped) == int((~kept_new[real]).sum())

    def test_pad_excluded_dispatch_matches_solo_run(self):
        cfg, p, x, xr, valid = self._setup()
        out_new, _ = moe._dispatch_combine(cfg, p, x, valid=valid)
        out_solo, _ = moe._dispatch_combine(cfg, p, xr)
        out_old, _ = moe._dispatch_combine(cfg, p, x)
        real = slice(self.T - self.REAL, self.T)
        np.testing.assert_allclose(out_new[real].numpy(), out_solo.numpy(),
                                   rtol=1e-6, atol=1e-6)
        assert not np.allclose(out_old[real].numpy(), out_solo.numpy(),
                               rtol=1e-3, atol=1e-4)
        np.testing.assert_array_equal(out_new[: self.T - self.REAL].numpy(), 0.0)

    def test_aux_loss_excludes_pads(self):
        cfg, p, x, xr, valid = self._setup()
        aux_new = float(moe._dispatch_combine(cfg, p, x, valid=valid)[1])
        aux_solo = float(moe._dispatch_combine(cfg, p, xr)[1])
        aux_old = float(moe._dispatch_combine(cfg, p, x)[1])
        assert np.isclose(aux_new, aux_solo, rtol=1e-6)
        assert not np.isclose(aux_old, aux_solo, rtol=1e-3)

    def test_moe_train_rows_masked_independently(self):
        cfg, p, x, xr, valid = self._setup()
        out, _ = moe.apply_moe_train(cfg, p, torch.stack([x, x]),
                                     mask=torch.stack([valid, torch.ones_like(valid)]))
        out_solo, _ = moe.apply_moe_train(cfg, p, xr[None])
        np.testing.assert_allclose(out[0, self.T - self.REAL:].numpy(),
                                   out_solo[0].numpy(), rtol=1e-6, atol=1e-6)


class TestRankChunking:
    """Past ``seq_chunk``, capacity groups are chunks of valid-token rank
    (reference: TestMoERankChunking)."""

    def _padded_pair(self, cfg, real, pad, seed):
        xr = _t(seed, 1, real, cfg.d_model)
        xp = torch.cat([_t(seed + 1, 1, pad, cfg.d_model), xr], dim=1)
        m_pad = torch.from_numpy((np.arange(pad + real) >= pad)[None])
        return xr, torch.ones((1, real), dtype=torch.bool), xp, m_pad

    def test_invariance_beyond_seq_chunk(self):
        cfg, p = _port_moe(11, capacity_factor=1.0)
        xr, m_solo, xp, m_pad = self._padded_pair(cfg, real=20, pad=6, seed=0)
        out_solo, aux_solo = moe.apply_moe_train(cfg, p, xr, seq_chunk=8, mask=m_solo)
        out_pad, aux_pad = moe.apply_moe_train(cfg, p, xp, seq_chunk=8, mask=m_pad)
        np.testing.assert_allclose(out_pad[:, 6:].numpy(), out_solo.numpy(),
                                   rtol=2e-5, atol=1e-6)
        np.testing.assert_allclose(float(aux_pad), float(aux_solo), rtol=1e-5)
        np.testing.assert_array_equal(out_pad[:, :6].numpy(), 0.0)

    def test_pad_crossing_chunk_boundary(self):
        cfg, p = _port_moe(11, capacity_factor=1.0)
        xr, m_solo, xp, m_pad = self._padded_pair(cfg, real=10, pad=7, seed=4)
        out_solo, _ = moe.apply_moe_train(cfg, p, xr, seq_chunk=8, mask=m_solo)
        out_pad, _ = moe.apply_moe_train(cfg, p, xp, seq_chunk=8, mask=m_pad)
        np.testing.assert_allclose(out_pad[:, 7:].numpy(), out_solo.numpy(),
                                   rtol=2e-5, atol=1e-6)


class TestDecodeNoDrop:
    """Decode capacity drops no real token (reference: TestMoEDecodeNoDrop)."""

    def _setup(self):
        cfg, p = _port_moe(21, n_experts=8, top_k=1, capacity_factor=1.0)
        x = _t(22, 1, cfg.d_model).expand(16, -1)[:, None, :].contiguous()
        return cfg, p, x

    def test_old_accounting_drops_new_does_not(self, monkeypatch):
        cfg, p, x = self._setup()
        gate_idx = torch.topk(moe._router_probs(p, x.reshape(-1, cfg.d_model)),
                              cfg.top_k)[1]
        assert len(set(gate_idx[:, 0].tolist())) == 1      # one hot expert
        cap_old = moe._capacity(x.shape[0], cfg, 4.0)
        assert x.shape[0] - cap_old > 0
        monkeypatch.setattr(moe, "DECODE_DROP_LOG", [])
        out = moe.apply_moe_decode(cfg, p, x)
        solo = moe.apply_moe_decode(cfg, p, x[:1])
        assert moe.DECODE_DROP_LOG == [0, 0]
        for i in (0, cap_old, x.shape[0] - 1):
            np.testing.assert_allclose(out[i].numpy(), solo[0].numpy(),
                                       rtol=1e-6, atol=1e-6)
        assert float(out.abs().sum()) > 0.0

    def test_chunk_boundaries_do_not_change_results(self):
        cfg, p, _ = self._setup()
        x = _t(23, 7, 1, cfg.d_model)
        np.testing.assert_allclose(moe.apply_moe_decode(cfg, p, x, chunk=2).numpy(),
                                   moe.apply_moe_decode(cfg, p, x, chunk=64).numpy(),
                                   rtol=1e-6, atol=1e-6)

    def test_large_decode_batch_no_drops_logged(self, monkeypatch):
        cfg, p, _ = self._setup()
        x = _t(24, moe.DECODE_CHUNK + 40, 1, cfg.d_model)
        monkeypatch.setattr(moe, "DECODE_DROP_LOG", [])
        moe.apply_moe_decode(cfg, p, x)
        assert len(moe.DECODE_DROP_LOG) >= 1 and sum(moe.DECODE_DROP_LOG) == 0


@settings(max_examples=25, deadline=None, derandomize=True)
@given(t=st.integers(1, 40), cf=st.sampled_from([0.1, 0.5, 1.0, 1.25, 2.0]),
       seed=st.integers(0, 2**16), pad_frac=st.floats(0.0, 0.9))
def test_kept_assignments_follow_the_position_rule(t, cf, seed, pad_frac):
    """Kept (token, slot) pairs are the numpy rule's: exclusive count in
    token-major, slot-minor order below the valid-count capacity."""
    cfg, p = _port_moe(5)
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((t, cfg.d_model)).astype(np.float32))
    valid = rng.uniform(size=t) >= pad_frac
    gate_idx = torch.topk(moe._router_probs(p, x), cfg.top_k)[1].numpy()
    n = int(valid.sum())
    cap = min(moe._capacity(t, cfg, cf),
              max(cfg.top_k, min(int(np.ceil(np.float32(cf) * np.float32(n)
                                             * cfg.top_k / cfg.n_experts)), n)))
    kept = _kept(gate_idx, cfg.n_experts, cap, valid)
    _, _, dropped = moe._dispatch_combine(cfg, p, x, capacity_factor=cf,
                                          valid=torch.from_numpy(valid), return_drops=True)
    assert int(dropped) == int((~kept & valid[:, None]).sum())


# ---------------------------------------------------------------------------
# The MoE member's masked prefill (reference: TestCrossMixerInvariance)
# ---------------------------------------------------------------------------

VOCAB = 64


@pytest.fixture(scope="module")
def moe_lm():
    cfg = get_smoke_config(NAME)
    return cfg, lm.init_lm(torch.Generator().manual_seed(0), cfg)


def _gen(cfg, params, prompts, max_new=4):
    return lm.greedy_generate(cfg, params, pad_prompts(prompts, cfg), max_new,
                              attn_mask=prompt_pad_mask(prompts, cfg)).numpy()


def test_lm_batch_composition_invariance(moe_lm):
    cfg, params = moe_lm
    rng = np.random.default_rng(0)
    p_short, p_long, p_other = (rng.integers(0, VOCAB, size=n).astype(np.int32)
                                for n in (5, 17, 11))
    alone = _gen(cfg, params, [p_short])
    with_long = _gen(cfg, params, [p_short, p_long])
    with_two = _gen(cfg, params, [p_short, p_other, p_long])
    np.testing.assert_array_equal(alone[0], with_long[0])
    np.testing.assert_array_equal(alone[0], with_two[0])
    np.testing.assert_array_equal(with_long[1], with_two[2])


def test_lm_pad_count_invariance(moe_lm):
    cfg, params = moe_lm
    prompt = np.random.default_rng(3).integers(0, VOCAB, size=7).astype(np.int32)
    ref = _gen(cfg, params, [prompt])[0]
    for pad in (4, 9):
        toks = torch.from_numpy(np.pad(prompt, (pad, 0))[None])
        mask = torch.from_numpy((np.arange(pad + len(prompt)) >= pad)[None])
        out = lm.greedy_generate(cfg, params, toks, 4, attn_mask=mask).numpy()
        np.testing.assert_array_equal(out[0], ref)


def test_lm_masked_prefill_matches_unpadded_logits(moe_lm):
    cfg, params = moe_lm
    prompt = np.random.default_rng(1).integers(0, VOCAB, size=7).astype(np.int32)
    pad = 6
    padded = torch.from_numpy(np.pad(prompt, (pad, 0))[None])
    mask = torch.from_numpy((np.arange(pad + len(prompt)) >= pad)[None])
    with torch.inference_mode():
        ref, _ = lm.apply_lm_prefill(cfg, params, torch.from_numpy(prompt[None]),
                                     lm.init_caches(cfg, 1, 11, "cpu"))
        out, _ = lm.apply_lm_prefill(cfg, params, padded,
                                     lm.init_caches(cfg, 1, 17, "cpu"), attn_mask=mask)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=2e-4, atol=2e-5)
