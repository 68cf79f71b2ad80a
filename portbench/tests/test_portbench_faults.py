"""A run with the timed path broken underneath comes out not correct:
the harness's look for a card is skipped and everything else runs as in
a cell's run, at smoke size on the CPU."""
import numpy as np
import pytest
import torch

from portbench import serving, training
from portbench.tests.smoke import smoke_cell

SEED = 4_000_000_007


def test_a_token_altered_where_it_is_produced(monkeypatch):
    from repro_torch.models import lm as lm_mod
    real = lm_mod.greedy_generate

    def altered(cfg, *args, **kwargs):
        out = real(cfg, *args, **kwargs).clone()
        out[:, -1] = (out[:, -1] + 1) % cfg.vocab_size
        return out

    monkeypatch.setattr(lm_mod, "greedy_generate", altered)
    out = serving.run(smoke_cell("pool3.steady"), SEED, 1.0, False, device="cpu", smoke=True)
    assert not out["correct"]
    assert out["checks"]["token_gap"]["value"] > out["checks"]["token_gap"]["limit"]


def test_a_logit_altered_where_it_is_produced(monkeypatch):
    """Logits scaled by 1% keep every served token (the argmax) and move
    the program's logits: ``logit_gap`` fails where ``token_gap`` holds."""
    from repro_torch.models import lm as lm_mod
    real = lm_mod.apply_lm_decode

    def scaled(cfg, *args, **kwargs):
        logits, caches = real(cfg, *args, **kwargs)
        return logits * 1.01, caches

    monkeypatch.setattr(lm_mod, "apply_lm_decode", scaled)
    out = serving.run(smoke_cell("pool3.backlog"), SEED, 1.0, False, device="cpu", smoke=True)
    assert not out["correct"]
    assert out["checks"]["logit_gap"]["value"] > out["checks"]["logit_gap"]["limit"]
    assert out["checks"]["token_gap"]["value"] <= out["checks"]["token_gap"]["limit"]


def test_a_routing_score_altered_where_it_is_produced(monkeypatch):
    from repro_torch.serving.engine import RoutedEngine
    real = RoutedEngine._scores

    def altered(self, q_emb):
        s, c = real(self, q_emb)
        return s + 0.01, c

    monkeypatch.setattr(RoutedEngine, "_scores", altered)
    out = serving.run(smoke_cell("pool3.backlog"), SEED, 1.0, False, device="cpu", smoke=True)
    assert not out["correct"]
    assert out["checks"]["route_s_gap"]["value"] > out["checks"]["route_s_gap"]["limit"]


def test_a_step_that_returns_its_state_unchanged(monkeypatch):
    from repro_torch.launch import steps
    monkeypatch.setattr(steps, "adam_update", lambda cfg, g, state, params, donate=False:
                        (params, state))
    out = training.run(smoke_cell("granite-moe-1b-a400m.train"), SEED, 0.5, False,
                       device="cpu", smoke=True)
    assert not out["correct"]
    assert out["checks"]["update_gap"]["value"] == pytest.approx(1.0)


def test_half_the_batch_left_out(monkeypatch):
    from repro_torch.launch import steps
    real = steps._loss

    def half(cfg, params, batch):
        n = batch["tokens"].shape[0] // 2
        return real(cfg, params, {k: v[:n] for k, v in batch.items()})

    monkeypatch.setattr(steps, "_loss", half)
    out = training.run(smoke_cell("granite-moe-1b-a400m.train"), SEED, 0.5, False,
                       device="cpu", smoke=True)
    assert not out["correct"]
    assert out["checks"]["loss_gap"]["value"] > out["checks"]["loss_gap"]["limit"]


def test_sound_runs_are_correct_on_the_same_seed():
    out = training.run(smoke_cell("granite-moe-1b-a400m.train"), SEED, 0.5, False,
                       device="cpu", smoke=True)
    assert out["correct"], out["checks"]
    assert np.isfinite([c["value"] for c in out["checks"].values()]).all()
    assert torch.get_num_threads() == 2
