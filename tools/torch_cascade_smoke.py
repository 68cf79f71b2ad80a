"""Cascade smoke on the PyTorch port: one seeded escalate -> stop trace in
under 5 seconds.

Exercises the real pieces end to end — deep-ensemble quality head
(``attn-ens``, bootstrap-trained), exact ``reg`` cost head, cost ladder,
:class:`CascadePolicy`, :class:`CascadeCoordinator`, and the micro-batching
scheduler's multi-leg lifecycle — against a stub pool (no LM generation):

  * EASY queries: the cheap member's answer is observed good -> stop at
    leg 1 (paying for the strong member there would be waste);
  * HARD queries: the cheap answer is observed inadequate and the
    ensemble predicts a strong upside -> escalate up the ladder, deliver
    the best answer, charge the SUM of leg costs.

The trace runs twice and must replay bit-identically (determinism).

    PYTHONPATH=src python tools/torch_cascade_smoke.py [--device cpu]

The port of ``tools/cascade_smoke.py``, on the CUDA card unless
``--device`` names another device (with no card and no ``--device`` it
raises). The ensemble head is trained here from a torch generator seeded
as the reference seeds its JAX key; the checks are the reference's. The
device is initialised before the clock starts.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch.cascade import (
    CascadeConfig,
    CascadeCoordinator,
    CascadePolicy,
    cost_ladder,
)
from repro_torch.common.device import resolve_device
from repro_torch.configs import get_smoke_config
from repro_torch.core.predictors import PREDICTORS
from repro_torch.core.router import PredictiveRouter
from repro_torch.serving.engine import RoutedEngine
from repro_torch.serving.queue import Request
from repro_torch.serving.scheduler import MicroBatchScheduler, SchedulerConfig
from repro_torch.training import AdamConfig, adam_init, make_ensemble_predictor_step

DQ, SEED, LAM = 32, 0, 8.0
COST = np.array([0.2, 1.0, 3.0])          # member $ rates (the ladder)
QUAL_EASY = np.array([0.90, 0.92, 0.95])  # cheap is adequate
QUAL_HARD = np.array([0.15, 0.55, 0.92])  # only the strong rung delivers
N_REQ = 48


class StubMember:
    """A member that generates zeros. ``cfg`` gives the engine its padding
    rule (plain attention: the batch is as wide as its longest prompt)."""

    cfg = get_smoke_config("qwen3-0.6b")

    def __init__(self, name, cost_rate):
        self.name, self.cost_rate = name, cost_rate

    def generate(self, prompts, max_new=8, attn_mask=None):
        return torch.zeros((prompts.shape[0], max_new), dtype=torch.int32)


def region_emb(rng, n, sign):
    mu = np.zeros(DQ, np.float32)
    mu[: DQ // 2] = 0.8 * sign
    e = rng.normal(0, 0.3, size=(n, DQ)).astype(np.float32) + mu
    return e / np.linalg.norm(e, axis=1, keepdims=True)


def build_engine(rng, device):
    """attn-ens quality head bootstrap-trained on both regions; exact reg
    cost head (constant member rates -> zero-weight head with rate bias)."""
    emb = np.concatenate([region_emb(rng, 128, +1.0),
                          region_emb(rng, 128, -1.0)])
    labels = np.concatenate([
        np.tile(QUAL_EASY, (128, 1)), np.tile(QUAL_HARD, (128, 1)),
    ]).astype(np.float32)
    labels += rng.normal(0, 0.03, labels.shape).astype(np.float32)
    # Distinct member embeddings: with near-identical rows the attention
    # context degenerates to a constant in q and the head cannot express
    # region-dependent quality at all.
    memb = rng.random((3, 4)).astype(np.float32)

    opt = AdamConfig(lr=5e-3)
    step = make_ensemble_predictor_step("attn-ens", opt)
    gen = torch.Generator(device=device).manual_seed(SEED)
    qp = PREDICTORS["attn-ens"].init(gen, DQ, 3, memb.shape[1])
    state = adam_init(opt, qp)
    boot = rng.poisson(1.0, size=(256, qp["bo"].shape[0])).astype(np.float32)
    q, m, t, w = (torch.as_tensor(a, device=device) for a in (emb, memb, labels, boot))
    for _ in range(200):
        _, qp, state = step(qp, state, q, m, t, w)

    # Exact cost path: a zero reg head + scaler mu = member rates means
    # denormalize_cost returns the rates verbatim (and the scaler is what
    # cost_ladder derives the escalation order from).
    cp = {"w": torch.zeros((DQ, 3), dtype=torch.float32, device=device),
          "b": torch.zeros(3, dtype=torch.float32, device=device)}
    router = PredictiveRouter(
        "attn-ens", "reg", qp, cp, memb, reward="R2",
        cost_scaler={"mu": np.asarray(COST, np.float64),
                     "sd": np.ones(3, np.float64)})
    pool = [StubMember(n, c) for n, c in
            zip(("cheap", "mid", "strong"), COST)]
    return RoutedEngine(router=router, pool=pool, lam=LAM, device=device)


def run_trace(device):
    rng = np.random.default_rng(SEED)
    engine = build_engine(rng, device)
    easy = region_emb(rng, N_REQ // 2, +1.0)
    hard = region_emb(rng, N_REQ // 2, -1.0)
    truth = {}

    # Requests alternate easy/hard; per-request truth keyed by text.
    ladder = cost_ladder(engine.router)
    reqs, embs = [], []
    for i in range(N_REQ):
        is_hard = i % 2 == 1
        e = hard[i // 2] if is_hard else easy[i // 2]
        text = f"{'hard' if is_hard else 'easy'}-{i}"
        truth[text] = QUAL_HARD if is_hard else QUAL_EASY
        r = Request(text=text, prompt=np.zeros(2, np.int32),
                    max_new=2, arrival_s=i * 1e-3)
        # Canonical cascade: every request starts at the cheapest rung and
        # buys stronger opinions only when the answer in hand is weak.
        r.forced_member = int(ladder[0])
        r.forced_member_name = engine.pool[int(ladder[0])].name
        reqs.append(r)
        embs.append(e)
    emb_of = {r.text: e for r, e in zip(reqs, embs)}
    engine.embed = lambda texts: np.stack([emb_of[t] for t in texts])

    coordinator = CascadeCoordinator(
        CascadePolicy(ladder, CascadeConfig(max_legs=3, beta=1.0)),
        observed_quality=lambda r: float(truth[r.text][r.member]))
    sched = MicroBatchScheduler(
        engine, SchedulerConfig(score_batch=16, max_batch=16),
        cascade=coordinator, service_time=lambda kind, n, wall: 1e-3)
    summary = sched.run_trace(reqs)
    return summary, coordinator, reqs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    device = resolve_device(ap.parse_args(argv).device)
    torch.zeros(1, device=device)          # the device's context, off the clock

    t0 = time.perf_counter()
    s1, coord1, reqs1 = run_trace(device)
    wall = time.perf_counter() - t0
    s2, coord2, _ = run_trace(device)

    easy_reqs = [r for r in reqs1 if r.text.startswith("easy")]
    hard_reqs = [r for r in reqs1 if r.text.startswith("hard")]
    easy_one_leg = np.mean([r.leg == 1 for r in easy_reqs])
    hard_escalated = np.mean([r.leg > 1 for r in hard_reqs])
    cum_ok = all(abs(r.cum_cost - sum(r.leg_costs)) < 1e-12 for r in reqs1)
    hard_quality = np.mean([r.best_q for r in hard_reqs])

    checks = {
        "all requests finalized exactly once":
            s1["completed"] == N_REQ
            and s1["double_finalize_blocked"] == 0,
        "easy queries stop at leg 1": easy_one_leg >= 0.9,
        "hard queries escalate": hard_escalated >= 0.9,
        "escalation delivered the strong answer": hard_quality > 0.8,
        "cumulative cost = sum of leg costs": cum_ok,
        "escalations counted": s1["escalations"] == coord1.stats[
            "escalations"] > 0,
        "deterministic replay": (
            s1["escalations"] == s2["escalations"]
            and s1["finalized_by_leg"] == s2["finalized_by_leg"]
            and coord1.stats == coord2.stats),
        "trace under 5s": wall < 5.0,
    }
    for name, ok in checks.items():
        print(f"  [{'ok' if ok else 'FAIL'}] {name}")
    print(coord1.report())
    print(f"finalized by leg {s1['finalized_by_leg']}  "
          f"easy one-leg {easy_one_leg:.2f}  hard escalated "
          f"{hard_escalated:.2f}  hard best-q {hard_quality:.2f}  "
          f"wall {wall:.2f}s on {device}")
    ok = all(checks.values())
    print(f"cascade smoke: {'OK' if ok else 'FAIL'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
