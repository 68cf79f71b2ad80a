"""Online-adaptation smoke on the PyTorch port: one seeded drift -> adapt
-> recover cycle.

Runs the full online loop (exploration choose, replay, drift alarm, burst
update, atomic router swap, detector recovery) against a stub pool and
synthetic embeddings — no LM generation, and the cost predictor is an
exact hand-built ``reg`` head (costs are constant per member), so the
whole cycle lands under the 5-second budget. The cycle runs twice and
must replay bit-identically (determinism).

    PYTHONPATH=src python tools/torch_online_smoke.py [--device cpu]

The port of ``tools/online_smoke.py``, on the CUDA card unless
``--device`` names another device (with no card and no ``--device`` it
raises): scoring launches the ``router_xattn`` kernel and the drift
detector ``pairwise_l2`` there. The router's quality head is trained here
from a torch generator seeded as the reference seeds its JAX key, so its
numbers are the port's own; the checks are the reference's. The device
is initialised before the clock starts: the 5 seconds are the cycle's.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch.common.device import resolve_device
from repro_torch.core.predictors import PREDICTORS
from repro_torch.core.router import PredictiveRouter
from repro_torch.online import (
    DriftDetector,
    ExplorationConfig,
    OnlineAdapter,
    OnlineUpdateConfig,
)
from repro_torch.serving.engine import RoutedEngine
from repro_torch.serving.queue import DONE, Request
from repro_torch.training import AdamConfig, adam_init, make_predictor_step

DQ, SEED, LAM = 32, 0, 2.0
COST = np.array([0.2, 1.0])        # member $ rates
# Offline world: the pricey member earns its premium everywhere
# (R2: 0.85*exp(-0.5) = 0.52 > 0.45*exp(-0.1) = 0.41). Post-drift, region
# B's true pool strengths are reversed — the frozen beliefs misroute.
QUAL_A = np.array([0.45, 0.85])    # offline labels (both regions)
QUAL_B = np.array([0.80, 0.35])    # post-drift truth on region B
BATCH, N_A, N_B, N_RECOVER = 16, 6, 18, 6


class StubMember:
    def __init__(self, name, cost_rate):
        self.name, self.cost_rate = name, cost_rate


def region_emb(rng, n, sign):
    mu = np.zeros(DQ, np.float32)
    mu[: DQ // 2] = 0.8 * sign
    e = rng.normal(0, 0.4, size=(n, DQ)).astype(np.float32) + mu
    return e / np.linalg.norm(e, axis=1, keepdims=True)


def build_engine(rng, device):
    """Attn quality head trained on pre-drift labels; exact reg cost head.

    The offline corpus covers BOTH regions with pre-drift labels; the
    drift detector's reference is the region-A sample only (the pre-drift
    serving distribution, as a deployment would fit it).
    """
    emb = np.concatenate([region_emb(rng, 192, +1.0),
                          region_emb(rng, 64, -1.0)])
    quality = (np.tile(QUAL_A, (256, 1))
               + rng.normal(0, 0.05, (256, 2))).astype(np.float32)
    memb = np.stack([np.full(4, q) for q in QUAL_A]).astype(np.float32)

    opt = AdamConfig(lr=3e-3)
    step = make_predictor_step("attn", opt)
    gen = torch.Generator(device=device).manual_seed(SEED)
    qp = PREDICTORS["attn"].init(gen, DQ, 2, memb.shape[1])
    state = adam_init(opt, qp)
    q, m, t = (torch.as_tensor(a, device=device) for a in (emb, memb, quality))
    for _ in range(30):
        _, qp, state = step(qp, state, q, m, t)

    # Costs are constant per member: a zero-weight reg head with the rates
    # as bias predicts them exactly (nothing to train).
    cp = {"w": torch.zeros((DQ, 2), dtype=torch.float32, device=device),
          "b": torch.as_tensor(COST, dtype=torch.float32, device=device)}
    router = PredictiveRouter("attn", "reg", qp, cp, memb, reward="R2",
                              cost_scaler=None, centroids=emb[:4].copy())
    pool = [StubMember("cheap", COST[0]), StubMember("pricey", COST[1])]
    return RoutedEngine(router=router, pool=pool, lam=LAM, device=device), emb[:192]


def run_cycle(device):
    rng = np.random.default_rng(SEED)
    engine, ref_emb = build_engine(rng, device)
    truth = {}   # request id -> true quality row

    def feedback(req):
        return float(truth[req.rid][req.member])

    adapter = OnlineAdapter(
        engine, feedback,
        config=OnlineUpdateConfig(update_every=32, steps_per_update=8,
                                  burst_steps=32, batch_size=32,
                                  min_buffer=16),
        exploration=ExplorationConfig(epsilon=0.1, seed=SEED),
        drift=DriftDetector(window=32, threshold=3.0, seed=SEED,
                            device=device).fit(ref_emb, engine.router.centroids),
        seed=SEED,
    )

    phases = ["A"] * N_A + ["B"] * (N_B + N_RECOVER)
    mix, alarms_at = [], []
    now = 0.0
    for bi, phase in enumerate(phases):
        emb = region_emb(rng, BATCH, +1.0 if phase == "A" else -1.0)
        qual = QUAL_A if phase == "A" else QUAL_B
        s_hat, c_hat = engine.score_emb(emb)
        choices = adapter.choose(s_hat, c_hat, engine.lam, now)
        reqs = []
        for e, m in zip(emb, choices):
            r = Request(text="", prompt=np.zeros(1, np.int32))
            r.q_emb, r.member, r.status = e, int(m), DONE
            r.cost = float(COST[int(m)])
            truth[r.rid] = qual
            reqs.append(r)
        alarms_before = adapter.stats["drift_alarms"]
        adapter.observe(reqs, now)
        if adapter.stats["drift_alarms"] > alarms_before:
            alarms_at.append(bi)
        mix.append(float(np.mean(choices == 0)))   # fraction to cheap
        now += 0.1
    return adapter, mix, alarms_at


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    device = resolve_device(ap.parse_args(argv).device)
    torch.zeros(1, device=device)          # the device's context, off the clock

    t0 = time.perf_counter()
    ad1, mix1, alarms1 = run_cycle(device)
    cycle1_wall = time.perf_counter() - t0
    ad2, mix2, alarms2 = run_cycle(device)

    s = ad1.stats
    pre_b = np.mean(mix1[N_A: N_A + 2])                    # drift onset
    post_b = np.mean(mix1[-N_RECOVER:])                    # after adaptation
    recovered = (not alarms1
                 or max(alarms1) < len(mix1) - N_RECOVER)  # alarms stopped
    checks = {
        "drift alarm fired": s["drift_alarms"] >= 1,
        "burst update ran": s["bursts"] >= 1,
        "router republished": ad1.engine.router.version >= 2,
        "routing flipped to cheap on B": post_b > 0.8 >= 0.5 > pre_b,
        "detector recovered (alarms stopped)": recovered,
        "deterministic replay": (mix1 == mix2 and alarms1 == alarms2
                                 and ad1.stats == ad2.stats),
        "cycle under 5s": cycle1_wall < 5.0,
    }
    for name, ok in checks.items():
        print(f"  [{'ok' if ok else 'FAIL'}] {name}")
    print(ad1.report())
    print(f"cheap-member share: pre-drift-adapt {pre_b:.2f} -> "
          f"post {post_b:.2f}; alarms at batches {alarms1}; "
          f"cycle wall {cycle1_wall:.2f}s on {device}")
    ok = all(checks.values())
    print(f"online smoke: {'OK' if ok else 'FAIL'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
