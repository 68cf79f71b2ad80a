"""Scenario-diverse open-loop traffic simulator.

The port's own copy of ``repro.serving.traffic`` (numpy only): the same
config gives the same trace, bit for bit.

Builds request traces on top of the synthetic RouterBench generator
(:func:`repro_torch.data.routerbench.generate`): arrival processes model
*when* queries land, the RouterBench texts model *what* they ask.
Scenarios:

  poisson   memoryless arrivals at a constant mean rate — the steady-state
            baseline every serving paper starts from;
  bursty    ON-OFF modulated Poisson (exponential ON/OFF holding times,
            ON rate = burst_factor * base rate) — flash crowds that stress
            admission control and the budget governor;
  drift     Poisson arrivals whose *content* shifts over the trace from one
            benchmark mixture to another (e.g. commonsense -> math+code) —
            domain shift that moves the router's quality estimates.
  neardup   Poisson arrivals where most queries repeat a small hot set of
            texts (Zipf-weighted) — the millions-of-users regime where
            near-duplicate queries make a semantic answer cache pay.

Prompt lengths are heavy-tailed (Pareto, truncated) — the long-prompt tail
is what makes naive fixed-batch serving stall, and what micro-batching is
for. All randomness flows from one ``numpy`` Generator seeded by the trace
config, so identical configs give identical traces.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.serving.queue import Request

TRACE_KINDS = ("poisson", "bursty", "drift", "neardup")


@dataclasses.dataclass
class TraceConfig:
    kind: str = "poisson"
    n_requests: int = 200
    rate: float = 200.0            # mean arrivals per (virtual) second
    seed: int = 0
    # bursty (ON-OFF) shape
    burst_factor: float = 8.0      # ON-phase rate multiplier
    on_mean_s: float = 0.25        # mean ON holding time
    off_mean_s: float = 0.75       # mean OFF holding time
    # heavy-tail prompt lengths
    prompt_len_min: int = 8
    prompt_len_max: int = 96
    pareto_alpha: float = 1.3
    # neardup (hot-set repetition) shape
    hot_set: int = 32              # number of hot texts arrivals repeat
    dup_frac: float = 0.7          # P(arrival repeats a hot text)
    # request shape
    max_new: int = 4
    deadline_s: Optional[float] = None  # relative to arrival; None = none
    vocab: int = 256


def _arrival_times(cfg: TraceConfig, rng: np.random.Generator) -> np.ndarray:
    n = cfg.n_requests
    if cfg.kind in ("poisson", "drift", "neardup"):
        return np.cumsum(rng.exponential(1.0 / cfg.rate, size=n))
    if cfg.kind == "bursty":
        times, t, on = [], 0.0, True
        on_rate = cfg.rate * cfg.burst_factor
        while len(times) < n:
            hold = rng.exponential(cfg.on_mean_s if on else cfg.off_mean_s)
            if on:
                tt = t + np.cumsum(rng.exponential(
                    1.0 / on_rate, size=max(int(on_rate * hold * 2), 8)))
                times.extend(tt[tt < t + hold].tolist())
            t += hold
            on = not on
        return np.asarray(times[:n])
    raise ValueError(f"unknown trace kind {cfg.kind!r}; "
                     f"choose from {TRACE_KINDS}")


def _prompt_lengths(cfg: TraceConfig, rng: np.random.Generator) -> np.ndarray:
    tail = rng.pareto(cfg.pareto_alpha, size=cfg.n_requests) + 1.0
    lens = (cfg.prompt_len_min * tail).astype(np.int64)
    return np.clip(lens, cfg.prompt_len_min, cfg.prompt_len_max)


def _drift_order(benchmarks: Sequence[str],
                 rng: np.random.Generator, n: int) -> np.ndarray:
    """Sample indices whose benchmark mixture drifts across the trace.

    Early requests are drawn mostly from the first half of the benchmark
    alphabet, late requests mostly from the second half, with a linear
    crossfade — a controlled distribution shift, not a hard switch.
    """
    benchmarks = np.asarray(benchmarks)
    names = sorted(set(benchmarks.tolist()))
    group_b = np.isin(benchmarks, names[len(names) // 2:])
    idx_a, idx_b = np.flatnonzero(~group_b), np.flatnonzero(group_b)
    if len(idx_a) == 0 or len(idx_b) == 0:   # degenerate: one benchmark
        return rng.integers(0, len(benchmarks), size=n)
    out = np.empty(n, np.int64)
    for i in range(n):
        p_b = 0.1 + 0.8 * (i / max(n - 1, 1))    # 10% -> 90% group B
        src = idx_b if rng.random() < p_b else idx_a
        out[i] = src[rng.integers(len(src))]
    return out


def _neardup_picks(cfg: TraceConfig, rng: np.random.Generator,
                   n_texts: int) -> np.ndarray:
    """Hot-set repetition: with probability ``dup_frac`` an arrival repeats
    one of ``hot_set`` hot texts (Zipf-weighted, so a few queries dominate
    — the shape real duplicate traffic has), else samples uniformly."""
    hot = rng.choice(n_texts, size=min(cfg.hot_set, n_texts), replace=False)
    w = 1.0 / np.arange(1, len(hot) + 1)          # Zipf s=1 over the hot set
    w /= w.sum()
    out = np.empty(cfg.n_requests, np.int64)
    for i in range(cfg.n_requests):
        if rng.random() < cfg.dup_frac:
            out[i] = hot[rng.choice(len(hot), p=w)]
        else:
            out[i] = rng.integers(n_texts)
    return out


def make_trace(cfg: TraceConfig, texts: Sequence[str],
               benchmarks: Optional[Sequence[str]] = None) -> List[Request]:
    """Build an open-loop request trace over the given prompt corpus.

    ``texts`` is the corpus to sample from (typically the held-out split of
    the synthetic RouterBench data); ``benchmarks`` (aligned with texts) is
    required for the drift scenario.
    """
    rng = np.random.default_rng(cfg.seed)
    arrivals = _arrival_times(cfg, rng)
    lens = _prompt_lengths(cfg, rng)
    if cfg.kind == "drift":
        if benchmarks is None:
            raise ValueError("drift trace needs per-text benchmark labels")
        picks = _drift_order(benchmarks, rng, cfg.n_requests)
    elif cfg.kind == "neardup":
        picks = _neardup_picks(cfg, rng, len(texts))
    else:
        picks = rng.integers(0, len(texts), size=cfg.n_requests)
    reqs = []
    for i in range(cfg.n_requests):
        t = float(arrivals[i])
        reqs.append(Request(
            text=texts[int(picks[i])],
            prompt=rng.integers(0, cfg.vocab, size=int(lens[i])).astype(
                np.int32),
            max_new=cfg.max_new,
            arrival_s=t,
            deadline_s=None if cfg.deadline_s is None else t + cfg.deadline_s,
        ))
    return reqs
