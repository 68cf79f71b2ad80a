"""A thin wrapper around the port's ``RoutedEngine``: the scheduler calls
it in the engine's place, and it records a host span around each call
(while the profiler runs, also on the real-time clock the device trace is
stamped on), plus what the routing calls returned and the logits of the
served tokens, which the reference judges."""
from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional, Sequence

import numpy as np


class SpanLog:
    """Host spans on ``time.perf_counter`` relative to ``t0``: dicts with
    ``name``, ``t0``, ``t1`` and the call's own fields; while ``traced``,
    also ``ns0`` and ``ns1`` from ``time.time_ns()``."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.spans: List[dict] = []
        self.traced = False

    @contextlib.contextmanager
    def span(self, name: str, **fields):
        rec = dict(name=name, traced=self.traced, **fields)
        if self.traced:
            rec["ns0"] = time.time_ns()
        rec["t0"] = time.perf_counter() - self.t0
        try:
            yield rec
        finally:
            rec["t1"] = time.perf_counter() - self.t0
            if self.traced:
                rec["ns1"] = time.time_ns()
            self.spans.append(rec)


class SpanEngine:
    """Delegates to ``engine``; ``embed``, ``score_emb``, ``score_texts``,
    ``choose`` and ``generate_member`` are timed. ``scored`` keeps each
    routing call's texts and (s_hat, c_hat), ``chosen`` each choice, and
    ``served`` maps each generated prompt (by ``id``) to the tap's steps
    of its call and its row there."""

    def __init__(self, engine, log: SpanLog, tap=None):
        self._engine = engine
        self.log = log
        self.tap = tap
        self.scored: List[tuple] = []
        self.chosen: List[tuple] = []
        self.served: Dict[int, tuple] = {}

    def __getattr__(self, name):
        return getattr(self._engine, name)

    def embed(self, texts: Sequence[str]) -> np.ndarray:
        with self.log.span("embed", n=len(texts)):
            return self._engine.embed(texts)

    def score_emb(self, q_emb: np.ndarray):
        with self.log.span("score_emb", n=len(q_emb)):
            return self._engine.score_emb(q_emb)

    def score_texts(self, texts: Sequence[str]):
        with self.log.span("score_texts", n=len(texts)):
            s_hat, c_hat = self._engine.score_texts(texts)
        self.scored.append((list(texts), np.asarray(s_hat), np.asarray(c_hat)))
        return s_hat, c_hat

    def choose(self, s_hat, c_hat, lam: Optional[float] = None):
        with self.log.span("choose", n=len(s_hat)):
            out = self._engine.choose(s_hat, c_hat, lam)
        self.chosen.append((self.lam if lam is None else lam, np.asarray(out)))
        return out

    def generate_member(self, member_idx: int, prompts: Sequence[np.ndarray],
                        max_new: int = 8, max_new_per_req: Optional[Sequence[int]] = None):
        name = self._engine.pool[member_idx].name
        with self.log.span("generate_member", member=name, n=len(prompts),
                           max_new=max_new) as rec:
            outs, costs = self._engine.generate_member(
                member_idx, prompts, max_new=max_new, max_new_per_req=max_new_per_req)
        caps = max_new_per_req if max_new_per_req is not None else [max_new] * len(prompts)
        rec["prompt_lens"] = [int(len(p)) for p in prompts]
        rec["delivered"] = [int(min(len(o), c)) for o, c in zip(outs, caps)]
        if self.tap is not None:
            steps = self.tap.steps
            self.served.update({id(p): (steps, row) for row, p in enumerate(prompts)})
        return outs, costs
