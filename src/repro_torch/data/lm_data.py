"""Synthetic LM token pipeline for LM training, numpy only.

The port's own copy of ``repro.data.lm_data``: for the same vocabulary and
seeds, :class:`MarkovCorpus` streams bit-identical batches.

A seeded order-1 Markov chain over the vocabulary with a low-entropy
transition structure: real learning signal (loss drops well below uniform)
without any external corpus. Order 1 keeps the context space (= vocab_size)
small enough that a few hundred small-batch steps see every context dozens
of times — an order-2 chain over a 4k vocab has 16.7M contexts and is
unlearnable at example scale. Batches stream deterministically.
"""
from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np


class MarkovCorpus:
    def __init__(self, vocab_size: int, *, seed: int = 0, branching: int = 4):
        self.vocab_size = vocab_size
        rng = np.random.default_rng(seed)
        # Each prev-token context prefers `branching` successor tokens.
        self._ctx_seed = int(rng.integers(1 << 31))
        self.branching = branching

    def _successors(self, a: int, b: int) -> np.ndarray:
        h = (b * 9176 + self._ctx_seed) % (1 << 31)
        rng = np.random.default_rng(h)
        return rng.integers(0, self.vocab_size, size=self.branching)

    def sample(self, rng: np.random.Generator, length: int) -> np.ndarray:
        out = np.empty((length,), np.int32)
        a, b = rng.integers(self.vocab_size), rng.integers(self.vocab_size)
        for i in range(length):
            succ = self._successors(int(a), int(b))
            # 90% follow structure, 10% noise.
            if rng.random() < 0.9:
                nxt = succ[rng.integers(self.branching)]
            else:
                nxt = rng.integers(self.vocab_size)
            out[i] = nxt
            a, b = b, nxt
        return out

    def batches(
        self, batch: int, seq_len: int, *, seed: int = 0
    ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Yields (tokens, labels) of shape (batch, seq_len) forever."""
        rng = np.random.default_rng(seed)
        while True:
            seqs = np.stack([self.sample(rng, seq_len + 1) for _ in range(batch)])
            yield seqs[:, :-1], seqs[:, 1:]

    def padded_batches(
        self, batch: int, seq_len: int, *, min_len: int = None,
        seed: int = 0, pad_id: int = 0
    ) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """Variable-length batches, left-padded: (tokens, labels, mask).

        Per-row lengths are uniform over [min_len, seq_len] (min_len
        defaults to ``seq_len // 4``, floored at 2); rows are left-padded
        to the fixed ``seq_len`` so jitted train steps see one static
        shape — the same convention the serving engine's ``pad_prompts``
        uses for generate micro-batches. ``mask`` (batch, seq_len) bool is
        True at real positions; tokens/labels under pads are ``pad_id``
        and MUST be excluded through ``lm_loss(attn_mask=mask)`` (which
        also drives the MoE pad-aware capacity accounting). Streams
        deterministically under a fixed seed.
        """
        min_len = max(2, seq_len // 4) if min_len is None else min_len
        if not 1 <= min_len <= seq_len:
            raise ValueError(f"min_len {min_len} not in [1, {seq_len}]")
        rng = np.random.default_rng(seed)
        while True:
            toks = np.full((batch, seq_len), pad_id, np.int32)
            labs = np.full((batch, seq_len), pad_id, np.int32)
            mask = np.zeros((batch, seq_len), bool)
            lens = rng.integers(min_len, seq_len + 1, size=batch)
            for i, length in enumerate(lens):
                seq = self.sample(rng, int(length) + 1)
                toks[i, seq_len - length:] = seq[:-1]
                labs[i, seq_len - length:] = seq[1:]
                mask[i, seq_len - length:] = True
            yield toks, labs, mask
