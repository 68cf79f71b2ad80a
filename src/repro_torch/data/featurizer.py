"""Prompt embedding frontend (DistilBERT stand-in), numpy only.

A copy of ``repro.data.featurizer`` that gives bit-identical embeddings:

  1. extract character 3..5-grams,
  2. hash each n-gram to one of ``N_BUCKETS`` (blake2s, stable across runs),
  3. log1p bucket counts -> a fixed seeded Gaussian random projection to
     768-d (``np.random.default_rng(1234567)``),
  4. L2 normalize (the paper normalizes too).
"""
from __future__ import annotations

import functools
import hashlib
from typing import List, Sequence

import numpy as np

EMB_DIM = 768
N_BUCKETS = 4096
_PROJ_SEED = 1234567


def _ngrams(text: str, lo: int = 3, hi: int = 5) -> List[str]:
    t = f"^{text.lower()}$"
    out = []
    for n in range(lo, hi + 1):
        out.extend(t[i : i + n] for i in range(max(0, len(t) - n + 1)))
    return out


def _bucket(ngram: str) -> int:
    h = hashlib.blake2s(ngram.encode("utf-8"), digest_size=4).digest()
    return int.from_bytes(h, "little") % N_BUCKETS


@functools.cache
def _projection() -> np.ndarray:
    rng = np.random.default_rng(_PROJ_SEED)
    return rng.standard_normal((N_BUCKETS, EMB_DIM)).astype(
        np.float32
    ) / np.sqrt(EMB_DIM)


def embed_text(text: str) -> np.ndarray:
    """One prompt -> (768,) unit-norm embedding. Deterministic.

    float64: the projection divides float32 by a numpy float64 scalar,
    which numpy 2 promotes, exactly as the reference does.
    """
    counts = np.zeros((N_BUCKETS,), dtype=np.float32)
    for g in _ngrams(text):
        counts[_bucket(g)] += 1.0
    if counts.sum() > 0:
        counts = np.log1p(counts)
    v = counts @ _projection()
    n = np.linalg.norm(v)
    return v / n if n > 0 else v


def embed_texts(texts: Sequence[str]) -> np.ndarray:
    return np.stack([embed_text(t) for t in texts])
