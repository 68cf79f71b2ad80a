"""Plain routing: the featurizer, the single-head cross-attention quality
and cost heads, and the R2 choice.

The featurizer is a frozen copy of the port's (character 3..5-grams
hashed with blake2s into 4096 buckets, log1p counts, a fixed seeded
Gaussian projection to 768, L2 normalised). The heads read the router's
parameters from the cell's router file (``routers/<config>.npz``, the
checkpoint layout, read here with numpy): ``wq`` (768, 20), ``wk`` and ``wv`` (20, 20) over
the members' model embeddings, ``wo`` (20, K) and ``bo`` (K,); the
logits are scaled by 1/sqrt(20). The cost head's output is denormalised
by the trainer's scaler and clamped at 0. R2 = s · exp(-c / λ), in
float32.
"""
from __future__ import annotations

import functools
import hashlib
import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from portbench.reference.model import mm

EMB_DIM = 768
N_BUCKETS = 4096
_PROJ_SEED = 1234567


def _ngrams(text: str, lo: int = 3, hi: int = 5):
    t = f"^{text.lower()}$"
    out = []
    for n in range(lo, hi + 1):
        out.extend(t[i:i + n] for i in range(max(0, len(t) - n + 1)))
    return out


def _bucket(ngram: str) -> int:
    h = hashlib.blake2s(ngram.encode("utf-8"), digest_size=4).digest()
    return int.from_bytes(h, "little") % N_BUCKETS


@functools.cache
def _projection() -> np.ndarray:
    rng = np.random.default_rng(_PROJ_SEED)
    return rng.standard_normal((N_BUCKETS, EMB_DIM)).astype(np.float32) / np.sqrt(EMB_DIM)


def embed(texts: Sequence[str]) -> np.ndarray:
    rows = []
    for text in texts:
        counts = np.zeros((N_BUCKETS,), dtype=np.float32)
        for g in _ngrams(text):
            counts[_bucket(g)] += 1.0
        if counts.sum() > 0:
            counts = np.log1p(counts)
        v = counts @ _projection()
        n = np.linalg.norm(v)
        rows.append(v / n if n > 0 else v)
    return np.stack(rows)


def load(path) -> Dict:
    """The router file's ``quality`` and ``cost`` heads, ``model_emb``
    and the cost ``scaler`` ({mu, sd} or None), as numpy arrays."""
    with np.load(path) as f:
        flat = {k: np.array(f[k]) for k in f.files}
    heads = {g: {k.split("/", 1)[1]: v for k, v in flat.items() if k.startswith(g + "/")}
             for g in ("quality", "cost")}
    scaler = None
    if "cost_scaler/mu" in flat:
        scaler = {"mu": flat["cost_scaler/mu"], "sd": flat["cost_scaler/sd"]}
    return {"quality": heads["quality"], "cost": heads["cost"], "model_emb": flat["model_emb"],
            "scaler": scaler}


def _tensors(p: Dict, device) -> Dict:
    return {k: torch.as_tensor(np.asarray(v, np.float32), device=device) for k, v in p.items()}


def head(p: Dict, q: torch.Tensor, m: torch.Tensor, prec: str) -> torch.Tensor:
    qp = mm(q, p["wq"], prec)
    kp = mm(m, p["wk"], prec)
    vp = mm(m, p["wv"], prec)
    alpha = torch.softmax(mm(qp, kp.T, prec) / math.sqrt(vp.shape[-1]), dim=-1)
    return mm(mm(alpha, vp, prec), p["wo"], prec) + p["bo"]


def scores(router: Dict, texts: Sequence[str], device, prec: str = "fp32"
           ) -> Tuple[np.ndarray, np.ndarray]:
    """(s, c) (B, K) for ``texts``. ``router`` holds ``quality``, ``cost``
    (parameter dicts), ``model_emb`` (K, 20) and ``scaler`` ({mu, sd} or
    None)."""
    q = torch.as_tensor(embed(texts).astype(np.float32), device=device)
    m = torch.as_tensor(np.asarray(router["model_emb"], np.float32), device=device)
    with torch.no_grad():
        s = head(_tensors(router["quality"], device), q, m, prec).cpu().numpy()
        c = head(_tensors(router["cost"], device), q, m, prec).cpu().numpy().astype(np.float64)
    sc: Optional[Dict] = router["scaler"]
    if sc is not None:
        c = c * sc["sd"] + sc["mu"]
    return s, np.maximum(c, 0.0)


def choose(s: np.ndarray, c: np.ndarray, lam: float, prec: str = "fp32") -> np.ndarray:
    """argmax over the members of R2 = s · exp(-c / λ), in float32 as the
    configuration states (``bf16``: in bfloat16), results below float32's
    smallest normal read as 0, the first maximum taken."""
    dt = torch.bfloat16 if prec == "bf16" else torch.float32
    tiny = torch.finfo(torch.float32).tiny
    e = torch.exp(torch.as_tensor(-np.asarray(c, np.float64) / lam, dtype=torch.float32).to(dt))
    e = torch.where(e.float().abs() < tiny, torch.zeros((), dtype=dt), e)
    r = torch.as_tensor(np.asarray(s, np.float32)).to(dt) * e
    r = torch.where(r.float().abs() < tiny, torch.zeros((), dtype=dt), r)
    return torch.argmax(r.float(), dim=-1).numpy()
