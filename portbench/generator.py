"""The one traffic generator: every mix is a data file under ``traffic/``.

Serving requests carry a RouterBench-shaped text (what the router scores),
a prompt of token ids (what the chosen member generates from) and a
``max_new``. LM training rows are left-padded variable-length Markov
sequences. The sizes come from the mix's ``shape_seed``, so every
``--seed`` runs the same multiset of requests, gaps and row lengths; the
seed draws their order and the token ids.

Frozen copies, numpy only: the arrival and Pareto-length draws of
``repro_torch/serving/traffic.py``, the prompt-text maker of
``repro_torch/data/routerbench.py`` and the order-1 Markov rows of
``repro_torch/data/lm_data.py``'s ``padded_batches`` (here vectorised over
rows, with one successor table drawn from the seed).
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np

BENCHMARKS = ["mmlu", "gsm8k", "hellaswag", "arc-challenge", "winogrande",
              "mbpp", "mt-bench", "rag"]
MMLU_DOMAINS = ["professional_law", "mathematics", "biology", "computer_science",
                "world_history", "philosophy"]
_SKILLS = ["reasoning", "math", "code", "knowledge", "commonsense",
           "reading", "instruction", "long_context"]
_BENCH_MIX = {
    "mmlu":          [0.3, 0.1, 0.0, 0.5, 0.0, 0.1, 0.0, 0.0],
    "gsm8k":         [0.4, 0.6, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
    "hellaswag":     [0.1, 0.0, 0.0, 0.1, 0.7, 0.1, 0.0, 0.0],
    "arc-challenge": [0.4, 0.1, 0.0, 0.4, 0.1, 0.0, 0.0, 0.0],
    "winogrande":    [0.2, 0.0, 0.0, 0.0, 0.7, 0.1, 0.0, 0.0],
    "mbpp":          [0.2, 0.1, 0.7, 0.0, 0.0, 0.0, 0.0, 0.0],
    "mt-bench":      [0.2, 0.0, 0.1, 0.2, 0.1, 0.1, 0.3, 0.0],
    "rag":           [0.1, 0.0, 0.0, 0.2, 0.0, 0.4, 0.1, 0.2],
}
_MMLU_DOMAIN_MIX = {
    "professional_law":  [0.5, 0.0, 0.0, 0.3, 0.0, 0.2, 0.0, 0.0],
    "mathematics":       [0.3, 0.7, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
    "biology":           [0.2, 0.0, 0.0, 0.7, 0.0, 0.1, 0.0, 0.0],
    "computer_science":  [0.2, 0.1, 0.5, 0.2, 0.0, 0.0, 0.0, 0.0],
    "world_history":     [0.1, 0.0, 0.0, 0.8, 0.0, 0.1, 0.0, 0.0],
    "philosophy":        [0.4, 0.0, 0.0, 0.3, 0.0, 0.3, 0.0, 0.0],
}
_SKILL_WORDS = {
    "reasoning": ["deduce", "therefore", "premise", "logic", "infer", "syllogism",
                  "contradiction", "entail", "proof", "consistent"],
    "math": ["integral", "equation", "algebra", "numerator", "polynomial",
             "arithmetic", "fraction", "derivative", "modulo", "quotient"],
    "code": ["function", "compile", "python", "variable", "recursion", "loop",
             "array", "debug", "syntax", "algorithm"],
    "knowledge": ["history", "capital", "discovered", "century", "theory",
                  "empire", "element", "biology", "constitution", "treaty"],
    "commonsense": ["kitchen", "umbrella", "breakfast", "neighbor", "holiday",
                    "weather", "grocery", "garden", "traffic", "weekend"],
    "reading": ["passage", "paragraph", "author", "summarize", "context",
                "excerpt", "narrator", "tone", "quote", "article"],
    "instruction": ["please", "rewrite", "steps", "format", "bullet", "draft",
                    "polite", "email", "explain", "concise"],
    "long_context": ["document", "archive", "transcript", "chapter", "appendix",
                     "ledger", "catalogue", "minutes", "volume", "registry"],
}
_DIFFICULTY_WORDS = [
    ["simple", "basic", "easy", "quick"],
    ["standard", "typical", "common", "regular"],
    ["tricky", "subtle", "layered", "detailed"],
    ["hard", "complex", "advanced", "intricate"],
    ["expert", "formidable", "exhaustive", "labyrinthine"],
]


def _make_prompt(rng: np.random.Generator, bench: str, mix: np.ndarray,
                 difficulty: float) -> str:
    words = [bench.replace("-", " ")]
    for _ in range(12):
        skill = rng.choice(len(_SKILLS), p=mix)
        words.append(rng.choice(_SKILL_WORDS[_SKILLS[skill]]))
    tier = int(np.clip(difficulty * len(_DIFFICULTY_WORDS), 0, len(_DIFFICULTY_WORDS) - 1))
    words.append(rng.choice(_DIFFICULTY_WORDS[tier]))
    words.append(rng.choice(_DIFFICULTY_WORDS[tier]))
    rng.shuffle(words)
    return " ".join(words)


def corpus(n: int, rng: np.random.Generator) -> Tuple[List[str], List[str]]:
    """``n`` RouterBench-shaped (text, benchmark) pairs."""
    texts, benches = [], []
    for _ in range(n):
        bench = BENCHMARKS[rng.integers(len(BENCHMARKS))]
        if bench == "mmlu":
            mix = np.asarray(_MMLU_DOMAIN_MIX[MMLU_DOMAINS[rng.integers(len(MMLU_DOMAINS))]])
        else:
            mix = np.asarray(_BENCH_MIX[bench], np.float64)
        mix = (mix + 0.02) / (mix + 0.02).sum()
        difficulty = float(np.clip(rng.beta(2.0, 2.6), 0.0, 1.0))
        texts.append(_make_prompt(rng, bench, mix, difficulty))
        benches.append(bench)
    return texts, benches


def prompt_lengths(spec: Dict, n: int, rng: np.random.Generator) -> np.ndarray:
    """Pareto(alpha) lengths from ``min``, clipped at ``max``."""
    tail = rng.pareto(spec["pareto_alpha"], size=n) + 1.0
    lens = (spec["min"] * tail).astype(np.int64)
    return np.clip(lens, spec["min"], spec["max"])


def request_shapes(mix: Dict, n: int) -> List[Dict]:
    """The mix's ``n`` request shapes (text, benchmark, prompt length,
    max_new), the same for every seed."""
    rng = np.random.default_rng(mix["shape_seed"])
    texts, benches = corpus(mix["corpus"], rng)
    picks = rng.integers(0, len(texts), size=n)
    lens = prompt_lengths(mix["prompt_len"], n, rng)
    short = set(mix["max_new"]["short_benchmarks"])
    return [{"text": texts[p], "benchmark": benches[p], "prompt_len": int(length),
             "max_new": int(mix["max_new"]["short" if benches[p] in short else "other"])}
            for p, length in zip(picks, lens)]


def requests(mix: Dict, n: int, seed: int, vocab: int, round_size: int = 0) -> List[Dict]:
    """The ``n`` shapes in the seed's order, each with seeded token ids
    below ``vocab`` (the smallest vocabulary of the pool, so any member
    can take any prompt). With ``round_size`` the seed orders the shapes
    within each run of ``round_size`` and keeps the runs in place: a
    backlog pops one run a round, so every seed's rounds do the same work
    on distinct requests, each round its own."""
    rng = np.random.default_rng(seed)
    shapes = request_shapes(mix, n)
    if round_size:
        order = np.concatenate([lo + rng.permutation(min(round_size, n - lo))
                                for lo in range(0, n, round_size)])
    else:
        order = rng.permutation(n)
    out = []
    for i in order:
        s = dict(shapes[i])
        s["prompt"] = rng.integers(0, vocab, size=s["prompt_len"]).astype(np.int32)
        out.append(s)
    return out


def open_loop_due(mix: Dict, seconds: float, seed: int) -> np.ndarray:
    """Due times of an open loop at ``rate_per_s`` over ``seconds``: the
    ``round(rate * seconds)`` exponential gaps of the shape seed, scaled
    so the last request is due at the window's end, in the seed's order
    (the first is due one gap after the window opens).
    Every seed thus offers the same number of requests with the same
    gaps."""
    n = max(1, int(round(mix["rate_per_s"] * seconds)))
    gaps = np.random.default_rng(mix["shape_seed"] + 1).exponential(1.0, size=n)
    gaps = gaps * (seconds / gaps.sum())
    gaps = gaps[np.random.default_rng(seed).permutation(n)]
    return np.cumsum(gaps)


def lm_rows(mix: Dict, n_rows: int, vocab: int, seed: int
            ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``n_rows`` left-padded rows (tokens, labels, mask), each (n_rows,
    seq_len): real lengths uniform over [min_len, seq_len], one batch's
    worth drawn from the shape seed and repeated for every batch, each in
    the seed's order (so every step trains the same number of real
    tokens); content an order-1 Markov chain whose ``branching``
    successors per token are drawn from the seed, 90% structure and 10%
    noise."""
    s, b = mix["seq_len"], mix["batch"]
    block = np.random.default_rng(mix["shape_seed"]).integers(mix["min_len"], s + 1, size=b)
    rng = np.random.default_rng(seed)
    lens = np.concatenate([block[rng.permutation(b)] for _ in range(-(-n_rows // b))])[:n_rows]
    succ = rng.integers(0, vocab, size=(vocab, mix["branching"]))
    seq = np.empty((n_rows, s + 1), np.int64)
    seq[:, 0] = rng.integers(0, vocab, size=n_rows)
    rows = np.arange(n_rows)
    for i in range(1, s + 1):
        follow = succ[seq[:, i - 1], rng.integers(0, mix["branching"], size=n_rows)]
        noise = rng.integers(0, vocab, size=n_rows)
        seq[:, i] = np.where(rng.random(n_rows) < 0.9, follow, noise)
    toks = np.zeros((n_rows, s), np.int32)
    labs = np.zeros((n_rows, s), np.int32)
    mask = np.zeros((n_rows, s), bool)
    for r, length in zip(rows, lens):
        # The row's last ``length + 1`` chain tokens, right-aligned.
        toks[r, s - length:] = seq[r, s - length:s]
        labs[r, s - length:] = seq[r, s - length + 1:]
        mask[r, s - length:] = True
    return toks, labs, mask


def n_train_batches(mix: Dict, seconds: float, first_steps: int) -> int:
    """Batches for the checked first steps and a window of ``seconds`` at
    no less than ``min_step_s`` a step: every row of a run differs."""
    return first_steps + int(math.ceil(seconds / mix["min_step_s"])) + 1
