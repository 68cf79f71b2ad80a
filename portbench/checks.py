"""The numbers that decide ``correct``, each held to its limit from the
cell's file.

Serving: ``token_gap``, the widest gap by which a served token's logit
lies below the reference's best at its position (logit units);
``logit_gap``, the widest gap between the program's own logit of a served
token (taken inside the timed call) and the reference's logit of that
token, in units of the reference row's standard deviation over the
vocabulary; ``route_s_gap`` the widest absolute gap of a quality score;
``route_c_gap`` the widest absolute gap of the cost head's output in its
trainer's normalised units, (c - mu) / sd (each member's cost column is
constant, so sd is the trainer's 1e-9 floor and the denormalised
estimates agree to 1e-8 of themselves whatever the head computes);
``route_choice_misses`` the rows whose chosen member is not the argmax of
R2 over the scores the program chose from, an exact comparison.
Training: ``loss_gap`` the widest relative gap of the first three steps'
losses; ``loss_gap_first`` that of the first
step's alone; ``grad_gap`` and ``update_gap`` the worst
leaf's gap between the program's and the reference's norms of the first
gradient and of the change after three steps, over the larger of that
leaf's reference norm and the median leaf's; ``grad_diff_median`` the
median leaf's norm of the difference of the first gradients, over the
same. The gaps of norms cannot tell TF32 from float32: rounding errors
cancel inside a norm; and the MoE's top-8 choices that flip on float32
rounding move every one of these numbers, on some seeds as far as TF32
moves them.
"""
from __future__ import annotations

import math
import statistics
from typing import Callable, Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch

from portbench.reference import model as ref_model
from portbench.reference import router as ref_router

# A leaf whose reference gradient is below this share of the median
# leaf's moves under Adam by round-off alone: its change is not compared.
STILL_LEAF = 1e-3


def token_gap(ref_logits: torch.Tensor, picks: torch.Tensor) -> float:
    """Widest ``max(row) - row[pick]`` over the rows."""
    best = ref_logits.max(dim=-1).values
    got = ref_logits.gather(1, picks.long()[:, None])[:, 0]
    return float((best - got).max())


def logit_gap(ref_logits: torch.Tensor, picks: torch.Tensor, got: torch.Tensor) -> float:
    """Widest ``|got - row[pick]|`` over the rows, each over the row's
    standard deviation; NaN where ``got`` holds one."""
    want = ref_logits.gather(1, picks.long()[:, None])[:, 0]
    gaps = (got.to(want) - want).abs() / ref_logits.std(dim=-1)
    return float("nan") if bool(torch.isnan(gaps).any()) else float(gaps.max())


def served_gaps(members: Sequence[Dict], weights: Callable[[int], Dict],
                sample: Iterable[Dict], device,
                control: Optional[str] = None) -> Dict[str, float]:
    """``token_gap`` and ``logit_gap``, the widest over ``sample`` (dicts
    with ``member``, ``prompt``, ``output`` and the program's ``logits``
    of the output). ``weights(i)`` makes member ``i``'s weights, once per
    member. With ``control`` the picks and their logits are those of the
    reference computed in that precision, at the same positions of the
    same sequences. A gap that is NaN reads as infinite."""
    by_member: Dict[int, List[Dict]] = {}
    for r in sample:
        by_member.setdefault(r["member"], []).append(r)
    worst = {"token_gap": 0.0, "logit_gap": 0.0}
    for mi, rows in by_member.items():
        m, p = members[mi], weights(mi)
        for r in rows:
            prompt = np.asarray(r["prompt"], np.int64)
            out = np.asarray(r["output"], np.int64)
            seq = torch.as_tensor(np.concatenate([prompt, out[:-1]]), device=device)
            pos = slice(len(prompt) - 1, len(prompt) - 1 + len(out))
            with ref_model.precision("fp32"):
                ref = ref_model.served_logits(m, p, seq, len(prompt))[pos]
            if control is None:
                picks = torch.as_tensor(out, device=device)
                got = torch.as_tensor(np.asarray(r["logits"], np.float64), device=device)
            else:
                with ref_model.precision(control):
                    low = ref_model.served_logits(m, p, seq, len(prompt), control)[pos]
                got, picks = low.max(dim=-1)
            for k, v in (("token_gap", token_gap(ref, picks)),
                         ("logit_gap", logit_gap(ref, picks, got))):
                worst[k] = max(worst[k], v) if math.isfinite(v) else math.inf
        del p
    return worst


def routing_gaps(router: Dict, rows: Sequence[Dict], device,
                 control: Optional[str] = None) -> Dict[str, float]:
    """``rows``: dicts with ``text``, the program's ``s`` and ``c`` rows,
    its ``choice`` and ``lam``. With ``control`` the reference in that
    precision stands in for the program: its scores, and its choice from
    the program's scores."""
    texts = [r["text"] for r in rows]
    s_prog = np.stack([r["s"] for r in rows])
    c_prog = np.stack([r["c"] for r in rows])
    with ref_model.precision("fp32"):
        s_ref, c_ref = ref_router.scores(router, texts, device)
    if control is None:
        s_got, c_got = s_prog, c_prog
        choice = np.asarray([r["choice"] for r in rows])
    else:
        with ref_model.precision(control):
            s_got, c_got = ref_router.scores(router, texts, device, control)
        choice = np.concatenate([ref_router.choose(s_prog[i:i + 1], c_prog[i:i + 1], r["lam"],
                                                   "bf16") for i, r in enumerate(rows)])
    want = np.concatenate([ref_router.choose(s_prog[i:i + 1], c_prog[i:i + 1], r["lam"])
                           for i, r in enumerate(rows)])
    sc = router["scaler"] or {"mu": 0.0, "sd": 1.0}
    return {"route_s_gap": float(np.max(np.abs(s_got - s_ref))),
            "route_c_gap": float(np.max(np.abs(c_got - c_ref) / np.asarray(sc["sd"]))),
            "route_choice_misses": float(np.sum(choice != want))}


def leaf_gaps(got: Dict[str, float], ref: Dict[str, float],
              keys: Optional[List[str]] = None) -> List[float]:
    """Each leaf's gap between the two norms, over the larger of its
    reference norm and the median leaf's."""
    keys = list(ref) if keys is None else keys
    med = statistics.median(ref[k] for k in keys)
    return [abs(got[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keys]


def diff_gaps(got: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor]) -> List[float]:
    """Each leaf's norm of the difference, over the larger of its
    reference norm and the median leaf's."""
    keys = list(ref)
    norms = {k: float(torch.linalg.vector_norm(ref[k].double())) for k in keys}
    med = statistics.median(norms.values())
    return [float(torch.linalg.vector_norm((got[k].to(ref[k].device) - ref[k]).double()))
            / max(norms[k], med, 1e-30) for k in keys]


def moving_leaves(grad_norms: Dict[str, float]) -> List[str]:
    med = statistics.median(grad_norms.values())
    return [k for k, g in grad_norms.items() if g >= STILL_LEAF * med]


def training_gaps(got: Dict, ref: Dict) -> Dict[str, float]:
    """``got`` and ``ref``: ``losses`` (first three steps), ``grad_norms``
    and ``update_norms`` by leaf, and ``grads``, the first gradient's
    leaves."""
    losses = [abs(a - b) / abs(b) for a, b in zip(got["losses"], ref["losses"])]
    return {
        "loss_gap": float(max(losses)),
        "loss_gap_first": float(losses[0]),
        "grad_gap": float(max(leaf_gaps(got["grad_norms"], ref["grad_norms"]))),
        "update_gap": float(max(leaf_gaps(got["update_norms"], ref["update_norms"],
                                          moving_leaves(ref["grad_norms"])))),
        "grad_diff_median": float(statistics.median(diff_gaps(got["grads"], ref["grads"]))),
    }


def judge(numbers: Dict[str, float], limits: Dict[str, float]):
    """(correct, {name: {value, limit}}): every number finite and within
    its limit."""
    checks = {k: {"value": float(v), "limit": float(limits[k])} for k, v in numbers.items()}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
