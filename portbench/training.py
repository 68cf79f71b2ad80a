"""Training cells: the port's ``launch/steps.py::make_train_step`` on
batches the benchmark makes, with AdamW as ``train_loop`` sets it.

Set-up makes the weights on the device from the seed, the step and the
optimizer state, and every batch of the run (rows that all differ); it
then drives that one step object through the first three steps, which
the plain reference follows after the window, and hands it on to the
window. Each step ends in one ``float(loss)``, as ``train_loop`` does.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from portbench import checks, generator
from portbench.common import load_reader, log, sub_seed
from portbench.members import check_member, describe, port_config
from portbench.reference import model as ref_model
from portbench.reference.optim import AdamW
from portbench.spans import SpanLog
from portbench.trace import DeviceTrace, breakdown, device_fields
from portbench.weights import leaves, make_params, rebuild

FIRST_STEPS = 3


def norm(t: torch.Tensor) -> float:
    """A leaf's L2 norm, summed in float64 on the leaf's device."""
    return float(torch.linalg.vector_norm(t.double()))


def make_batches(cell: Dict, entry: Dict, seconds: float, seed: int, device) -> List[Dict]:
    mix = cell["traffic"]
    n = generator.n_train_batches(mix, seconds, FIRST_STEPS)
    b = mix["batch"]
    toks, labs, mask = generator.lm_rows(mix, n * b, entry["vocab_size"], sub_seed(seed, 2))
    out = []
    for i in range(n):
        rows = slice(i * b, (i + 1) * b)
        out.append({"tokens": torch.from_numpy(toks[rows]).to(device),
                    "labels": torch.from_numpy(labs[rows]).to(device),
                    "attn_mask": torch.from_numpy(mask[rows]).to(device),
                    "lengths": mask[rows].sum(axis=1).tolist()})
    return out


def reference_steps(entry: Dict, shapes, seed: int, batches: List[Dict], adam: Dict,
                    device, prec: str = "fp32", rows: slice = slice(None)) -> Dict:
    """The first three steps in plain PyTorch, row by row, from the same
    weights: losses, the first gradient and its norms, the change's norms.
    ``rows`` keeps part of each batch (a planted fault: the mean is then
    taken over the rows kept)."""
    init = make_params(shapes, sub_seed(seed, 1), device)
    params = {k: t.detach().clone().requires_grad_(True) for k, t in leaves(init)}
    start = {k: t.detach().clone() for k, t in leaves(init)}
    del init
    tree = rebuild(shapes, params)
    opt = AdamW(adam, params)
    losses, first = [], None
    coef = entry["router_aux_coef"]
    with ref_model.precision(prec):
        for step, b in enumerate(batches[:FIRST_STEPS]):
            mask = b["attn_mask"].cpu().numpy()
            kept = range(mask.shape[0])[rows]
            n_total = float(mask[list(kept)].sum())
            total = 0.0
            for r in kept:
                real = torch.as_tensor(mask[r], device=device)
                ce, groups = ref_model.train_row(entry, tree, b["tokens"][r][real],
                                                 b["labels"][r][real], prec)
                loss = ce / n_total
                if groups:
                    loss = loss + coef * sum(a * n for a, n in groups) / n_total
                loss.backward()
                total += float(loss.detach())
            grads = {k: p.grad for k, p in params.items()}
            if step == 0:
                first = {k: g.detach().clone() for k, g in grads.items()}
            opt.step(params, grads)
            for p in params.values():
                p.grad = None
            losses.append(total)
    return {"losses": losses, "grads": first,
            "grad_norms": {k: norm(g) for k, g in first.items()},
            "update_norms": {k: norm(params[k].detach() - start[k]) for k in params}}


class Setup:
    def __init__(self, cell: Dict, seed: int, seconds: float, device, smoke: bool = False):
        from repro_torch.launch.steps import make_train_step
        from repro_torch.models import lm as lm_mod
        from repro_torch.training.optim import AdamConfig, adam_init

        self.cell, self.device = cell, torch.device(device)
        entry = cell["config"]["members"][0]
        cfg = port_config(entry["name"], smoke)
        if smoke:
            entry = dict(describe(cfg), name=entry["name"])
        else:
            check_member(entry, cfg)
        self.entry, self.seed = entry, seed
        self.shapes = lm_mod.abstract_params(cfg)
        a = cell["adam"]
        self.adam = a
        self.b1 = a["b1"]
        adam_cfg = AdamConfig(lr=a["lr"], b1=a["b1"], b2=a["b2"], eps=a["eps"],
                              weight_decay=a["weight_decay"], t_max=a["t_max"])
        self.params = make_params(self.shapes, sub_seed(seed, 1), self.device)
        self.opt_state = adam_init(adam_cfg, self.params)
        self.step_fn = make_train_step(cfg, adam_cfg=adam_cfg)
        self.batches = make_batches(cell, entry, seconds, seed, self.device)

    def step(self, b: Dict) -> float:
        batch = {k: b[k] for k in ("tokens", "labels", "attn_mask")}
        loss, self.params, self.opt_state = self.step_fn(self.params, self.opt_state, batch)
        return float(loss)

    def first_steps(self) -> Dict:
        """Steps 1..3 through the window's own call: the losses, the first
        gradient from Adam's first moment after step 1 (m = (1 - b1) g; its
        leaves kept on the host) and its norms, and the norms of the change
        after step 3."""
        start = {k: t.detach().clone() for k, t in leaves(self.params)}
        losses, grads, grad_norms = [], None, None
        for i in range(FIRST_STEPS):
            losses.append(self.step(self.batches[i]))
            if i == 0:
                grads = {k: m / (1.0 - self.b1) for k, m in leaves(self.opt_state.m)}
                grad_norms = {k: norm(g) for k, g in grads.items()}
                grads = {k: g.cpu() for k, g in grads.items()}
        updates = {k: norm(t.detach() - start[k]) for k, t in leaves(self.params)}
        return {"losses": losses, "grads": grads, "grad_norms": grad_norms,
                "update_norms": updates}


def run(cell: Dict, seed: int, seconds: float, trace: bool, device="cuda",
        smoke: bool = False, t_start: Optional[float] = None,
        per_layer: Optional[List[str]] = None, end_to_end: Optional[List[str]] = None) -> Dict:
    t_start = time.perf_counter() if t_start is None else t_start
    cuda = torch.device(device).type == "cuda"
    st = Setup(cell, seed, seconds, device, smoke)
    got = st.first_steps()
    if cuda:
        torch.cuda.synchronize()
    setup_peak = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start

    log_ = SpanLog()
    dtrace = DeviceTrace() if trace else None
    slice_s = min(cell["trace_slice_s"], seconds)
    steps: List[Dict] = []
    log_.t0 = time.perf_counter()
    if dtrace is not None:
        log_.traced = True
        dtrace.start()
    i = FIRST_STEPS
    while True:
        b = st.batches[i % len(st.batches)]
        with log_.span("train_step", lengths=b["lengths"]) as rec:
            loss = st.step(b)
        rec["loss"] = loss
        steps.append(rec)
        i += 1
        if dtrace is not None and dtrace.running and rec["t1"] >= slice_s:
            dtrace.stop()
            log_.traced = False
        if rec["t1"] >= seconds:
            break
    if dtrace is not None:
        if dtrace.running:
            dtrace.stop()
        dtrace.add_spans(log_.spans)
    window_peak = torch.cuda.max_memory_allocated() if cuda else 0
    t_end = steps[-1]["t1"]
    real = sum(sum(s["lengths"]) for s in steps)
    losses = [s["loss"] for s in steps]
    failed = sum(not np.isfinite(x) for x in losses)
    log(f"[window] {len(steps)} steps, {real} real tokens in {t_end:.3f} s; "
        f"loss {got['losses'][0]:.4f} -> {losses[-1]:.4f}")
    e2e = {"train_tokens_per_s": real / t_end, "setup_s": setup_s}
    ctx = {"spans": log_.spans, "trace": dtrace, "window_end_s": t_end,
           "members": {st.entry["name"]: st.entry}, "peak_window_bytes": window_peak,
           "seconds": seconds}
    if trace:
        metrics = {}
        for name in per_layer or []:
            v = load_reader(name)(ctx)
            if v is not None:
                metrics[name] = v
    else:
        metrics = {k: v for k, v in e2e.items() if end_to_end is None or k in end_to_end}

    # The reference follows the first three steps once the program's state
    # is freed, from weights made again from the seed.
    entry, shapes, batches, adam = st.entry, st.shapes, st.batches[:FIRST_STEPS], st.adam
    del st
    if cuda:
        torch.cuda.empty_cache()
    ref = reference_steps(entry, shapes, seed, batches, adam, device)
    numbers = {k: v for k, v in checks.training_gaps(got, ref).items() if k in cell["limits"]}
    log(f"[check] losses program {got['losses']} reference {ref['losses']}")
    correct, verdicts = checks.judge(numbers, cell["limits"])
    out = {"correct": correct, "attempted": len(steps), "failed": int(failed),
           "metrics": metrics, "checks": verdicts, "peak_bytes": max(setup_peak, window_peak)}
    if dtrace is not None:
        out["device_extra"] = device_fields(dtrace)
        out["breakdown"] = breakdown(dtrace)
    return out
