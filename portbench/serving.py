"""Serving cells: the port's ``MicroBatchScheduler`` over a ``RoutedEngine``
on the wall clock, driven by the harness's own loop.

Set-up makes every member's weights on the device from the seed, loads
the cell's router file (``routers/<config>.npz``) through
``launch/serve.py::train_engine(router_path=...)``, builds the
scheduler with ``build_scheduler(wall_time=True, clock=WallClock())`` and
runs each member's generate and the routing pass once at the cell's
largest shapes. The window then offers the cell's traffic: an open loop
(each request offered at its due time and timed from it; those due
inside the window are drained after it) or a backlog (the queue topped
up to ``outstanding`` before every round). ``dispatch()`` runs when
``should_dispatch`` says so; otherwise the loop sleeps until the next due
time or the head request's wait bound.

Each member's greedy loop is the port's own ``lm.greedy_generate`` with
a tap on its prefill and decode steps (:class:`LogitTap`): it keeps the
program's logit of every token it serves, which the reference judges.
"""
from __future__ import annotations

import functools
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from portbench import checks, generator
from portbench.clock import WallClock
from portbench.common import HERE, load_reader, log, quantile, sub_seed
from portbench.members import check_member, describe, port_config
from portbench.reference import router as ref_router
from portbench.spans import SpanEngine, SpanLog
from portbench.trace import DeviceTrace, breakdown, device_fields
from portbench.weights import make_params, param_bytes
from repro_torch.serving.queue import REJECTED, Request


class LogitTap:
    """Binds each member's greedy loop to the port's ``greedy_generate``
    with its prefill and decode steps wrapped: after each step the
    program's largest logit over the vocabulary, which is the logit of the
    token it serves (the first maximum), is kept as a (B,) tensor on the
    device. ``steps`` holds those of the last call."""

    def __init__(self):
        self.steps: List[torch.Tensor] = []

    def bind(self, member) -> None:
        from repro_torch.models import lm as lm_mod
        cfg = member.cfg

        def tapped(step):
            def run(*args, **kwargs):
                logits, caches = step(*args, **kwargs)
                self.steps.append(logits[:, -1, : cfg.vocab_size].amax(dim=-1))
                return logits, caches
            return run

        def greedy(params, prompt, max_new, *, attn_mask=None, media=None):
            self.steps = []
            # Inference mode, as the untapped loop runs (given steps, it
            # would otherwise run under no_grad alone).
            with torch.inference_mode():
                return lm_mod.greedy_generate(
                    cfg, params, prompt, max_new, attn_mask=attn_mask, media=media,
                    prefill=tapped(functools.partial(lm_mod.apply_lm_prefill, cfg)),
                    decode=tapped(functools.partial(lm_mod.apply_lm_decode, cfg)))

        member.greedy = greedy


class Setup:
    """The pool, the engine, its wrapper and the scheduler of one run."""

    def __init__(self, cell: Dict, seed: int, device, smoke: bool = False):
        from repro_torch.launch import serve
        from repro_torch.models import lm as lm_mod
        from repro_torch.serving.engine import PoolMember, arch_cost_rate

        self.cell, self.device = cell, torch.device(device)
        entries = cell["config"]["members"]
        self.members: List[Dict] = []
        pool = []
        for i, entry in enumerate(entries):
            cfg = port_config(entry["name"], smoke)
            if smoke:
                entry = dict(describe(cfg), name=entry["name"])
            else:
                check_member(entry, cfg)
            self.members.append(entry)
            params = make_params(lm_mod.abstract_params(cfg), sub_seed(seed, 1, i), self.device)
            pool.append(PoolMember(name=entry["name"], cfg=cfg, params=params,
                                   cost_rate=arch_cost_rate(port_config(entry["name"]))))
        log(f"[setup] pool weights {sum(param_bytes(m.params) for m in pool) / 2**30:.2f} GiB")
        self.tap = LogitTap()
        for member in pool:
            self.tap.bind(member)
        router_file = HERE / "routers" / f"{cell['router']}.npz"
        self.engine = serve.train_engine(pool, router_path=str(router_file), device=self.device)
        # The reference's copy of the router, read from the file itself.
        self.router = ref_router.load(router_file)
        self.engine.lam = cell["lam"]
        self.clock = WallClock()
        self.vocab = min(m["vocab_size"] for m in self.members)
        self.new_scheduler()

    def new_scheduler(self) -> None:
        """A fresh span log, engine wrapper and scheduler over the engine."""
        from repro_torch.launch import serve
        sc = self.cell["scheduler"]
        self.log = SpanLog()
        self.wrapped = SpanEngine(self.engine, self.log, self.tap)
        self.scheduler = serve.build_scheduler(
            self.wrapped, score_batch=sc["score_batch"], max_batch=sc["max_batch"],
            max_wait_s=sc["max_wait_s"], queue_capacity=sc["queue_capacity"],
            wall_time=True, clock=self.clock, device=self.device)

    def free_weights(self) -> None:
        """Drop the program's weights (the reference makes its own)."""
        for member in self.engine.pool:
            member.params = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reseed(self, seed: int) -> None:
        """Every member's weights made again from ``seed`` (the router file
        stays), and a fresh scheduler."""
        from repro_torch.models import lm as lm_mod
        for i, member in enumerate(self.engine.pool):
            member.params = None
            if self.device.type == "cuda":
                torch.cuda.empty_cache()
            member.params = make_params(lm_mod.abstract_params(member.cfg),
                                        sub_seed(seed, 1, i), self.device)
        self.new_scheduler()

    def warm_up(self, texts: List[str]) -> None:
        """The routing pass at the score batch, and each member's prefill
        and decode at the largest and the smallest batch of the cell's
        longest and shortest prompts."""
        mix, sc = self.cell["traffic"], self.cell["scheduler"]
        rng = np.random.default_rng(0)
        self.engine.score_texts((texts * sc["score_batch"])[: sc["score_batch"]])
        lo, hi = mix["prompt_len"]["min"], mix["prompt_len"]["max"]
        for i in range(len(self.engine.pool)):
            for b, s in ((sc["max_batch"], hi), (1, lo)):
                prompts = [rng.integers(0, self.vocab, size=s).astype(np.int32)] * b
                self.engine.generate_member(i, prompts, max_new=2)
        if self.device.type == "cuda":
            torch.cuda.synchronize()


def _request(spec: Dict, due: float):
    return Request(text=spec["text"], prompt=spec["prompt"], max_new=spec["max_new"],
                   arrival_s=float(due))


def _run_open_loop(st: Setup, specs: List[Dict], due: np.ndarray, seconds: float,
                   trace: Optional[DeviceTrace], slice_s: float) -> List:
    sched, clock, log_ = st.scheduler, st.clock, st.log
    reqs = [_request(s, d) for s, d in zip(specs, due)]
    offered = []
    i, n = 0, len(reqs)
    while True:
        now = clock.now
        if trace is not None and trace.running and now >= slice_s:
            trace.stop()
            log_.traced = False
        while i < n and due[i] <= now:
            sched.queue.offer(reqs[i], now)
            offered.append(now - due[i])
            i += 1
        pending = i < n
        if sched.should_dispatch(flush=not pending):
            with log_.span("dispatch"):
                sched.dispatch()
            continue
        if not pending and sched.queue.depth == 0:
            break
        wake = []
        if pending:
            wake.append(due[i])
        if sched.queue.depth:
            wake.append(sched.queue.peek_all()[0].admitted_s + sched.config.max_wait_s)
        with log_.span("wait"):
            clock.advance_to(min(wake))
    if trace is not None and trace.running:
        trace.stop()
        log_.traced = False
    lag = np.asarray(offered)
    log(f"[generator] {n} requests offered; lateness p50 {np.median(lag) * 1e3:.3f} ms, "
        f"p95 {quantile(lag, 0.95) * 1e3:.3f} ms, max {lag.max() * 1e3:.3f} ms")
    return reqs


def _run_backlog(st: Setup, specs: List[Dict], seconds: float,
                 trace: Optional[DeviceTrace], slice_s: float):
    sched, clock, log_ = st.scheduler, st.clock, st.log
    outstanding = st.cell["traffic"]["outstanding"]
    reqs, i = [], 0
    while True:
        now = clock.now
        if trace is not None and trace.running and now >= slice_s:
            trace.stop()
            log_.traced = False
        if now >= seconds and any(s["name"] == "generate_member" and s["t1"] >= seconds
                                  for s in log_.spans[-8:]):
            break
        while sched.queue.depth < outstanding:
            r = _request(specs[i % len(specs)], now)
            sched.queue.offer(r, now)
            reqs.append(r)
            i += 1
        with log_.span("dispatch"):
            sched.dispatch()
    if trace is not None and trace.running:
        trace.stop()
        log_.traced = False
    return reqs


def window_end(spans: List[Dict], seconds: float) -> float:
    """End of a throughput window: the first generate call to complete at
    or after ``seconds``."""
    ends = sorted(s["t1"] for s in spans if s["name"] == "generate_member")
    after = [t for t in ends if t >= seconds]
    return after[0] if after else ends[-1]


def tokens_per_s(spans: List[Dict], seconds: float) -> float:
    t_end = window_end(spans, seconds)
    toks = sum(sum(s["delivered"]) for s in spans
               if s["name"] == "generate_member" and s["t1"] <= t_end)
    return toks / t_end


def latencies_ms(reqs) -> List[float]:
    return [(r.finish_s - r.arrival_s) * 1e3 for r in reqs if np.isfinite(r.finish_s)]


def check_sample(reqs, n_members: int, per_member: int, seed: int,
                 served: Dict[int, tuple]) -> List[Dict]:
    """Per member that served: its longest request and up to
    ``per_member - 1`` more drawn from the seed, each with the program's
    logits of its served tokens (``served``: the engine wrapper's record by
    prompt; a request with an output and no record reads NaN)."""
    rng = np.random.default_rng(sub_seed(seed, 7))
    out = []
    for mi in range(n_members):
        done = [r for r in reqs if r.member == mi and r.output is not None]
        if not done:
            continue
        longest = max(range(len(done)), key=lambda j: len(done[j].prompt) + len(done[j].output))
        rest = [j for j in range(len(done)) if j != longest]
        pick = [longest] + list(rng.choice(rest, size=min(per_member - 1, len(rest)),
                                           replace=False))
        for j in pick:
            r = done[j]
            steps, row = served.get(id(r.prompt), (None, None))
            logits = (np.full(len(r.output), np.nan) if steps is None else
                      torch.stack([t[row] for t in steps[: len(r.output)]]).cpu().numpy())
            out.append({"member": mi, "prompt": r.prompt, "output": r.output,
                        "logits": logits})
    return out


def route_sample(wrapped: SpanEngine, n: int, seed: int) -> List[Dict]:
    rows = []
    for (texts, s, c), (lam, choice) in zip(wrapped.scored, wrapped.chosen):
        rows += [{"text": t, "s": s[i], "c": c[i], "choice": int(choice[i]), "lam": lam}
                 for i, t in enumerate(texts)]
    rng = np.random.default_rng(sub_seed(seed, 8))
    keep = rng.choice(len(rows), size=min(n, len(rows)), replace=False)
    return [rows[i] for i in sorted(keep)]


def drive(st: Setup, seed: int, seconds: float, trace: bool, warm: bool = True) -> Dict:
    """One window of the cell's traffic on ``st``: the requests, the window's
    end, the end-to-end numbers, the attempted and failed counts, the
    device trace and the window's memory peak."""
    cell, cuda = st.cell, st.device.type == "cuda"
    mix = cell["traffic"]
    backlog = mix["kind"] == "backlog"
    if backlog:
        specs = generator.requests(mix, mix["records"], seed, st.vocab,
                                   round_size=cell["scheduler"]["score_batch"])
        due = None
    else:
        due = generator.open_loop_due(mix, seconds, seed)
        specs = generator.requests(mix, len(due), seed, st.vocab)
    if warm:
        st.warm_up([s["text"] for s in specs])
    out = {"setup_peak": torch.cuda.max_memory_allocated() if cuda else 0}
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    dtrace = DeviceTrace() if trace else None
    out["window_open"] = time.perf_counter()
    st.clock.start()
    st.log.t0 = st.clock.t0
    if dtrace is not None:
        st.log.traced = True
        dtrace.start()
    slice_s = min(cell["trace_slice_s"], seconds)
    if backlog:
        reqs = _run_backlog(st, specs, seconds, dtrace, slice_s)
    else:
        reqs = _run_open_loop(st, specs, due, seconds, dtrace, slice_s)
    out["window_peak"] = torch.cuda.max_memory_allocated() if cuda else 0
    spans = st.log.spans
    if dtrace is not None:
        dtrace.add_spans(spans)
        first = min((s["ns0"] for s in spans if "ns0" in s), default=None)
        if dtrace.kernels and first is not None:
            log(f"[trace] {len(dtrace.kernels)} device events; first device event "
                f"{(dtrace.kernels[0][1] - first) / 1e6:.3f} ms after the first traced span")
    if backlog:
        t_end = window_end(spans, seconds)
        done = [r for r in reqs if np.isfinite(r.finish_s) and r.finish_s <= t_end]
        out["attempted"], out["failed"] = len(done), sum(r.status == REJECTED for r in reqs)
        out["e2e"] = {"tokens_per_s": tokens_per_s(spans, seconds)}
    else:
        t_end = max(r.finish_s for r in reqs if np.isfinite(r.finish_s))
        lat = latencies_ms(reqs)
        out["attempted"], out["failed"] = len(reqs), len(reqs) - len(lat)
        out["e2e"] = {"e2e_p95_ms": quantile(lat, 0.95), "e2e_p50_ms": quantile(lat, 0.5)}
        log(f"[window] {len(lat)} of {len(reqs)} requests done; last at {t_end:.3f} s "
            f"(window {seconds:.1f} s)")
    shares = np.bincount([r.member for r in reqs if r.member >= 0], minlength=len(st.members))
    log(f"[window] member shares {dict(zip([m['name'] for m in st.members], shares.tolist()))}")
    out.update(reqs=reqs, t_end=t_end, trace=dtrace)
    return out


def numbers(st: Setup, reqs, seed: int, control: Optional[str] = None) -> Dict[str, float]:
    """The compared numbers of one window: the sampled requests' served
    tokens and the program's logits of them against the plain reference
    on weights it makes again from the seed, and the sampled routing rows
    against the reference on the router file (with ``control``, the
    reference in that precision in the program's place). The program's
    weights are freed first."""
    from repro_torch.models import lm as lm_mod
    chk = st.cell["check"]
    sample = check_sample(reqs, len(st.members), chk["per_member"], seed, st.wrapped.served)
    rows = route_sample(st.wrapped, chk["route_sample"], seed)
    st.free_weights()
    shapes = [lm_mod.abstract_params(m.cfg) for m in st.engine.pool]

    def weights(i):
        return make_params(shapes[i], sub_seed(seed, 1, i), st.device)

    out = checks.served_gaps(st.members, weights, sample, st.device, control)
    out.update(checks.routing_gaps(st.router, rows, st.device, control))
    log(f"[check] {len(sample)} requests, {sum(len(s['output']) for s in sample)} served "
        f"tokens; {len(rows)} routing rows{'' if control is None else ' (control ' + control + ')'}")
    return out


def run(cell: Dict, seed: int, seconds: float, trace: bool, device="cuda",
        smoke: bool = False, t_start: Optional[float] = None,
        per_layer: Optional[List[str]] = None, end_to_end: Optional[List[str]] = None) -> Dict:
    t_start = time.perf_counter() if t_start is None else t_start
    st = Setup(cell, seed, device, smoke)
    w = drive(st, seed, seconds, trace)
    e2e = dict(w["e2e"], setup_s=w["window_open"] - t_start)
    ctx = {"requests": w["reqs"], "spans": st.log.spans, "trace": w["trace"],
           "window_end_s": w["t_end"], "members": {m["name"]: m for m in st.members},
           "peak_window_bytes": w["window_peak"], "router": st.router,
           "seconds": seconds}
    metrics = {}
    if trace:
        for name in per_layer or []:
            v = load_reader(name)(ctx)
            if v is not None:
                metrics[name] = v
    else:
        metrics = {k: v for k, v in e2e.items() if end_to_end is None or k in end_to_end}
    # Correctness, once the window is closed and the peak is read.
    st.scheduler = None
    correct, verdicts = checks.judge(numbers(st, w["reqs"], seed), cell["limits"])
    out = {"correct": correct, "attempted": w["attempted"], "failed": w["failed"],
           "metrics": metrics, "checks": verdicts,
           "peak_bytes": max(w["setup_peak"], w["window_peak"])}
    if w["trace"] is not None:
        out["device_extra"] = device_fields(w["trace"])
        out["breakdown"] = breakdown(w["trace"])
    return out
