"""Observability smoke on the PyTorch port: a seeded traced cascade run,
replayed bit-identically, in under 5 seconds.

Exercises the whole observability plane against the stub cascade scenario
(no LM generation, no training beyond the bootstrap head): a
:class:`~repro_torch.obs.TraceRecorder` threaded through the
micro-batching scheduler + cascade coordinator, a
:class:`~repro_torch.obs.MetricsRegistry` with the full scheduler/cascade
metric set, and the Chrome-trace exporter.

Checks:
  * the exported trace is schema-valid Chrome JSON and its span tree is
    well-formed — every request covered admission -> legs -> finalize,
    legs nested inside their request root, no overlapping legs;
  * every cascade leg span links (via its ``gen`` arg) to the generate
    micro-batch span that actually served it;
  * the run replays bit-identically: trace JSON and deterministic metrics
    snapshot are byte-equal across two fresh runs (virtual-clock
    timestamps and admission-order trace keys, no wall time anywhere);
  * the same run in **streaming mode** (sampling 0.25 + per-worker cap +
    rotating segment flushes) concatenates back into a valid trace that
    retains 100%% of the escalated request trees, bounds the recorder's
    peak buffer, and is segment-for-segment byte-identical across
    replays;
  * artifacts land on disk for CI upload (--out-dir).

    PYTHONPATH=src python tools/torch_obs_smoke.py [--out-dir reports/obs_smoke] [--device cpu]

The port of ``tools/obs_smoke.py``, on the CUDA card unless ``--device``
names another device (with no card and no ``--device`` it raises). The
ensemble head is trained here from a torch generator seeded as the
reference seeds its JAX key; the checks are the reference's. The device
is initialised before the clock starts. ``tools/torch_trace_export.py``
reads the trace it writes.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from repro_torch.cascade import (
    CascadeConfig,
    CascadeCoordinator,
    CascadePolicy,
    cost_ladder,
)
from repro_torch.common.device import resolve_device
from repro_torch.configs import get_smoke_config
from repro_torch.core.predictors import PREDICTORS
from repro_torch.core.router import PredictiveRouter
from repro_torch.obs import (
    MetricsRegistry,
    ObsFlusher,
    TraceRecorder,
    TraceSampler,
    concat_dir,
    register_scheduler_metrics,
    request_trees,
    trace_summary,
    validate_chrome_trace,
    validate_span_tree,
)
from repro_torch.obs.trace import trace_doc_to_json
from repro_torch.serving.engine import RoutedEngine
from repro_torch.serving.queue import Request
from repro_torch.serving.scheduler import MicroBatchScheduler, SchedulerConfig
from repro_torch.training import AdamConfig, adam_init, make_ensemble_predictor_step

DQ, SEED, LAM = 32, 0, 8.0
COST = np.array([0.2, 1.0, 3.0])
QUAL_EASY = np.array([0.90, 0.92, 0.95])
QUAL_HARD = np.array([0.15, 0.55, 0.92])
N_REQ = 48


class StubMember:
    """A member that generates zeros. ``cfg`` gives the engine its padding
    rule (plain attention: the batch is as wide as its longest prompt)."""

    cfg = get_smoke_config("qwen3-0.6b")

    def __init__(self, name, cost_rate):
        self.name, self.cost_rate = name, cost_rate

    def generate(self, prompts, max_new=8, attn_mask=None):
        return torch.zeros((prompts.shape[0], max_new), dtype=torch.int32)


def region_emb(rng, n, sign):
    mu = np.zeros(DQ, np.float32)
    mu[: DQ // 2] = 0.8 * sign
    e = rng.normal(0, 0.3, size=(n, DQ)).astype(np.float32) + mu
    return e / np.linalg.norm(e, axis=1, keepdims=True)


def build_engine(rng, device):
    emb = np.concatenate([region_emb(rng, 128, +1.0),
                          region_emb(rng, 128, -1.0)])
    labels = np.concatenate([
        np.tile(QUAL_EASY, (128, 1)), np.tile(QUAL_HARD, (128, 1)),
    ]).astype(np.float32)
    labels += rng.normal(0, 0.03, labels.shape).astype(np.float32)
    memb = rng.random((3, 4)).astype(np.float32)

    opt = AdamConfig(lr=5e-3)
    step = make_ensemble_predictor_step("attn-ens", opt)
    gen = torch.Generator(device=device).manual_seed(SEED)
    qp = PREDICTORS["attn-ens"].init(gen, DQ, 3, memb.shape[1])
    state = adam_init(opt, qp)
    boot = rng.poisson(1.0, size=(256, qp["bo"].shape[0])).astype(np.float32)
    q, m, t, w = (torch.as_tensor(a, device=device) for a in (emb, memb, labels, boot))
    for _ in range(120):
        _, qp, state = step(qp, state, q, m, t, w)

    cp = {"w": torch.zeros((DQ, 3), dtype=torch.float32, device=device),
          "b": torch.zeros(3, dtype=torch.float32, device=device)}
    router = PredictiveRouter(
        "attn-ens", "reg", qp, cp, memb, reward="R2",
        cost_scaler={"mu": np.asarray(COST, np.float64),
                     "sd": np.ones(3, np.float64)})
    pool = [StubMember(n, c) for n, c in
            zip(("cheap", "mid", "strong"), COST)]
    return RoutedEngine(router=router, pool=pool, lam=LAM, device=device)


def scenario(device, deadline_s=None):
    """(engine, requests, cascade coordinator) of the seeded stub cascade:
    easy and hard requests alternating, each forced onto the cheapest
    rung first, with a deadline ``deadline_s`` after arrival if given."""
    rng = np.random.default_rng(SEED)
    engine = build_engine(rng, device)
    easy = region_emb(rng, N_REQ // 2, +1.0)
    hard = region_emb(rng, N_REQ // 2, -1.0)
    truth = {}

    ladder = cost_ladder(engine.router)
    reqs, embs = [], []
    for i in range(N_REQ):
        is_hard = i % 2 == 1
        e = hard[i // 2] if is_hard else easy[i // 2]
        text = f"{'hard' if is_hard else 'easy'}-{i}"
        truth[text] = QUAL_HARD if is_hard else QUAL_EASY
        r = Request(text=text, prompt=np.zeros(2, np.int32),
                    max_new=2, arrival_s=i * 1e-3,
                    deadline_s=None if deadline_s is None else i * 1e-3 + deadline_s)
        r.forced_member = int(ladder[0])
        r.forced_member_name = engine.pool[int(ladder[0])].name
        reqs.append(r)
        embs.append(e)
    emb_of = {r.text: e for r, e in zip(reqs, embs)}
    engine.embed = lambda texts: np.stack([emb_of[t] for t in texts])
    coordinator = CascadeCoordinator(
        CascadePolicy(ladder, CascadeConfig(max_legs=3, beta=1.0)),
        observed_quality=lambda r: float(truth[r.text][r.member]))
    return engine, reqs, coordinator


STREAM_RATE, STREAM_CAP, SCRAPE_S = 0.25, 4096, 2e-3


def run_traced(device, stream_dir=None):
    """One seeded cascade run under the recorder; returns artifacts.

    With ``stream_dir`` set the run uses the full streaming stack —
    deterministic head+tail sampling (rate ``STREAM_RATE``, head=0 so
    sampling actually bites), a per-worker buffered-event cap, and
    rotating segment flushes every ``SCRAPE_S`` virtual seconds — and the
    returned trace JSON is the canonical concatenation of the segments.
    """
    engine, reqs, coordinator = scenario(device)
    label = f"obs-smoke-seed{SEED}"
    if stream_dir is None:
        recorder, flusher = TraceRecorder(label=label), None
    else:
        recorder = TraceRecorder(
            label=label, sampler=TraceSampler(STREAM_RATE, seed=SEED, head=0),
            max_buffered_per_worker=STREAM_CAP)
        flusher = ObsFlusher(stream_dir, recorder=recorder,
                             scrape_every_s=SCRAPE_S, label=label)
    registry = MetricsRegistry()
    sched = MicroBatchScheduler(
        engine, SchedulerConfig(score_batch=16, max_batch=16),
        cascade=coordinator, service_time=lambda kind, n, wall: 1e-3,
        tracer=recorder.scoped(0), flusher=flusher)
    register_scheduler_metrics(registry, sched)
    summary = sched.run_trace(reqs)
    if flusher is not None:
        flusher.finalize(sched.clock.now)
        trace_json = trace_doc_to_json(concat_dir(stream_dir))
    else:
        trace_json = recorder.to_json()
    return trace_json, registry.to_json(deterministic=True), summary, recorder


def run_rescue(device):
    """Deadline-pressure variant: requests whose deadlines fire mid-cascade
    while they hold a best-so-far answer are *rescued* (finalized done with
    the answer in hand), requests that expire empty-handed stay expired —
    and the trace must tell the same story as the queue counters: a rescued
    tree carries a ``rescued`` instant and a done root, never an ``expire``
    instant, and the ``expire`` instants in the trace match ``queue.expired``
    exactly."""
    engine, reqs, coordinator = scenario(device, deadline_s=4e-3)
    recorder = TraceRecorder(label="obs-smoke-rescue")
    sched = MicroBatchScheduler(
        engine, SchedulerConfig(score_batch=16, max_batch=16),
        cascade=coordinator, service_time=lambda kind, n, wall: 1e-3,
        tracer=recorder.scoped(0))
    summary = sched.run_trace(reqs)
    return recorder.to_json(), summary, sched


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out-dir", default="reports/obs_smoke",
                    help="artifact directory for the trace + metrics JSON")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    torch.zeros(1, device=device)          # the device's context, off the clock

    t0 = time.perf_counter()
    trace1, metrics1, s1, _ = run_traced(device)
    wall = time.perf_counter() - t0
    trace2, metrics2, _, _ = run_traced(device)

    doc = json.loads(trace1)
    schema_errors = validate_chrome_trace(doc)
    tree_errors = validate_span_tree(doc)
    summ = trace_summary(doc)
    trees = request_trees(doc)
    covered = all(
        t["root"] is not None
        and any(e["name"] == "leg" for e in t["events"])
        and len(t["admits"]) >= 1
        for t in trees.values())
    legs = [e for t in trees.values() for e in t["legs"]]
    linked = legs and all("gen" in (e.get("args") or {}) for e in legs)

    # Deadline-rescue mode: the span tree must agree with the queue
    # counters about who was rescued (done, answer in hand) vs expired.
    r_trace, r_sum, r_sched = run_rescue(device)
    rdoc = json.loads(r_trace)
    r_tree_errors = validate_span_tree(rdoc)
    r_trees = request_trees(rdoc)
    n_rescued = n_expire_inst = 0
    rescue_consistent = True
    for t in r_trees.values():
        names = [e["name"] for e in t["events"]]
        root_args = ((t["root"] or {}).get("args") or {})
        n_rescued += names.count("rescued")
        n_expire_inst += names.count("expire")
        if "rescued" in names:
            # A rescued request finalizes done on its best-so-far answer;
            # an expire instant in the same tree would contradict it.
            rescue_consistent &= ("expire" not in names
                                  and root_args.get("status") == "done"
                                  and root_args.get("rescued") is True)
        elif "expire" in names:
            rescue_consistent &= root_args.get("status") == "expired"

    # Streaming mode: same seeded scenario through sampling + cap +
    # rotating flushes, twice, into sibling segment dirs.
    sdir1 = os.path.join(args.out_dir, "stream")
    sdir2 = os.path.join(args.out_dir, "stream_replay")
    st1, _, ss1, srec = run_traced(device, stream_dir=sdir1)
    st2, _, _, _ = run_traced(device, stream_dir=sdir2)
    sdoc = json.loads(st1)
    s_schema = validate_chrome_trace(sdoc)
    s_tree = validate_span_tree(sdoc)
    s_trees = request_trees(sdoc)
    # Escalated trees are anomalous (readmit instants): 100% retained.
    readmits = sum(1 for t in s_trees.values() for e in t["events"]
                   if e["name"] == "readmit")
    n_kept = len(s_trees)

    def read(path):
        with open(path, "rb") as f:
            return f.read()

    seg_identical = (
        sorted(os.listdir(sdir1)) == sorted(os.listdir(sdir2))
        and all(read(os.path.join(sdir1, n)) == read(os.path.join(sdir2, n))
                for n in os.listdir(sdir1)))

    os.makedirs(args.out_dir, exist_ok=True)
    for name, text in (("trace.json", trace1), ("metrics.json", metrics1),
                       ("stream_trace.json", st1)):
        with open(os.path.join(args.out_dir, name), "w") as f:
            f.write(text)

    checks = {
        "schema-valid chrome trace": not schema_errors,
        "well-formed span tree": not tree_errors,
        "every request admission->legs->finalize":
            covered and summ["finalized"] == N_REQ
            and s1["completed"] == N_REQ,
        "cascade decisions traced":
            summ["by_name"].get("cascade_decision", 0) >= N_REQ,
        "legs link their generate micro-batch span": bool(linked),
        "rescue trees consistent (rescued != expired)":
            n_rescued >= 1 and rescue_consistent and not r_tree_errors
            and n_expire_inst == r_sched.queue.expired,
        "replay bit-identity (trace)": trace1 == trace2,
        "replay bit-identity (metrics)": metrics1 == metrics2,
        "streaming concat schema+tree valid": not (s_schema or s_tree),
        "streaming retains all escalated trees":
            ss1["escalations"] > 0 and readmits == ss1["escalations"],
        "streaming samples out non-anomalous trees":
            0 < n_kept < N_REQ
            and srec.stats["requests_sampled_out"] > 0,
        "streaming recorder peak under cap":
            srec.peak_buffered < STREAM_CAP
            and srec.peak_buffered < summ["events"],
        "streaming replay segment byte-identity":
            seg_identical and st1 == st2,
        "trace under 5s": wall < 5.0,
    }
    for name, ok in checks.items():
        print(f"  [{'ok' if ok else 'FAIL'}] {name}")
    for err in (schema_errors + tree_errors + s_schema + s_tree)[:8]:
        print(f"    error: {err}")
    print(f"{summ['events']} events  {summ['requests']} requests  "
          f"escalations {s1['escalations']}  wall {wall:.2f}s on {device}  "
          f"artifacts -> {args.out_dir}/")
    print(f"streaming: {len(os.listdir(sdir1))} segment files  "
          f"{n_kept}/{N_REQ} trees kept  peak buffered "
          f"{srec.peak_buffered}  drops {srec.drop_stats}")
    ok = all(checks.values())
    print(f"obs smoke: {'OK' if ok else 'FAIL'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
