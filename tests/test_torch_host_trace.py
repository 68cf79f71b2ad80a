"""The host tracer (``repro_torch.obs.host_trace``) on the CPU.

Off, it records nothing and keeps nothing. On, it changes no token, $ or
score, and its spans nest as the calls do: ``pad``, ``prefill``, one
``decode_step`` per step after the first token and ``to_host`` inside each
``generate``; ``featurize``, ``score`` and ``choose`` around routing. Its
counters equal counts made by hand, its stamps land on ``time.time_ns()``'s
clock, and a traced scheduler's deterministic trace is the same bytes with
it as without it. Every test that installs a tracer removes it again in a
``finally``.
"""
import contextlib
import functools
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from repro_torch.launch import serve
from repro_torch.models import lm as lm_mod
from repro_torch.models import trace_hook
from repro_torch.obs import TraceRecorder, WALL_CATS, host_trace
from repro_torch.obs.host_trace import COUNTS, HostTracer, generate_counts
from repro_torch.serving.engine import RoutedEngine, pad_prompts, prompt_pad_mask
from repro_torch.serving.queue import Request
from repro_torch.serving.scheduler import MicroBatchScheduler, SchedulerConfig

NAMES = ("qwen3-0.6b", "granite-3-8b")


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def engine():
    pool = serve.build_pool(NAMES, smoke=True, device="cpu")
    return RoutedEngine(router=serve.init_router(len(NAMES), device="cpu"), pool=pool,
                        lam=1.0, device="cpu")


@contextlib.contextmanager
def installed(recorder=None):
    tracer = HostTracer(TraceRecorder() if recorder is None else recorder)
    host_trace.set_host_tracer(tracer)
    try:
        yield tracer
    finally:
        host_trace.set_host_tracer(None)


def ragged(vocab, lens=(3, 9, 5, 1), seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n).astype(np.int32) for n in lens]


def host_spans(tracer):
    """``(name, t0, dur, args)`` of each host span, in order."""
    return list(tracer.spans())


def by_name(tracer, name):
    return [e for e in host_spans(tracer) if e[0] == name]


def inside(child, parent):
    return parent[1] <= child[1] and child[1] + child[2] <= parent[1] + parent[2]


def end(span):
    return span[1] + span[2]


def test_host_category_is_wall_clock():
    assert host_trace.HOST_CAT in WALL_CATS and "kernel" in WALL_CATS


def test_off_records_nothing_and_keeps_no_state(engine):
    assert trace_hook.TRACER is None
    module_state = dict(vars(trace_hook)), dict(vars(host_trace))
    idle = HostTracer(TraceRecorder())
    tracer_state = dict(vars(idle))
    prompts = ragged(engine.pool[0].cfg.vocab_size)
    engine.generate_member(0, prompts, max_new=3, max_new_per_req=[1, 3, 2, 3])
    engine.choose(*engine.score_texts(["a", "b"]))
    engine.score_emb(engine.embed(["c"]))
    assert trace_hook.TRACER is None
    assert (dict(vars(trace_hook)), dict(vars(host_trace))) == module_state
    assert dict(vars(idle)) == tracer_state and idle.recorder.events == []


def test_the_model_and_serving_layers_read_the_hook_without_the_obs_package():
    """The hook is a leaf of the model layer: importing the LM and the
    engine loads nothing of ``repro_torch.obs``, and installing through
    ``host_trace`` sets the hook they read."""
    code = ("import sys, repro_torch.models.lm, repro_torch.serving.engine; "
            "print(sorted(m for m in sys.modules if m.startswith('repro_torch.obs')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True).stdout
    assert out.strip() == "[]"
    with installed() as tracer:
        assert trace_hook.TRACER is tracer
    assert trace_hook.TRACER is None


def test_tokens_outputs_costs_and_scores_are_the_same_on_and_off(engine):
    member = engine.pool[1]
    prompts = ragged(member.cfg.vocab_size, seed=1)
    caps = [4, 1, 2, 3]
    texts = ["what is 2+2", "write a poem", "translate this"]
    padded, mask = pad_prompts(prompts, member.cfg), prompt_pad_mask(prompts, member.cfg)
    runs = []
    for on in (False, True):
        with installed() if on else contextlib.nullcontext():
            toks = lm_mod.greedy_generate(member.cfg, member.params, padded, 4, attn_mask=mask)
            outs, costs = engine.generate_member(1, prompts, max_new=4, max_new_per_req=caps)
            s_hat, c_hat = engine.score_texts(texts)
            choice = engine.choose(s_hat, c_hat)
        runs.append((toks, outs, costs, s_hat, c_hat, choice))
    (t0, o0, k0, s0, c0, ch0), (t1, o1, k1, s1, c1, ch1) = runs
    assert torch.equal(t0, t1)
    assert all(np.array_equal(a, b) for a, b in zip(o0, o1))
    assert np.array_equal(k0, k1) and np.array_equal(ch0, ch1)
    assert np.array_equal(s0, s1) and np.array_equal(c0, c1)


@pytest.mark.parametrize("max_new", [1, 4])
def test_generate_nests_pad_prefill_decode_steps_and_to_host(engine, max_new):
    prompts = ragged(engine.pool[0].cfg.vocab_size)
    with installed() as tracer:
        engine.generate_member(0, prompts, max_new=max_new)
    (gen,) = by_name(tracer, "generate")
    (pad,) = by_name(tracer, "pad")
    (prefill,) = by_name(tracer, "prefill")
    steps = by_name(tracer, "decode_step")
    (to_host,) = by_name(tracer, "to_host")
    assert len(steps) == max_new - 1
    assert [s[3]["i"] for s in steps] == list(range(max_new - 1))
    order = [pad, prefill, *steps, to_host]
    assert all(inside(s, gen) for s in order)
    assert all(end(a) <= b[1] for a, b in zip(order, order[1:]))
    assert prefill[3] == {"b": 4, "s": lm_mod.prefill_width(engine.pool[0].cfg, 9)}
    assert gen[3]["member"] == NAMES[0] and gen[3]["n"] == 4 and gen[3]["max_new"] == max_new
    events = tracer.recorder.events
    assert len(events) == len(host_spans(tracer))
    assert all(e[1] == host_trace.HOST_CAT and e[2] == "X" and e[6] is None and e[5] == 0
               for e in events)


def test_stepped_loop_records_its_steps_too(engine):
    """The loop given its steps (as the mesh's ``make_generate`` and a
    logit tap give them) records the same spans."""
    member = engine.pool[0]
    prompt = torch.from_numpy(ragged(member.cfg.vocab_size, lens=(6, 6))[0])[None].repeat(2, 1)
    with installed() as tracer:
        lm_mod.greedy_generate(member.cfg, member.params, prompt, 3,
                               prefill=functools.partial(lm_mod.apply_lm_prefill, member.cfg),
                               decode=functools.partial(lm_mod.apply_lm_decode, member.cfg))
    assert [e[0] for e in host_spans(tracer)] == ["prefill", "decode_step", "decode_step"]


@pytest.mark.parametrize("path", ["score_texts", "embed"])
def test_routing_spans_on_both_featurizer_paths(engine, path):
    texts = ["alpha", "beta", "gamma"]
    with installed() as tracer:
        if path == "score_texts":
            s_hat, c_hat = engine.score_texts(texts)
        else:
            s_hat, c_hat = engine.score_emb(engine.embed(texts))
        engine.choose(s_hat, c_hat)
    names = [e[0] for e in host_spans(tracer)]
    assert names == ["featurize", "score", "choose"]
    assert all(e[3] == {"n": 3} for e in host_spans(tracer))
    featurize, score, choose = host_spans(tracer)
    assert end(featurize) <= score[1] and end(score) <= choose[1]


def test_counters_equal_the_hand_count(engine):
    member = engine.pool[0]
    lens, caps, max_new = (3, 9, 5, 1), [1, 6, 2, 4], 4
    with installed() as tracer:
        engine.generate_member(0, ragged(member.cfg.vocab_size, lens), max_new=max_new,
                               max_new_per_req=caps)
        engine.generate_member(0, ragged(member.cfg.vocab_size, (2, 2)), max_new=2)
    width = lm_mod.prefill_width(member.cfg, 9)
    first = {"prefill_positions": 4 * width, "prefill_tokens": 18, "decode_row_steps": 12,
             # kept tokens per request: 1, 4, 2, 4 -> decode steps kept 0, 3, 1, 3
             "decode_row_steps_kept": 7}
    second = {"prefill_positions": 2 * lm_mod.prefill_width(member.cfg, 2),
              "prefill_tokens": 4, "decode_row_steps": 2, "decode_row_steps_kept": 2}
    gens = by_name(tracer, "generate")
    assert [{k: g[3][k] for k in COUNTS} for g in gens] == [first, second]
    assert [(g[3]["n"], g[3]["max_new"]) for g in gens] == [(4, 4), (2, 2)]


@pytest.mark.parametrize("lens,caps,max_new,want", [
    ((4,), (0,), 0, {"decode_row_steps": 0, "decode_row_steps_kept": 0}),
    ((4, 4), (1, 9), 1, {"prefill_tokens": 8, "decode_row_steps": 0,
                         "decode_row_steps_kept": 0}),
    ((1, 2, 3), (5, 5, 5), 5, {"prefill_positions": 3 * 8, "decode_row_steps": 12,
                               "decode_row_steps_kept": 12}),
])
def test_generate_counts_edges(lens, caps, max_new, want):
    got = generate_counts(lens, caps, max_new, width=8)
    assert {k: got[k] for k in want} == want


def test_stamps_land_on_the_real_time_clock(engine):
    before = time.time_ns()
    with installed() as tracer:
        engine.generate_member(0, ragged(engine.pool[0].cfg.vocab_size), max_new=3)
        engine.choose(*engine.score_texts(["x"]))
    after = time.time_ns()
    assert before <= tracer.anchor_ns <= after
    for _name, ts, dur, _args in host_spans(tracer):
        assert before <= tracer.wall_ns(ts) <= tracer.wall_ns(ts + dur) <= after


def _scheduler_trace(engine, recorder):
    sched = MicroBatchScheduler(engine, SchedulerConfig(score_batch=4, max_batch=3),
                                service_time=lambda kind, n, wall: 1e-3,
                                tracer=recorder.scoped(0))
    rng = np.random.default_rng(3)
    vocab = min(m.cfg.vocab_size for m in engine.pool)
    reqs = [Request(text=f"query {i}", prompt=rng.integers(0, vocab, size=2 + i % 5,
                                                           dtype=np.int32),
                    max_new=1 + i % 3, arrival_s=i * 1e-3) for i in range(10)]
    return sched.run_trace(reqs)


def test_scheduler_trace_bytes_are_the_same_with_the_host_tracer(engine):
    rec_off, rec_on = TraceRecorder(label="t"), TraceRecorder(label="t")
    summary_off = _scheduler_trace(engine, rec_off)
    with installed(rec_on) as tracer:
        summary_on = _scheduler_trace(engine, rec_on)
    assert summary_on["completed"] == summary_off["completed"] == 10
    assert rec_on.to_json() == rec_off.to_json()
    wall = [e for e in rec_on.chrome_trace(include_wall=True)["traceEvents"]
            if e.get("cat") == host_trace.HOST_CAT]
    assert {e["name"] for e in wall} >= {"featurize", "score", "choose", "generate", "pad",
                                         "prefill", "to_host"}
    assert sum(e[3]["n"] for e in by_name(tracer, "generate")) == 10
