"""The program's host spans on the harness's clocks, the five readers of
them on hand-made contexts with hand-computed values, and a serving window
with the host tracer installed (``portbench/host_window.py``) at smoke
size."""
import time

import numpy as np
import pytest

from portbench import host_spans
from portbench.common import load_reader
from portbench.trace import DeviceTrace

READERS = tuple(host_spans.READERS)


def _span(name, t0, t1, **args):
    return dict(args, name=name, t0=t0, t1=t1, ns0=int(t0 * 1e9), ns1=int(t1 * 1e9))


def _trace(window, kernels=(), ranges=()):
    tr = DeviceTrace()
    tr.window, tr.kernels, tr.ranges = window, list(kernels), list(ranges)
    return tr


def test_program_spans_land_on_both_clocks():
    from repro_torch.obs import TraceRecorder
    from repro_torch.obs.host_trace import HostTracer
    ns_a = time.time_ns()
    tracer = HostTracer(TraceRecorder())
    tracer.span("before", tracer.now())       # begins before log_t0: dropped
    log_t0 = time.perf_counter()
    perf_a = time.perf_counter()
    t = tracer.now()
    time.sleep(0.002)
    tracer.span("decode_step", t, {"i": 3})
    perf_b, ns_b = time.perf_counter(), time.time_ns()
    (s,) = host_spans.program_spans(tracer, log_t0)
    assert s["name"] == "decode_step" and s["i"] == 3
    assert perf_a - log_t0 - 1e-6 <= s["t0"] < s["t1"] <= perf_b - log_t0 + 1e-6
    assert s["t1"] - s["t0"] >= 0.002
    assert ns_a <= s["ns0"] < s["ns1"] <= ns_b
    assert s["ns1"] - s["ns0"] == pytest.approx((s["t1"] - s["t0"]) * 1e9, abs=2)
    tr = _trace((ns_a, ns_b))
    ctx = {}
    host_spans.attach(ctx, tr, tracer, log_t0)
    assert ctx["program_spans"] == [s] and tr.ranges == [("pb:decode_step", s["ns0"], s["ns1"])]


def test_readers_on_the_programs_own_spans():
    """A ragged generate call on the smoke member and a routing pass,
    traced, read back through the readers."""
    from repro_torch.launch import serve
    from repro_torch.models import lm as lm_mod
    from repro_torch.serving.engine import RoutedEngine
    pool = serve.build_pool(["qwen3-0.6b"], smoke=True, device="cpu")
    engine = RoutedEngine(router=serve.init_router(1, device="cpu"), pool=pool, device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 100, size=n).astype(np.int32) for n in (2, 7, 3)]
    log_t0 = time.perf_counter()
    tracer = host_spans.open_window()
    try:
        engine.generate_member(0, prompts, max_new=5, max_new_per_req=[5, 1, 2])
        engine.score_texts(["a", "b", "c", "d"])
    finally:
        host_spans.close_window()
    ctx = {"program_spans": host_spans.program_spans(tracer, log_t0), "trace": None,
           "window_end_s": time.perf_counter() - log_t0 + 1.0}
    width = lm_mod.prefill_width(pool[0].cfg, 7)
    read = {name: load_reader(name)(ctx) for name in READERS}
    assert read["prefill_pad_share.backlog"] == pytest.approx(100 * (1 - 12 / (3 * width)))
    # 3 rows x 4 steps; kept 4 + 0 + 1
    assert read["decode_waste_share.backlog"] == pytest.approx(100 * (1 - 5 / 12))
    assert read["decode_ms_per_step.backlog"] > 0 and read["featurize_ms_per_req.backlog"] > 0
    assert read["decode_idle_share.backlog"] is None
    (gen,) = host_spans.done(ctx, "generate")
    assert (gen["member"], gen["n"], gen["max_new"]) == ("qwen3-0.6b", 3, 5)


def test_pad_and_waste_shares_sum_over_calls_done_by_the_window_end():
    ctx = {"window_end_s": 10.0, "trace": None, "program_spans": [
        _span("generate", 1.0, 2.0, prefill_positions=100, prefill_tokens=20,
              decode_row_steps=30, decode_row_steps_kept=10),
        _span("generate", 3.0, 4.0, prefill_positions=200, prefill_tokens=80,
              decode_row_steps=10, decode_row_steps_kept=10),
        _span("generate", 9.5, 10.5, prefill_positions=900, prefill_tokens=900,
              decode_row_steps=50, decode_row_steps_kept=50),
        _span("pad", 1.0, 1.1)]}
    assert load_reader("prefill_pad_share.backlog")(ctx) == pytest.approx(100 * (1 - 100 / 300))
    assert load_reader("decode_waste_share.backlog")(ctx) == pytest.approx(50.0)


def test_featurize_ms_per_request():
    ctx = {"window_end_s": 10.0, "trace": None, "program_spans": [
        _span("featurize", 1.0, 1.002, n=4), _span("featurize", 2.0, 2.006, n=4),
        _span("score", 2.006, 2.5, n=4), _span("featurize", 9.9, 10.1, n=128)]}
    assert load_reader("featurize_ms_per_req.backlog")(ctx) == pytest.approx(1.0)


def test_decode_steps_after_the_traced_slice():
    spans = [_span("decode_step", 0.5, 0.6), _span("decode_step", 2.0, 2.04),
             _span("decode_step", 3.0, 3.06), _span("decode_step", 9.0, 11.0)]
    read = load_reader("decode_ms_per_step.backlog")
    ctx = {"window_end_s": 10.0, "program_spans": spans,
           "trace": _trace((0, int(1e9)))}
    assert read(ctx) == pytest.approx(50.0)
    assert read(dict(ctx, trace=None)) == pytest.approx(1e3 * (0.1 + 0.04 + 0.06) / 3)


def test_decode_idle_share_reads_the_gaps_decode_steps_name():
    tr = _trace((0, 1000), kernels=[("k", 0, 100), ("k", 300, 400), ("k", 900, 1000)],
                ranges=[("pb:generate_member", 40, 960), ("pb:generate", 50, 950),
                        ("pb:decode_step", 100, 300), ("pb:decode_step", 400, 600),
                        ("pb:to_host", 600, 900)])
    # Gaps (100, 300) and (400, 900): midpoints 200 (decode_step), 650 (to_host).
    assert load_reader("decode_idle_share.backlog")({"trace": tr}) == pytest.approx(20.0)
    assert dict(tr.idle_gaps()) == pytest.approx({"decode_step": 2e-7, "to_host": 5e-7})


@pytest.mark.parametrize("name", READERS)
def test_none_when_the_run_recorded_no_program_spans(name):
    tr = _trace((0, 1000), kernels=[("k", 0, 500)], ranges=[("pb:generate_member", 0, 1000)])
    for ctx in ({"trace": tr, "window_end_s": 1.0, "spans": []},
                {"trace": tr, "window_end_s": 1.0, "program_spans": []},
                {"trace": None, "window_end_s": 1.0,
                 "program_spans": [_span("dispatch", 0.1, 0.2)]}):
        assert load_reader(name)(ctx) is None


def test_a_serving_window_with_the_host_tracer_reads_the_programs_spans():
    """``host_window.window`` at smoke size on the CPU, untraced: the
    readers of the counters and the host spans read, the one that needs a
    device trace reads nothing, the window stays correct, and the tracer is
    removed afterwards."""
    from portbench import host_window
    from portbench.tests.smoke import smoke_cell
    from repro_torch.models import trace_hook
    out = host_window.window(smoke_cell("pool3.backlog"), 3_300_000_001, 1.5, False,
                             device="cpu", smoke=True)
    assert trace_hook.TRACER is None
    assert out["correct"] and out["attempted"] > 0
    assert set(out["metrics"]) == set(READERS) - {"decode_idle_share.backlog"}
    assert 0 < out["metrics"]["prefill_pad_share.backlog"] < 100
    assert 0 <= out["metrics"]["decode_waste_share.backlog"] < 100
    assert out["metrics"]["decode_ms_per_step.backlog"] > 0
