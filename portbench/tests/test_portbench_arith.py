"""The tail, rate and trace arithmetic on hand-made records."""
import math
from types import SimpleNamespace

import pytest

from portbench import roofline, serving
from portbench.common import load_reader, quantile, sub_seed
from portbench.trace import DeviceTrace


def _req(due, start, finish, member=0):
    return SimpleNamespace(arrival_s=due, service_start_s=start, finish_s=finish, member=member,
                           output=None, status="done")


def test_quantile_interpolates_over_all_values():
    xs = list(range(1, 101))
    assert quantile(xs, 0.5) == pytest.approx(50.5)
    assert quantile(xs, 0.95) == pytest.approx(95.05)
    assert quantile([3.0], 0.95) == 3.0
    assert math.isnan(quantile([], 0.5))


def test_a_stall_inside_the_window_counts_from_due_time():
    # Requests due every 0.1 s; the system stalls from 1.0 s to 3.0 s, so
    # each request due in the stall is served at 3.0 s and pays the wait.
    reqs = []
    for i in range(40):
        due = 0.1 * i
        start = max(due, 3.0) if 1.0 <= due < 3.0 else due
        reqs.append(_req(due, start, start + 0.05))
    lat = serving.latencies_ms(reqs)
    assert len(lat) == 40
    assert max(lat) == pytest.approx(2050.0)
    assert quantile(lat, 0.5) == pytest.approx(quantile([r.finish_s * 1e3 - r.arrival_s * 1e3
                                                         for r in reqs], 0.5))
    assert quantile(lat, 0.95) > 1500.0


def test_unfinished_requests_are_left_out_of_the_latencies():
    reqs = [_req(0.0, 0.1, 0.2), _req(0.0, math.nan, math.nan)]
    assert serving.latencies_ms(reqs) == [pytest.approx(200.0)]


def test_tokens_per_s_ends_at_the_first_completion_after_the_window():
    spans = [{"name": "generate_member", "t0": t - 1.0, "t1": t, "delivered": [4, 32]}
             for t in (2.0, 4.0, 9.5, 10.5, 12.0)]
    spans.append({"name": "score_texts", "t0": 0.0, "t1": 0.1, "n": 2})
    assert serving.window_end(spans, 10.0) == 10.5
    assert serving.tokens_per_s(spans, 10.0) == pytest.approx(4 * 36 / 10.5)
    # A stall past the window: the window stretches to the late call.
    assert serving.tokens_per_s(spans[:2], 3.0) == pytest.approx(2 * 36 / 4.0)


def test_sub_seeds_take_any_whole_number():
    for s in (0, 1, 2**31 + 5, 2**64 + 3, -7):
        assert 0 <= sub_seed(s, 1, 2) < 2**63
    assert sub_seed(5, 1) != sub_seed(5, 2) and sub_seed(5, 1) == sub_seed(5, 1)


def _trace():
    tr = DeviceTrace()
    tr.window = (0, 1000)
    tr.kernels = [("gemm", 100, 300), ("gemm", 250, 400), ("router_xattn_kernel<float>", 600, 610),
                  ("copy", 990, 1200)]
    tr.ranges = [("pb:generate_member", 50, 450), ("pb:wait", 450, 590),
                 ("pb:score_texts", 590, 700), ("pb:dispatch", 40, 980)]
    return tr


def test_busy_is_the_union_of_device_intervals_inside_the_slice():
    tr = _trace()
    assert tr.busy_intervals() == [(100, 400), (600, 610), (990, 1000)]
    assert tr.busy_s() == pytest.approx(320e-9)
    assert tr.window_s() == pytest.approx(1e-6)
    assert load_reader("idle_share.backlog")({"trace": tr}) == pytest.approx(68.0)


def test_idle_gaps_are_named_by_the_innermost_host_range():
    # Gaps (0, 100), (400, 600), (610, 990), named at their midpoints.
    gaps = dict(_trace().idle_gaps())
    assert gaps == pytest.approx({"generate_member": 100e-9, "wait": 200e-9, "dispatch": 380e-9})


def test_router_roofline_reads_one_launch_per_traced_scoring_call():
    import torch
    tr = _trace()
    router = {"quality": {"wq": torch.zeros(768, 20), "wo": torch.zeros(20, 3)}}
    spans = [{"name": "score_texts", "n": 64, "traced": True, "t0": 0, "t1": 1}]
    got = load_reader("router_xattn_roofline")({"trace": tr, "spans": spans, "router": router})
    least = roofline.router_xattn_least_s(64, 768, 20, 3)
    assert got == pytest.approx(100.0 * least / 10e-9)
    # A launch the spans cannot account for: nothing is read.
    assert load_reader("router_xattn_roofline")({"trace": tr, "spans": spans * 2,
                                                 "router": router}) is None


def test_routing_ms_per_request_reads_the_wrappers_routing_spans():
    spans = [{"name": "score_texts", "n": 4, "t0": 0.0, "t1": 0.010},
             {"name": "choose", "n": 4, "t0": 0.010, "t1": 0.012},
             {"name": "generate_member", "n": 4, "t0": 0.012, "t1": 1.0}]
    assert load_reader("route_ms_per_req.backlog")({"spans": spans}) == pytest.approx(3.0)
    assert load_reader("route_ms_per_req.backlog")({"spans": spans[2:]}) is None


def test_flop_counts():
    m = {"d_model": 8, "n_heads": 2, "n_kv_heads": 1, "head_dim": 4, "d_ff": 16,
         "n_layers": 2, "vocab_size": 10}
    per_tok = 2 * (8 * 8 * 2 + 8 * 4 * 2 + 3 * 8 * 16) + 8 * 10
    assert roofline.matmul_params_per_token(m) == per_tok
    # Positions 0..2 see 1, 2, 3 keys.
    assert roofline.attention_flops(m, 0, 3) == 4.0 * 6 * 4 * 2 * 2
    assert roofline.generate_flops(m, 3, 1) == 2.0 * per_tok * 3 + roofline.attention_flops(m, 0, 3)
    assert roofline.train_flops(m, [3]) == 3 * roofline.generate_flops(m, 3, 1)
    moe = dict(m, n_experts=4, top_k=2, d_ff_expert=6)
    assert roofline.matmul_params_per_token(moe) == per_tok - 2 * 3 * 8 * 16 + 2 * (8 * 4 + 2 * 3 * 8 * 6)
