"""The port's in-process serving fleet on the CPU, against the JAX reference.

The reference's transport cases (``tests/test_transport.py``: the codec,
trace-context frames, RPC telemetry, the local transport, fault injection,
partitions and leader election) are written out against the port's
``repro_torch.distributed`` with stub workers of this file's own; its
socket-transport and sharded-pool cases are in ``tests/test_torch_socket.py``.
Then the two packages are held to each other: the codec frames the
same payloads into the same bytes and each package decodes the other's
frames; ``tests/test_distributed.py``'s stub-member scenarios (replay-merge
determinism, stale-version rejection, crash and rejoin, the shared ledger)
run in both packages from one router carried across by the npz checkpoint
and agree exactly on every request's status, member and cost, on the
coordinator's stats, the versions and lambda, and within 1e-5 on the
leader's router params. Last, the serve entry point's in-process plane
(``--workers 3 --online`` with a crash and a rejoin) replays byte for byte,
and ``--transport socket`` refuses what the reference refuses.
"""
import contextlib
import dataclasses
import hashlib
import io
import json
import os

import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, st
from repro_torch.configs import get_smoke_config
from repro_torch.core.predictors import PREDICTORS
from repro_torch.core.router import PredictiveRouter
from repro_torch.distributed import Coordinator, SyncConfig, WorkerNode
from repro_torch.distributed import messages as M
from repro_torch.distributed.messages import Message, decode, encode
from repro_torch.distributed.transport import (
    FaultyTransport,
    LocalTransport,
    RpcStats,
    TransportError,
)
from repro_torch.obs import TraceRecorder, build_trace_doc, validate_span_tree
from repro_torch.online import OnlineAdapter, OnlineUpdateConfig
from repro_torch.serving.engine import RoutedEngine
from repro_torch.serving.queue import Request
from repro_torch.serving.scheduler import (
    MicroBatchScheduler, SchedulerConfig, SimClock, default_service_model,
)
from repro_torch.serving.telemetry import Telemetry

DQ, K, DM = 16, 2, 4
COSTS = (0.2, 1.0)
STUB_CFG = get_smoke_config("qwen3-0.6b")


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads while this file runs, so that parallel test
    workers do not each start one per core."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _text_emb(text: str) -> np.ndarray:
    h = int.from_bytes(hashlib.blake2s(text.encode(), digest_size=4).digest(),
                       "little")
    e = np.random.default_rng(h).normal(0, 1, DQ).astype(np.float32)
    return e / np.linalg.norm(e)


@dataclasses.dataclass
class StubEngine(RoutedEngine):
    """The port's RoutedEngine with a cheap deterministic embedder."""

    def embed(self, texts):
        return np.stack([_text_emb(t) for t in texts])


class StubGenMember:
    """Pool member whose generate is a constant-token stub; the port's
    engine pads by the member's config and reads a tensor back."""

    cfg = STUB_CFG

    def __init__(self, name, cost_rate):
        self.name, self.cost_rate = name, cost_rate

    def generate(self, prompts, max_new=8, attn_mask=None):
        return torch.zeros((int(prompts.shape[0]), max_new), dtype=torch.int32)


def _truth(text: str, member: int) -> float:
    h = int.from_bytes(
        hashlib.blake2s(f"{text}|{member}".encode(),
                        digest_size=4).digest(), "little")
    return (h % 1000) / 999.0


def make_router(seed=0):
    rng = np.random.default_rng(seed)
    memb = rng.random((K, DM)).astype(np.float32)
    qp = PREDICTORS["attn"].init(torch.Generator().manual_seed(seed), DQ, K, DM)
    cp = {"w": torch.zeros((DQ, K)), "b": torch.tensor(COSTS, dtype=torch.float32)}
    return PredictiveRouter("attn", "reg", qp, cp, memb, reward="R2")


def make_workers(n_workers=3, seed=0, router=None, update=None):
    """N port workers sharing one router lineage and the stub pool."""
    router = make_router(seed) if router is None else router
    pool = [StubGenMember(f"m{i}", c) for i, c in enumerate(COSTS)]
    workers = []
    for wid in range(n_workers):
        engine = StubEngine(router=router, pool=pool, lam=2.0, device="cpu")
        adapter = OnlineAdapter(
            engine, lambda req: _truth(req.text, req.member),
            config=update or OnlineUpdateConfig(min_buffer=8, batch_size=16),
            defer_updates=True, seed=seed + 7 * wid + 1)
        sched = MicroBatchScheduler(
            engine,
            SchedulerConfig(score_batch=8, max_batch=4, max_wait_s=0.005,
                            queue_capacity=64),
            clock=SimClock(), service_time=default_service_model(),
            adapter=adapter)
        workers.append(WorkerNode(wid, engine, sched, adapter))
    return workers


def feed_outcomes(worker, n=40, seed=0, now=0.0, request_cls=Request):
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        r = request_cls(text=f"direct {i}", prompt=np.zeros(1, np.int32))
        r.q_emb = rng.normal(0, 1, DQ).astype(np.float32)
        r.member = int(rng.integers(K))
        r.cost = COSTS[r.member]
        r.status = "done"
        reqs.append(r)
    worker.adapter.observe(reqs, now)


def roundtrip(payload, kind="PING"):
    msg = Message(kind=kind, dst=3, src=1, seq=42, payload=payload)
    return decode(encode(msg), device="cpu").payload


# ---------------------------------------------------------------------------
# Codec
# ---------------------------------------------------------------------------


class TestCodecRoundTrip:
    @settings(max_examples=40, deadline=None)
    @given(st.integers(-2**70, 2**70))
    def test_ints(self, n):
        assert roundtrip({"v": n})["v"] == n

    @settings(max_examples=40, deadline=None)
    @given(st.floats(-1e300, 1e300))
    def test_floats(self, x):
        got = roundtrip({"v": x})["v"]
        assert got == x and isinstance(got, float)

    @settings(max_examples=40, deadline=None)
    @given(st.text(max_size=40))
    def test_text(self, s):
        assert roundtrip({"v": s})["v"] == s

    @settings(max_examples=20, deadline=None)
    @given(st.lists(st.tuples(st.integers(-100, 100),
                              st.floats(-10.0, 10.0)),
                    max_size=6))
    def test_nested_containers(self, items):
        payload = {"items": items, "meta": {"n": len(items),
                                            "tags": ("a", "b")}}
        got = roundtrip(payload)
        assert got["items"] == items          # tuples stay tuples
        assert got["meta"] == {"n": len(items), "tags": ("a", "b")}

    def test_special_floats_and_bytes(self):
        p = roundtrip({"nan": float("nan"), "inf": float("inf"),
                       "ninf": float("-inf"), "blob": b"\x00\xffraw"})
        assert np.isnan(p["nan"])
        assert p["inf"] == float("inf") and p["ninf"] == float("-inf")
        assert p["blob"] == b"\x00\xffraw"

    def test_bool_none_set(self):
        p = roundtrip({"t": True, "f": False, "n": None, "s": {3, 1, 2}})
        assert p["t"] is True and p["f"] is False and p["n"] is None
        assert p["s"] == {1, 2, 3} and isinstance(p["s"], set)

    @pytest.mark.parametrize("arr", [
        np.arange(12, dtype=np.float32).reshape(3, 4) / 7,
        np.asarray([-2**40, 0, 2**40], np.int64),
        np.asarray([True, False, True]),
        np.asarray([np.nan, np.inf, -np.inf, 1.5], np.float64),
        np.zeros((0, 3), np.float32),
    ])
    def test_ndarray_exact(self, arr):
        got = roundtrip({"a": arr})["a"]
        assert got.dtype == arr.dtype and got.shape == arr.shape
        np.testing.assert_array_equal(got, arr)

    def test_non_contiguous_array_roundtrips(self):
        arr = np.arange(24, dtype=np.float32).reshape(4, 6)[:, ::2]
        np.testing.assert_array_equal(roundtrip({"a": arr})["a"], arr)

    def test_host_tensor_degrades_to_numpy(self):
        arr = torch.arange(6, dtype=torch.float32)
        got = roundtrip({"a": arr})["a"]
        assert isinstance(got, np.ndarray) and got.dtype == np.float32
        np.testing.assert_array_equal(got, np.arange(6, dtype=np.float32))

    def test_object_dtype_rejected(self):
        with pytest.raises(TypeError):
            encode(Message(kind="X", dst=0,
                           payload={"a": np.asarray([object()])}))

    def test_message_fields(self):
        msg = Message(kind=M.SYNC_STATUS, dst=2, src=7, seq=9000001,
                      reply_to=13, expect_reply=True, payload={"k": 1})
        got = decode(encode(msg))
        assert (got.kind, got.dst, got.src, got.seq) == \
            (M.SYNC_STATUS, 2, 7, 9000001)
        assert got.reply_to == 13 and got.expect_reply is True
        assert got.payload == {"k": 1}

    def test_bad_magic_rejected(self):
        buf = bytearray(encode(Message(kind="X", dst=0)))
        buf[0] ^= 0xFF
        with pytest.raises(ValueError):
            decode(bytes(buf))

    def test_version_mismatch_rejected(self):
        buf = bytearray(encode(Message(kind="X", dst=0)))
        buf[len(M.MAGIC)] = M.PROTOCOL_VERSION + 1
        with pytest.raises(ValueError):
            decode(bytes(buf))

    def test_truncated_frame_rejected(self):
        buf = encode(Message(kind="X", dst=0, payload={"a": 1}))
        with pytest.raises(ValueError):
            decode(buf[:-2])

    def test_router_adapter_roundtrip(self):
        router = make_router(4)
        got = roundtrip({"router": router})["router"]
        assert got.version == router.version
        assert got.quality_kind == router.quality_kind
        for k, v in router.quality_params.items():
            assert got.quality_params[k].dtype == v.dtype
            assert got.quality_params[k].device.type == "cpu"
            torch.testing.assert_close(got.quality_params[k], v, rtol=0, atol=0)
        np.testing.assert_array_equal(np.asarray(got.model_emb),
                                      np.asarray(router.model_emb))

    def test_request_adapter_roundtrip(self):
        r = Request(text="hello", prompt=np.arange(5, dtype=np.int32),
                    max_new=3, arrival_s=0.25)
        r.member, r.cost, r.status = 1, 0.5, "done"
        got = roundtrip({"req": r})["req"]
        assert got.text == "hello" and got.member == 1
        assert got.cost == 0.5 and got.status == "done"
        np.testing.assert_array_equal(got.prompt, r.prompt)

    def test_telemetry_adapter_roundtrip(self):
        tel = Telemetry(["m0", "m1"])
        got = roundtrip({"tel": tel})["tel"]
        assert isinstance(got, Telemetry)
        assert got.member_names == tel.member_names


class TestTraceContextFrames:
    """Protocol v2: frames optionally carry (trace_key, parent_span)."""

    def test_trace_context_roundtrip(self):
        msg = Message(kind=M.GENERATE, dst=1, src=0, seq=77,
                      trace_key=123, parent_span=4, payload={"x": 1})
        got = decode(encode(msg))
        assert got.trace_key == 123 and got.parent_span == 4
        assert got.payload == {"x": 1}

    def test_absent_trace_context_decodes_to_none(self):
        got = decode(encode(Message(kind=M.STEP, dst=1)))
        assert got.trace_key is None and got.parent_span is None

    def test_version_bumped_to_two(self):
        # The trace-context fields rode a frame version bump: a v1 peer
        # fails the version check up front instead of mis-parsing the new
        # fields. Simulated symmetrically — a v1 frame against this (v2)
        # decoder is the same fencing the old decoder applies to ours.
        assert M.PROTOCOL_VERSION == 2
        buf = bytearray(encode(Message(kind="X", dst=0, trace_key=5)))
        buf[len(M.MAGIC)] = 1
        with pytest.raises(ValueError):
            decode(bytes(buf))

    def test_rpc_span_kind_policy(self):
        # Real request/reply protocol legs trace; the hot NEXT_ACTION poll
        # and the obs drains themselves stay unspanned (they would dwarf
        # and recursively observe the traffic they measure).
        for kind in (M.GENERATE, M.STEP, M.SYNC_STATUS, M.LEDGER_OP,
                     M.ASSIGN, M.TICK, M.FINALIZE):
            assert kind in M.RPC_SPAN_KINDS
        for kind in (M.NEXT_ACTION, M.TRACE_REQ, M.TELEMETRY_REQ,
                     M.METRICS_REQ, M.HELLO, M.SHUTDOWN):
            assert kind not in M.RPC_SPAN_KINDS


class TestRpcTelemetry:
    def test_request_counts_latency_and_client_span(self):
        lt = LocalTransport()
        lt.bind(1, lambda msg: {"ok": 1})
        rec = TraceRecorder()
        lt.tracer = rec
        lt.now = 2.5
        lt.request(Message(kind=M.STEP, dst=1, payload={"t": 0.1}))
        s = lt.stats
        assert s.requests == {M.STEP: 1}
        assert s.peer_requests == {1: 1}
        assert s.in_flight == 0 and s.unreachable == 0
        assert s.latency[M.STEP].count == 1
        assert s.merged_latency().count == 1
        spans = [e for e in rec.events if e[0] == "rpc"]
        assert len(spans) == 1
        name, cat, ph, ts, dur, wid, key, args = spans[0]
        assert (cat, ph, wid, key) == ("rpc", "X", 0, None)
        assert ts == 2.5                      # virtual stamp, not wall
        assert args["side"] == "client" and args["peer"] == 1
        assert args["kind"] == M.STEP and args["rpc"] == 1

    def test_unspanned_kind_counts_but_emits_no_span(self):
        lt = LocalTransport()
        lt.bind(1, lambda msg: {})
        rec = TraceRecorder()
        lt.tracer = rec
        lt.request(Message(kind=M.NEXT_ACTION, dst=1))
        assert lt.stats.requests == {M.NEXT_ACTION: 1}
        assert not [e for e in rec.events if e[0] == "rpc"]

    def test_unreachable_failure_counted_no_span(self):
        lt = LocalTransport()
        rec = TraceRecorder()
        lt.tracer = rec
        with pytest.raises(TransportError):
            lt.request(Message(kind=M.STEP, dst=9))
        assert lt.stats.unreachable == 1
        assert lt.stats.requests == {}        # only completed RPCs count
        assert not rec.events                 # no span for a failed call

    def test_failure_classification(self):
        s = RpcStats()
        s.note_failure(TransportError("request to w1 timed out"))
        s.note_failure(TransportError("remote handler failed: boom"))
        s.note_failure(TransportError("no endpoint bound for wid 9"))
        assert (s.timeouts, s.errors, s.unreachable) == (1, 1, 1)

    def test_server_span_pairs_with_client_span(self):
        w = make_workers(1)[0]
        lt = LocalTransport()
        w.bind(lt)
        rec = TraceRecorder()
        lt.tracer = rec
        lt.trace_wid = 5                      # a distinct client process
        lt.now = 1.0
        w.scheduler.tracer = rec.scoped(0)
        lt.request(Message(kind=M.SYNC_STATUS, dst=0, src=5))
        spans = [e for e in rec.events if e[0] == "rpc"]
        sides = {e[7]["side"]: e for e in spans}
        assert set(sides) == {"client", "server"}
        assert sides["client"][7]["rpc"] == sides["server"][7]["rpc"]
        assert sides["client"][5] == 5 and sides["server"][5] == 0
        doc = build_trace_doc(rec.events)
        assert validate_span_tree(doc) == []

    def test_dangling_client_link_fails_validation(self):
        rec = TraceRecorder()
        rec.span("rpc", "rpc", 0.0, 0.1, wid=1,
                 args={"rpc": 99, "kind": M.STEP, "side": "client",
                       "peer": 0})
        errs = validate_span_tree(build_trace_doc(rec.events))
        assert errs and any("rpc" in e for e in errs)
        # An unmatched SERVER span is fine (the reply can be lost in
        # transit after the handler ran) — only client links must pair.
        rec2 = TraceRecorder()
        rec2.span("rpc", "rpc", 0.0, 0.1, wid=0,
                  args={"rpc": 99, "kind": M.STEP, "side": "server",
                        "peer": 1})
        assert validate_span_tree(build_trace_doc(rec2.events)) == []


# ---------------------------------------------------------------------------
# Local + faulty transports vs. version fencing
# ---------------------------------------------------------------------------


class TestLocalTransport:
    def test_request_reaches_bound_handler(self):
        lt = LocalTransport()
        lt.bind(1, lambda msg: {"echo": msg.payload["x"] + 1})
        rep = lt.request(Message(kind="PING", dst=1, payload={"x": 41}))
        assert rep.kind == M.ACK and rep.payload == {"echo": 42}

    def test_unbound_destination_raises(self):
        with pytest.raises(TransportError):
            LocalTransport().request(Message(kind="PING", dst=9))

    def test_handler_exception_propagates_raw(self):
        lt = LocalTransport()

        def boom(msg):
            raise KeyError("inner detail")

        lt.bind(0, boom)
        with pytest.raises(KeyError):
            lt.request(Message(kind="PING", dst=0))


class TestFaultInjection:
    def _bound_worker(self, **faults):
        w = make_workers(1)[0]
        ft = FaultyTransport(LocalTransport(), **faults)
        w.bind(ft)
        return w, ft

    def test_dropped_broadcasts_are_tolerated(self):
        w, ft = self._bound_worker(seed=0, drop=1.0)
        r2 = dataclasses.replace(w.engine.router, version=2)
        ft.send(Message(kind=M.ROUTER_BCAST, dst=0, payload={"router": r2}))
        assert ft.stats["dropped"] == 1
        assert w.router_version == 0          # lost, not applied
        # The reliable request path still works — and fencing lets a later
        # newer broadcast repair the miss.
        rep = ft.request(Message(kind=M.ROUTER_BCAST, dst=0,
                                 payload={"router": r2}))
        assert rep.payload["accepted"] and w.router_version == 2

    def test_duplicate_broadcast_applies_once(self):
        w, ft = self._bound_worker(seed=1, dup=1.0)
        r2 = dataclasses.replace(w.engine.router, version=2)
        ft.send(Message(kind=M.ROUTER_BCAST, dst=0, payload={"router": r2}))
        assert ft.stats["duplicated"] == 1
        assert w.router_version == 2
        assert w.swaps_accepted == 1 and w.swaps_rejected == 1

    def test_reordered_broadcasts_never_roll_back(self):
        for seed in range(6):                 # both flush orders occur
            w, ft = self._bound_worker(seed=seed, reorder=1.0)
            r1 = dataclasses.replace(w.engine.router, version=1)
            r2 = dataclasses.replace(w.engine.router, version=2)
            ft.send(Message(kind=M.ROUTER_BCAST, dst=0,
                            payload={"router": r1}))
            ft.send(Message(kind=M.ROUTER_BCAST, dst=0,
                            payload={"router": r2}))
            assert w.router_version == 0      # both held
            ft.flush()
            assert w.router_version == 2      # fencing beats delivery order


# ---------------------------------------------------------------------------
# Partition, converge repair, leader crash re-election
# ---------------------------------------------------------------------------


class PartitionedTransport(LocalTransport):
    """LocalTransport where a set of wids is unreachable."""

    def __init__(self):
        super().__init__()
        self.blocked = set()

    def _deliver(self, msg):
        if msg.dst in self.blocked:
            raise TransportError(f"w{msg.dst} partitioned")
        return super()._deliver(msg)


class TestPartitionAndElection:
    def _fleet(self, n=3, seed=0):
        workers = make_workers(n, seed=seed)
        pt = PartitionedTransport()
        for w in workers:
            w.bind(pt)
        coord = Coordinator(workers, SyncConfig(
            merge_per_worker=16, steps_per_sync=4, min_buffer=8, seed=seed),
            transport=pt)
        return workers, pt, coord

    def test_partition_during_sync_counts_unreachable(self):
        workers, pt, coord = self._fleet()
        for w in workers:
            feed_outcomes(w, n=30, seed=30 + w.wid)
        pt.blocked = {2}
        router = coord.sync_round(0.1)
        assert router is not None
        assert coord.stats["unreachable"] > 0
        assert workers[0].router_version == router.version
        assert workers[1].router_version == router.version
        assert workers[2].router_version == 0          # behind the wall

    def test_heal_then_converge_repairs_versions(self):
        workers, pt, coord = self._fleet()
        for w in workers:
            feed_outcomes(w, n=30, seed=30 + w.wid)
        pt.blocked = {2}
        router = coord.sync_round(0.1)
        pt.blocked = set()
        coord.converge()
        assert {w.router_version for w in workers} == {router.version}

    def test_converge_is_version_fenced(self):
        """catch_up on an already-current worker must not re-broadcast."""
        workers, pt, coord = self._fleet()
        for w in workers:
            feed_outcomes(w, n=30, seed=30 + w.wid)
        coord.sync_round(0.1)
        before = [(w.swaps_accepted, w.swaps_rejected) for w in workers]
        coord.converge()
        # Nobody re-receives the router they already hold.
        assert [(w.swaps_accepted, w.swaps_rejected)
                for w in workers] == before

    def test_leader_crash_reelection_and_fenced_catch_up(self):
        workers, pt, coord = self._fleet()
        for w in workers:
            feed_outcomes(w, n=30, seed=30 + w.wid)
        r1 = coord.sync_round(0.1)
        assert coord.leader is workers[0]
        # Leader crashes AND partitions away mid-run.
        workers[0].alive = False
        pt.blocked = {0}
        for w in workers[1:]:
            feed_outcomes(w, n=20, seed=90 + w.wid, now=0.2)
        r2 = coord.sync_round(0.2)
        assert r2 is not None and r2.version > r1.version
        assert coord.leader is workers[1]
        assert coord.stats["leader_changes"] >= 1
        assert workers[0].router_version == r1.version  # missed the epoch
        # Heal + catch up before marking alive (the plane's rejoin order:
        # the surviving leader is still authoritative while the returning
        # worker is down). The catch-up is version-fenced: it lands
        # exactly on the leader's version, and repeating it is a no-op.
        pt.blocked = set()
        coord.catch_up(workers[0])
        assert workers[0].router_version == r2.version
        before = (workers[0].swaps_accepted, workers[0].swaps_rejected)
        coord.catch_up(workers[0])
        assert (workers[0].swaps_accepted,
                workers[0].swaps_rejected) == before
        workers[0].alive = True
        assert coord.leader is workers[0]     # lowest alive id leads again


# ---------------------------------------------------------------------------
# Both packages: codec frames
# ---------------------------------------------------------------------------

from types import SimpleNamespace  # noqa: E402

import jax  # noqa: E402

from repro import checkpoint as jax_ckpt  # noqa: E402
from repro import distributed as jax_dist  # noqa: E402
from repro.core.predictors import PREDICTORS as JAX_PREDICTORS  # noqa: E402
from repro.core.router import PredictiveRouter as JaxRouter  # noqa: E402
from repro.distributed import messages as JM  # noqa: E402
from repro.online import OnlineAdapter as JaxAdapter  # noqa: E402
from repro.online import OnlineUpdateConfig as JaxUpdateConfig  # noqa: E402
from repro.serving import MicroBatchScheduler as JaxScheduler  # noqa: E402
from repro.serving import Request as JaxRequest  # noqa: E402
from repro.serving import RoutedEngine as JaxEngine  # noqa: E402
from repro.serving import SchedulerConfig as JaxSchedulerConfig  # noqa: E402
from repro.serving import TraceConfig as JaxTraceConfig  # noqa: E402
from repro.serving import default_service_model as jax_service_model  # noqa: E402
from repro.serving import make_trace as jax_make_trace  # noqa: E402
from repro.serving.scheduler import SimClock as JaxClock  # noqa: E402
from repro.serving.telemetry import Telemetry as JaxTelemetry  # noqa: E402
from repro_torch import distributed as port_dist  # noqa: E402
from repro_torch.checkpoint import load_router  # noqa: E402
from repro_torch.serving.traffic import TraceConfig, make_trace  # noqa: E402

VOCAB = 32


def _jax_router(seed=0):
    rng = np.random.default_rng(seed)
    memb = rng.random((K, DM)).astype(np.float32)
    qp = JAX_PREDICTORS["attn"].init(jax.random.key(seed), DQ, K, DM)
    cp = {"w": np.zeros((DQ, K), np.float32), "b": np.asarray(COSTS, np.float32)}
    return JaxRouter("attn", "reg", qp, cp, memb, reward="R2",
                     cost_scaler={"mu": np.asarray([0.1, 0.5]), "sd": np.asarray([1.0, 2.0])},
                     version=3, centroids=rng.standard_normal((5, DQ)).astype(np.float32))


@pytest.fixture(scope="module")
def routers(tmp_path_factory):
    """(reference router, the port's copy through the npz checkpoint, the
    reference's copy through the same checkpoint)."""
    jr = _jax_router(0)
    path = str(tmp_path_factory.mktemp("router") / "r.npz")
    jax_ckpt.save_router(path, jr)
    return jr, load_router(path, device="cpu"), jax_ckpt.load_router(path)


def _payloads(req_cls, tel_cls, router):
    r = req_cls(text="hello", prompt=np.arange(5, dtype=np.int32), max_new=3,
                arrival_s=0.25, deadline_s=0.5)
    r.member, r.cost, r.status = 1, 0.5, "done"
    r.rid = 7               # each package numbers its requests from its own counter
    r.q_emb = np.linspace(-1, 1, DQ).astype(np.float32)
    tel = tel_cls(["m0", "m1"])
    tel.record_lambda(0.1, 2.0)
    tel.record_queue_depth(0.2, 3)
    tel.routing_latency.record(1e-3)
    return [
        {"i": 7, "big": 2 ** 70, "neg": -3, "f": 0.1, "s": "héllo", "b": b"\x00\xff",
         "t": True, "n": None, "set": {3, 1, 2}, "tup": (1, 2.5, "x")},
        {"nested": [{"a": [1, (2, 3)], "b": {"c": [0.5, None]}}], "empty": []},
        {"arr": np.asarray([np.nan, np.inf, -np.inf, 1.5]), "i64": np.arange(4),
         "f32": np.arange(12, dtype=np.float32).reshape(3, 4)[:, ::2],
         "bool": np.asarray([True, False]), "z": np.zeros((0, 3), np.float32),
         "np_scalars": [np.float32(0.25), np.int64(5), np.bool_(True)]},
        {"req": r}, {"tel": tel}, {"router": router},
    ]


def _frame(mod, kind, payload, **kw):
    return mod.encode(mod.Message(kind=kind, dst=2, src=1, seq=11, payload=payload, **kw))


def test_frames_are_the_references_bytes_and_cross_decode(routers):
    _, pr, jr = routers
    ref = _payloads(JaxRequest, JaxTelemetry, jr)
    port = _payloads(Request, Telemetry, pr)
    for i, (a, b) in enumerate(zip(ref, port)):
        fa = _frame(JM, JM.ROUTER_BCAST, a, trace_key=i, parent_span=9)
        fb = _frame(M, M.ROUTER_BCAST, b, trace_key=i, parent_span=9)
        assert fa == fb, f"payload {i}"
        got_port = decode(fa, device="cpu")      # the reference's frame, the port's decoder
        got_ref = JM.decode(fb)
        assert (got_port.trace_key, got_port.parent_span) == (i, 9)
        assert encode(got_port) == fa
        assert JM.encode(got_ref) == fb
    got = decode(_frame(JM, JM.ROUTER_BCAST, {"router": jr}), device="cpu").payload["router"]
    assert type(got) is PredictiveRouter and got.version == 3
    for k, v in got.quality_params.items():
        assert v.dtype == torch.float32
        np.testing.assert_array_equal(v.numpy(), np.asarray(jr.quality_params[k]))
    assert got.cost_scaler["mu"].dtype == np.float64
    back = JM.decode(_frame(M, M.ROUTER_BCAST, {"router": pr})).payload["router"]
    assert type(back) is JaxRouter
    np.testing.assert_array_equal(np.asarray(back.quality_params["wq"]),
                                  pr.quality_params["wq"].numpy())
    tel = decode(_frame(JM, JM.TELEMETRY_REQ, {"t": ref[4]["tel"]})).payload["t"]
    assert type(tel) is Telemetry and tel.lam_trace.n_seen == 1


def test_decoding_a_router_needs_a_device_without_a_card(routers, monkeypatch):
    """A router frame lands on the card unless a device is named: with no
    card, decoding it without one raises; frames without a router decode."""
    frame = _frame(M, M.ROUTER_BCAST, {"router": routers[1]})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        decode(frame)
    assert decode(_frame(M, M.STEP, {"t": 0.5})).payload == {"t": 0.5}
    assert decode(frame, device="cpu").payload["router"].device.type == "cpu"


# ---------------------------------------------------------------------------
# Both packages: test_distributed.py's stub-member scenarios
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class JaxStubEngine(JaxEngine):
    def embed(self, texts):
        return np.stack([_text_emb(t) for t in texts])


class JaxStubMember:
    def __init__(self, name, cost_rate):
        self.name, self.cost_rate = name, cost_rate

    def generate(self, prompts, max_new=8, attn_mask=None):
        return np.zeros((int(np.asarray(prompts).shape[0]), max_new), np.int32)


REF = SimpleNamespace(
    dist=jax_dist, Engine=lambda router, pool: JaxStubEngine(router=router, pool=pool,
                                                             lam=2.0),
    Member=JaxStubMember, Adapter=JaxAdapter, UpdateConfig=JaxUpdateConfig,
    Scheduler=JaxScheduler, SchedulerConfig=JaxSchedulerConfig, Clock=JaxClock,
    service_model=jax_service_model, Request=JaxRequest, TraceConfig=JaxTraceConfig,
    make_trace=jax_make_trace)
PORT = SimpleNamespace(
    dist=port_dist, Engine=lambda router, pool: StubEngine(router=router, pool=pool,
                                                           lam=2.0, device="cpu"),
    Member=StubGenMember, Adapter=OnlineAdapter, UpdateConfig=OnlineUpdateConfig,
    Scheduler=MicroBatchScheduler, SchedulerConfig=SchedulerConfig, Clock=SimClock,
    service_model=default_service_model, Request=Request, TraceConfig=TraceConfig,
    make_trace=make_trace)


def _fleet(pkg, router, n_workers=3, seed=0):
    """``tests/test_distributed.py::make_workers`` on ``pkg``'s classes."""
    pool = [pkg.Member(f"m{i}", c) for i, c in enumerate(COSTS)]
    workers = []
    for wid in range(n_workers):
        engine = pkg.Engine(router, pool)
        adapter = pkg.Adapter(
            engine, lambda req: _truth(req.text, req.member),
            config=pkg.UpdateConfig(min_buffer=8, batch_size=16),
            defer_updates=True, seed=seed + 7 * wid + 1)
        sched = pkg.Scheduler(
            engine, pkg.SchedulerConfig(score_batch=8, max_batch=4, max_wait_s=0.005,
                                        queue_capacity=64),
            clock=pkg.Clock(), service_time=pkg.service_model(), adapter=adapter)
        workers.append(pkg.dist.WorkerNode(wid, engine, sched, adapter))
    return workers


def _trace(pkg, n=60, seed=0):
    return pkg.make_trace(
        pkg.TraceConfig(kind="poisson", n_requests=n, rate=2000.0, seed=seed, max_new=2,
                        prompt_len_min=4, prompt_len_max=12, vocab=VOCAB),
        texts=[f"query number {i} about topic {i % 7}" for i in range(40)])


def _params(router):
    return {k: np.asarray(v.detach().numpy() if isinstance(v, torch.Tensor) else v)
            for part in ("quality_params", "cost_params")
            for k, v in ((part + "/" + k, v) for k, v in getattr(router, part).items())}


def _plane_run(pkg, router, events, budget=None):
    workers = _fleet(pkg, router)
    ledger = None
    if budget is not None:
        ledger = pkg.dist.SharedBudgetLedger(budget, 0.1, lam0=2.0)
        for w in workers:
            w.scheduler.governor = ledger
            w.adapter.governor = ledger
    coord = pkg.dist.Coordinator(workers, pkg.dist.SyncConfig(
        sync_every_s=0.004, merge_per_worker=16, steps_per_sync=2, min_buffer=8, seed=0))
    plane = pkg.dist.ServingPlane(
        workers, coord, events=[pkg.dist.PlaneEvent(*e) for e in events])
    trace = _trace(pkg)
    summary = plane.run_trace(trace)
    return {"requests": [(r.rid - trace[0].rid, r.status, r.member, r.cost, r.leg)
                         for r in trace],
            "stats": dict(coord.stats), "reassigned": plane.reassigned,
            "versions": {w.wid: (w.router_version, w.alive, w.crashes, w.swaps_accepted,
                                 w.swaps_rejected) for w in workers},
            "completed": summary["completed"],
            "per_worker": summary["per_worker_completed"],
            "lam": None if ledger is None else (ledger.lam, ledger.throttled,
                                                ledger.summary(1.0)["total_spend"]),
            "leader": _params(coord.leader.engine.router)}


def _agree(port, ref):
    leader_p, leader_r = port.pop("leader"), ref.pop("leader")
    assert port == ref
    assert leader_p.keys() == leader_r.keys()
    for k in leader_r:
        np.testing.assert_allclose(leader_p[k], leader_r[k], rtol=0, atol=1e-5, err_msg=k)


SCENARIOS = {
    "steady": [],
    "crash": [(0.008, "crash", 1)],
    "crash-rejoin": [(0.006, "crash", 1), (0.02, "rejoin", 1)],
    "leader-crash": [(0.006, "crash", 0), (0.025, "rejoin", 0)],
}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_plane_scenario_agrees_with_the_reference(scenario, routers):
    jr, pr, _ = routers
    ref = _plane_run(REF, jr, SCENARIOS[scenario])
    port = _plane_run(PORT, pr, SCENARIOS[scenario])
    assert port["completed"] == 60 and port["stats"]["updates"] > 0
    if SCENARIOS[scenario]:
        assert port["reassigned"] > 0
    if scenario == "leader-crash":
        assert port["stats"]["leader_changes"] >= 1
    alive = {v[0] for v in port["versions"].values() if v[1]}
    assert len(alive) == 1 and port["stats"]["stale_rejected"] == 0
    _agree(port, ref)


def test_shared_ledger_plane_agrees_with_the_reference(routers):
    jr, pr, _ = routers
    events = [(0.006, "crash", 2), (0.02, "rejoin", 2)]
    ref = _plane_run(REF, jr, events, budget=0.5)
    port = _plane_run(PORT, pr, events, budget=0.5)
    lam, throttled, spend = port["lam"]
    assert lam < 2.0 and throttled > 0 and spend > 0
    _agree(port, ref)


def _merge_run(pkg, router, request_cls):
    workers = _fleet(pkg, router, seed=5)
    for w in workers:
        feed_outcomes(w, n=30, seed=50 + w.wid, request_cls=request_cls)
    coord = pkg.dist.Coordinator(workers, pkg.dist.SyncConfig(
        merge_per_worker=16, steps_per_sync=4, min_buffer=8, seed=5))
    r1 = coord.sync_round(1.0)
    for w in workers:
        feed_outcomes(w, n=10, seed=90 + w.wid, now=1.5, request_cls=request_cls)
    r2 = coord.sync_round(2.0)
    stale = [workers[1].publish(r1), workers[1].publish(router)]
    buf = coord.merge_replay
    merged = [(q.tobytes(), m, s, c, t) for (q, m, s, c, t)
              in list(buf._recent) + buf._reservoir]
    return {"merged": merged, "versions": (r1.version, r2.version,
                                           [w.router_version for w in workers]),
            "stale": stale, "stats": dict(coord.stats), "leader": _params(r2)}


def test_replay_merge_and_stale_rejection_agree_with_the_reference(routers):
    jr, pr, _ = routers
    ref = _merge_run(REF, jr, JaxRequest)
    port = _merge_run(PORT, pr, Request)
    assert port["stale"] == [False, False] and port["versions"][1] > port["versions"][0]
    _agree(port, ref)
    assert _merge_run(PORT, pr, Request)["merged"] == port["merged"]


# ---------------------------------------------------------------------------
# The serve entry point's in-process plane
# ---------------------------------------------------------------------------

from repro_torch.checkpoint import save_router  # noqa: E402
from repro_torch.launch import serve  # noqa: E402

PLANE_FLAGS = ["--smoke", "--device", "cpu", "--trace", "drift", "--online",
               "--workers", "3", "--requests", "48", "--max-new", "2",
               "--sync-every", "0.02", "--crash-at", "0.04", "--rejoin-at", "0.09",
               "--budget", "0.0001", "--budget-window", "0.25"]


def _serve_plane(router_path, out_dir):
    os.makedirs(out_dir)
    trace_out, metrics_out = (os.path.join(out_dir, n) for n in ("t.json", "m.json"))
    stdout = io.StringIO()
    with contextlib.redirect_stdout(stdout):
        summary_lines = serve.main([*PLANE_FLAGS, "--router", router_path,
                                    "--trace-out", trace_out, "--metrics-out", metrics_out])
    assert summary_lines == 0
    return stdout.getvalue().splitlines(), {
        n: open(os.path.join(out_dir, n), "rb").read() for n in ("t.json", "m.json")}


def test_serve_plane_replays_byte_identically(tmp_path):
    """``--workers 3 --online`` with a crash and a rejoin, on the smoke
    default pool, twice from one seed: the same trace and metrics bytes,
    every worker up on one router version, requests reassigned, the shared
    ledger's lambda tightened and the rpc spans paired."""
    path = str(tmp_path / "router.npz")
    save_router(path, serve.init_router(3, seed=0, device="cpu"),
                pool_names=serve.DEFAULT_POOL.split(","))
    lines, out_a = _serve_plane(path, str(tmp_path / "a"))
    _, out_b = _serve_plane(path, str(tmp_path / "b"))
    assert out_a == out_b
    plane = next(x for x in lines if x.startswith("plane: "))
    assert plane.startswith("plane: 3/3 workers up"), plane
    versions = {v.split(":")[1] for v in plane.split("versions ")[1].split("  ")[0].split()}
    assert len(versions) == 1 and versions != {"v0"}, plane
    assert int(plane.split("reassigned ")[1].split()[0]) > 0, plane
    coord = next(x for x in lines if x.startswith("coordinator: "))
    assert "(stale rejected 0)" in coord and "updates 0 " not in coord, coord
    budget = next(x for x in lines if x.startswith("shared budget "))
    lam = float(budget.split("final lambda ")[1].split()[0])
    assert lam < 1.0, budget
    doc = json.loads(out_a["t.json"])
    assert validate_span_tree(doc) == []
    rpc = [e for e in doc["traceEvents"] if e.get("cat") == "rpc"]
    assert {e["args"]["side"] for e in rpc} == {"client", "server"}
    assert {e["pid"] for e in doc["traceEvents"]} == {0, 1, 2}
    metrics = json.loads(out_a["m.json"])
    assert sum(v["value"] for k, v in metrics.items()
               if k.startswith("requests_completed_total")) == 48


def test_socket_transport_raises(capsys):
    """The serve entry point refuses what the reference's refuses with
    ``--transport socket``, before it builds anything: one worker, and a
    crash of worker 0 (the controller and leader)."""
    for flags, why in ((["--workers", "1"], "needs --workers >= 2"),
                       (["--workers", "2", "--crash-at", "0.1", "--crash-worker", "0"],
                        "crash a follower")):
        with pytest.raises(SystemExit) as exc:
            serve.main(["--smoke", "--device", "cpu", "--trace", "drift", "--transport",
                        "socket", *flags])
        assert exc.value.code == 2
        assert why in capsys.readouterr().err
