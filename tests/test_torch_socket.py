"""The port's socket fleet on the CPU, against the JAX reference.

The reference's socket-transport cases (``tests/test_transport.py``:
``TestSocketTransport``) and sharded-pool cases (``TestPoolDispatch``) are
written out against the port's ``SocketTransport``, ``owner_of``,
``owned_members`` and ``PoolDispatcher``; the two packages' transports talk
to each other over real sockets (either package's controller with the
other's followers: HELLO/ACK, a nested follower-to-follower call, an
application error, SHUTDOWN); a pool built for one owner holds the full
build's bits for its members and trains the full pool's router; the
controller-side ``RemoteWorkerProxy`` mirrors a worker and falls back to
its cache, and ``drain_local`` serves a follower's backlog after the
controller is lost. Last, the serve entry point runs the same seeded fleet
over both transports (``--workers 2 --online``, a crash and a rejoin, one
shared ledger): the rollups are equal, the socket run spans two OS
processes, and each follower's router digest equals the controller's. The
four scheduler and trace flags the port took from the reference reach the
scheduler and the trace as the reference's do.
"""
import dataclasses
import json
import re
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.common.tree import flatten_with_paths
from repro_torch.configs import get_smoke_config
from repro_torch.core.predictors import PREDICTORS
from repro_torch.core.router import PredictiveRouter
from repro_torch.data.routerbench import generate
from repro_torch.distributed import WorkerNode
from repro_torch.distributed import messages as M
from repro_torch.distributed import transport as port_transport
from repro_torch.distributed.host import RemoteWorkerProxy, drain_local
from repro_torch.distributed.messages import Message, router_digest
from repro_torch.distributed.shard import (
    PoolDispatcher, owned_members, owner_of, pool_param_bytes, shard_pool,
)
from repro_torch.distributed.transport import (
    LocalTransport, SocketTransport, TransportError,
)
from repro_torch.launch import serve
from repro_torch.obs import validate_chrome_trace, validate_span_tree
from repro_torch.serving.engine import RoutedEngine
from repro_torch.serving.queue import Request
from repro_torch.serving.scheduler import (
    MicroBatchScheduler, SchedulerConfig, SimClock, default_service_model,
)

from repro.distributed import messages as JM
from repro.distributed import shard as jax_shard
from repro.distributed import transport as jax_transport
from repro.launch import serve as jax_serve
from repro.serving import TraceConfig as JaxTraceConfig
from repro.serving import make_trace as jax_make_trace

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


# ---------------------------------------------------------------------------
# Stub workers (cheap embedder, token stubs that depend on the prompt)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class StubEngine(RoutedEngine):
    """The port's RoutedEngine with a cheap deterministic embedder; with
    ``target`` set every request routes to that member."""

    target: int = -1

    def embed(self, texts):
        rng = np.random.default_rng(len(texts))
        e = rng.normal(0, 1, (len(texts), DQ)).astype(np.float32)
        return e / np.linalg.norm(e, axis=1, keepdims=True)

    def score_texts(self, texts):
        return self._scores(self.embed(texts))

    def choose(self, s_hat, c_hat, lam=None):
        if self.target >= 0:
            return np.full(len(s_hat), self.target)
        return super().choose(s_hat, c_hat, lam)


class StubGenMember:
    """Pool member whose tokens are the padded prompt's row sum plus the
    step (mod 97), so a remote generate's rows can be told apart."""

    cfg = STUB_CFG

    def __init__(self, name, cost_rate):
        self.name, self.cost_rate = name, cost_rate

    def generate(self, prompts, max_new=8, attn_mask=None):
        base = prompts.to(torch.int64).sum(dim=1, keepdim=True)
        return ((base + torch.arange(max_new)) % 97).to(torch.int32)


def make_router(seed=0, version=0):
    rng = np.random.default_rng(seed)
    memb = rng.random((K, DM)).astype(np.float32)
    qp = PREDICTORS["attn"].init(torch.Generator().manual_seed(seed), DQ, K, DM)
    cp = {"w": torch.zeros((DQ, K)), "b": torch.tensor(COSTS, dtype=torch.float32)}
    return PredictiveRouter("attn", "reg", qp, cp, memb, reward="R2", version=version)


def stub_worker(wid, target=-1, router=None):
    engine = StubEngine(router=router or make_router(), lam=2.0, device="cpu",
                        pool=[StubGenMember(f"m{i}", c) for i, c in enumerate(COSTS)],
                        target=target)
    sched = MicroBatchScheduler(
        engine, SchedulerConfig(score_batch=8, max_batch=4, max_wait_s=0.005,
                                queue_capacity=64),
        clock=SimClock(), service_time=default_service_model())
    return WorkerNode(wid, engine, sched)


def stub_requests(n, seed=0):
    rng = np.random.default_rng(seed)
    return [Request(text=f"query {i}", prompt=rng.integers(1, 50, 3 + i % 4).astype(np.int32),
                    max_new=2, arrival_s=0.001 * i) for i in range(n)]


# ---------------------------------------------------------------------------
# tests/test_transport.py::TestSocketTransport on the port
# ---------------------------------------------------------------------------


def _start_follower(wid, port, handler, errors, net=port_transport):
    """Connect + serve a follower transport of ``net``'s package on its own
    thread."""
    t = net.SocketTransport(wid, timeout=20.0)
    t.bind(wid, handler)
    ready = threading.Event()

    def run():
        try:
            t.connect(port, hello_payload={"pid": 1000 + wid})
            ready.set()
            t.serve_forever()
        except net.TransportError as exc:
            errors[wid] = exc
        finally:
            ready.set()
            t.close()

    th = threading.Thread(target=run, daemon=True)
    th.start()
    return t, th, ready


class TestSocketTransport:
    def test_hello_rpc_forwarding_and_shutdown(self):
        ctrl = SocketTransport(0, timeout=20.0)
        port = ctrl.listen()
        state = {"ticks": 0}
        ctrl.bind(0, lambda msg: {"ctrl": msg.payload.get("x", 0) * 10})
        errors = {}

        def w1_handler(msg):
            if msg.kind == "RELAY":
                # Nested RPC mid-handling: w1 -> w2 hops through the
                # controller while the controller waits on this reply.
                rep = t1.request(Message(kind="PING", dst=2,
                                         payload={"x": msg.payload["x"]}))
                return {"via": rep.payload["sq"]}
            if msg.kind == "ASKCTRL":
                rep = t1.request(Message(kind="PING", dst=0, payload={"x": 7}))
                return {"ctrl": rep.payload["ctrl"]}
            state["ticks"] += 1
            return {}

        def w2_handler(msg):
            return {"sq": msg.payload["x"] ** 2}

        t1, th1, _ = _start_follower(1, port, w1_handler, errors)
        t2, th2, _ = _start_follower(2, port, w2_handler, errors)
        try:
            hellos = ctrl.accept(2, timeout=20.0)
            assert {w: h["pid"] for w, h in hellos.items()} == {1: 1001, 2: 1002}
            rep = ctrl.request(Message(kind="PING", dst=2, payload={"x": 6}))
            assert rep.payload == {"sq": 36}
            rep = ctrl.request(Message(kind="RELAY", dst=1, payload={"x": 5}))
            assert rep.payload == {"via": 25}
            rep = ctrl.request(Message(kind="ASKCTRL", dst=1))
            assert rep.payload == {"ctrl": 70}
            ctrl.send(Message(kind=M.TICK, dst=1))
            ctrl.request(Message(kind=M.TICK, dst=1))
            assert state["ticks"] == 2
        finally:
            for wid in (1, 2):
                try:
                    ctrl.request(Message(kind=M.SHUTDOWN, dst=wid))
                except TransportError:
                    pass
            th1.join(timeout=10.0)
            th2.join(timeout=10.0)
            ctrl.close()
        assert not th1.is_alive() and not th2.is_alive()
        assert errors == {}

    def test_remote_handler_error_surfaces_as_transport_error(self):
        ctrl = SocketTransport(0, timeout=20.0)
        port = ctrl.listen()
        errors = {}

        def bad_handler(msg):
            if msg.kind == "BOOM":
                raise ValueError("follower exploded")
            return {}

        t1, th1, _ = _start_follower(1, port, bad_handler, errors)
        try:
            ctrl.accept(1, timeout=20.0)
            with pytest.raises(TransportError, match="follower exploded"):
                ctrl.request(Message(kind="BOOM", dst=1))
            assert ctrl.request(Message(kind="OK", dst=1)).kind == M.ACK
            assert ctrl.stats.errors == 1
        finally:
            try:
                ctrl.request(Message(kind=M.SHUTDOWN, dst=1))
            except TransportError:
                pass
            th1.join(timeout=10.0)
            ctrl.close()

    def test_lost_controller_raises_in_serve_forever(self):
        ctrl = SocketTransport(0, timeout=20.0)
        port = ctrl.listen()
        errors = {}
        t1, th1, ready = _start_follower(1, port, lambda msg: {}, errors)
        try:
            ctrl.accept(1, timeout=20.0)
            ready.wait(timeout=10.0)
            ctrl.drop_connection(1)
            th1.join(timeout=10.0)
            assert not th1.is_alive()
            assert isinstance(errors.get(1), TransportError)
        finally:
            ctrl.close()

    def test_connect_refused_after_retries(self):
        t = SocketTransport(3, timeout=1.0)
        sacrificial = SocketTransport(0, timeout=1.0)
        port = sacrificial.listen()
        sacrificial.close()
        t.CONNECT_RETRIES = 2
        with pytest.raises(TransportError):
            t.connect(port)
        assert t.stats.retries == 2


def test_a_router_frame_decodes_onto_the_transports_device():
    """The port's transport decodes with its worker's device: a router
    crossing a socket lands on the CPU here, with no card."""
    ctrl = SocketTransport(0, timeout=20.0, device="cpu")
    port = ctrl.listen()
    got = {}
    follower = SocketTransport(1, timeout=20.0, device="cpu")

    def handler(msg):
        got["router"] = msg.payload["router"]
        return {"digest": router_digest(msg.payload["router"])}

    follower.bind(1, handler)
    th = threading.Thread(target=lambda: (follower.connect(port), follower.serve_forever()),
                          daemon=True)
    th.start()
    try:
        ctrl.accept(1, timeout=20.0)
        router = make_router(3)
        rep = ctrl.request(Message(kind=M.ROUTER_BCAST, dst=1, payload={"router": router}))
        assert rep.payload["digest"] == router_digest(router)
        assert got["router"].quality_params["wq"].device.type == "cpu"
        ctrl.request(Message(kind=M.SHUTDOWN, dst=1))
    finally:
        th.join(timeout=10.0)
        ctrl.close()
        follower.close()
    assert not th.is_alive()


# ---------------------------------------------------------------------------
# Wire parity: either package's controller with the other's followers
# ---------------------------------------------------------------------------

PORT_NET = SimpleNamespace(transport=port_transport, M=M, name="port")
REF_NET = SimpleNamespace(transport=jax_transport, M=JM, name="reference")


@pytest.mark.parametrize("ctrl_net,follower_net", [(PORT_NET, REF_NET), (REF_NET, PORT_NET)],
                         ids=["port-controller", "reference-controller"])
def test_controller_and_followers_of_the_two_packages_interoperate(ctrl_net, follower_net):
    ctrl = ctrl_net.transport.SocketTransport(0, timeout=20.0)
    port = ctrl.listen()
    ctrl.bind(0, lambda msg: {"ctrl": msg.payload.get("x", 0) * 10})
    errors = {}
    followers = {}

    def w1_handler(msg):
        if msg.kind == "RELAY":
            rep = followers[1].request(follower_net.M.Message(
                kind="PING", dst=2, payload={"x": msg.payload["x"]}))
            return {"via": rep.payload["sq"], "arr": np.arange(3, dtype=np.int32)}
        if msg.kind == "BOOM":
            raise ValueError("follower exploded")
        return {}

    def w2_handler(msg):
        return {"sq": msg.payload["x"] ** 2}

    threads = []
    for wid, handler in ((1, w1_handler), (2, w2_handler)):
        followers[wid], th, _ = _start_follower(wid, port, handler, errors,
                                                net=follower_net.transport)
        threads.append(th)
    try:
        hellos = ctrl.accept(2, timeout=20.0)
        assert {w: h["pid"] for w, h in hellos.items()} == {1: 1001, 2: 1002}
        rep = ctrl.request(ctrl_net.M.Message(kind="RELAY", dst=1, payload={"x": 5}))
        assert rep.payload["via"] == 25
        np.testing.assert_array_equal(rep.payload["arr"], np.arange(3, dtype=np.int32))
        with pytest.raises(ctrl_net.transport.TransportError, match="follower exploded"):
            ctrl.request(ctrl_net.M.Message(kind="BOOM", dst=1))
        for wid in (1, 2):
            rep = ctrl.request(ctrl_net.M.Message(kind=ctrl_net.M.SHUTDOWN, dst=wid))
            assert rep.kind == ctrl_net.M.ACK
    finally:
        for t in threads:
            t.join(timeout=10.0)
        ctrl.close()
    assert not any(t.is_alive() for t in threads)
    assert errors == {}


# ---------------------------------------------------------------------------
# Ownership and tests/test_transport.py::TestPoolDispatch on the port
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_workers", [1, 2, 3, 4, 7])
def test_ownership_equals_the_references(n_workers):
    for n_members in range(0, 12):
        assert [owner_of(mi, n_workers) for mi in range(n_members)] == \
            [jax_shard.owner_of(mi, n_workers) for mi in range(n_members)]
        for wid in range(n_workers + 1):
            assert owned_members(wid, n_members, n_workers) == \
                jax_shard.owned_members(wid, n_members, n_workers)
    with pytest.raises(ValueError):
        owner_of(0, 0)


class TestPoolDispatch:
    def test_owner_layout_round_robin(self):
        assert [owner_of(mi, 2) for mi in range(4)] == [0, 1, 0, 1]
        assert owned_members(0, 5, 2) == [0, 2, 4]
        assert owned_members(1, 5, 2) == [1, 3]
        assert owned_members(2, 2, 3) == []

    def _pair(self):
        workers = [stub_worker(wid) for wid in range(2)]
        lt = LocalTransport()
        for w in workers:
            w.bind(lt)
        disp = PoolDispatcher(0, 2, workers[0].engine, lt)
        prompts = [np.arange(4, dtype=np.int32), np.arange(7, dtype=np.int32) % 9]
        return workers, disp, prompts

    def test_remote_generate_matches_local(self):
        workers, disp, prompts = self._pair()
        want_outs, want_costs = workers[1].engine.generate_member(1, prompts, max_new=4)
        outs, costs = disp.generate_member(1, prompts, max_new=4)
        assert disp.stats == {"local": 0, "remote": 1}
        assert disp.last_rpc is not None
        np.testing.assert_array_equal(costs, want_costs)
        for got, want in zip(outs, want_outs):
            np.testing.assert_array_equal(got, want)

    def test_owned_member_stays_local(self):
        workers, disp, prompts = self._pair()
        outs, costs = disp.generate_member(0, prompts, max_new=4)
        assert disp.stats == {"local": 1, "remote": 0} and disp.last_rpc is None
        assert len(outs) == len(prompts) and costs.shape == (2,)

    def test_per_request_caps_cross_the_wire(self):
        workers, disp, prompts = self._pair()
        want_outs, want_costs = workers[1].engine.generate_member(
            1, prompts, max_new=4, max_new_per_req=[1, 3])
        outs, costs = disp.generate_member(1, prompts, max_new=4, max_new_per_req=[1, 3])
        np.testing.assert_array_equal(costs, want_costs)
        for got, want in zip(outs, want_outs):
            np.testing.assert_array_equal(got, want)

    def test_unreachable_owner_raises_transport_error(self):
        workers = [stub_worker(wid) for wid in range(2)]
        lt = LocalTransport()
        workers[0].bind(lt)                   # w1 never binds
        disp = PoolDispatcher(0, 2, workers[0].engine, lt)
        with pytest.raises(TransportError):
            disp.generate_member(1, [np.arange(3, dtype=np.int32)])


def test_generate_hop_carries_the_trace_context_over_a_socket():
    """A GENERATE frame carries the dispatcher's trace key and parent span;
    the owner's tokens and costs come back over a real socket."""
    ctrl = SocketTransport(0, timeout=20.0, device="cpu")
    port = ctrl.listen()
    owner = stub_worker(1)
    seen = {}
    follower = SocketTransport(1, timeout=20.0, device="cpu")
    follower.bind(1, lambda msg: (seen.update(key=msg.trace_key, parent=msg.parent_span),
                                  owner.handle(msg))[1])
    th = threading.Thread(target=lambda: (follower.connect(port), follower.serve_forever()),
                          daemon=True)
    th.start()
    try:
        ctrl.accept(1, timeout=20.0)
        w0 = stub_worker(0)
        disp = PoolDispatcher(0, 2, w0.engine, ctrl)
        disp.trace_key, disp.parent_span = 41, 7
        prompts = [np.arange(5, dtype=np.int32), np.arange(2, dtype=np.int32)]
        outs, costs = disp.generate_member(1, prompts, max_new=3)
        want_outs, want_costs = owner.engine.generate_member(1, prompts, max_new=3)
        assert seen == {"key": 41, "parent": 7}
        assert disp.last_rpc == 1 and costs.dtype == np.float64
        np.testing.assert_array_equal(costs, want_costs)
        for got, want in zip(outs, want_outs):
            np.testing.assert_array_equal(got, want)
        ctrl.request(Message(kind=M.SHUTDOWN, dst=1))
    finally:
        th.join(timeout=10.0)
        ctrl.close()
        follower.close()
    assert not th.is_alive()


# ---------------------------------------------------------------------------
# A pool built for one owner
# ---------------------------------------------------------------------------

SHARD_POOL = ["qwen3-0.6b", "llama-3.2-vision-90b", "granite-3-8b"]


def _leaves(tree):
    return flatten_with_paths(tree)


def _router_state(router):
    return {k: v for k, v in flatten_with_paths(M.router_to_state(router)).items()}


def test_owned_build_holds_the_full_builds_bits_and_trains_its_router():
    full = serve.build_pool(SHARD_POOL, seed=3, device="cpu", smoke=True)
    part = serve.build_pool(SHARD_POOL, seed=3, device="cpu", smoke=True, owned=[1])
    for i, (a, b) in enumerate(zip(full, part)):
        assert (a.name, a.cfg, a.cost_rate) == (b.name, b.cfg, b.cost_rate)
        if i == 1:
            la, lb = _leaves(a.params), _leaves(b.params)
            assert la.keys() == lb.keys()
            assert all(torch.equal(la[k], lb[k]) for k in la)
            assert b.media is not None and torch.equal(a.media, b.media)
        else:
            assert b.params is None and b.media is None
    assert 0 < pool_param_bytes(part) < pool_param_bytes(full)
    r_full = serve.train_engine(full, seed=3, device="cpu", epochs=2, n_traffic=300).router
    r_part = serve.train_engine(part, seed=3, device="cpu", epochs=2, n_traffic=300).router
    sa, sb = _router_state(r_full), _router_state(r_part)
    assert sa.keys() == sb.keys()
    for k in sa:
        a, b = np.asarray(sa[k]), np.asarray(sb[k])
        assert a.dtype == b.dtype and np.array_equal(a, b), k
    assert router_digest(r_full) == router_digest(r_part)


def test_shard_pool_places_owned_members_and_evicts_the_rest():
    pool = serve.build_pool(serve.DEFAULT_POOL.split(","), seed=0, device="cpu", smoke=True)
    kept = _leaves(pool[1].params)
    assert shard_pool(pool, 1, 2, device="cpu") == [1]
    assert pool[0].params is None and pool[2].params is None
    assert all(torch.equal(kept[k], v) for k, v in _leaves(pool[1].params).items())
    with pytest.raises(ValueError, match="holds no params"):
        shard_pool(pool, 0, 2, device="cpu")
    assert shard_pool(pool, 1, 2, device="cpu", evict=False) == [1]


# ---------------------------------------------------------------------------
# The controller's proxy and a follower without its controller
# ---------------------------------------------------------------------------


class SwitchTransport(LocalTransport):
    """A LocalTransport whose endpoints can all be made unreachable."""

    down = False

    def _deliver(self, msg):
        if self.down:
            raise TransportError("partitioned")
        return super()._deliver(msg)


def test_remote_worker_proxy_mirrors_then_falls_back_to_its_cache():
    lt = SwitchTransport()
    worker = stub_worker(1)
    worker.bind(lt)
    proxy = RemoteWorkerProxy(1, lt, member_names=["m0", "m1"], pid=77)
    assert (proxy.pid, proxy.alive, proxy.served_count) == (77, True, 0)
    assert not hasattr(proxy, "bind") and not hasattr(proxy, "scheduler")
    proxy.observe_step({"now": 0.25, "n_served": 3})
    assert (proxy.clock.now, proxy.served_count) == (0.25, 3)
    worker.assign(stub_requests(6))
    while worker.next_action_s() != float("inf"):
        worker.step(worker.next_action_s())
    assert worker.publish(make_router(1, version=4))
    tel = proxy.telemetry
    assert tel is worker.telemetry and tel.completed == 6
    assert proxy.served_count == len(worker.served) == 6
    assert proxy.router_version == worker.router_version
    assert proxy.swaps_accepted == worker.swaps_accepted
    assert proxy.clock.now == max(0.25, worker.clock.now)
    lt.down = True
    worker.crash(1.0)
    assert proxy.telemetry is tel and proxy.crashes == 0     # cached, not raised
    assert proxy.router_version == worker.router_version


@pytest.mark.parametrize("target,served", [(1, 5), (0, 0)], ids=["owned", "peer"])
def test_drain_local_serves_the_backlog_after_the_controller_is_lost(target, served):
    """The controller assigns five requests over the socket and then drops
    the connection: the follower's ``serve_forever`` raises, and
    ``drain_local`` serves them when they route to its own member, or stops
    at once when the first leg needs the lost controller's member."""
    ctrl = SocketTransport(0, timeout=20.0, device="cpu")
    port = ctrl.listen()
    worker = stub_worker(1, target=target)
    follower = SocketTransport(1, timeout=20.0, device="cpu")
    worker.scheduler.dispatcher = PoolDispatcher(1, 2, worker.engine, follower)
    worker.bind(follower)
    out = {}

    def run():
        follower.connect(port, hello_payload={"pid": 5})
        try:
            follower.serve_forever()
        except TransportError as exc:
            out["lost"] = exc
            out["served"] = drain_local(worker)
        finally:
            follower.close()

    th = threading.Thread(target=run, daemon=True)
    th.start()
    try:
        ctrl.accept(1, timeout=20.0)
        rep = ctrl.request(Message(kind=M.ASSIGN, dst=1, payload={"reqs": stub_requests(5)}))
        assert rep.payload == {"n": 5}
        ctrl.drop_connection(1)
        th.join(timeout=20.0)
    finally:
        ctrl.close()
    assert not th.is_alive()
    assert isinstance(out["lost"], TransportError)
    assert out["served"] == served == len(worker.served)
    assert worker.scheduler.dispatcher.stats["remote"] == (1 if target == 0 else 0)


# ---------------------------------------------------------------------------
# The serve CLI: the four scheduler / trace flags, and the socket fleet
# ---------------------------------------------------------------------------

NEW_FLAGS = ["--max-wait", "0.02", "--queue-capacity", "7", "--deadline", "0.3",
             "--wall-time"]
NEW_DESTS = ("max_wait", "queue_capacity", "deadline", "wall_time")


def test_new_flags_reach_the_scheduler_and_the_trace_as_the_references():
    for flags in ([], NEW_FLAGS):
        args = serve.parse_args(["--trace", "poisson", "--requests", "12", *flags])
        ref_args = jax_serve.make_parser().parse_args(
            ["--trace", "poisson", "--requests", "12", *flags])
        assert {d: getattr(args, d) for d in NEW_DESTS} == \
            {d: getattr(ref_args, d) for d in NEW_DESTS}
        engine = RoutedEngine(router=serve.init_router(3, device="cpu"), device="cpu",
                              pool=serve.build_pool(serve.DEFAULT_POOL.split(","),
                                                    device="cpu", smoke=True, owned=[]))
        sched = serve.build_plane_worker(
            engine, args, 0, governor=None, drift_proto=None, truth=None, train_emb=None,
            radius=None, recorder=None, slo=None).scheduler
        ref_ctx = SimpleNamespace(
            engine=SimpleNamespace(router=engine.router,
                                   pool=[SimpleNamespace(name=m.name) for m in engine.pool]),
            make_cascade=lambda governor: None, make_semcache=lambda: None)
        ref_sched = jax_serve.build_plane_worker(ref_args, ref_ctx, 0, None, None, None,
                                                 None).scheduler
        for field in ("max_wait_s", "queue_capacity", "score_batch", "max_batch"):
            assert getattr(sched.config, field) == getattr(ref_sched.config, field), field
        assert (sched.service_time is None) == (ref_sched.service_time is None) \
            == args.wall_time
        assert sched.queue.capacity == ref_sched.queue.capacity == args.queue_capacity
        data = generate(300, seed=0)
        _, _, te = data.split(seed=0)
        trace = serve.make_serve_trace(args, data, te, vocab=64)
        ref_trace = jax_make_trace(
            JaxTraceConfig(kind=ref_args.trace, n_requests=ref_args.requests,
                           rate=ref_args.rate, seed=ref_args.seed, max_new=ref_args.max_new,
                           deadline_s=ref_args.deadline, prompt_len_max=48, vocab=64),
            texts=[data.texts[i] for i in te], benchmarks=[data.benchmark[i] for i in te])
        assert [(r.text, r.arrival_s, r.deadline_s, r.max_new) for r in trace] == \
            [(r.text, r.arrival_s, r.deadline_s, r.max_new) for r in ref_trace]
        assert all((r.deadline_s is None) == (args.deadline is None) for r in trace)
    assert serve.parse_args(["--restore-router", "r.npz"]).router == "r.npz"


FLEET_FLAGS = ["--smoke", "--device", "cpu", "--trace", "drift", "--online",
               "--workers", "2", "--requests", "48", "--epochs", "2", "--max-new", "2",
               "--max-wait", "0.01", "--sync-every", "0.02", "--online-update-every", "8",
               "--crash-at", "0.05", "--rejoin-at", "0.08",
               "--budget", "0.00005", "--budget-window", "0.25"]
# The reference's tools/distributed_smoke.py rollup keys.
PARITY_KEYS = ("completed", "rejected", "expired", "per_member_counts",
               "per_member_spend", "total_spend", "generate_calls", "n_workers",
               "alive_workers", "reassigned", "router_versions", "per_worker_completed")
COORD_KEYS = ("syncs", "merged", "updates", "update_steps", "bursts",
              "stale_rejected", "leader_changes")
DIGEST = re.compile(r"router v(\d+) digest ([0-9a-f]{16})")


def _line(out, prefix):
    """The first output line holding ``prefix``, from it on (the fleet's
    processes share one stdout)."""
    return next(x[x.index(prefix):] for x in out.splitlines() if prefix in x)


def test_serve_socket_fleet_equals_the_local_fleet(tmp_path, monkeypatch, capfd):
    """The same seeded fleet over both transports: equal rollups; the
    socket run spans two OS processes, its merged trace covers pids {0, 1}
    with every remote GENERATE paired, the fleet exposition holds worker
    1's series, and the follower's router digest equals the controller's
    when it is ready and at the end."""
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    local = serve.run_cli(FLEET_FLAGS)
    capfd.readouterr()
    trace_out, metrics_out = str(tmp_path / "t.json"), str(tmp_path / "m.prom")
    sock = serve.run_cli([*FLEET_FLAGS, "--transport", "socket", "--trace-out", trace_out,
                          "--metrics-out", metrics_out])
    out = capfd.readouterr().out
    for key in PARITY_KEYS:
        assert local[key] == sock[key], key
    for key in COORD_KEYS:
        assert local["coordinator"][key] == sock["coordinator"][key], key
    assert sock["reassigned"] > 0 and sock["coordinator"]["updates"] > 0
    assert sock["transport"] == "socket"
    assert len(set(sock["pids"].values())) == 2 and sorted(sock["pids"]) == [0, 1]
    assert sock["pool_owner"] == {"qwen3-0.6b": 0, "granite-moe-1b-a400m": 1,
                                  "granite-3-8b": 0}
    ctrl_ready, ctrl_end, ready, done = (
        DIGEST.search(_line(out, prefix)).groups()
        for prefix in ("socket plane: controller", "socket plane: w0", "[w1] ready",
                       "[w1] done"))
    assert ready == ctrl_ready and done == ctrl_end and ctrl_end != ctrl_ready
    assert "owns pool members [1]" in out
    doc = json.load(open(trace_out))
    assert validate_chrome_trace(doc) == [] and validate_span_tree(doc) == []
    assert {e["pid"] for e in doc["traceEvents"]} == {0, 1}
    gen = [e for e in doc["traceEvents"]
           if e.get("name") == "rpc" and e["args"]["kind"] == M.GENERATE]
    servers = {e["args"]["rpc"]: e["pid"] for e in gen if e["args"]["side"] == "server"}
    clients = [e for e in gen if e["args"]["side"] == "client"]
    assert clients and all(servers.get(e["args"]["rpc"], e["pid"]) != e["pid"]
                           for e in clients)
    assert 'worker="1"' in open(metrics_out + ".fleet.prom").read()
