"""Follower process entry point + controller-side worker proxy.

The port of ``repro.distributed.host``.
``python -m repro_torch.distributed.host --wid W --port P --serve-argv JSON``
is what ``repro_torch.launch.serve --transport socket`` launches for
workers 1..N-1. The follower:

  1. turns TF32 off for matmul and cuDNN (a new process starts with
     PyTorch's defaults, and TF32 would move the router's training and
     scores off the controller's bits);
  2. dials the controller **first** (connect/retry/backoff) — the
     controller's ``accept`` returns as soon as the TCP handshakes land,
     and protocol frames simply queue in the socket buffers while step 3
     runs;
  3. re-parses the controller's forwarded serve argv and builds the pool
     members it owns (``launch/serve.py::build_engine`` with ``owned``:
     each member is seeded on its own, so they are the bits the controller
     would have made) and trains the router from ``--seed`` (every RNG
     derives from it, so no parameters cross the wire; the ``ready`` line
     prints the router's digest to show it), then the corpus split, the
     truth lookup and the drift prototype. The reference's follower
     builds the whole pool first and evicts afterwards; on one card that
     would hold N copies of the pool before the first eviction;
  4. claims its pool shard (:func:`repro_torch.distributed.shard.shard_pool`)
     and installs a :class:`~repro_torch.distributed.shard.PoolDispatcher`
     so legs for non-owned members hop to their owners;
  5. services protocol messages (``serve_forever``) until ``SHUTDOWN``.

Budget ops go through a :class:`~repro_torch.distributed.ledger.LedgerClient`
to the controller's shared ledger; traces land in a process-local
recorder the controller collects via ``TRACE_REQ``. With
``--trace-profile`` the follower installs a kernel-dispatch profiler of
its own whose kernel spans carry its wid (the reference's follower
profiles nothing), so the merged trace shows each process's launches.

**Graceful degradation**: if the controller connection dies mid-run the
follower does not crash — it drains its remaining queued work locally
(:func:`drain_local`) under the last known router version and effective
lambda, stopping only if a leg needs an unreachable peer's pool shard.

:class:`RemoteWorkerProxy` is the other side: the controller's in-memory
stand-in for a follower, satisfying the plane/coordinator reporting
surface (``telemetry`` / ``router_version`` / ``clock`` / ``alive``) by
``TELEMETRY_REQ`` RPC with cached fallback, and mirroring step results
via ``observe_step`` so mid-run reads don't need extra round trips. It
deliberately has NO ``bind`` or ``scheduler`` attribute: the coordinator
then never binds it as a local endpoint, and the plane's SLO dedup
always forces the remote tracker's end-of-run check.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import types
from typing import Optional

import torch

from repro_torch.distributed import messages as M
from repro_torch.distributed.messages import Message
from repro_torch.distributed.transport import SocketTransport, TransportError
from repro_torch.serving.telemetry import Telemetry


class RemoteWorkerProxy:
    """Controller-side mirror of a follower-process worker."""

    def __init__(self, wid: int, transport, *, member_names=(),
                 pid: int = -1):
        self.wid = int(wid)
        self.transport = transport
        self.pid = int(pid)
        self.alive = True
        self.clock = types.SimpleNamespace(now=0.0)
        self.served_count = 0
        # Cached fallbacks for a partitioned follower: reporting degrades
        # to the last mirrored values instead of raising mid-summary.
        self._telemetry = Telemetry(list(member_names))
        self._version = 0
        self.swaps_accepted = 0
        self.swaps_rejected = 0
        self.crashes = 0

    def observe_step(self, rep: dict) -> None:
        """Mirror a STEP reply — keeps clock/served fresh without RPC."""
        self.clock.now = max(self.clock.now, float(rep["now"]))
        self.served_count += int(rep["n_served"])

    def _refresh(self) -> None:
        try:
            rep = self.transport.request(
                Message(kind=M.TELEMETRY_REQ, dst=self.wid))
        except TransportError:
            return
        p = rep.payload
        self._telemetry = p["telemetry"]
        self._version = int(p["version"])
        self.swaps_accepted = int(p["swaps_accepted"])
        self.swaps_rejected = int(p["swaps_rejected"])
        self.crashes = int(p["crashes"])
        self.served_count = int(p["served"])
        self.clock.now = max(self.clock.now, float(p["now"]))

    @property
    def telemetry(self) -> Telemetry:
        self._refresh()
        return self._telemetry

    @property
    def router_version(self) -> int:
        self._refresh()
        return self._version


def say(line: str) -> None:
    """Write ``line`` and its newline in one write: the fleet's processes
    share one stdout, and a line written in two parts can be split by
    another process's."""
    sys.stdout.write(line + "\n")
    sys.stdout.flush()


def drain_local(worker) -> int:
    """Follower-local degradation: serve out the backlog without a plane.

    Runs the worker's own step loop (arrivals -> queue -> dispatch) under
    the last broadcast router version; the LedgerClient governor has
    already degraded to its cached lambda. Stops early if a generate leg
    needs a pool shard owned by an unreachable peer. Returns requests
    served while degraded.
    """
    served = 0
    while True:
        t = worker.next_action_s()
        if t == float("inf"):
            break
        try:
            served += len(worker.step(t))
        except TransportError:
            break           # a leg needs an unreachable peer's shard
    return served


def run_follower(wid: int, port: int, serve_argv: list,
                 host: str = "127.0.0.1") -> int:
    """Build worker ``wid`` from the forwarded argv and serve the plane."""
    # Imported here, not at module top: serve imports this module back for
    # RemoteWorkerProxy.
    from repro_torch.common.device import resolve_device
    from repro_torch.distributed.ledger import LedgerClient
    from repro_torch.distributed.messages import router_digest
    from repro_torch.distributed.shard import (
        PoolDispatcher, owned_members, pool_param_bytes, shard_pool,
    )
    from repro_torch.kernels import ops as kops
    from repro_torch.launch import serve
    from repro_torch.obs import (
        KernelProfiler, MetricsRegistry, TraceRecorder, TraceSampler,
        register_scheduler_metrics, register_slo_metrics, register_transport_metrics,
    )

    args = serve.parse_args(serve_argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = resolve_device(args.device)

    transport = SocketTransport(wid, timeout=600.0, device=device)
    transport.connect(port, host, hello_payload={"pid": os.getpid()})
    say(f"[w{wid}] pid {os.getpid()} connected to controller "
        f"{host}:{port}; building its pool shard and router")

    names = args.pool.split(",")
    engine = serve.build_engine(
        names, router_path=args.router, seed=args.seed, device=device,
        smoke=args.smoke, epochs=args.epochs,
        quality_kind="attn-ens" if args.cascade else args.quality_kind,
        owned=owned_members(wid, len(names), args.workers))
    engine.lam = args.lam
    data, tr, _, truth = serve.trace_corpus(engine, args)
    streaming = serve._streaming_requested(args)
    recorder = profiler = None
    if args.trace_out or args.trace_profile or streaming:
        sampler = None
        if args.trace_sample is not None:
            sampler = TraceSampler(args.trace_sample, seed=args.seed,
                                   head=args.trace_head)
        # key_base partitions the trace-key space per process so the
        # controller can absorb drained follower events verbatim.
        recorder = TraceRecorder(
            label=f"serve-{args.trace}-seed{args.seed}-w{wid}",
            sampler=sampler, max_buffered_per_worker=args.trace_cap,
            key_base=wid * 1_000_000)
    if args.trace_profile:
        profiler = KernelProfiler(tracer=recorder.scoped(wid))
        kops.set_kernel_profiler(profiler)
    try:
        radius = serve.cache_radius(args, data.emb[tr], device)
        governor = LedgerClient(transport, dst=0) if args.budget > 0 else None
        slo = serve.make_slo(args, tracer=recorder)
        worker = serve.build_plane_worker(
            engine, args, wid, governor=governor,
            drift_proto=serve.plane_drift_proto(engine, args, data.emb[tr]),
            truth=truth, train_emb=data.emb[tr], radius=radius,
            recorder=recorder, slo=slo)
        worker.recorder = recorder
        owned = shard_pool(worker.engine.pool, wid, args.workers, device=device)
        worker.scheduler.dispatcher = PoolDispatcher(
            wid, args.workers, worker.engine, transport)
        worker.bind(transport)
        # Fleet RPC observability: this follower's outbound RPCs (GENERATE
        # hops to shard owners, ledger ops) emit client-side rpc spans into
        # the local recorder, timestamped on the worker's virtual clock.
        if recorder is not None:
            transport.tracer = recorder
            transport.trace_wid = wid
        transport.now_fn = lambda: worker.clock.now
        # Federated metrics: a process-local registry (series labelled with
        # this wid) the controller scrapes via METRICS_REQ. The shared
        # budget ledger is NOT registered here — it lives in the
        # controller's registry exactly once.
        if args.metrics_out or args.metrics_port is not None or streaming:
            registry = MetricsRegistry()
            labels = (("worker", wid),)
            register_scheduler_metrics(registry, worker.scheduler, labels=labels)
            if slo is not None:
                register_slo_metrics(registry, slo, lambda: worker.clock.now,
                                     labels=labels)
            register_transport_metrics(registry, transport, labels=labels)
            worker.registry = registry
        say(f"[w{wid}] ready: router v{worker.router_version} digest "
            f"{router_digest(worker.engine.router)}, owns pool members {owned} "
            f"({pool_param_bytes(worker.engine.pool) / 2**30:.4f} GiB of params)")

        clean = True
        try:
            transport.serve_forever()
        except TransportError as exc:
            clean = False
            say(f"[w{wid}] controller lost ({exc}); degrading to "
                f"follower-local serving")
            degraded = drain_local(worker)
            say(f"[w{wid}] degraded drain served {degraded} requests")
        finally:
            transport.close()
    finally:
        if profiler is not None:
            kops.set_kernel_profiler(None)

    disp = worker.scheduler.dispatcher
    say(f"[w{wid}] done: served {len(worker.served)} (router "
        f"v{worker.router_version} digest {router_digest(worker.engine.router)}, "
        f"generate local/remote {disp.stats['local']}/{disp.stats['remote']}"
        f"{serve.peak_memory_note(device)})")
    if worker.scheduler.cascade is not None:
        say(f"[w{wid}] {worker.scheduler.cascade.report()}")
    if worker.scheduler.semcache is not None:
        rep = worker.scheduler.semcache.report()
        say(f"[w{wid}] semcache: {rep['served']}/{rep['lookups']} served "
            f"(hit rate {rep['hit_rate']:.2f})  {rep['entries']} entries")
    if worker.adapter is not None:
        say(f"[w{wid}] {worker.adapter.report()}")
    if profiler is not None:
        for line in profiler.report().splitlines():
            say(f"[w{wid}] {line}")
    return 0 if clean else 1


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--wid", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--serve-argv", required=True,
                    help="JSON list: the controller's serve argv, "
                         "re-parsed to rebuild identical seeded state")
    a = ap.parse_args(argv)
    serve_argv = json.loads(a.serve_argv)
    if not isinstance(serve_argv, list):
        ap.error("--serve-argv must be a JSON list of strings")
    return run_follower(a.wid, a.port, [str(s) for s in serve_argv],
                        host=a.host)


if __name__ == "__main__":
    sys.exit(main())
