"""Leader/follower router sync: replay merge -> leader update -> broadcast.

The port of ``repro.distributed.coordinator``. The leader's update is the
port's :class:`~repro_torch.online.updater.IncrementalUpdater`, on the
leader's device; the router it publishes crosses to the other workers by
reference over :class:`~repro_torch.distributed.transport.LocalTransport`,
so the fleet holds one copy of its tensors, and as codec bytes over
:class:`~repro_torch.distributed.transport.SocketTransport`, decoded onto
each follower's device.

The serve->learn loop of the single-worker adapter has four in-process
singletons: the replay buffer, the incremental updater, the drift burst,
and the router version. Replicating the scheduler across N workers
requires each to become an explicitly synchronized component:

  * **replay merge** — every sync round, each alive worker contributes a
    recency-stratified sample of its *local* replay (its own seeded
    generator), gathered in ascending worker-id order into the leader's
    merge buffer. The merge order and every sample are seeded, so two
    planes fed the same traffic produce bit-identical merged streams.
  * **leader update** — only the leader runs the bounded Adam steps
    (:class:`~repro_torch.online.updater.IncrementalUpdater`), on the merged
    buffer, anchored to the leader's live router.
  * **broadcast** — the resulting versioned router is swapped on every
    alive worker through ``RoutedEngine.swap_router``; its stale-publish
    rejection means a worker that missed a version can accept any newer
    broadcast but can never be rolled back by a delayed older one.
  * **leader election** — deterministic, state-free: the lowest-id alive
    worker leads. When the leader crashes, the next worker's router (kept
    current by the broadcasts) anchors a fresh updater; Adam moments reset,
    exactly like the hot-membership warm-start path.

Since the message-passing refactor, every worker interaction above is a
:class:`~repro_torch.distributed.messages.Message` over a
:class:`~repro_torch.distributed.transport.Transport` — ``SYNC_STATUS`` /
``REPLAY_SAMPLE`` / ``ROUTER_BCAST`` / ``CLEAR_BURST`` / ``CACHE_INVAL``
— so the same coordinator drives in-process workers (LocalTransport,
by-reference, bit-identical to the pre-refactor plane) and real remote
processes (SocketTransport). The one deliberate exception: the
coordinator is **co-located with the leader** — the updater reads
``leader.engine`` / ``leader.adapter`` directly (gathering gradients over
a wire buys nothing when the update runs on exactly one node), which in
socket mode pins the controller process to worker 0.

An unreachable worker (socket partition) is skipped for the round and
counted in ``stats["unreachable"]``; version fencing makes the eventual
``converge()`` catch-up safe regardless of what it missed.

Follower drift alarms don't burst locally (that would fork router
lineages); they raise ``pending_burst``, and the next sync round runs one
concentrated burst on the leader instead — and, since the burst signals
the query distribution moved, broadcasts a ``CACHE_INVAL`` so every
worker's semantic cache invalidates together instead of drifting apart.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from repro_torch.distributed import messages as M
from repro_torch.distributed.messages import Message
from repro_torch.distributed.transport import LocalTransport, TransportError
from repro_torch.online.replay import ReplayBuffer
from repro_torch.online.updater import IncrementalUpdater, OnlineUpdateConfig


@dataclasses.dataclass(frozen=True)
class SyncConfig:
    sync_every_s: float = 0.25     # virtual seconds between sync rounds
    merge_per_worker: int = 48     # stratified sample size gathered per worker
    merge_capacity: int = 4096     # leader-side merge buffer capacity
    merge_recent_frac: float = 0.5
    steps_per_sync: int = 8        # bounded leader Adam steps per round
    burst_steps: int = 48          # when a follower raised pending_burst
    min_buffer: int = 32           # don't update on a near-empty merge buffer
    seed: int = 0
    update: OnlineUpdateConfig = OnlineUpdateConfig()


class Coordinator:
    def __init__(self, workers: List, config: Optional[SyncConfig] = None,
                 *, transport=None):
        self.workers = list(workers)
        self.config = config or SyncConfig()
        self.transport = transport if transport is not None \
            else LocalTransport()
        for w in self.workers:
            if hasattr(w, "bind") and getattr(w, "transport", None) is None:
                w.bind(self.transport)
        self.merge_replay = ReplayBuffer(self.config.merge_capacity,
                                         seed=self.config.seed)
        self._updater: Optional[IncrementalUpdater] = None
        self._anchor_wid: Optional[int] = None
        self._last_outcome_snap: dict = {}
        # Observability hook (repro_torch.obs): the shared TraceRecorder (not a
        # worker-scoped view) — sync events are stamped with the leader's
        # wid at emission time. Installed by the plane.
        self.tracer = None
        self.stats = {
            "syncs": 0, "merged": 0, "updates": 0, "update_steps": 0,
            "bursts": 0, "broadcasts": 0, "stale_rejected": 0,
            "leader_changes": 0, "unreachable": 0, "cache_invals": 0,
        }

    # -- transport helpers ---------------------------------------------------

    def _request(self, wid: int, kind: str,
                 payload: Optional[dict] = None) -> Optional[dict]:
        """One RPC to a worker endpoint; None = unreachable this round."""
        try:
            rep = self.transport.request(
                Message(kind=kind, dst=wid, payload=payload or {}))
        except TransportError:
            self.stats["unreachable"] += 1
            return None
        return rep.payload

    def _send(self, wid: int, kind: str,
              payload: Optional[dict] = None) -> None:
        try:
            self.transport.send(
                Message(kind=kind, dst=wid, payload=payload or {}))
        except TransportError:
            self.stats["unreachable"] += 1

    # -- membership ----------------------------------------------------------

    @property
    def alive(self) -> List:
        return [w for w in sorted(self.workers, key=lambda w: w.wid)
                if w.alive]

    @property
    def leader(self):
        """Lowest-id alive worker — deterministic, no consensus state."""
        alive = self.alive
        return alive[0] if alive else None

    def _ensure_updater(self, leader) -> IncrementalUpdater:
        if self._updater is None or self._anchor_wid != leader.wid:
            if self._anchor_wid is not None and self._anchor_wid != leader.wid:
                self.stats["leader_changes"] += 1
            # Anchor on the new leader's live router (kept current by the
            # broadcasts); optimizer moments reset, like warm_start.
            self._updater = IncrementalUpdater(leader.engine.router,
                                               self.config.update)
            self._anchor_wid = leader.wid
        return self._updater

    # -- sync protocol -------------------------------------------------------

    def merge_round(self, now: float) -> int:
        """Gather stratified replay samples from every alive worker, in
        ascending worker-id order (deterministic merge order)."""
        n = 0
        for w in self.alive:
            rep = self._request(w.wid, M.REPLAY_SAMPLE, {
                "n": self.config.merge_per_worker,
                "recent_frac": self.config.merge_recent_frac})
            batch = None if rep is None else rep.get("batch")
            if batch is None:
                continue
            for q, m, s, c, t in zip(batch["q_emb"], batch["member"],
                                     batch["s"], batch["c"], batch["t"]):
                self.merge_replay.add(q, int(m), float(s), float(c), float(t))
                n += 1
        self.stats["merged"] += n
        return n

    def _statuses(self) -> Dict[int, dict]:
        """SYNC_STATUS from every alive worker (ascending wid); workers
        unreachable this round are simply absent from the map."""
        out: Dict[int, dict] = {}
        for w in self.alive:
            st = self._request(w.wid, M.SYNC_STATUS)
            if st is not None:
                out[w.wid] = st
        return out

    def sync_round(self, now: float):
        """One leader/follower cycle: merge -> bounded update -> broadcast.

        Returns the newly published router, or None when no update ran
        (empty merge buffer, no leader, or zero effective steps).
        """
        leader = self.leader
        if leader is None:
            return None
        self.transport.now = now   # virtual timestamp for rpc spans
        updater = self._ensure_updater(leader)
        self.stats["syncs"] += 1

        statuses = self._statuses()
        # Read (don't clear) escalated follower bursts: if this round can't
        # run steps yet (empty merge buffer), the flags must survive to the
        # round that can — the drift detector already re-anchored, so a
        # dropped flag would mean the burst never happens at all.
        burst = any(st["has_adapter"] and st["pending_burst"]
                    for st in statuses.values())
        # Idle guard: if no worker observed anything since the last round
        # (long traffic gaps fire many sync boundaries), don't re-gather
        # and re-train on the same stale samples. Compared per worker id
        # (not as a sum): a crash removes a worker's count and a rejoin
        # resets it, either of which could make an aggregate alias.
        snap = {wid: st["added"] for wid, st in statuses.items()
                if st["has_adapter"]}
        if snap == self._last_outcome_snap and not burst:
            return None
        self._last_outcome_snap = snap
        # Like the solo adapter's min_buffer, counted over DISTINCT held
        # outcomes — the merge buffer itself is inflated by with-replacement
        # sampling, so its length would pass on a near-empty fleet.
        distinct = sum(st["distinct"] for st in statuses.values()
                       if st["has_adapter"])
        if distinct < self.config.min_buffer:
            return None
        self.merge_round(now)
        if len(self.merge_replay) < self.config.min_buffer:
            return None
        steps = self.config.burst_steps if burst else self.config.steps_per_sync
        # Leader co-location: the update runs against the leader's live
        # engine/adapter in this process — the one shared-object access
        # the transport abstraction deliberately keeps.
        model_emb = (leader.adapter.membership.model_emb
                     if leader.adapter is not None
                     else leader.engine.router.model_emb)
        res = updater.run_steps(self.merge_replay, model_emb, steps)
        if res["steps"] == 0:
            return None
        if burst:
            for w in self.alive:
                st = statuses.get(w.wid)
                if st is not None and st["has_adapter"]:
                    self._send(w.wid, M.CLEAR_BURST)
            self.stats["bursts"] += 1
            # The burst means the query distribution moved: invalidate
            # every worker's semantic cache in the same round, so no
            # worker keeps serving answers its peers already dropped.
            for w in self.alive:
                self._send(w.wid, M.CACHE_INVAL,
                           {"mode": "probe", "now": now})
                self.stats["cache_invals"] += 1
        new_router = updater.publish(leader.engine, model_emb)
        leader.swaps_accepted += 1
        self.stats["updates"] += 1
        self.stats["update_steps"] += res["steps"]
        accepted = self.broadcast(new_router, exclude=leader)
        if self.tracer is not None:
            self.tracer.instant(
                "sync_round", "plane", now, wid=leader.wid,
                args={"version": new_router.version,
                      "steps": int(res["steps"]), "burst": bool(burst),
                      "broadcast_accepted": accepted})
        return new_router

    def broadcast(self, router, exclude=None) -> int:
        """Swap ``router`` onto every alive worker; returns acceptances."""
        ok = 0
        for w in self.alive:
            if w is exclude:
                continue
            self.stats["broadcasts"] += 1
            rep = self._request(w.wid, M.ROUTER_BCAST, {"router": router})
            if rep is None:
                continue            # partitioned: converge() repairs later
            if rep["accepted"]:
                ok += 1
            else:
                self.stats["stale_rejected"] += 1
        return ok

    def catch_up(self, worker) -> None:
        """Bring a (re)joined worker to the current canonical version."""
        leader = self.leader
        if leader is None or worker is leader:
            return
        router = leader.engine.router
        st = self._request(worker.wid, M.SYNC_STATUS)
        if st is None:
            return
        if router.version > st["version"]:
            self._request(worker.wid, M.ROUTER_BCAST, {"router": router})

    def converge(self) -> None:
        """Ensure every alive worker holds the leader's router version."""
        for w in self.alive:
            self.catch_up(w)

    # -- reporting -----------------------------------------------------------

    def report(self) -> str:
        s = self.stats
        leader = self.leader
        unreachable = (f"  unreachable {s['unreachable']}"
                       if s["unreachable"] else "")
        return (
            f"coordinator: leader w{leader.wid if leader else '-'}  "
            f"syncs {s['syncs']}  merged {s['merged']} outcomes  "
            f"updates {s['updates']} ({s['update_steps']} steps, "
            f"{s['bursts']} bursts)  broadcasts {s['broadcasts']} "
            f"(stale rejected {s['stale_rejected']})  "
            f"leader changes {s['leader_changes']}{unreachable}"
        )
