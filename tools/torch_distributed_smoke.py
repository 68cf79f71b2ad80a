"""Distributed serving smoke on the PyTorch port: the socket transport
against real processes.

The port of ``tools/distributed_smoke.py``. Runs the port's seeded serve
CLI (``repro_torch.launch.serve``, the code behind ``python -m
repro_torch.launch.serve``) twice on the SAME argv — once on the
in-process ``LocalTransport`` plane, once on ``--transport socket``
(controller + N-1 follower OS processes, each holding only the pool
members it owns, shared ledger over ``LEDGER_OP``) — and asserts the message-passing refactor's
core contract:

  * **parity** — both planes converge to the same final router version
    on every worker and produce matching deterministic telemetry rollups
    (completed / spend / per-member counts / sync + merge + update
    counters). Only wall-measured latency percentiles may differ.
  * **real processes** — the socket run reports >= ``--workers`` distinct
    OS pids (the controller plus one per follower), proving the legs
    crossed process boundaries rather than a loopback.
  * **sharded pool** — the socket summary's member->owner layout covers
    every pool member, each owned by a valid worker.
  * **rpc observability** — both traces carry client/server ``rpc``
    spans joined by flow link ids; counts match across transports for
    the transport-invariant message kinds, the socket run's remote
    ``GENERATE`` legs all resolve to a server-side span in the follower
    process, and ``validate_span_tree`` is clean on both documents.
  * **federated metrics** — the socket run's merged fleet exposition
    (``--metrics-out`` + ``.fleet.prom``) carries follower-labelled
    series scraped over ``METRICS_REQ``.
  * **artifacts** — both summaries plus the controller's merged fleet
    trace (followers folded in via ``TRACE_REQ``) land in ``--out-dir``
    for CI upload.

    PYTHONPATH=src python tools/torch_distributed_smoke.py --transport socket \
        [--workers 2] [--requests 40] [--out-dir reports/distributed_smoke] \
        [--device cpu]

The pool is the reduced configs (``--smoke``), as the reference's serve
CLI builds it, on the CUDA card unless ``--device`` names another
device (with no card and no ``--device`` it raises); the followers get
the same argv.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "src"))

from repro_torch.common.device import resolve_device  # noqa: E402
from repro_torch.launch import serve  # noqa: E402

# Rollup keys that must match exactly across transports. Latency
# percentiles are excluded on purpose: routing time is wall-measured.
PARITY_KEYS = (
    "completed", "rejected", "expired", "per_member_counts",
    "per_member_spend", "total_spend", "generate_calls",
    "n_workers", "alive_workers", "reassigned", "router_versions",
    "per_worker_completed",
)
COORD_KEYS = ("syncs", "merged", "updates", "update_steps", "bursts",
              "stale_rejected", "leader_changes")


def rpc_spans(doc):
    return [e for e in doc["traceEvents"]
            if e.get("ph") == "X" and e.get("name") == "rpc"]


def rpc_counts(doc, kinds):
    """(kind, side) -> span count, restricted to the given kinds."""
    counts = {}
    for e in rpc_spans(doc):
        a = e["args"]
        if a["kind"] in kinds:
            k = (a["kind"], a["side"])
            counts[k] = counts.get(k, 0) + 1
    return counts


def run_serve(argv, label):
    t0 = time.time()
    print(f"--- {label}: serve {' '.join(argv)}", flush=True)
    summary = serve.run_cli(argv)
    print(f"--- {label} done in {time.time() - t0:.1f}s", flush=True)
    return summary


def check(cond, what):
    if not cond:
        print(f"FAIL: {what}", flush=True)
        sys.exit(1)
    print(f"ok: {what}", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--transport", choices=["local", "socket"],
                    default="socket",
                    help="socket also runs the local plane for the "
                         "parity check")
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--requests", type=int, default=40)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out-dir", default="reports/distributed_smoke")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    os.makedirs(args.out_dir, exist_ok=True)
    base = [
        "--trace", "poisson", "--requests", str(args.requests),
        "--epochs", "4", "--seed", str(args.seed),
        "--workers", str(args.workers), "--online", "--cascade",
        "--sync-every", "0.02", "--budget", "0.02", "--smoke",
        "--device", str(device),
    ]

    local = run_serve(
        base + ["--trace-out",
                os.path.join(args.out_dir, "trace-local.json")],
        "local plane")
    check(local["completed"] == args.requests,
          f"local plane completed all {args.requests} requests")
    if args.transport == "local":
        with open(os.path.join(args.out_dir, "summary-local.json"),
                  "w") as f:
            json.dump(local, f, indent=2, default=str)
        print("distributed smoke (local only): PASS", flush=True)
        return 0

    metrics_out = os.path.join(args.out_dir, "metrics-socket.prom")
    sock = run_serve(
        base + ["--transport", "socket",
                "--trace-out",
                os.path.join(args.out_dir, "trace-socket.json"),
                "--metrics-out", metrics_out],
        "socket plane")

    # Real OS processes: controller + one per follower, all distinct.
    pids = sock.get("pids", {})
    check(len(set(pids.values())) >= args.workers
          and len(pids) == args.workers,
          f"socket run spanned {len(set(pids.values()))} distinct OS "
          f"processes {sorted(pids.values())}")
    check(pids.get(0) == os.getpid() or pids.get("0") == os.getpid(),
          "controller is this process (wid 0)")

    # Sharded pool layout covers every member with a valid owner.
    owners = sock.get("pool_owner", {})
    check(owners and all(0 <= int(o) < args.workers
                         for o in owners.values()),
          f"pool shard layout {owners}")

    # Transport parity: identical deterministic rollups.
    for key in PARITY_KEYS:
        lv, sv = local.get(key), sock.get(key)
        check(lv == sv, f"parity on {key!r}: local={lv} socket={sv}")
    for key in COORD_KEYS:
        lv = local["coordinator"].get(key)
        sv = sock["coordinator"].get(key)
        check(lv == sv,
              f"coordinator parity on {key!r}: local={lv} socket={sv}")
    versions = set(sock["router_versions"].values())
    check(len(versions) == 1,
          f"all workers converged to one router version {versions}")

    # RPC observability: both traces validate (no dangling client->server
    # flow links), the transport-invariant message kinds emit identical
    # client/server span counts, and every remote GENERATE leg in the
    # socket trace resolves to a server-side span in the owning process.
    from repro_torch.distributed import messages as M
    from repro_torch.obs import validate_span_tree

    with open(os.path.join(args.out_dir, "trace-local.json")) as f:
        ldoc = json.load(f)
    with open(os.path.join(args.out_dir, "trace-socket.json")) as f:
        sdoc = json.load(f)
    for name, doc in (("local", ldoc), ("socket", sdoc)):
        errs = validate_span_tree(doc)
        check(not errs, f"{name} trace span tree valid "
                        f"({len(errs)} problems: {errs[:3]})")
    invariant = set(M.RPC_SPAN_KINDS) - {M.GENERATE, M.LEDGER_OP}
    lc, sc = rpc_counts(ldoc, invariant), rpc_counts(sdoc, invariant)
    check(lc and lc == sc,
          f"rpc span parity on transport-invariant kinds "
          f"({sum(lc.values())} spans over {len(lc)} (kind, side) pairs)")
    gen = [e for e in rpc_spans(sdoc) if e["args"]["kind"] == M.GENERATE]
    gen_cli = [e for e in gen if e["args"]["side"] == "client"]
    gen_srv = {e["args"]["rpc"]: e for e in gen
               if e["args"]["side"] == "server"}
    check(gen_cli, f"socket run produced remote GENERATE rpc spans "
                   f"({len(gen_cli)} client legs)")
    check(all(e["args"]["rpc"] in gen_srv
              and gen_srv[e["args"]["rpc"]]["pid"] != e["pid"]
              for e in gen_cli),
          "every remote GENERATE client span links to a server span in "
          "a different worker process")

    # Federated metrics: the merged fleet exposition carries follower-
    # labelled series next to the controller's own.
    fleet_path = metrics_out + ".fleet.prom"
    check(os.path.exists(fleet_path),
          f"fleet metrics exposition {fleet_path} written")
    with open(fleet_path) as f:
        fleet_text = f.read()
    check('worker="1"' in fleet_text,
          'fleet exposition contains follower-labelled (worker="1") series')
    check("rpc_requests" in fleet_text,
          "fleet exposition exports transport rpc telemetry")

    for name, summary in (("local", local), ("socket", sock)):
        with open(os.path.join(args.out_dir, f"summary-{name}.json"),
                  "w") as f:
            json.dump(summary, f, indent=2, default=str)
    for artifact in ("trace-local.json", "trace-socket.json"):
        check(os.path.exists(os.path.join(args.out_dir, artifact)),
              f"trace artifact {artifact} written")
    print("distributed smoke: PASS", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
