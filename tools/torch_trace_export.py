"""Inspect / validate / filter Chrome-trace JSON emitted by the PyTorch
port's serving runtime (``--trace-out`` on ``repro_torch.launch.serve``,
``tools/torch_obs_smoke.py``).

The port of ``tools/trace_export.py``, reading traces with
``repro_torch.obs``. It reads and writes JSON on the host and touches no
tensor, so, unlike the port's other entry points, it takes no
``--device`` and runs on a machine with or without a card.

The files are already Perfetto-loadable (https://ui.perfetto.dev — open the
JSON directly, or chrome://tracing). This CLI covers what a UI doesn't:

    # validate schema + span-tree well-formedness, print a summary
    PYTHONPATH=src python tools/torch_trace_export.py trace.json

    # one request's full span tree (tid = trace key + 1)
    PYTHONPATH=src python tools/torch_trace_export.py trace.json --request 7

    # re-emit a filtered trace (one worker / selected categories) for
    # loading into Perfetto, pretty-printed for diffing
    PYTHONPATH=src python tools/torch_trace_export.py trace.json \\
        --worker 0 --cat request,cascade -o filtered.json --pretty

    # stitch a streaming run's rotated segments (--scrape-every) back
    # into one valid Chrome trace; accepts the obs dir (reads its
    # manifest) or explicit segment files in flush order
    PYTHONPATH=src python tools/torch_trace_export.py concat obs_dir \\
        -o full.json
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.obs import (
    request_trees,
    trace_summary,
    validate_chrome_trace,
    validate_span_tree,
)


def load(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def filter_doc(doc: dict, worker=None, cats=None) -> dict:
    """Subset a trace document; metadata rows follow surviving workers."""
    out = []
    for ev in doc["traceEvents"]:
        if ev.get("ph") == "M":
            if worker is None or ev.get("pid") == worker:
                out.append(ev)
            continue
        if worker is not None and ev.get("pid") != worker:
            continue
        if cats is not None and ev.get("cat") not in cats:
            continue
        out.append(ev)
    return {**doc, "traceEvents": out}


def rpc_index(doc: dict) -> dict:
    """rpc link id -> {"client": span, "server": span} over the doc's
    cross-process rpc spans (both sides of one RPC share args["rpc"])."""
    idx = {}
    for ev in doc["traceEvents"]:
        if ev.get("ph") != "X" or ev.get("name") != "rpc":
            continue
        a = ev.get("args") or {}
        if a.get("rpc") is None:
            continue
        idx.setdefault(a["rpc"], {})[a.get("side")] = ev
    return idx


def print_request(doc: dict, key: int) -> int:
    trees = request_trees(doc)
    tid = key + 1
    if tid not in trees:
        print(f"no events for request trace key {key} (tid {tid})")
        return 1
    t = trees[tid]
    rpcs = rpc_index(doc)
    for ev in sorted(t["events"], key=lambda e: (e["ts"], e.get("dur", 0))):
        dur = f"  dur={ev['dur'] / 1e3:.3f}ms" if "dur" in ev else ""
        args = f"  {ev['args']}" if ev.get("args") else ""
        print(f"  {ev['ts'] / 1e3:10.3f}ms  w{ev['pid']}  "
              f"[{ev['cat']}] {ev['name']}{dur}{args}")
        # Follow the span's rpc flow link across process boundaries: the
        # remote leg's server-side span lives on another pid's runtime
        # track, not in this request tree.
        link = (ev.get("args") or {}).get("rpc")
        if link is not None and ev.get("name") != "rpc":
            pair = rpcs.get(link, {})
            for side in ("client", "server"):
                leg = pair.get(side)
                if leg is not None:
                    print(f"      ↳ rpc#{link} {side} w{leg['pid']}  "
                          f"{leg['ts'] / 1e3:.3f}ms  "
                          f"dur={leg.get('dur', 0) / 1e3:.3f}ms  "
                          f"kind={leg['args'].get('kind')}")
            if "server" not in pair:
                print(f"      ↳ rpc#{link} server span MISSING "
                      f"(dangling flow link)")
    root = t["root"]
    if root is not None:
        print(f"request root: status={root.get('args', {}).get('status')}  "
              f"legs={root.get('args', {}).get('legs')}  "
              f"span {root['ts'] / 1e3:.3f}ms -> "
              f"{(root['ts'] + root['dur']) / 1e3:.3f}ms")
    return 0


def main_concat(argv) -> int:
    import os

    from repro_torch.obs import concat_segments
    from repro_torch.obs.stream import segment_paths

    ap = argparse.ArgumentParser(
        prog="torch_trace_export.py concat",
        description="stitch rotated trace segments into one Chrome trace")
    ap.add_argument("inputs", nargs="+",
                    help="an obs segment directory (reads manifest.json) "
                         "or trace-*.json segment files in flush order")
    ap.add_argument("-o", "--out", default=None,
                    help="write the stitched trace here (default: stdout "
                         "summary only)")
    ap.add_argument("--pretty", action="store_true",
                    help="indent the output JSON")
    ap.add_argument("--no-validate", action="store_true",
                    help="skip schema/span-tree validation")
    args = ap.parse_args(argv)

    if len(args.inputs) == 1 and os.path.isdir(args.inputs[0]):
        paths = segment_paths(args.inputs[0])
    else:
        paths = args.inputs
    if not paths:
        print("no trace segments found")
        return 1
    doc = concat_segments(paths)

    rc = 0
    if not args.no_validate:
        schema = validate_chrome_trace(doc)
        tree = validate_span_tree(doc)
        for err in schema[:20]:
            print(f"schema: {err}")
        for err in tree[:20]:
            print(f"span-tree: {err}")
        if schema or tree:
            rc = 1
        else:
            print("valid chrome trace, well-formed span tree")

    summ = trace_summary(doc)
    print(f"{len(paths)} segments -> {summ['events']} events  "
          f"workers {summ['workers']}  requests {summ['requests']} "
          f"({summ['finalized']} finalized)")
    if doc["otherData"].get("drops"):
        d = doc["otherData"]["drops"]
        print(f"drops: {d.get('requests_sampled_out', 0)} trees sampled "
              f"out, {d.get('requests_shed', 0)} shed by the cap")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(doc, f, sort_keys=True,
                      indent=2 if args.pretty else None,
                      separators=None if args.pretty else (",", ":"))
        print(f"wrote stitched trace -> {args.out}")
    return rc


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] == "concat":
        return main_concat(argv[1:])
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trace", help="Chrome-trace JSON file")
    ap.add_argument("--request", type=int, default=None, metavar="KEY",
                    help="print one request's span tree (its trace key)")
    ap.add_argument("--worker", type=int, default=None,
                    help="keep only this worker's events")
    ap.add_argument("--cat", default=None,
                    help="comma-separated categories to keep")
    ap.add_argument("-o", "--out", default=None,
                    help="write the (filtered) trace JSON here")
    ap.add_argument("--pretty", action="store_true",
                    help="indent the output JSON")
    ap.add_argument("--no-validate", action="store_true",
                    help="skip schema/span-tree validation")
    args = ap.parse_args(argv)

    doc = load(args.trace)

    rc = 0
    if not args.no_validate:
        schema = validate_chrome_trace(doc)
        tree = validate_span_tree(doc)
        for err in schema[:20]:
            print(f"schema: {err}")
        for err in tree[:20]:
            print(f"span-tree: {err}")
        if schema or tree:
            rc = 1
        else:
            print("valid chrome trace, well-formed span tree")

    if args.request is not None:
        return print_request(doc, args.request) or rc

    summ = trace_summary(doc)
    print(f"label: {doc.get('otherData', {}).get('label')}  "
          f"deterministic: {doc.get('otherData', {}).get('deterministic')}")
    print(f"{summ['events']} events  workers {summ['workers']}  "
          f"requests {summ['requests']} ({summ['finalized']} finalized)")
    by = ", ".join(f"{k}={v}" for k, v in sorted(summ["by_name"].items()))
    print(f"by name: {by}")
    rpcs = rpc_index(doc)
    if rpcs:
        n_cli = sum(1 for p in rpcs.values() if "client" in p)
        n_srv = sum(1 for p in rpcs.values() if "server" in p)
        linked = sum(1 for p in rpcs.values()
                     if "client" in p and "server" in p)
        cross = sum(1 for p in rpcs.values()
                    if "client" in p and "server" in p
                    and p["client"]["pid"] != p["server"]["pid"])
        print(f"rpc: {n_cli} client / {n_srv} server spans  "
              f"{linked} linked pairs ({cross} cross-worker)")

    if args.out:
        cats = set(args.cat.split(",")) if args.cat else None
        filtered = filter_doc(doc, worker=args.worker, cats=cats)
        with open(args.out, "w") as f:
            json.dump(filtered, f, sort_keys=True,
                      indent=2 if args.pretty else None,
                      separators=None if args.pretty else (",", ":"))
        n = sum(1 for e in filtered["traceEvents"] if e.get("ph") != "M")
        print(f"wrote {n} events -> {args.out}")
    return rc


if __name__ == "__main__":
    sys.exit(main())
