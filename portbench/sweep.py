"""Find a serving cell's knee once, on the card: one set-up, then open-loop
windows at several offered rates, each with the cell's own mix, and the
share of requests each member gets over a grid of lambda.

    python3 portbench/sweep.py --workload pool3.steady --rates 2,3,4,5,6 --seconds 30

For each rate it prints p50 and p95 (ms, from due time), how long the
queue took to drain after the window closed, and the mean latency of the
window's first and last fifths: a queue that grows shows as a drain of
more than a round and a last fifth far slower than the first. The knee is
the highest rate whose queue does not grow.
"""
from __future__ import annotations

import argparse
import copy
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", default="pool3.steady")
    ap.add_argument("--rates", default="2,3,4,5,6")
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--lams", default="", help="lambdas to print the shares at")
    ap.add_argument("--serve-lams", default="",
                    help="lambdas to serve the rates at (default: the cell's)")
    args = ap.parse_args()
    import numpy as np
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    from portbench import generator, serving
    from portbench.common import cell_spec, quantile
    cell = cell_spec(args.workload)
    st = serving.Setup(cell, args.seed, "cuda")
    mix = cell["traffic"]
    shapes = generator.request_shapes(mix, 2000)
    s, c = st.engine.score_texts([x["text"] for x in shapes])
    lams = [float(x) for x in args.lams.split(",") if x] or list(
        np.geomspace(cell["lam"] * 0.96, cell["lam"] * 1.04, 9))
    for lam in lams:
        share = np.bincount(st.engine.choose(s, c, lam), minlength=len(st.members)) / len(s)
        print(json.dumps({"lam": lam, "shares": share.tolist()}), flush=True)
    st.warm_up([x["text"] for x in shapes])
    serve_lams = [float(x) for x in args.serve_lams.split(",") if x] or [cell["lam"]]
    for lam, rate in [(lam, float(r)) for lam in serve_lams for r in args.rates.split(",")]:
        st.engine.lam = lam
        m = copy.deepcopy(mix)
        m["rate_per_s"] = rate
        due = generator.open_loop_due(m, args.seconds, args.seed)
        specs = generator.requests(m, len(due), args.seed, st.vocab)
        st.log.spans.clear()
        st.clock.start()
        st.log.t0 = st.clock.t0
        reqs = serving._run_open_loop(st, specs, due, args.seconds, None, 0.0)
        lat = serving.latencies_ms(reqs)
        fifth = max(1, len(reqs) // 5)
        first = [(r.finish_s - r.arrival_s) * 1e3 for r in reqs[:fifth]]
        last = [(r.finish_s - r.arrival_s) * 1e3 for r in reqs[-fifth:]]
        print(json.dumps({
            "lam": lam, "rate": rate, "n": len(reqs), "done": len(lat), "p50_ms": quantile(lat, 0.5),
            "p95_ms": quantile(lat, 0.95),
            "drain_s": max(r.finish_s for r in reqs) - args.seconds,
            "first_fifth_ms": float(np.mean(first)), "last_fifth_ms": float(np.mean(last)),
            "gen_calls": sum(1 for x in st.log.spans if x["name"] == "generate_member"),
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
