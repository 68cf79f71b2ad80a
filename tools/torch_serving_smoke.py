"""Serving-runtime smoke on the PyTorch port: replay a ~2-virtual-second
traffic trace through the full queue -> scheduler -> engine pipeline and
assert every request is accounted for.

    PYTHONPATH=src python tools/torch_serving_smoke.py [--device cpu]

The port of ``tools/serving_smoke.py``, on the CUDA card unless
``--device`` names another device (with no card and no ``--device`` it
raises).
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.launch.serve import build_routed_engine
from repro_torch.serving.budget import BudgetGovernor
from repro_torch.serving.queue import DONE
from repro_torch.serving.scheduler import (
    MicroBatchScheduler, SchedulerConfig, default_service_model,
)
from repro_torch.serving.traffic import TraceConfig, make_trace


def main(argv=None, *, epochs: int = 5, n_traffic: int = 300,
         n_requests: int = 24) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    # Tiny everything: 2 cheapest members, a handful of training epochs
    # (the smoke exercises runtime mechanics, not router accuracy).
    engine, data, te = build_routed_engine(
        ["qwen3-0.6b", "granite-moe-1b-a400m"], seed=0, epochs=epochs,
        n_traffic=n_traffic, device=args.device)

    trace = make_trace(
        TraceConfig(kind="bursty", n_requests=n_requests, rate=12.0, seed=0,
                    max_new=2, prompt_len_max=16, vocab=64),
        texts=[data.texts[i] for i in te],
    )  # rate 12/s -> ~2 virtual seconds of traffic
    governor = BudgetGovernor(budget=1e-3, window_s=0.5, lam0=1.0)
    sched = MicroBatchScheduler(
        engine, SchedulerConfig(score_batch=16, max_batch=8),
        governor=governor, service_time=default_service_model())
    summary = sched.run_trace(trace)

    n = summary["completed"] + summary["rejected"] + summary["expired"]
    ok = (n == len(trace)
          and summary["completed"] > 0
          and summary["total_spend"] > 0
          and all(r.output is not None for r in trace if r.status == DONE))
    print(f"device: {engine.device}")
    print(sched.telemetry.report(summary.get("duration_s")))
    print(f"serving smoke: {'OK' if ok else 'FAIL'} "
          f"({summary['completed']}/{len(trace)} served, "
          f"spend ${summary['total_spend']:.6f}, "
          f"final lambda {governor.lam:.3g})")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
