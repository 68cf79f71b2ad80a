"""Streaming routed serving on the PyTorch port: the paper's router
fronting the assigned-architecture pool under simulated open-loop traffic.

    PYTHONPATH=src python examples/torch_routed_serving.py [--device cpu]

The port of ``examples/routed_serving.py``. Builds three pool members
(the reduced configs, as the reference's example does: a dense, an MoE,
and a second dense family member) on the CUDA card unless ``--device``
names another device (with no card and no ``--device`` it raises), trains
the attention router on synthetic RouterBench traffic mapped onto them,
then drives the continuous micro-batching scheduler three ways:

  1. steady Poisson traffic at the nominal willingness-to-pay;
  2. the same traffic at a near-zero lambda (everything routes cheap);
  3. a bursty trace under a tight rolling budget — the governor shifts
     traffic toward cheaper members as the window overspends.
"""
import argparse
import sys

from repro_torch.configs import get_config
from repro_torch.launch.serve import build_routed_engine
from repro_torch.serving.budget import BudgetGovernor
from repro_torch.serving.scheduler import (
    MicroBatchScheduler, SchedulerConfig, default_service_model,
)
from repro_torch.serving.traffic import TraceConfig, make_trace

POOL = ["qwen3-0.6b", "granite-moe-1b-a400m", "granite-3-8b"]
SEED = 0


def run(engine, data, te, *, kind, lam, budget=None, n=48, score_batch=32):
    trace = make_trace(
        TraceConfig(kind=kind, n_requests=n, rate=400.0, seed=SEED,
                    max_new=2, prompt_len_max=24, vocab=64),
        texts=[data.texts[i] for i in te],
        benchmarks=[data.benchmark[i] for i in te],
    )
    engine.lam = lam
    governor = None
    if budget is not None:
        governor = BudgetGovernor(budget, window_s=0.2, lam0=lam)
    sched = MicroBatchScheduler(
        engine, SchedulerConfig(score_batch=score_batch, max_batch=8),
        governor=governor, service_time=default_service_model())
    summary = sched.run_trace(trace)
    label = f"{kind} lam={lam:g}" + (f" budget=${budget:g}" if budget else "")
    print(f"--- {label}")
    print("   routed:", summary["per_member_counts"],
          f" spend ${summary['total_spend']:.6f}")
    if governor is not None:
        print(f"   governor: final lambda {governor.lam:.3g} "
              f"(tightened x{governor.tightened})")
    return summary


def main(argv=None, *, epochs: int = 150, n_traffic: int = 1200,
         n_steady: int = 48, n_bursty: int = 96) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    engine, data, te = build_routed_engine(POOL, seed=SEED, epochs=epochs,
                                           n_traffic=n_traffic, device=args.device)
    print(f"device: {engine.device}")
    for m in engine.pool:
        full = get_config(m.name)
        print(f"member {m.name:24s} cost ${m.cost_rate:.6f}/request "
              f"({full.active_param_count()/1e9:.2f}B active params full-size)")

    run(engine, data, te, kind="poisson", lam=1.0, n=n_steady)
    run(engine, data, te, kind="poisson", lam=1e-7, n=n_steady)
    # Small score batches -> more dispatch rounds -> the governor gets
    # enough controller steps to visibly shift traffic mid-trace.
    run(engine, data, te, kind="bursty", lam=1.0, budget=5e-4, n=n_bursty,
        score_batch=12)
    return 0


if __name__ == "__main__":
    sys.exit(main())
