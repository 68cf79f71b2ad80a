"""Write a pool's router file, ``routers/<config>.npz``: the port's
``train_router`` run once on the CPU (``launch/serve.py::train_engine``'s
recipe: synthetic RouterBench queries mapped onto the pool, ``attn``
quality and cost heads, R2), saved in the checkpoint layout the port's
``train_engine(router_path=...)`` loads.

    PYTHONPATH=src python3 portbench/router_file.py --config pool3

The file is then a fixed input, like published weights: a serving cell
hands it to the program, and the plain reference reads the same raw file
with numpy (``reference/router.py::load``). No run of the benchmark
trains a router or reads a table the program made.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--queries", type=int, default=1200)
    ap.add_argument("--epochs", type=int, default=120)
    args = ap.parse_args()
    import torch
    from portbench.common import HERE, load_json
    from portbench.members import port_config
    from repro_torch.checkpoint import save_router
    from repro_torch.launch import serve
    from repro_torch.serving.engine import PoolMember, arch_cost_rate

    torch.manual_seed(args.seed)
    names = [m["name"] for m in load_json(HERE / "configs" / f"{args.config}.json")["members"]]
    pool = [PoolMember(name=n, cfg=port_config(n), params=None,
                       cost_rate=arch_cost_rate(port_config(n))) for n in names]
    router = serve.train_router(serve.synthetic_pool_traffic(pool, n=args.queries, seed=args.seed),
                                seed=args.seed, device="cpu", epochs=args.epochs)
    path = HERE / "routers" / f"{args.config}.npz"
    save_router(str(path), router, pool_names=names)
    print(path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
