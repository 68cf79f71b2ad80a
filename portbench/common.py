"""What every cell shares: the manifests, seeds, device facts and the
result line.

A cell's files are found by name: ``workloads/<cell>.json`` names its
config (``configs/<config>.json``) and its traffic mix
(``traffic/<traffic>.json``); each per-layer metric is read by
``metrics/<metric>.py``. ``BENCHMARK.json`` at the checkout's root says
which per-layer metrics a cell reports.
"""
from __future__ import annotations

import importlib.util
import json
import math
import sys
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

# Top-level module names the benchmark's process may never hold: JAX and
# its libraries, the JAX package the port was made from, and the reference
# repository's own benchmark scripts. Compared whole, so ``repro_torch``
# (the system under test) is not ``repro``.
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro", "benchmarks")


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def manifest() -> Dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell_spec(name: str) -> Dict:
    """The cell's own file with its config and traffic mix merged in under
    ``config`` and ``traffic``."""
    path = HERE / "workloads" / f"{name}.json"
    if not path.exists():
        raise SystemExit(f"portbench: no cell {name!r} ({path} missing)")
    cell = load_json(path)
    cell["name"] = name
    cell["config"] = load_json(HERE / "configs" / f"{cell['config']}.json")
    cell["traffic"] = load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    return cell


def per_layer_names(cell: str) -> List[str]:
    """The per-layer metrics ``BENCHMARK.json`` lists for ``cell``."""
    return [m["name"] for m in manifest()["per_layer"]
            if cell in m.get("workloads", [cell])]


def end_to_end_names(cell: str) -> List[str]:
    return [m["name"] for m in manifest()["end_to_end"]
            if cell in m.get("workloads", [cell])]


def metric_units() -> Dict[str, str]:
    m = manifest()
    return {e["name"]: e["unit"] for e in m["end_to_end"] + m["per_layer"]}


def load_reader(metric: str) -> Callable:
    """``metrics/<metric>.py``'s ``read(ctx)``: a number, or None when the
    run gave it nothing to read."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def sub_seed(seed: int, *salt: int) -> int:
    """A 63-bit seed for one use of the run's ``--seed`` (any whole
    number, negative or past 64 bits included)."""
    h = int(seed) % (1 << 63)
    for s in salt:
        h = (h * 6364136223846793005 + 1442695040888963407 + int(s)) % (1 << 63)
    return h


def quantile(values: Sequence[float], q: float) -> float:
    """The ``q`` quantile (0..1) by linear interpolation between order
    statistics, over all ``values``."""
    xs = sorted(values)
    if not xs:
        return math.nan
    pos = q * (len(xs) - 1)
    lo = int(math.floor(pos))
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def forbidden_loaded(modules: Optional[Dict] = None) -> List[str]:
    """Forbidden top-level names among ``modules`` (``sys.modules``)."""
    modules = dict(sys.modules if modules is None else modules)
    return sorted({name.split(".")[0] for name, mod in modules.items()
                   if name.split(".")[0] in FORBIDDEN_MODULES and mod is not None})


def device_info(count: int = 1) -> Dict:
    import torch
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(0))}


def result_line(*, correct: bool, attempted: int, failed: int, metrics: Dict[str, float],
                device: Dict, checks: Dict[str, Dict], breakdown: Optional[Dict] = None) -> str:
    units = metric_units()
    out = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
           "metrics": {k: {"value": float(v), "unit": units[k]} for k, v in metrics.items()},
           "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return json.dumps(out)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)
