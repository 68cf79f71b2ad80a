"""One window of a serving cell with the port's host tracer installed, read
by the cell's per-layer metrics and by the readers of the program's spans.

    python3 portbench/host_window.py --workload pool3.backlog --seed 7 --seconds 51

From the repository root, on a CUDA card. It runs what ``portbench/run.py
--trace 1`` runs, and besides installs the host tracer for the window and
hands its spans to the readers and to the device trace
(``portbench/host_spans.py``), so that the breakdown names each idle gap by
the innermost program span. It prints one JSON line: ``correct``, the
attempted and failed counts, ``metrics`` (name to value; the units of the
program spans' readers are in ``host_spans.READERS``), the device's busy
and traced seconds, the breakdown and the compared numbers. ``serving.run``
does not install the tracer itself; with that wiring in it, this script
has nothing left to do.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path
from typing import Dict, Optional

ROOT = Path(__file__).resolve().parents[1]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
    os.environ.setdefault(var, str(ROOT / "portbench" / ".cache" / sub))


def window(cell: Dict, seed: int, seconds: float, trace: bool, device="cuda",
           smoke: bool = False) -> Dict:
    """``serving.run``'s window and readings, the host tracer installed
    over it and the readers of its spans read beside the cell's own."""
    from portbench import checks, host_spans, serving
    from portbench.common import load_reader, per_layer_names
    from portbench.trace import breakdown, device_fields
    st = serving.Setup(cell, seed, device, smoke)
    tracer = host_spans.open_window()
    try:
        w = serving.drive(st, seed, seconds, trace)
    finally:
        host_spans.close_window()
    ctx = {"requests": w["reqs"], "spans": st.log.spans, "trace": w["trace"],
           "window_end_s": w["t_end"], "members": {m["name"]: m for m in st.members},
           "peak_window_bytes": w["window_peak"], "router": st.router,
           "seconds": seconds}
    host_spans.attach(ctx, w["trace"], tracer, st.log.t0)
    names = (per_layer_names(cell["name"]) if trace else []) + list(host_spans.READERS)
    metrics = {name: v for name in names if (v := load_reader(name)(ctx)) is not None}
    st.scheduler = None
    correct, verdicts = checks.judge(serving.numbers(st, w["reqs"], seed), cell["limits"])
    out = {"correct": correct, "attempted": w["attempted"], "failed": w["failed"],
           "metrics": metrics, "checks": verdicts}
    if w["trace"] is not None:
        out.update(device=device_fields(w["trace"]), breakdown=breakdown(w["trace"]))
    return out


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    import torch
    from portbench.common import cell_spec, forbidden_loaded, log
    if not torch.cuda.is_available():
        log("portbench: host_window needs a CUDA card")
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(min(4, os.cpu_count() or 1))
    cell = cell_spec(args.workload)
    if cell["kind"] != "serving":
        log(f"portbench: {args.workload!r} is not a serving cell")
        return 2
    out = window(cell, args.seed, args.seconds, True)
    bad = forbidden_loaded()
    if bad:
        log(f"portbench: forbidden modules loaded in this process: {bad}")
        return 4
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
