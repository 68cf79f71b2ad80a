"""Run one cell of ``BENCHMARK.json`` and print its result line last.

    python3 portbench/run.py --workload pool3.backlog --seed 7 --seconds 51 --trace 0

From the repository root. It refuses to run without a CUDA card (or with
fewer cards than the cell asks for), and prints no result if JAX, the JAX
package ``repro`` or ``benchmarks/`` got loaded. ``--trace 1`` reports
the cell's per-layer metrics and a breakdown instead of its end-to-end
metrics. The lines before the last say what was compared and how late
the traffic generator ran; the compared numbers with their limits are
also the last lines on standard error.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))
# Every cache the program or its libraries keep lives inside the checkout,
# at a fixed path, so that only a cell's first run there builds anything.
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
    os.environ.setdefault(var, str(ROOT / "portbench" / ".cache" / sub))


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    from portbench.common import (cell_spec, device_info, end_to_end_names, forbidden_loaded,
                                  log, manifest, per_layer_names, result_line)
    cells = {w["name"]: w for w in manifest()["workloads"]}
    if args.workload not in cells:
        log(f"portbench: {args.workload!r} is not a cell of BENCHMARK.json")
        return 2
    import torch
    chips = cells[args.workload]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"portbench: the cell needs {chips} CUDA card(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available")
        return 3
    # The configurations state float32 with TF32 off.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(min(4, os.cpu_count() or 1))
    cell = cell_spec(args.workload)
    if cell["kind"] == "serving":
        from portbench import serving as runner
    else:
        from portbench import training as runner
    out = runner.run(cell, args.seed, args.seconds, bool(args.trace), device="cuda",
                     t_start=T_START, per_layer=per_layer_names(args.workload),
                     end_to_end=end_to_end_names(args.workload))
    bad = forbidden_loaded()
    if bad:
        log(f"portbench: forbidden modules loaded in this process: {bad}")
        return 4
    device = device_info(chips)
    device["memory_peak_bytes"] = int(out["peak_bytes"])
    if args.trace:
        device.update(out["device_extra"])
    for name, c in out["checks"].items():
        log(f"[correct] {name} {c['value']!r} limit {c['limit']!r}")
    print(result_line(correct=out["correct"], attempted=out["attempted"], failed=out["failed"],
                      metrics=out["metrics"], device=device, checks=out["checks"],
                      breakdown=out.get("breakdown")), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
