"""Read the two ends of every compared number on the card, at the cell's
own size, in one process: the program's sound runs over many seeds (the
lower readings) and the control, the reference computed in TF32 in the
program's place, on a few (the upper readings). A training cell also
reads, on the seeds given to ``--fault``, the half-batch fault planted in
the reference put in the program's place, and counts the reference's
top-8 choices that sit within 1e-6 of a tie.

    python3 portbench/calibrate.py --workload pool3.backlog --seeds 1,2,3 --control 1,2 --seconds 15

Serving seeds share one set-up (the router is the cell's router file):
each seed remakes the weights, serves a window of the cell's load, and
compares a sample as a run does. One JSON line per seed.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

# The control's precision: the configurations state float32 with TF32 off.
CONTROL = "tf32"


def serving_cell(cell, seeds, control, seconds):
    from portbench import serving
    st = serving.Setup(cell, seeds[0], "cuda")
    for i, seed in enumerate(seeds):
        if i:
            st.reseed(seed)
        w = serving.drive(st, seed, seconds, False, warm=(i == 0))
        row = {"seed": seed, "e2e": w["e2e"], "program": serving.numbers(st, w["reqs"], seed)}
        if seed in control:
            row["control"] = serving.numbers(st, w["reqs"], seed, CONTROL)
        print(json.dumps(row), flush=True)


def near_ties(counter):
    """Count, in the reference's forward passes, the routing decisions whose
    top_k-th and next expert probabilities lie within 1e-6: where float32
    rounding in another summation order can pick another expert."""
    import torch
    from portbench.reference import model as ref_model
    real = ref_model.moe

    def moe(m, p, x, cap, prec):
        with torch.no_grad():
            probs = torch.softmax(ref_model.mm(x, p["router"], prec).float(), dim=-1)
            top = torch.topk(probs, m["top_k"] + 1, dim=-1).values
            counter["decisions"] += top.shape[0]
            counter["near_ties"] += int((top[:, -2] - top[:, -1] < 1e-6).sum())
        return real(m, p, x, cap, prec)

    ref_model.moe = moe
    return real


def training_cell(cell, seeds, control, fault):
    import torch
    from portbench import checks, training
    from portbench.reference import model as ref_model
    for seed in seeds:
        st = training.Setup(cell, seed, 1.0, "cuda")
        got = st.first_steps()
        entry, shapes, batches, adam = st.entry, st.shapes, st.batches[:3], st.adam
        del st
        torch.cuda.empty_cache()
        counter = {"decisions": 0, "near_ties": 0}
        real = near_ties(counter)
        ref = training.reference_steps(entry, shapes, seed, batches, adam, "cuda")
        ref_model.moe = real
        row = {"seed": seed, "routing": counter, "program": checks.training_gaps(got, ref),
               "losses": got["losses"], "ref_losses": ref["losses"]}
        if seed in control:
            ctrl = training.reference_steps(entry, shapes, seed, batches, adam, "cuda", CONTROL)
            row["control"] = checks.training_gaps(ctrl, ref)
            del ctrl
        if seed in fault:
            half = training.reference_steps(entry, shapes, seed, batches, adam, "cuda",
                                            rows=slice(0, len(batches[0]["lengths"]) // 2))
            row["fault_half_batch"] = checks.training_gaps(half, ref)
            del half
        del ref, got
        print(json.dumps(row), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", default="")
    ap.add_argument("--fault", default="")
    ap.add_argument("--seconds", type=float, default=15.0)
    args = ap.parse_args()
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from portbench.common import cell_spec
    cell = cell_spec(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    control = {int(s) for s in args.control.split(",") if s}
    fault = {int(s) for s in args.fault.split(",") if s}
    if cell["kind"] == "serving":
        serving_cell(cell, seeds, control, args.seconds)
    else:
        training_cell(cell, seeds, control, fault)
    return 0


if __name__ == "__main__":
    sys.exit(main())
