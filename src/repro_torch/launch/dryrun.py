"""Multi-pod dry-run: trace every (architecture x input shape) step on the
production mesh without the hardware, and count what one device does.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-0.6b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod
    ... --probe-repeats 1   (roofline probe: one pattern repeat, coarse
                             flash tiles, see models/runtime_flags.py)

The port of ``repro.launch.dryrun``. The reference lowers and compiles
each step on 512 forced host devices; the port runs the step, as rank 0
of a fake process group of 256 (or 512) ranks, on meta tensors: the
params, optimizer state, batch and caches are DTensors over meta local
shards placed by ``launch/sharding.py``, so nothing is allocated and no
collective moves data, while every op and collective of rank 0 runs its
shape logic. ``launch/hlo_analysis.py`` counts the FLOPs, the peak bytes
and the collective bytes per device.

Writes one JSON record per run under ``--out-dir`` (default
``reports/dryrun/``) and prints a one-line summary; exits nonzero if any
run failed. A host tool: it touches no GPU. It starts its own (fake)
process group, so run it as a child process wherever a real one is live.

The port's models compute in float32 (the bf16 policy is not wired into
them), so params, caches and moments are float32 here, where the
reference's dry-run takes bf16 params and caches: the port's param and
cache bytes are twice the reference's. Beyond the reference's flags:
``--mesh 1x1`` traces on a one-device mesh (to hold the counts against a
real step on one card), ``--batch`` and ``--seq`` replace the shape's
global batch and sequence length, and ``--smoke`` takes the smoke configs.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time
import traceback
from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.common.tree import tree_map
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.configs.base import ArchConfig
from repro_torch.configs.shapes import SHAPES, input_specs, shape_applicable
from repro_torch.launch.hlo_analysis import StepCounter, summarize
from repro_torch.launch.mesh import make_fake_mesh, make_production_mesh, mesh_chips
from repro_torch.launch.sharding import (
    NamedSharding, batch_shardings, cache_shardings, param_shardings,
)
from repro_torch.launch.steps import (
    TRAIN_ADAM, abstract_opt_state, make_decode_step, make_prefill_step, make_train_step,
)
from repro_torch.models import lm as lm_mod
from repro_torch.models import runtime_flags

MOMENT_DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}


def probe_config(cfg: ArchConfig, n_repeats: int) -> ArchConfig:
    """Shrink to n_repeats pattern repeats (roofline probe)."""
    return dataclasses.replace(
        cfg,
        n_repeats=n_repeats,
        n_layers=len(cfg.pattern) * n_repeats + len(cfg.remainder),
    )


def _place(t: torch.Tensor, sh: NamedSharding) -> DTensor:
    """A meta global tensor as a DTensor holding rank 0's shard (the
    first chunk along each sharded dim, in mesh order), made locally: no
    collective, no data."""
    placements = sh.placements
    local = t
    for md, p in enumerate(placements):
        if p.is_shard():
            local = local.chunk(sh.mesh.size(md), dim=p.dim)[0]
    return DTensor.from_local(local.contiguous(), sh.mesh, placements, run_check=False,
                              shape=t.shape, stride=t.stride())


def _placed(tree, shardings):
    return tree_map(_place, tree, shardings)


def lower_one(
    arch: str,
    shape_name: str,
    *,
    mesh=None,
    multi_pod: bool = False,
    probe_repeats: int = 0,
    donate: bool = True,
    microbatch: int = 1,
    moment_dtype: str = "fp32",
    seq_shard: bool = False,
    xlstm_gather: bool = False,
    variant: str = "",
    batch: Optional[int] = None,
    seq: Optional[int] = None,
    smoke: bool = False,
):
    """Trace and count one (arch, shape, mesh). Returns the report dict.
    ``mesh`` defaults to the production mesh; ``smoke`` takes the smoke
    config (tests)."""
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    shape = SHAPES[shape_name]
    if not shape_applicable(cfg, shape):
        return {"arch": arch, "shape": shape_name, "status": "skipped",
                "reason": "long_500k requires sub-quadratic decode"}
    if probe_repeats:
        cfg = probe_config(cfg, probe_repeats)
    if seq is not None:
        shape = dataclasses.replace(shape, seq_len=seq)
    mesh = mesh if mesh is not None else make_production_mesh(multi_pod=multi_pod)
    t0 = time.time()
    abstract = lm_mod.abstract_params(cfg)
    params = _placed(abstract, param_shardings(cfg, mesh, abstract))
    specs = input_specs(cfg, shape, batch_override=batch)
    if shape.kind == "train":
        adam_cfg = dataclasses.replace(TRAIN_ADAM, moment_dtype=MOMENT_DTYPES[moment_dtype])
        rules_override = {}
        if seq_shard:
            rules_override["seq"] = "model"
        if xlstm_gather:
            rules_override["xlstm_gather_params"] = True
        step = make_train_step(cfg, mesh, adam_cfg, microbatch=microbatch,
                               rules_override=rules_override or None, donate=donate)
        opt = abstract_opt_state(cfg, params, adam_cfg)    # mirrors the params
        args = (params, opt, _placed(specs, batch_shardings(mesh, specs)))
    else:
        caches = specs.pop("caches")
        tensors = {k: v for k, v in specs.items() if isinstance(v, torch.Tensor)}
        b = {**specs, **_placed(tensors, batch_shardings(mesh, tensors)),
             "caches": _placed(caches, cache_shardings(cfg, mesh, caches))}
        step = (make_prefill_step if shape.kind == "prefill" else make_decode_step)(cfg, mesh)
        args = (params, b)
    t_setup = time.time() - t0
    counter = StepCounter()
    counter.hold(args)
    with counter:
        out = step(*args)
    summary = summarize(counter, args, out)
    t_trace = time.time() - t0 - t_setup
    names = "x".join(str(n) for n in mesh.shape)
    return {
        "arch": arch,
        "shape": shape_name,
        "variant": variant,
        "mesh": names,
        "chips": mesh_chips(mesh),
        "probe_repeats": probe_repeats,
        "status": "ok",
        "lower_s": round(t_setup, 1),
        "compile_s": round(t_trace, 1),
        "param_count": cfg.param_count(),
        "active_param_count": cfg.active_param_count(),
        "batch": batch or shape.global_batch,
        "seq_len": shape.seq_len,
        **summary,
    }


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--probe-repeats", type=int, default=0,
                    help="roofline probe: n pattern repeats, coarse flash tiles")
    ap.add_argument("--out-dir", default="reports/dryrun")
    ap.add_argument("--no-donate", action="store_true")
    # §Perf hillclimb levers (train shapes):
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--moment-dtype", choices=["fp32", "bf16"], default="fp32")
    ap.add_argument("--seq-shard", action="store_true",
                    help="shard train activations' seq dim over 'model'")
    ap.add_argument("--xlstm-gather", action="store_true",
                    help="ZeRO-3 gathered-weights mode for xLSTM blocks")
    ap.add_argument("--variant", default="",
                    help="tag appended to the output file name")
    # The port's, to hold a count against a real step on one card:
    ap.add_argument("--mesh", choices=["production", "1x1"], default="production",
                    help="1x1: a one-device mesh instead of 16x16 / 2x16x16")
    ap.add_argument("--batch", type=int, default=None, help="global batch override")
    ap.add_argument("--seq", type=int, default=None, help="sequence length override")
    ap.add_argument("--smoke", action="store_true", help="the reduced smoke configs")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)
    if args.all:
        pairs = [(a, s) for a in ARCH_IDS for s in SHAPES]
    elif args.arch and args.shape:
        pairs = [(args.arch, args.shape)]
    else:
        raise SystemExit("dryrun: give --arch and --shape, or --all")
    if args.mesh == "1x1":
        mesh, mesh_tag = make_fake_mesh((1, 1), ("data", "model")), "1x1"
    else:
        mesh = make_production_mesh(multi_pod=args.multi_pod)
        mesh_tag = "2x16x16" if args.multi_pod else "16x16"

    os.makedirs(args.out_dir, exist_ok=True)
    failures = 0
    try:
        for arch, shape in pairs:
            tag = f"{arch}__{shape}__{mesh_tag}"
            if args.probe_repeats:
                tag += f"__probe{args.probe_repeats}"
            if args.variant:
                tag += f"__{args.variant}"
            out_path = os.path.join(args.out_dir, tag + ".json")
            try:
                ctx = (runtime_flags.unroll_inner() if args.probe_repeats
                       else contextlib.nullcontext())
                with ctx:
                    rep = lower_one(
                        arch, shape, mesh=mesh,
                        probe_repeats=args.probe_repeats,
                        donate=not args.no_donate,
                        microbatch=args.microbatch,
                        moment_dtype=args.moment_dtype,
                        seq_shard=args.seq_shard,
                        xlstm_gather=args.xlstm_gather,
                        variant=args.variant,
                        batch=args.batch, seq=args.seq, smoke=args.smoke,
                    )
            except Exception as e:  # noqa: BLE001 — record the pair, go on, exit nonzero
                rep = {"arch": arch, "shape": shape, "status": "error",
                       "error": f"{type(e).__name__}: {e}",
                       "traceback": traceback.format_exc()[-4000:]}
                failures += 1
            with open(out_path, "w") as f:
                json.dump(rep, f, indent=2)
            status = rep["status"]
            extra = ""
            if status == "ok":
                extra = (f"flops={rep['flops']:.3e} "
                         f"coll={rep['collective_bytes_per_device']:.3e}B "
                         f"peak={rep['peak_bytes_per_device']/2**30:.2f}GiB "
                         f"compile={rep['compile_s']}s")
            elif status == "error":
                extra = rep["error"][:200]
            print(f"[dryrun] {tag}: {status} {extra}", flush=True)
    finally:
        dist.destroy_process_group()
    if failures:
        print(f"{failures} dry-run failures", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
