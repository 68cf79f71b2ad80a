#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero before the last line):
  1. device: the card's name and power limit (nvidia-smi); TF32 off.
  2. build: ``router_xattn`` and ``pairwise_l2`` from src/repro_torch/csrc,
     one nvcc for each source, both started together; ptxas's register,
     spill and shared-memory lines for each kernel instance.
  3. kernel: hold ``router_xattn`` against its plain PyTorch version over
     B x K x d (fp32 within 1e-5, bf16 q within 2e-2) and time both at the
     serving engine's shapes (K 3 at B 8 and 256), each with the cluster
     size, grid and shared bytes of its launch (``[launch]``).
  4. pairwise_l2: hold the kernel against its plain version over N x K x d
     (fp32 within 1e-4, bf16 within 5e-2), identical rows exactly 0, and
     time kernel, plain version and the ``torch.cdist`` yardstick at the
     four shapes the cached serving path gives it, each with its launch's
     cluster size, grid and shared bytes (``[launch]``).
  5. train: ``build_engine`` builds the reference's default pool,
     qwen3-0.6b, granite-moe-1b-a400m (32 experts, top-8) and granite-3-8b,
     at published width and depth, fp32, on the card, and trains their
     router there as the reference does (1200 synthetic RouterBench queries
     mapped onto the pool, k-means model embeddings, ``attn`` quality and
     cost predictors for 120 epochs with AdamW, the best-validation params
     kept); wall times, ms per optimizer step and the losses;
     ``router_xattn`` on the trained params (K = 3) held against the plain
     predictor over the 240 held-out queries (1e-5).
  6. serve: on that pool and trained router, ``engine.serve`` on 8 seeded
     requests, then ``generate_member`` on each member.
  7. breakdown and reference: where a warm serve's time goes, with prefill
     and decode step per member and the device's busy time and idle share
     in each; engine scores against the plain predictor; smoke-size
     qwen3-0.6b and granite-moe logits and tokens on the card against the
     CPU; finite full-size logits of every member.
  8. moe: full-width granite-moe generates the 8 requests through
     ``generate_member`` with the decode drop log set: every logged count
     must be 0, one per MoE layer and decode step; prefill and decode step
     with the device's busy time, the decode step's bytes bound, the real
     assignments the prefill capacity drops; each request alone must give
     its tokens in the batch (a part is excused only at a logit or
     router-probability margin of at most 1e-4); and the trained router's
     routing split of the 240 held-out queries over the lambda grid.
  9. trace: on the same pool, a seeded ``neardup`` trace of 192 requests
     through the streaming scheduler with the semantic cache as rung 0 (a
     calibrated radius, cap 256) and a cache-owned drift detector fitted on
     the training split against the router's k-means centroids.
 10. lookup: a deployment-size cache (cap 4096, at least 512 entries)
     answers 64 queries through the kernel; its hits equal a CPU twin's.
 11. online: on the same pool, ``launch/serve.py::make_adapter`` (drift
     detector of window 48 fitted on the training split, an update every
     32 outcomes, epsilon 0.05, seed 0, feedback from the truth lookup):
     a 192-request ``drift`` trace (every request accounted for, outcomes
     equal to the generate legs, updates published by swap, the live
     router's tensors bitwise unchanged across every ``run_steps``,
     ``router_xattn`` on the newest router within 1e-5 of the plain
     predictor over 64 held-out queries); ms per incremental step with the
     device's busy time; 96 requests with staged feedback (0.01 virtual s
     late, jitter 0.005: every outcome resolves, none expires); then
     qwen1.5-4b at published size hot-added (K = 4, ``router_xattn`` within
     1e-5; 64 requests in which the probationary member is never the
     exploit argmax) and removed (memory back within 0.1 GiB).
 12. cascade: an ``attn-ens`` router trained on the same pool through
     ``train_engine``; ``make_cascade`` (cost ladder ascending in the
     scaler's mu, 3 legs, observed quality from the truth lookup) with the
     semantic cache as rung 0 on a 96-request ``neardup`` trace at lambda
     5e-4 (escalations, ``finalized_by_leg`` summing to the completed
     requests, each request's $ the sum of its legs, rung-0 stops equal to
     the cache's served count); then the adapter and the cascade together
     on 48 requests (the adapter observes every leg).
 13. obs: on the same pool, the 96-request ``neardup`` trace at lambda 1
     with the semantic cache and a budget governor, twice under the whole
     obs stack (a recorder sampling 0.25 with a head of 8 and a cap of 256
     buffered events, the metrics registry with scheduler, governor, SLO
     and stream metrics, p95 and miss-rate SLOs, a flusher every 0.05
     virtual s, the kernel-dispatch profiler) and once without it: the
     trace and span tree validate, the two runs' trace, segment files and
     deterministic metrics are byte-identical, the profiler's calls equal
     each kernel's launches, and each kernel's profiled p50 and p99 print
     beside its ``[kernel]`` and ``[pairwise_l2]`` times.
 14. fleet: three in-process workers on the same pool through
     ``serve.build_plane`` from the serve CLI's flags (``--online``, a
     96-request ``drift`` trace, sync every 0.05, worker 1 crashed at 0.08
     and rejoined at 0.2, one shared ledger of $0.01 per 0.5 s), twice:
     the workers' device memory within 0.5 GiB (one pool, shared), every
     worker up on one router version, no stale publish, requests
     reassigned, ``router_xattn`` on every worker within 1e-5 of the plain
     predictor, the rpc spans validate, and the two runs' rollups and
     traces equal; the wall by part, syncs, merges, updates and lambda.
 15. socket: with the default pool freed, the serve CLI with the same flags
     as child processes, once with ``--transport local`` and once with
     ``--transport socket`` (workers 1 and 2 as OS processes on the card,
     each building only the pool members it owns and training its router
     from the seed), both with ``--trace-out``, ``--metrics-out *.prom`` and
     ``--trace-profile``: the rollup lines equal, three pids, one owner per
     member, each process's params its members' bytes and its device memory
     (the allocator's peak it reports, nvidia-smi's sampled from here) within
     a stated margin of them, every router digest the controller's when
     ready and at the end, the merged trace valid with every GENERATE client
     span paired with a server span in another process, the followers'
     series in the fleet exposition, and both kernels launched in every
     process (the profiler's kernel spans per pid); the walls, and the
     socket run's wall by part from the arrival times of its lines.
 16. attn_long: with the default pool freed, smoke qwen1.5-4b (nonzero QKV
     biases) and gemma3-27b (window 8) on the card against the CPU at 17 and
     2048 tokens (1e-4); a pool of qwen3-0.6b, qwen1.5-4b and gemma3-27b at
     full width, fp32, gemma3 cut to 8 layers (7 local with window 1024, 1
     global), with its router trained through ``train_engine``; 8 requests
     served, then two of 2500 and 40 tokens (the engine pads the batch to
     the flash chunk), and the routing split of the 240 held-out queries
     through ``router_xattn`` at K = 3 (1e-5 against the plain predictor); gemma3's
     prompts of 1020, 1536, 2048 and 4096 tokens as one left-padded batch
     and each alone (a part excused only at a logit margin of at most 1e-4);
     one full-width gemma3 layer's flash against dense at S 4096 and its ring
     cache against a full cache across the wrap (1e-4); prefill and decode
     step of qwen1.5-4b and gemma3 at S 1536, 2048 and 4096 with the
     device's busy time and the decode step's bytes bound.
 17. recurrent: with the attention pool freed, smoke xlstm-1.3b and the
     jamba hybrid on the card against the CPU at 17 and 600 tokens (xlstm
     pads 600 to 768; 1e-4); a pool of qwen3-0.6b, xlstm-1.3b at published
     size (48 layers, sLSTM:mLSTM 1:7) and jamba-1.5-large at published
     width cut to layers 2-3 of its block (mamba+MLP, attn+MoE), fp32, with its
     router trained through ``train_engine``; 8 requests served, two of
     1000 and 40 tokens through ``generate_member`` on xlstm (padded to
     1024, the mLSTM chunk), and the routing split of the 240 held-out
     queries through ``router_xattn`` at K = 3 (1e-5 against the plain
     predictor); xlstm's prompts of 100, 300, 1024 and 2048 tokens as one
     left-padded batch and each alone (a part excused only at a logit
     margin of at most 1e-4); one full-width mLSTM layer's chunkwise form
     against ``mlstm_step`` token by token at S 512 (h 3e-5, C 1e-5; with the
     init's input-gate bias and with it shifted to 0) and one
     full-width Mamba layer's chunked scan against its decode step (1e-4);
     prefill and decode step of xlstm at S 1024 and 2048 and of jamba at S
     1024, B 1 and 8, with the device's busy time, the decode step's bytes
     bound (weights, the K/V cache, the recurrent state read and written)
     and xlstm's sLSTM and mLSTM shares of prefill (one layer of each timed
     alone, times its count).
 18. multimodal: with the recurrent pool freed, smoke musicgen-large,
     llama4-maverick and llama-3.2-vision (with seeded stub media) on the
     card against the CPU at 17 and 600 tokens (1e-4); then two pools in
     turn, each built by ``build_cut_pool`` (``build_pool``, then the cut
     member) with its router trained through ``train_engine`` and freed
     before the next (checked < 1 GiB left).
     Pool A: qwen3-0.6b, musicgen-large at published size (48 layers) and
     llama-3.2-vision at published width cut to one repeat of its pattern
     (4 self-attention layers, then one cross layer over 1601 media tokens
     of 1280), with its stub media. Pool B: qwen3-0.6b and llama4-maverick
     at published width cut to its first two layers (ATTN+MLP, ATTN+MoE,
     128 experts top-1 and a shared expert). For each pool: 8 requests
     served and generated by each member but qwen3 with the MoE decode drop
     log set (all 0), and the routing split of the 240 held-out queries
     through ``router_xattn`` (1e-5 against the plain predictor). On pool A,
     the vision member's prompts of 40, 300, 1000 and 2048 tokens as one
     left-padded batch (flash self attention, dense cross attention; peak
     memory printed) and each alone (a part excused only at a logit margin
     of at most 1e-4), and the full-width cross layer's decode step on the
     prefilled media cache against its full sequence (1e-5). Prefill and
     decode step of musicgen, the vision member and llama4 at S 1024, B 1
     and 8, with the device's busy time, the decode step's bytes bound (the
     media K/V counted; for llama4 with the experts the tokens chose and
     with all 128, as the decode rule reads them) and llama4's prefill
     capacity drops; device memory after each build and each timing.
 19. table2: the paper's Table 2 on pool1 (K = 5) with benchmarks/common.py's
     defaults (4000 queries, 300 epochs): the attention router and the MLP
     trained on the card, KNN (k = 20), SVM, LLM-Blender and the oracle, each
     with AIQ and perf_max over the 25-point lambda grid; the same attention
     quality predictor trained on the CPU from the same initial params must
     agree (losses rtol 1e-3, AIQ 5e-3); ``router_xattn`` on the trained
     params over the 1000 held-out queries (1e-5), timed.
 20. lm_train: the LM training path. ``lm_loss`` and its gradient for every
     param of each of the ten smoke configs (B 2, S 64; MoE at capacity
     factor 8.0) and of smoke gemma3 at S 2048 (banded flash, window 8),
     card against CPU from the same seeded params and corpus batch (loss
     1e-5 relative, each gradient leaf 1e-4 of its largest magnitude);
     qwen3-0.6b and granite-moe-1b-a400m (``var_len``) at published size
     through ``train_loop``, B 8, S 1024, 5 steps, seed 0: losses finite
     and falling, the allocator's peak against params + grads + two
     moments, the loop's in-place step timed alone (host clock ending in a
     sync; device busy and idle share from torch.profiler) against its
     FLOP bound, the MoE aux and its gradient on a router, and qwen3's
     one-step peak with and without donation; then the train CLI as a
     child process (``python -m repro_torch.launch.train --arch qwen3-0.6b
     --smoke --steps 20 --checkpoint build/lm_train/cli.npz``): exit 0, its
     loss falling, its checkpoint loaded back with ``load_checkpoint``.
 21. mesh: the LM steps on a 1x1 NCCL mesh (``make_debug_mesh(1, 1)``;
     params, moments and batches as DTensors placed by the reference's
     rules): qwen3-0.6b at published size, B 8, S 1024, three
     ``make_train_step`` steps from the same seeded params with the mesh
     and with ``mesh=None`` (losses within 1e-6 relative, each step's ms,
     the idle share, the allocator's peak, DTensor's overhead per step);
     one granite-moe-1b-a400m ``var_len`` step on the mesh against the
     plain step (1e-5); the group destroyed; then the dry-run as child
     processes that see no card: at the same shape on a 1x1 mesh (its
     FLOPs within 1% of the real step's ``FlopCounterMode`` count, beside
     6·N·T; its peak beside the allocator's), and qwen3-0.6b train_4k on
     the fake 16x16 production mesh (its record's figures).
Each path (serve, moe, trace, lookup, online, cascade, obs, fleet, socket,
attn_long, recurrent, multimodal, lm_train, mesh) runs with every kernel's launch count set to 0 just
before it and read just after; a kernel of the path that was not launched
fails the run (the socket path launches in its child processes, so its counts
are the profiler's kernel spans in its merged trace, one per launch on the
card, and this process's own counts must stay 0) (the cascade's ``attn-ens`` router scores on the plain
predictor, as the reference's does, so only ``pairwise_l2`` runs there;
no kernel of the port is on the LM training path or the mesh path, so
both counts must stay 0 there).
The kernel checks on trained params (train, table2) are counted the same
way. The second-to-last line is a JSON object with the kernels' numbers,
the last ``{"ok": true, "device": {...}}``. The kernel libraries are built
into build/repro_torch/ under the checkout.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

POOL = ["qwen3-0.6b", "granite-moe-1b-a400m", "granite-3-8b"]
MOE_MEMBER = "granite-moe-1b-a400m"
N_REQUESTS = 8
MAX_NEW = 8
# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, fp32 FLOP/s off the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
SWEEP_B, SWEEP_K, SWEEP_D = (1, 37, 64, 256, 1000), (2, 3, 5, 11), (4, 20, 64)
PL2_SWEEP = ((1, 1, 8), (8, 3, 16), (100, 20, 768), (256, 256, 64), (300, 37, 128),
             (48, 20, 768), (900, 20, 768), (512, 512, 768), (64, 4096, 768),
             (1000, 1000, 1024))
# (N, K, d) of each pairwise_l2 call site on the cached serving path.
PL2_PATH_SHAPES = (("drift window", (48, 20, 768)), ("drift fit", (900, 20, 768)),
                   ("calibrate_radius", (512, 512, 768)),
                   ("match, cap 4096", (64, 4096, 768)))
TRACE_REQUESTS = 192
DRIFT_WINDOW = 48
LOOKUP_CAP = 4096
LOOKUP_QUERIES = 64
# [online] on the default pool: a drift trace with immediate feedback, a
# trace with staged feedback (delivered 0.01 virtual s late, jitter up to
# half that), then a published-size member hot-added and removed.
ONLINE_REQUESTS = 192
STAGED_REQUESTS = 96
FEEDBACK_DELAY = 0.01
HOTADD_MEMBER = "qwen1.5-4b"
HOTADD_REQUESTS = 64
HELD_OUT_CHECK = 64
# [cascade] on the default pool with an attn-ens router: lambda on the pool's
# $ per request scale (1e-4 to 1e-3), as the reference's cascade soak sets
# it, so leg 1 prefers a cheap member and the ladder has room to climb.
CASCADE_REQUESTS = 96
COMPOSED_REQUESTS = 48
CASCADE_LAM = 5e-4
# [obs] on the default pool: the neardup trace with the semantic cache at
# lambda 1 under the whole obs stack (sampled recorder with a cap, registry,
# SLOs, a flusher every 0.05 virtual s, the kernel profiler), run twice, and
# once without the stack for the wall it costs.
OBS_REQUESTS = 96
OBS_SAMPLE, OBS_HEAD, OBS_CAP = 0.25, 8, 256
OBS_SCRAPE_EVERY = 0.05
OBS_BUDGET = (0.01, 0.5)          # $ per window, window in virtual s
OBS_SLO = {"p95_target_s": 0.05, "miss_rate_budget": 0.05}
# [fleet]: three in-process workers sharing the default pool, the serve CLI's
# own flags: online, a drift trace, a crash of worker 1 and its rejoin, one
# shared budget ledger.
FLEET_WORKERS = 3
FLEET_REQUESTS = 96
FLEET_ARGV = ["--trace", "drift", "--online", "--workers", str(FLEET_WORKERS),
              "--requests", str(FLEET_REQUESTS), "--sync-every", "0.05",
              "--crash-at", "0.08", "--rejoin-at", "0.2", "--crash-worker", "1",
              "--budget", "0.01", "--budget-window", "0.5"]
FLEET_SHARED_GIB = 0.5
# [socket]: the [fleet] argv through the serve CLI as child processes, once
# per transport; over sockets workers 1 and 2 are OS processes, each holding
# only the pool members it owns (round-robin: w0 qwen3-0.6b, w1 granite-moe,
# w2 granite-3-8b). A process's device memory may exceed its members' params
# by SOCKET_ALLOC_MARGIN_GIB as its caching allocator reserves it (generate's
# activations and the router's training state), and by SOCKET_MARGIN_GIB as
# nvidia-smi counts it (also the CUDA context, about 0.5 GiB); where
# nvidia-smi lists the run's processes as one row, their sum by N margins.
SOCKET_MARGIN_GIB = 2.0
SOCKET_ALLOC_MARGIN_GIB = 1.0
SOCKET_TIMEOUT_S = 600
SOCKET_ROLLUP = ("completed ", "per-member counts:", "per-member spend:", "total spend ",
                 "plane: ", "coordinator: ", "shared budget ")
# [attn_long]: a pool of the attention members, gemma3-27b at full width cut
# to one repeat of its 6-layer pattern (5 local, 1 global) plus its 2-local
# remainder; the default pool is freed first.
ATTN_POOL = ["qwen3-0.6b", "qwen1.5-4b", "gemma3-27b"]
WINDOW_MEMBER = "gemma3-27b"
WINDOW_MEMBER_LAYERS = 8
LONG_PROMPTS = (1020, 1536, 2048, 4096)
PREFILL_LENGTHS = (1536, 2048, 4096)
# Served beside each other: 2500 is past FLASH_MIN_SEQ and off its chunk.
SERVED_LONG = (2500, 40)
# [recurrent]: xlstm-1.3b at published size and jamba-1.5-large at published
# width, cut to layers 2-3 of its 8-layer block (mamba+MLP, attn+MoE: a
# Mamba state beside a KV cache, one MoE FFN, which is what fits the card);
# the attention pool is freed first.
RECURRENT_POOL = ["qwen3-0.6b", "xlstm-1.3b", "jamba-1.5-large-398b"]
XLSTM_MEMBER, JAMBA_MEMBER = RECURRENT_POOL[1:]
JAMBA_CUT = slice(2, 4)
# xlstm alone vs batched: 300 pads to 512 alone, the batch to 2048.
RECURRENT_PROMPTS = (100, 300, 1024, 2048)
# Served on xlstm beside each other: 1000 is off the mLSTM chunk (pads to 1024).
SERVED_RECURRENT = (1000, 40)
RECURRENT_TIMES = ((XLSTM_MEMBER, (1024, 2048)), (JAMBA_MEMBER, (1024,)))
CHUNK_CHECK_SEQ = 512
# [multimodal]: pool A holds musicgen-large at published size and
# llama-3.2-vision at published width cut to one repeat of its pattern (4
# self + 1 cross layer); pool B, built once A is freed, llama4-maverick at
# published width cut to one repeat (ATTN+MLP, ATTN+MoE), which fits only
# beside the smallest member. The recurrent pool is freed first.
MULTIMODAL_POOLS = (("A", ["qwen3-0.6b", "musicgen-large", "llama-3.2-vision-90b"]),
                    ("B", ["qwen3-0.6b", "llama4-maverick-400b-a17b"]))
MUSIC_MEMBER, VISION_MEMBER = MULTIMODAL_POOLS[0][1][1:]
LLAMA4_MEMBER = MULTIMODAL_POOLS[1][1][1]
# The vision member alone vs batched, with its stub media: the batch pads to
# 2048 (flash self attention), where cross attention stays dense.
VISION_PROMPTS = (40, 300, 1000, 2048)
MULTIMODAL_TIMES_S = 1024
# The full-width cross layer's decode against the full sequence: B, S.
CROSS_CHECK = (2, 64)


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def router_inputs(seed, b, k, d, dq=768, dm=20):
    """Engine-like operands on the card: unit-norm query rows, model
    embeddings in [0, 1), fan-in-scaled weights except an N(0, 1) Wq (so
    the softmax over members is far from uniform)."""
    from repro_torch.kernels import ops

    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).cuda()  # noqa: E731
    q = rng.standard_normal((b, dq))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    w = lambda i, o: rng.standard_normal((i, o)) / np.sqrt(i)  # noqa: E731
    kt, vt = ops.pool_projections(t(w(dm, d)), t(w(dm, d)), t(rng.uniform(size=(k, dm))))
    return [t(q), t(rng.standard_normal((dq, d))), kt, vt, t(w(d, k)),
            t(rng.standard_normal(k) * 0.1)]


def time_ms(fn, n=200, repeats=7) -> float:
    """Median over ``repeats`` of the mean per-call time of ``n`` back-to-back
    calls, between CUDA events."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        per_call.append(start.elapsed_time(end) / n)
    return float(np.median(per_call))


def router_xattn_bound(b, k, d, dq) -> tuple:
    """Least time on an H100 SXM for one call: bytes (each input read once,
    the output written once) over HBM bandwidth vs fp32 operations over the
    CUDA-core peak. Returns (ms, "bytes" | "operations")."""
    n_bytes = 4 * (b * dq + dq * d + 2 * k * d + d * k + k + b * k)
    ops = (2 * b * dq * d          # qp = q Wq
           + 2 * b * k * d         # logits
           + 4 * b * k             # scale, max-subtract, exp, normalize
           + 2 * b * k * d         # ctx = alpha V~
           + 2 * b * d * k + b * k)  # ctx Wo + bo
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, ops / FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def phase_build(modules) -> None:
    """Build every kernel library at once: one nvcc per source, in parallel
    (each build waits on its own subprocess)."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(modules)) as pool:
        builds = list(pool.map(lambda m: m.build(), modules))
    for (lib, ptxas) in builds:
        name = os.path.basename(lib).rsplit("_", 1)[0]
        log(f"[build] {os.path.relpath(lib, ROOT)}")
        for line in ptxas.splitlines():
            if "Compiling entry function" in line:     # the kernel instance below
                log(f"[build] {name} ptxas: {line.split(':', 1)[-1].strip()}")
            elif "registers" in line or "spill" in line or "smem" in line:
                log(f"[build] {name} ptxas:   {line.split(':', 1)[-1].strip()}")
    log(f"[build] {len(modules)} libraries in {time.perf_counter() - t0:.2f}s")


def phase_kernel(rx, ref):
    err = {"float32": 0.0, "bfloat16": 0.0}
    n_cases = 0
    for b in SWEEP_B:
        for k in SWEEP_K:
            for d in SWEEP_D:
                q, wq, kt, vt, wo, bo = router_inputs(1000 * b + 10 * k + d, b, k, d)
                for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
                    qd = q.to(dtype)
                    got = rx.router_xattn_cuda(qd, wq, kt, vt, wo, bo)
                    torch.cuda.synchronize()
                    want = ref.router_xattn_pool_ref(qd, wq, kt, vt, wo, bo)
                    check(bool(torch.isfinite(got).all()), f"finite scores B={b} K={k} d={d}")
                    e = float((got - want).abs().max())
                    rel_ok = torch.allclose(got, want, rtol=tol, atol=tol)
                    check(rel_ok, f"router_xattn {dtype} B={b} K={k} d={d}: "
                                  f"max |err| {e:.3g} above tol {tol}")
                    name = "float32" if dtype == torch.float32 else "bfloat16"
                    err[name] = max(err[name], e)
                    n_cases += 1
    log(f"[kernel] {n_cases} cases within tolerance; max |err| fp32 {err['float32']:.3g}, "
        f"bf16 q {err['bfloat16']:.3g}")
    return err


def time_kernel(rx, ref, b, k, d=20, dq=768) -> dict:
    args = router_inputs(7, b, k, d, dq)
    ms = time_ms(lambda: rx.router_xattn_cuda(*args))
    plain_ms = time_ms(lambda: ref.router_xattn_pool_ref(*args))
    bound_ms, bound_by = router_xattn_bound(b, k, d, dq)
    _, by_name = profile_device(lambda: rx.router_xattn_cuda(*args), n=50)
    device_ms = sum(v for name, v in by_name.items() if "router_xattn" in name) or None
    plain_device_ms, _ = profile_device(lambda: ref.router_xattn_pool_ref(*args), n=50)
    pl = rx.plan(b, dq, d, k)
    log(f"[launch] router_xattn B={b} dq={dq} d={d} K={k}: cluster {pl.cluster}, grid "
        f"{pl.grid} blocks of {pl.threads} threads, {pl.smem} bytes shared per block "
        f"(Wq slice {pl.slice} rows per rank)")
    log(f"[kernel] B={b} K={k} d={d} dq={dq} fp32: kernel {ms:.5f} ms/call "
        f"(device {device_ms} ms), plain {plain_ms:.5f} ms/call "
        f"(device {plain_device_ms:.5f} ms), bound {bound_ms:.3g} ms ({bound_by})")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "device_ms": device_ms, "plain_device_ms": plain_device_ms,
            "cluster": pl.cluster, "grid": pl.grid, "smem_bytes": pl.smem}


def profile_device(fn, n=1, check_total=False):
    """Device time per call from torch.profiler over ``n`` calls: (busy ms,
    {kernel or copy name: ms}). Busy is the sum over device events; the
    port runs on one stream, so they do not overlap. The events are read
    from the profiler's raw results (a private attribute): building its
    Python event tree takes minutes for a prefill of a few hundred thousand
    launches. ``check_total`` also builds that tree and raises unless its
    ``key_averages()`` count the same device events, with the same total
    time to within the microsecond each event is rounded to there."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    by_name, n_events = {}, 0
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == DeviceType.CUDA:
            by_name[ev.name()] = by_name.get(ev.name(), 0.0) + ev.duration_ns() / 1e6 / n
            n_events += 1
    busy = sum(by_name.values())
    if check_total:
        avgs = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        n_avg = sum(e.count for e in avgs)
        key = ("self_device_time_total" if hasattr(avgs[0], "self_device_time_total")
               else "self_cuda_time_total") if avgs else None
        total = sum(getattr(e, key) for e in avgs) / 1e3 / n
        check(n_events > 0 and n_avg == n_events
              and abs(total - busy) <= 1e-3 * n_events / n,
              f"profile_device: raw device events {n_events} ({busy:.4f} ms) vs "
              f"key_averages() {n_avg} ({total:.4f} ms)")
        log(f"[profile] raw device events {n_events} ({busy:.4f} ms per call) agree with "
            f"key_averages() ({n_avg} events, {total:.4f} ms)")
    return busy, by_name


def _timed(module, name, record):
    """Replace ``module.name`` by a wrapper that appends (seconds, args,
    result) of each call to ``record``; returns the original."""
    fn = getattr(module, name)

    def wrapper(*args, **kwargs):
        t = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        record.append((time.perf_counter() - t, args, kwargs, out))
        return out

    setattr(module, name, wrapper)
    return fn


def step_ms(kind, q, t, m, n=50):
    """Steady-state host ms per optimizer step of the trainer's own step on
    one full batch, one ``float(loss)`` each as the training loop does; and
    the device's busy ms per step from torch.profiler."""
    from repro_torch.core.predictors import PREDICTORS
    from repro_torch.training.optim import AdamConfig, adam_init
    from repro_torch.training.predictor_trainer import make_predictor_step

    params = PREDICTORS[kind].init(torch.Generator(device="cuda").manual_seed(9),
                                   q.shape[1], t.shape[1], m.shape[1])
    cfg = AdamConfig(lr=1e-3, weight_decay=1e-5, t_max=10_000)
    step, state = make_predictor_step(kind, cfg), adam_init(cfg, params)
    for _ in range(5):
        loss, params, state = step(params, state, q, m, t)
        float(loss)
    t0 = time.perf_counter()
    for _ in range(n):
        loss, params, state = step(params, state, q, m, t)
        float(loss)
    wall_ms = (time.perf_counter() - t0) / n * 1e3
    box = [params, state]

    def one():
        loss, box[0], box[1] = step(box[0], box[1], q, m, t)
        float(loss)
    busy, _ = profile_device(lambda: [one() for _ in range(20)])
    return wall_ms, busy / 20


def phase_train(rx):
    """``build_engine`` trains the serving router on the card; then the kernel
    on the trained quality params against the plain predictor."""
    from repro_torch.common.tree import flatten_with_paths
    from repro_torch.core import model_repr
    from repro_torch.launch import serve as serve_mod
    from repro_torch.training import predictor_trainer

    calls = {"kmeans": [], "model_emb": [], "train": []}
    patched = [(model_repr, "kmeans", calls["kmeans"]),
               (serve_mod, "build_model_embeddings", calls["model_emb"]),
               (predictor_trainer, "train_predictor", calls["train"])]
    originals = [_timed(mod, name, rec) for mod, name, rec in patched]
    t0 = time.perf_counter()
    try:
        engine = serve_mod.build_engine(POOL, seed=0, device="cuda")
        torch.cuda.synchronize()
    finally:
        for (mod, name, _), fn in zip(patched, originals):
            setattr(mod, name, fn)
    t_build = time.perf_counter() - t0
    for m in engine.pool:
        n = sum(p.numel() for p in flatten_with_paths(m.params).values())
        experts = (f", {m.cfg.n_experts} experts of width {m.cfg.resolved_d_ff_expert}, "
                   f"top-{m.cfg.top_k}, {m.cfg.active_param_count() / 1e9:.4f}B active"
                   if m.cfg.n_experts else "")
        log(f"[train] {m.name}: {m.cfg.n_layers} layers d_model={m.cfg.d_model} "
            f"{n / 1e9:.4f}B params ({4 * n / 2**30:.2f} GiB) fp32 on {m.device}{experts}; "
            f"$ {m.cost_rate:.6g} per request")
    (t_km, (x, k), _, _), = calls["kmeans"]
    (t_memb, *_), = calls["model_emb"]
    log(f"[train] pool of {len(engine.pool)} + trained router built in {t_build:.2f}s; "
        f"device memory {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated, "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB peak")
    log(f"[train] k-means C={k} of {x.shape[0]} x {x.shape[1]} embeddings {t_km:.3f}s; "
        f"model embeddings (k-means included) {t_memb:.3f}s")
    summary = {"build_s": t_build, "kmeans_s": t_km, "model_emb_s": t_memb}
    for role, (secs, args, kwargs, (params, hist)) in zip(("quality", "cost"), calls["train"]):
        kind, q_emb, _, _, cfg = args[:5]
        steps = cfg.epochs * max(1, q_emb.shape[0] // cfg.batch_size)
        check(all(np.isfinite(hist["train_loss"])) and all(np.isfinite(hist["val_loss"])),
              f"{role} predictor losses finite")
        check(all(t.device.type == "cuda" for t in flatten_with_paths(params).values()),
              f"{role} predictor trained on the card")
        log(f"[train] {role} predictor {kind}: {cfg.epochs} epochs, {steps} steps of batch "
            f"{min(cfg.batch_size, q_emb.shape[0])} in {secs:.3f}s ({secs / steps * 1e3:.3f} "
            f"ms/step, validation every {cfg.eval_every} epochs included); train loss "
            f"{hist['train_loss'][0]:.6g} -> {hist['train_loss'][-1]:.6g}, best val loss "
            f"{min(hist['val_loss']):.6g}")
        summary[role] = {"kind": kind, "seconds": secs, "steps": steps,
                         "final_train_loss": hist["train_loss"][-1],
                         "best_val_loss": min(hist["val_loss"])}

    data, quality, _ = serve_mod.synthetic_pool_traffic(engine.pool, seed=0)
    tr, _, te = data.split(seed=0)
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32)).cuda()  # noqa: E731
    wall, busy = step_ms("attn", f32(data.emb[tr]), f32(quality[tr]),
                         f32(engine.router.model_emb))
    log(f"[train] attn optimizer step, batch {len(tr)}: {wall:.4f} ms host wall per step "
        f"(one float(loss) sync each); device busy {busy:.4f} ms -> idle share "
        f"{max(0.0, 1 - busy / wall):.3f}")
    summary["step_ms"], summary["step_device_ms"] = wall, busy

    rx.router_xattn_cuda.launches = 0
    s_kernel, c_kernel = engine.score_emb(data.emb[te])
    torch.cuda.synchronize()
    launches = rx.router_xattn_cuda.launches
    s_plain, c_plain = engine.router.predict(data.emb[te])
    e = float(np.abs(s_kernel - s_plain).max())
    check(launches == 1, f"the trained router's scoring launched router_xattn {launches} times")
    check(np.allclose(s_kernel, s_plain, rtol=1e-5, atol=1e-5),
          f"router_xattn on trained params vs plain predictor, max |err| {e:.3g}")
    check(np.array_equal(c_kernel, c_plain), "cost path identical on both scoring paths")
    choices = engine.choose(s_kernel, c_kernel)
    counts = np.bincount(choices, minlength=len(engine.pool))
    log(f"[train] router_xattn on the trained params, {len(te)} held-out queries "
        f"(B={len(te)}, K={len(engine.pool)}): max |err| {e:.3g} vs the plain predictor "
        f"(tol 1e-5), 1 launch; at lambda 1 it routes " + ", ".join(
            f"{m.name}={int(c)}" for m, c in zip(engine.pool, counts)))
    summary.update(launches=launches, max_abs_err=e)
    return engine, summary


def phase_serve(engine, rx, pl2):
    from repro_torch.launch.serve import synthetic_requests

    vocab = min(m.cfg.vocab_size for m in engine.pool)
    texts, prompts = synthetic_requests(N_REQUESTS, vocab, seed=0)

    rx.router_xattn_cuda.launches = 0
    pl2.pairwise_l2_cuda.launches = 0
    t0 = time.perf_counter()
    res = engine.serve(texts, prompts, max_new=MAX_NEW)
    t_serve = time.perf_counter() - t0
    per_member = []
    for mi, member in enumerate(engine.pool):
        t0 = time.perf_counter()
        outs, costs = engine.generate_member(mi, prompts, max_new=MAX_NEW)
        per_member.append((member, outs, costs, time.perf_counter() - t0))
    launches = {"router_xattn": rx.router_xattn_cuda.launches,
                "pairwise_l2": pl2.pairwise_l2_cuda.launches}

    check(launches["router_xattn"] > 0, "the serve path launched router_xattn")
    for i, out in enumerate(res["outputs"]):
        member = engine.pool[int(res["choices"][i])]
        check(len(out) == MAX_NEW, f"request {i} got {len(out)} tokens")
        check(0 <= int(out.min()) and int(out.max()) < member.cfg.vocab_size,
              f"request {i} tokens outside {member.name}'s vocab")
    n_tok = sum(len(o) for o in res["outputs"])
    counts = ", ".join(f"{m.name}={int(c)}" for m, c in zip(engine.pool,
                                                            res["per_member_counts"]))
    log(f"[serve] engine.serve: {N_REQUESTS} requests, prompts "
        f"{min(map(len, prompts))}-{max(map(len, prompts))} tokens, max_new={MAX_NEW}")
    log(f"[serve] per-member counts: {counts}; total $ {res['total_cost']:.6g}; "
        f"wall {t_serve:.3f}s; {n_tok / t_serve:.1f} tokens/s; "
        f"launches router_xattn {launches['router_xattn']}, pairwise_l2 "
        f"{launches['pairwise_l2']}")
    for member, outs, costs, dt in per_member:
        check(all(len(o) == MAX_NEW for o in outs), f"{member.name} output lengths")
        check(all(0 <= int(o.min()) and int(o.max()) < member.cfg.vocab_size for o in outs),
              f"{member.name} tokens in vocab")
        log(f"[serve] generate_member {member.name}: {len(outs)} requests, "
            f"wall {dt:.3f}s, {len(outs) * MAX_NEW / dt:.1f} tokens/s, $ {costs.sum():.6g}")
    return engine, texts, prompts, launches


def _synced(fn):
    """Host wall seconds of ``fn()``, ending in a device synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def member_profile(member, tok, mask, tag) -> dict:
    """A member's prefill of ``tok`` and its decode steps, on the host clock
    (ending in a device sync) and under torch.profiler: ms, device busy ms
    and idle share of each, and the three longest device kernels of each."""
    from repro_torch.models import lm

    cfg = member.cfg
    b, s = tok.shape
    media = member.batch_media(b)
    with torch.inference_mode():
        caches = lm.init_caches(cfg, b, s + MAX_NEW, "cuda")
        t_pre, (logits, caches) = _synced(
            lambda: lm.apply_lm_prefill(cfg, member.params, tok, caches, mask, media=media))
        nxt = torch.argmax(logits[:, -1, :cfg.vocab_size], -1)[:, None]
        steps = [_synced(lambda i=i: lm.apply_lm_decode(cfg, member.params, nxt,
                                                        caches, s + i))[0]
                 for i in range(MAX_NEW - 2)]
        busy, by_name = profile_device(lambda: lm.apply_lm_decode(
            cfg, member.params, nxt, caches, s + MAX_NEW - 2), check_total=True)
        del caches, logits             # one set of caches alive at a time
        pre_busy, pre_by_name = profile_device(lambda: lm.apply_lm_prefill(
            cfg, member.params, tok, lm.init_caches(cfg, b, s + MAX_NEW, "cuda"), mask,
            media=media))
    step = float(np.median(steps))
    out = {"prefill_ms": t_pre * 1e3, "prefill_busy_ms": pre_busy,
           "prefill_idle": max(0.0, 1 - pre_busy / (t_pre * 1e3)),
           "decode_step_ms": step * 1e3, "decode_busy_ms": busy,
           "decode_idle": max(0.0, 1 - busy / (step * 1e3))}
    log(f"[{tag}] {member.name} B={b} S={s}: prefill {out['prefill_ms']:.2f} ms "
        f"({b * s / t_pre:.0f} prompt tokens/s; profiled: device busy {pre_busy:.2f} ms -> "
        f"idle share {out['prefill_idle']:.3f}), decode step median {step * 1e3:.2f} ms "
        f"({b / step:.0f} tokens/s; profiled: device busy {busy:.2f} ms -> idle share "
        f"{out['decode_idle']:.3f})")
    for what, names in (("prefill", pre_by_name), ("decode step", by_name)):
        for name, ms in sorted(names.items(), key=lambda kv: -kv[1])[:3]:
            log(f"[{tag}]   {what} {ms:8.3f} ms  {name[:100]}")
    return out


def phase_breakdown(engine, texts, prompts):
    """Where a warm serve's time goes: host clock per layer, then the device's
    busy time and idle share from torch.profiler."""
    from repro_torch.serving.engine import pad_prompts, prompt_pad_mask

    walls = [_synced(lambda: engine.serve(texts, prompts, max_new=MAX_NEW))[0]
             for _ in range(3)]
    wall = float(np.median(walls))
    t_embed, q_emb = _synced(lambda: engine.embed(texts))
    t_score, (s_hat, c_hat) = _synced(lambda: engine.score_emb(q_emb))
    t_choose, _ = _synced(lambda: engine.choose(s_hat, c_hat))
    log(f"[breakdown] warm serve wall {wall * 1e3:.2f} ms (median of 3: "
        + ", ".join(f"{w * 1e3:.2f}" for w in walls) + "); featurizer (host) "
        f"{t_embed * 1e3:.3f} ms, scoring {t_score * 1e3:.3f} ms, choose {t_choose * 1e3:.3f} ms")
    for member in engine.pool:
        member_profile(member, pad_prompts(prompts, member.cfg).cuda(),
                       prompt_pad_mask(prompts, member.cfg).cuda(), "breakdown")
    busy, by_name = profile_device(lambda: engine.serve(texts, prompts, max_new=MAX_NEW))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    log(f"[breakdown] profiled serve: device busy {busy:.2f} ms of a {wall * 1e3:.2f} ms "
        f"unprofiled wall -> idle share {max(0.0, 1 - busy / (wall * 1e3)):.3f}")
    for name, ms in top:
        log(f"[breakdown]   {ms:8.3f} ms  {name[:100]}")


def smoke_card_vs_cpu(name, lengths, tag) -> float:
    """A smoke config's seeded params on the card and on the CPU: prefill of
    left-padded prompts of ``lengths`` and two decode steps, logits within
    1e-4; greedy tokens equal; a config with cross attention reads the
    same seeded stub media on both. Returns the largest logit gap."""
    from repro_torch.common.tree import tree_map
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.serve import stub_media
    from repro_torch.models import lm
    from repro_torch.serving.engine import pad_prompts, prompt_pad_mask

    cfg = get_smoke_config(name)
    gen = torch.Generator().manual_seed(5)
    params_cpu = lm.seed_qkv_biases(lm.init_lm(gen, cfg), cfg)
    params_gpu = tree_map(lambda t: t.cuda(), params_cpu)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, size=n, dtype=np.int32) for n in lengths]
    tok, mask = pad_prompts(prompts, cfg), prompt_pad_mask(prompts, cfg)
    b, s = tok.shape
    m_cpu = stub_media(cfg, gen)
    m_cpu = None if m_cpu is None else m_cpu.expand(b, -1, -1)
    m_gpu = None if m_cpu is None else m_cpu.cuda()
    e = 0.0
    with torch.inference_mode():
        c_cpu, c_gpu = lm.init_caches(cfg, b, s + 3, "cpu"), lm.init_caches(cfg, b, s + 3, "cuda")
        for i in range(3):      # the prefill, then two decode steps
            if i == 0:
                lg_cpu, _ = lm.apply_lm_prefill(cfg, params_cpu, tok, c_cpu, mask, media=m_cpu)
                lg_gpu, _ = lm.apply_lm_prefill(cfg, params_gpu, tok.cuda(), c_gpu,
                                                mask.cuda(), media=m_gpu)
                nxt = torch.argmax(lg_cpu[:, -1, :cfg.vocab_size], -1)[:, None]
            else:
                lg_cpu, _ = lm.apply_lm_decode(cfg, params_cpu, nxt, c_cpu, s + i - 1)
                lg_gpu, _ = lm.apply_lm_decode(cfg, params_gpu, nxt.cuda(), c_gpu, s + i - 1)
            e = max(e, float((lg_gpu.cpu() - lg_cpu).abs().max()))
            check(torch.allclose(lg_gpu.cpu(), lg_cpu, rtol=1e-4, atol=1e-4),
                  f"smoke {name} S={s} logits card vs CPU (step {i}), max |err| {e:.3g}")
    t_cpu = lm.greedy_generate(cfg, params_cpu, tok, 6, attn_mask=mask, media=m_cpu)
    t_gpu = lm.greedy_generate(cfg, params_gpu, tok.cuda(), 6, attn_mask=mask.cuda(),
                               media=m_gpu)
    check(torch.equal(t_cpu, t_gpu.cpu()), f"smoke {name} S={s} greedy tokens card vs CPU")
    log(f"[{tag}] smoke {name} on card vs CPU, prompts {list(lengths)} (S {s}): prefill "
        f"and 2 decode steps' logits max |err| {e:.3g} (tol 1e-4), greedy tokens equal")
    return e


def phase_reference(engine, texts):
    from repro_torch.models import lm
    from repro_torch.serving.engine import pad_prompts, prompt_pad_mask

    s_kernel, c_kernel = engine.score_texts(texts)
    s_plain, c_plain = engine.router.predict(engine.embed(texts))
    e = float(np.abs(s_kernel - s_plain).max())
    check(np.allclose(s_kernel, s_plain, rtol=1e-5, atol=1e-5),
          f"engine kernel scores vs plain predictor, max |err| {e:.3g}")
    check(np.array_equal(c_kernel, c_plain), "cost path identical on both scoring paths")
    log(f"[reference] engine scores: kernel vs plain predictor max |err| {e:.3g}")

    for name in ("qwen3-0.6b", MOE_MEMBER):
        smoke_card_vs_cpu(name, (5, 17, 9), "reference")

    for member in engine.pool:
        p = [np.arange(1, 17, dtype=np.int32), np.arange(3, 11, dtype=np.int32)]
        with torch.inference_mode():
            lg, _ = lm.apply_lm_prefill(member.cfg, member.params, pad_prompts(p, member.cfg).cuda(),
                                        lm.init_caches(member.cfg, 2, 16, "cuda"),
                                        prompt_pad_mask(p, member.cfg).cuda())
        check(tuple(lg.shape) == (2, 1, member.cfg.padded_vocab), f"{member.name} logits shape")
        check(bool(torch.isfinite(lg).all()), f"{member.name} full-size logits finite")
    log(f"[reference] full-size prefill logits finite, shape (B, 1, padded_vocab), all "
        f"{len(engine.pool)} members")


def decode_step_bound(member, b, s_kv, experts_read) -> tuple:
    """Least time on an H100 SXM for one fp32 decode step of ``b`` tokens
    over ``s_kv`` cached positions: bytes (every weight of the member's
    params but the embedding table read once, with ``experts_read`` expert
    SwiGLUs of the MoE layers in place of all of them, and without a cross
    layer's projector and K/V weights, which only prefill reads; ``b``
    table rows; the K/V cache in use, at most the window's positions in a
    sliding-window layer, and each cross layer's media K/V; each recurrent
    state read and written once; the logits written) over HBM bandwidth vs
    fp32 operations (2 per weight of those params a token uses, with
    ``top_k`` experts per MoE layer; 4 per attended position or media
    token, head dim and query head, 4 per state element) over the
    CUDA-core peak. Returns (ms, "bytes" | "operations", bytes)."""
    from repro_torch.common.tree import flatten_with_paths
    from repro_torch.models import lm

    cfg = member.cfg
    d, hd = cfg.d_model, cfg.resolved_head_dim
    table = cfg.padded_vocab * d
    n_moe = sum(1 for spec in cfg.layer_plan() if spec.ffn == "moe")
    expert = 3 * d * cfg.resolved_d_ff_expert
    n_x = sum(1 for spec in cfg.layer_plan() if spec.mixer == "xattn")
    prefill_only = n_x * (cfg.frontend_dim * d + d + 2 * d * cfg.n_kv_heads * hd)
    made = (sum(t.numel() for t in flatten_with_paths(member.params).values())
            - table - prefill_only)
    weights = made - (n_moe * cfg.n_experts - experts_read) * expert
    active = made - n_moe * (cfg.n_experts - cfg.top_k) * expert
    attended = sum(min(spec.window, s_kv) if spec.window > 0 else s_kv
                   for spec in cfg.layer_plan() if spec.mixer == "attn")
    attended += n_x * cfg.n_frontend_tokens
    kv = 2 * b * attended * cfg.n_kv_heads * hd
    state = sum(t.numel() for spec, cache in zip(cfg.layer_plan(),
                                                 lm.init_caches(cfg, b, 1, "meta"))
                if spec.mixer not in ("attn", "xattn") for t in cache.values())
    n_bytes = 4 * (weights + b * d + kv + 2 * state + b * cfg.padded_vocab)
    ops = (2 * b * active
           + 4 * b * attended * cfg.n_heads * hd + 4 * state)
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, ops / FP32_FLOPS
    return (max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"),
            n_bytes)


def greedy_margins(cfg, params, tok, mask, max_new, media=None):
    """``lm.greedy_generate``'s loop, also keeping each step's gap between
    the two largest logits: (tokens (B, max_new), gaps (B, max_new)) numpy."""
    from repro_torch.models import lm

    b, s = tok.shape
    toks, gaps = [], []
    with torch.inference_mode():
        caches = lm.init_caches(cfg, b, s + max_new, "cuda")
        logits, caches = lm.apply_lm_prefill(cfg, params, tok, caches, attn_mask=mask,
                                             media=media)
        for i in range(max_new):
            if i:
                logits, caches = lm.apply_lm_decode(cfg, params, toks[-1], caches, s + i - 1)
            lg = logits[:, -1, :cfg.vocab_size]
            top2 = torch.topk(lg, 2, dim=-1).values
            gaps.append(top2[:, 0] - top2[:, 1])
            toks.append(torch.argmax(lg, dim=-1)[:, None])
    return (torch.cat(toks, 1).to(torch.int32).cpu().numpy(),
            torch.stack(gaps, 1).cpu().numpy())


def phase_moe(engine, rx, pl2) -> dict:
    """Full-width granite-moe on the card: no-drop decode, prefill capacity,
    times and the decode bound, batch invariance, and the routing split."""
    from repro_torch.core import DEFAULT_LAMBDA_GRID
    from repro_torch.launch.serve import synthetic_pool_traffic, synthetic_requests
    from repro_torch.models import moe
    from repro_torch.serving.engine import pad_prompts, prompt_pad_mask

    names = [m.name for m in engine.pool]
    mi = names.index(MOE_MEMBER)
    member = engine.pool[mi]
    cfg = member.cfg
    n_moe = sum(1 for spec in cfg.layer_plan() if spec.ffn == "moe")
    vocab = min(m.cfg.vocab_size for m in engine.pool)
    texts, prompts = synthetic_requests(N_REQUESTS, vocab, seed=0)
    data, _, _ = synthetic_pool_traffic(engine.pool, seed=0)
    _, _, te = data.split(seed=0)

    # The path: generate_member with the drop log set, then the routing split.
    rx.router_xattn_cuda.launches = 0
    pl2.pairwise_l2_cuda.launches = 0
    moe.DECODE_DROP_LOG = []
    try:
        t_gen, (outs, costs) = _synced(
            lambda: engine.generate_member(mi, prompts, max_new=MAX_NEW))
        drop_log = list(moe.DECODE_DROP_LOG)
    finally:
        moe.DECODE_DROP_LOG = None
    s_hat, c_hat = engine.score_emb(data.emb[te])
    torch.cuda.synchronize()
    launches = {"router_xattn": rx.router_xattn_cuda.launches,
                "pairwise_l2": pl2.pairwise_l2_cuda.launches}

    n_steps = MAX_NEW - 1
    check(len(drop_log) == n_moe * n_steps,
          f"{len(drop_log)} decode drop logs, not {n_moe} MoE layers x {n_steps} steps")
    check(all(v == 0 for v in drop_log), f"decode dropped assignments: {sum(drop_log)}")
    check(all(len(o) == MAX_NEW and 0 <= int(o.min()) and int(o.max()) < cfg.vocab_size
              for o in outs), f"{MOE_MEMBER} output lengths and vocab")
    check(launches["router_xattn"] == 1, f"the routing split launched router_xattn "
                                         f"{launches['router_xattn']} times, not once")
    log(f"[moe] {MOE_MEMBER} generate_member: {len(prompts)} requests, prompts "
        f"{min(map(len, prompts))}-{max(map(len, prompts))} tokens, max_new={MAX_NEW}, "
        f"wall {t_gen:.3f}s, $ {costs.sum():.6g}; decode drop log {len(drop_log)} calls "
        f"(= {n_moe} MoE layers x {n_steps} steps), all 0")

    # Where the split falls over lambda (scoring only; the launch is counted above).
    rows = [(lam, np.bincount(engine.choose(s_hat, c_hat, lam), minlength=len(names)))
            for lam in DEFAULT_LAMBDA_GRID]
    log(f"[moe] routing split of the {len(te)} held-out queries by the trained router "
        f"(router_xattn, K={len(names)}, 1 launch), counts {'/'.join(names)} per lambda:")
    for i in range(0, len(rows), 5):
        log("[moe]   " + "; ".join(f"{lam:.3g}: " + "/".join(str(int(c)) for c in counts)
                                   for lam, counts in rows[i:i + 5]))
    moe_lams = [lam for lam, counts in rows if counts[mi] > 0]
    log(f"[moe] {MOE_MEMBER} is chosen at {len(moe_lams)} of {len(rows)} lambdas"
        + (f", from {min(moe_lams):.3g} to {max(moe_lams):.3g}" if moe_lams else ""))

    # Times on the device, off the counted path and with the drop log unset.
    tok, mask = pad_prompts(prompts, cfg).cuda(), prompt_pad_mask(prompts, cfg).cuda()
    b, s = tok.shape
    prof = member_profile(member, tok, mask, "moe")

    # The prefill's capacity (factor 1.25) and one decode step's chosen experts.
    dropped = _prefill_drops(member, tok, mask)
    chosen = _decode_experts(member, tok, mask)
    router_probs = moe._router_probs
    n_real = int(mask.sum())
    log(f"[moe] prefill capacity: {dropped} of {n_real * cfg.top_k * n_moe} real (token, "
        f"expert) assignments dropped over {n_moe} MoE layers ({n_real} real tokens, "
        f"capacity factor {cfg.capacity_factor}, one group per row)")
    all_ms, by, all_bytes = decode_step_bound(member, b, s + 1, n_moe * cfg.n_experts)
    read_ms, read_by, read_bytes = decode_step_bound(member, b, s + 1, chosen)
    expert_bytes = 4 * n_moe * cfg.n_experts * 3 * cfg.d_model * cfg.resolved_d_ff_expert
    log(f"[moe] decode step bound (B={b}, {s + 1} cached positions): all {n_moe} x "
        f"{cfg.n_experts} experts {expert_bytes / 1e9:.3f} GB, the step {all_bytes / 1e9:.3f} GB "
        f"-> {all_ms:.4f} ms ({by}); the {chosen} experts this step's tokens chose "
        f"({chosen / n_moe:.2f} per layer): {read_bytes / 1e9:.3f} GB -> {read_ms:.4f} ms "
        f"({read_by}); measured step {prof['decode_step_ms']:.2f} ms, device busy "
        f"{prof['decode_busy_ms']:.2f} ms (bound / busy {read_ms / prof['decode_busy_ms']:.3f})")

    # Each request alone against the same request in the padded batch.
    batch_toks, batch_gaps = greedy_margins(cfg, member.params, tok, mask, MAX_NEW)
    check(np.array_equal(batch_toks, np.stack(outs)),
          "greedy_margins reproduces generate_member's tokens")
    parts = []
    for i, p in enumerate(prompts):
        margins = []
        moe._router_probs = lambda params, x: _keep_router_gap(router_probs(params, x),
                                                               cfg.top_k, margins)
        try:
            alone, alone_gaps = greedy_margins(cfg, member.params, pad_prompts([p], cfg).cuda(),
                                               prompt_pad_mask([p], cfg).cuda(), MAX_NEW)
        finally:
            moe._router_probs = router_probs
        if np.array_equal(alone[0], batch_toks[i]):
            continue
        j = int(np.flatnonzero(alone[0] != batch_toks[i])[0])
        logit_gap = float(min(alone_gaps[0, j], batch_gaps[i, j]))
        router_gap = float(torch.stack(margins[: (j + 1) * n_moe]).min())
        parts.append(i)
        log(f"[moe] request {i} alone parts from the batch at token {j}: logit margin "
            f"{logit_gap:.3g}, router-probability margin {router_gap:.3g}")
        check(min(logit_gap, router_gap) <= 1e-4,
              f"request {i} alone parts from the batch at token {j} with margins "
              f"{logit_gap:.3g} (logits) and {router_gap:.3g} (router) above 1e-4")
    log(f"[moe] each request alone vs in the padded batch: "
        f"{len(prompts) - len(parts)} of {len(prompts)} equal"
        + (f"; parts at near ties: requests {parts}" if parts else ""))
    return {"launches": launches}


def _keep_router_gap(probs, k, margins):
    """Append the smallest gap between the k-th and (k+1)-th router
    probability over ``probs``'s tokens; return ``probs``."""
    top = torch.topk(probs, k + 1, dim=-1).values
    margins.append((top[..., k - 1] - top[..., k]).min())
    return probs


def _flash_band(s, window) -> str:
    """The k chunks each q chunk of a flash prefill of ``s`` visits."""
    from repro_torch.models import attention as attn_mod

    c = attn_mod.FLASH_CHUNK
    bands = [attn_mod.flash_band(qi * c, (qi + 1) * c, window, c) for qi in range(s // c)]
    return " ".join(f"q{qi}:k{b.start}-{b.stop - 1}" for qi, b in enumerate(bands))


def phase_attn_long(rx, pl2) -> dict:
    """Sliding-window and long-prompt attention: smoke qwen1.5-4b and gemma3
    card vs CPU; the attention pool at full width with its trained router
    serving and routing through router_xattn; gemma3's long prompts alone
    and batched; one full-width gemma3 layer's flash vs dense and ring vs
    full cache; prefill and decode times of the two new members."""
    from repro_torch.common.tree import flatten_with_paths
    from repro_torch.core import DEFAULT_LAMBDA_GRID
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models import attention as attn_mod
    from repro_torch.models.layers import apply_rope
    from repro_torch.serving.engine import pad_prompts, prompt_pad_mask

    for name in ("qwen1.5-4b", WINDOW_MEMBER):
        for lengths in ((5, 17, 9), (attn_mod.FLASH_MIN_SEQ,)):
            smoke_card_vs_cpu(name, lengths, "attn_long")

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pool = build_cut_pool(ATTN_POOL, cut_depth(n_layers=WINDOW_MEMBER_LAYERS))
    torch.cuda.synchronize()
    t_pool = time.perf_counter() - t0
    for m in pool:
        n = sum(p.numel() for p in flatten_with_paths(m.params).values())
        windows = sorted({spec.window for spec in m.cfg.layer_plan()})
        log(f"[attn_long] {m.name}: {m.cfg.n_layers} layers d_model={m.cfg.d_model} "
            f"{m.cfg.n_heads}/{m.cfg.n_kv_heads} heads of {m.cfg.resolved_head_dim}, windows "
            f"{windows}, qkv_bias {m.cfg.qkv_bias}; {n / 1e9:.4f}B params "
            f"({4 * n / 2**30:.2f} GiB) fp32; $ {m.cost_rate:.6g} per request")
    log(f"[attn_long] pool built in {t_pool:.2f}s; device memory "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated, "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB peak")
    t0 = time.perf_counter()
    engine = serve_mod.train_engine(pool, seed=0, device="cuda")
    torch.cuda.synchronize()
    log(f"[attn_long] router trained on the card through train_engine in "
        f"{time.perf_counter() - t0:.2f}s (K = {engine.router.n_members})")

    # The path: serve 8 requests, then the routing split of the held-out queries.
    names = [m.name for m in engine.pool]
    data, _, _ = serve_mod.synthetic_pool_traffic(engine.pool, seed=0)
    _, _, te = data.split(seed=0)
    vocab = min(m.cfg.vocab_size for m in engine.pool)
    texts, prompts = serve_mod.synthetic_requests(N_REQUESTS, vocab, seed=0)
    rx.router_xattn_cuda.launches = 0
    pl2.pairwise_l2_cuda.launches = 0
    t_serve, res = _synced(lambda: engine.serve(texts, prompts, max_new=MAX_NEW))
    # Two served prompts, one off the flash chunk: the engine pads the batch.
    rng = np.random.default_rng(23)
    off_chunk = [rng.integers(0, vocab, size=n, dtype=np.int32) for n in SERVED_LONG]
    t_long, res_long = _synced(lambda: engine.serve(texts[:len(off_chunk)], off_chunk,
                                                    max_new=MAX_NEW))
    s_hat, c_hat = engine.score_emb(data.emb[te])
    torch.cuda.synchronize()
    launches = {"router_xattn": rx.router_xattn_cuda.launches,
                "pairwise_l2": pl2.pairwise_l2_cuda.launches}
    check(launches["router_xattn"] == 3, f"two serves and the routing split launched "
                                         f"router_xattn {launches['router_xattn']} times, not 3")
    for r in (res, res_long):
        for i, out in enumerate(r["outputs"]):
            member = engine.pool[int(r["choices"][i])]
            check(len(out) == MAX_NEW and 0 <= int(out.min())
                  and int(out.max()) < member.cfg.vocab_size,
                  f"[attn_long] request {i}: {len(out)} tokens in {member.name}'s vocab")
    s_plain, c_plain = engine.router.predict(data.emb[te])
    e = float(np.abs(s_hat - s_plain).max())
    check(np.allclose(s_hat, s_plain, rtol=1e-5, atol=1e-5),
          f"router_xattn K={len(names)} on the attention pool's router, max |err| {e:.3g}")
    check(np.array_equal(c_hat, c_plain), "cost path identical on both scoring paths")
    log(f"[attn_long] engine.serve: {N_REQUESTS} requests, prompts "
        f"{min(map(len, prompts))}-{max(map(len, prompts))} tokens, max_new={MAX_NEW}, wall "
        f"{t_serve:.3f}s; per-member counts " + ", ".join(
            f"{n}={int(c)}" for n, c in zip(names, res["per_member_counts"]))
        + f"; total $ {res['total_cost']:.6g}")
    log(f"[attn_long] engine.serve of prompts of {'/'.join(map(str, SERVED_LONG))} tokens "
        f"(the engine pads the batch to S {attn_mod.prefill_width(max(SERVED_LONG))}): wall "
        f"{t_long:.3f}s; members " + ", ".join(
            names[int(c)] for c in res_long["choices"]) + "; tokens in vocab")
    log(f"[attn_long] router_xattn K={len(names)} B={len(te)} on the trained params: max |err| "
        f"{e:.3g} vs the plain predictor (tol 1e-5); launches on the path: router_xattn "
        f"{launches['router_xattn']} (serve 2, split 1), pairwise_l2 {launches['pairwise_l2']}")
    rows = [(lam, np.bincount(engine.choose(s_hat, c_hat, lam), minlength=len(names)))
            for lam in DEFAULT_LAMBDA_GRID]
    log(f"[attn_long] routing split of the {len(te)} held-out queries, counts "
        f"{'/'.join(names)} per lambda:")
    for i in range(0, len(rows), 5):
        log("[attn_long]   " + "; ".join(f"{lam:.3g}: " + "/".join(str(int(c)) for c in counts)
                                         for lam, counts in rows[i:i + 5]))

    # Long prompts on gemma3-27b (8 L): one left-padded batch, then each alone.
    member = engine.pool[names.index(WINDOW_MEMBER)]
    cfg = member.cfg
    window = max(spec.window for spec in cfg.layer_plan())
    rng = np.random.default_rng(19)
    long_prompts = [rng.integers(0, cfg.vocab_size, size=n, dtype=np.int32)
                    for n in LONG_PROMPTS]
    tok, mask = pad_prompts(long_prompts, cfg).cuda(), prompt_pad_mask(long_prompts, cfg).cuda()
    torch.cuda.reset_peak_memory_stats()
    t_batch, (batch_toks, batch_gaps) = _synced(
        lambda: greedy_margins(cfg, member.params, tok, mask, MAX_NEW))
    peak = torch.cuda.max_memory_allocated() / 2**30
    check(batch_toks.shape == (len(long_prompts), MAX_NEW) and 0 <= batch_toks.min()
          and batch_toks.max() < cfg.vocab_size, "long-prompt batch tokens in vocab")
    log(f"[attn_long] {WINDOW_MEMBER} ({cfg.n_layers} L) long prompts {list(LONG_PROMPTS)} as "
        f"one left-padded batch (S {tok.shape[1]}, flash with kv_valid; band of a windowed "
        f"layer {_flash_band(tok.shape[1], window)}): {t_batch:.3f}s for {MAX_NEW} tokens each; "
        f"device memory peak {peak:.2f} GiB")
    parts = []
    for i, p in enumerate(long_prompts):
        t_alone, (alone, alone_gaps) = _synced(lambda p=p: greedy_margins(
            cfg, member.params, pad_prompts([p], cfg).cuda(), prompt_pad_mask([p], cfg).cuda(), MAX_NEW))
        n = len(p)
        how = ("flash, band " + _flash_band(n, window) if n >= attn_mod.FLASH_MIN_SEQ
               else "dense") + (", ring tail at prefill" if n >= window else
                                f", ring wraps in decode at {window}" if n + MAX_NEW > window
                                else "")
        same = np.array_equal(alone[0], batch_toks[i])
        log(f"[attn_long]   {n} tokens alone ({how}): {t_alone:.3f}s, "
            + ("equal to its batch tokens" if same else "parts from its batch tokens"))
        if same:
            continue
        j = int(np.flatnonzero(alone[0] != batch_toks[i])[0])
        gap = float(min(alone_gaps[0, j], batch_gaps[i, j]))
        parts.append(i)
        log(f"[attn_long]   request {i} alone parts from the batch at token {j}: logit margin "
            f"{gap:.3g}")
        check(gap <= 1e-4, f"{n}-token request alone parts from the batch at token {j} with "
                           f"logit margin {gap:.3g} above 1e-4")
    log(f"[attn_long] each long request alone vs in the batch: "
        f"{len(long_prompts) - len(parts)} of {len(long_prompts)} equal"
        + (f"; parts at near ties: requests {parts}" if parts else ""))

    # One full-width gemma3 layer of each kind: flash vs dense at S 4096.
    plan = cfg.layer_plan()
    s_long = max(LONG_PROMPTS)
    gen = torch.Generator(device="cuda").manual_seed(23)
    errs = {}
    with torch.inference_mode():
        for li in (next(i for i, sp in enumerate(plan) if sp.window > 0),
                   next(i for i, sp in enumerate(plan) if sp.window == 0)):
            spec, p = plan[li], member.params["layers"][li]["mixer"]
            x = torch.randn((2, s_long, cfg.d_model), generator=gen, device="cuda")
            valid = torch.ones((2, s_long), dtype=torch.bool, device="cuda")
            valid[1, :s_long - LONG_PROMPTS[0]] = False
            pos = torch.arange(s_long, dtype=torch.int32, device="cuda").expand(2, s_long)
            q = apply_rope(attn_mod._project_q(cfg, p, x), pos, cfg.rope_theta)
            k, v = attn_mod._project_kv(cfg, p, x)
            k = apply_rope(k, pos, cfg.rope_theta)
            t_flash, flash = _synced(lambda: attn_mod.flash_attention(
                q, k, v, window=spec.window, kv_valid=valid))
            mask = attn_mod.causal_mask(s_long, s_long, "cuda", window=spec.window)
            t_dense, dense = _synced(lambda: attn_mod.dense_attention(
                q, k, v, mask & valid[:, None, :]))
            e = float((flash[valid] - dense[valid]).abs().max())
            check(torch.allclose(flash[valid], dense[valid], rtol=1e-4, atol=1e-4),
                  f"full-width layer {li} (window {spec.window}) flash vs dense at S {s_long}, "
                  f"max |err| {e:.3g}")
            errs[f"flash vs dense, window {spec.window}"] = e
            del flash, dense
            log(f"[attn_long] full-width {WINDOW_MEMBER} layer {li} (window {spec.window}), "
                f"B 2 (row 1 with {s_long - LONG_PROMPTS[0]} pads), S {s_long}: flash vs dense "
                f"max |err| {e:.3g} on real rows (tol 1e-4); flash {t_flash * 1e3:.2f} ms, "
                f"dense {t_dense * 1e3:.2f} ms (host clock, one call)")
        # Ring cache vs a full cache with the window mask, across the wrap.
        li = next(i for i, sp in enumerate(plan) if sp.window > 0)
        spec, p = plan[li], member.params["layers"][li]["mixer"]
        for s0 in LONG_PROMPTS[:2]:
            x = torch.randn((1, s0 + MAX_NEW, cfg.d_model), generator=gen, device="cuda")
            pos = torch.arange(s0, dtype=torch.int32, device="cuda")[None]
            ring = attn_mod.init_kv_cache(cfg, spec, 1, s0 + MAX_NEW, "cuda")
            full = attn_mod.init_kv_cache(cfg, dataclasses.replace(spec, window=0), 1,
                                          s0 + MAX_NEW, "cuda")
            y_ring, ring = attn_mod.self_attention_prefill(cfg, spec, p, x[:, :s0], pos, ring)
            y_full, full = attn_mod.self_attention_prefill(cfg, spec, p, x[:, :s0], pos, full)
            e = float((y_ring - y_full).abs().max())
            for t in range(s0, s0 + MAX_NEW):
                o_ring, ring = attn_mod.self_attention_decode(cfg, spec, p, x[:, t:t + 1], ring, t)
                o_full, full = attn_mod.self_attention_decode(cfg, spec, p, x[:, t:t + 1], full, t)
                e = max(e, float((o_ring - o_full).abs().max()))
                check(torch.allclose(o_ring, o_full, rtol=1e-4, atol=1e-4),
                      f"ring vs full cache at position {t}, max |err| {e:.3g}")
            errs[f"ring vs full cache from {s0}"] = e
            top = int(ring["slot_pos"].max())
            check(ring["k"].shape[1] == spec.window and top == s0 + MAX_NEW - 1
                  and int(ring["slot_pos"][top % spec.window]) == top,
                  f"ring of {spec.window} slots holds position {top} at slot {top % spec.window}")
            log(f"[attn_long] full-width layer {li} (window {spec.window}): prefill {s0} then "
                f"{MAX_NEW} decode steps, ring of {ring['k'].shape[1]} slots vs a "
                f"{full['k'].shape[1]}-slot cache with the window mask: max |err| {e:.3g} "
                f"(tol 1e-4); position {top} sits in slot {top % spec.window}")
            del ring, full

    # Times of the two new members at long prompts (B 1), against the decode bound.
    times = {}
    for name in ATTN_POOL[1:]:
        m = engine.pool[names.index(name)]
        rng = np.random.default_rng(29)
        for n in PREFILL_LENGTHS:
            p = [rng.integers(0, m.cfg.vocab_size, size=n, dtype=np.int32)]
            prof = member_profile(m, pad_prompts(p, m.cfg).cuda(), prompt_pad_mask(p, m.cfg).cuda(),
                                  "attn_long")
            bound_ms, by, n_bytes = decode_step_bound(m, 1, n + MAX_NEW - 1, 0)
            log(f"[attn_long] {name} S={n} decode step bound {n_bytes / 1e9:.3f} GB -> "
                f"{bound_ms:.4f} ms ({by}); device busy {prof['decode_busy_ms']:.2f} ms "
                f"(bound / busy {bound_ms / prof['decode_busy_ms']:.3f})")
            times[f"{name} S={n}"] = {**prof, "decode_bound_ms": bound_ms,
                                      "decode_bound_by": by}
    del engine, pool
    return {"launches": launches, "max_abs_err": errs, "times": times}


def _decode_experts(member, tok, mask) -> int:
    """The experts one decode step's tokens choose, summed over the MoE
    layers (0 without MoE)."""
    from repro_torch.models import lm, moe

    cfg = member.cfg
    if not cfg.n_experts:
        return 0
    chosen, router_probs = [], moe._router_probs

    def choosing(p, x):
        probs = router_probs(p, x)
        chosen.append(torch.topk(probs, cfg.top_k, dim=-1).indices.unique().numel())
        return probs

    b, s = tok.shape
    with torch.inference_mode():
        caches = lm.init_caches(cfg, b, s + 1, "cuda")
        logits, caches = lm.apply_lm_prefill(cfg, member.params, tok, caches, mask,
                                             media=member.batch_media(b))
        nxt = torch.argmax(logits[:, -1, :cfg.vocab_size], -1)[:, None]
        moe._router_probs = choosing
        try:
            lm.apply_lm_decode(cfg, member.params, nxt, caches, s)
        finally:
            moe._router_probs = router_probs
    return int(sum(chosen))


def phase_recurrent(rx, pl2) -> dict:
    """Recurrent generation: smoke xlstm-1.3b and jamba card vs CPU; the
    recurrent pool with its trained router serving and routing through
    router_xattn; xlstm's prompts alone and batched; one full-width mLSTM
    layer's chunkwise form against its step recurrence and one full-width
    Mamba layer's chunked scan against its decode step; prefill and decode
    times of both recurrent members with their decode bounds."""
    from repro_torch.common.tree import flatten_with_paths
    from repro_torch.core import DEFAULT_LAMBDA_GRID
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models import ssm, xlstm
    from repro_torch.serving.engine import pad_prompts, prompt_pad_mask

    t_phase = time.perf_counter()
    for name in (XLSTM_MEMBER, JAMBA_MEMBER):
        for lengths in ((5, 17, 9), (600,)):
            smoke_card_vs_cpu(name, lengths, "recurrent")

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pool = build_cut_pool(RECURRENT_POOL, cut_depth(layers=JAMBA_CUT))
    torch.cuda.synchronize()
    t_pool = time.perf_counter() - t0
    for m in pool:
        n = sum(p.numel() for p in flatten_with_paths(m.params).values())
        mixers = {spec.mixer for spec in m.cfg.layer_plan()}
        log(f"[recurrent] {m.name}: {m.cfg.n_layers} layers d_model={m.cfg.d_model}, "
            f"mixers {sorted(mixers)}, ffns {sorted({sp.ffn for sp in m.cfg.layer_plan()})}; "
            f"{n / 1e9:.4f}B params ({4 * n / 2**30:.2f} GiB) fp32 (counted for $: "
            f"{m.cfg.param_count() / 1e9:.4f}B); $ {m.cost_rate:.6g} per request")
    log(f"[recurrent] pool built in {t_pool:.2f}s; device memory "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated, "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB peak")
    t0 = time.perf_counter()
    engine = serve_mod.train_engine(pool, seed=0, device="cuda")
    torch.cuda.synchronize()
    log(f"[recurrent] router trained on the card through train_engine in "
        f"{time.perf_counter() - t0:.2f}s (K = {engine.router.n_members}; "
        f"{time.perf_counter() - t_phase:.1f}s into the phase)")

    # The path: serve 8 requests, two long ones on xlstm, the routing split.
    names = [m.name for m in engine.pool]
    x_idx = names.index(XLSTM_MEMBER)
    data, _, _ = serve_mod.synthetic_pool_traffic(engine.pool, seed=0)
    _, _, te = data.split(seed=0)
    vocab = min(m.cfg.vocab_size for m in engine.pool)
    texts, prompts = serve_mod.synthetic_requests(N_REQUESTS, vocab, seed=0)
    rng = np.random.default_rng(31)
    long_pair = [rng.integers(0, vocab, size=n, dtype=np.int32) for n in SERVED_RECURRENT]
    rx.router_xattn_cuda.launches = 0
    pl2.pairwise_l2_cuda.launches = 0
    t_serve, res = _synced(lambda: engine.serve(texts, prompts, max_new=MAX_NEW))
    t_long, (long_outs, long_costs) = _synced(
        lambda: engine.generate_member(x_idx, long_pair, max_new=MAX_NEW))
    s_hat, c_hat = engine.score_emb(data.emb[te])
    torch.cuda.synchronize()
    launches = {"router_xattn": rx.router_xattn_cuda.launches,
                "pairwise_l2": pl2.pairwise_l2_cuda.launches}
    check(launches["router_xattn"] == 2, f"the serve and the routing split launched "
                                         f"router_xattn {launches['router_xattn']} times, not 2")
    for i, out in enumerate(res["outputs"]):
        member = engine.pool[int(res["choices"][i])]
        check(len(out) == MAX_NEW and 0 <= int(out.min())
              and int(out.max()) < member.cfg.vocab_size,
              f"[recurrent] request {i}: {len(out)} tokens in {member.name}'s vocab")
    check(all(len(o) == MAX_NEW and 0 <= int(o.min()) and int(o.max()) < vocab
              for o in long_outs), "the long pair's tokens on xlstm")
    s_plain, c_plain = engine.router.predict(data.emb[te])
    e_route = float(np.abs(s_hat - s_plain).max())
    check(np.allclose(s_hat, s_plain, rtol=1e-5, atol=1e-5),
          f"router_xattn K={len(names)} on the recurrent pool's router, max |err| {e_route:.3g}")
    check(np.array_equal(c_hat, c_plain), "cost path identical on both scoring paths")
    log(f"[recurrent] engine.serve: {N_REQUESTS} requests, prompts "
        f"{min(map(len, prompts))}-{max(map(len, prompts))} tokens, max_new={MAX_NEW}, wall "
        f"{t_serve:.3f}s; per-member counts " + ", ".join(
            f"{n}={int(c)}" for n, c in zip(names, res["per_member_counts"]))
        + f"; total $ {res['total_cost']:.6g}")
    s_long = pad_prompts(long_pair, engine.pool[x_idx].cfg).shape[1]
    log(f"[recurrent] generate_member {XLSTM_MEMBER}, prompts of "
        f"{'/'.join(map(str, SERVED_RECURRENT))} tokens (padded to S {s_long}, the mLSTM "
        f"chunk): wall {t_long:.3f}s, $ {long_costs.sum():.6g}; tokens in vocab")
    log(f"[recurrent] router_xattn K={len(names)} B={len(te)} on the trained params: max "
        f"|err| {e_route:.3g} vs the plain predictor (tol 1e-5); launches on the path: "
        f"router_xattn {launches['router_xattn']} (serve 1, split 1), pairwise_l2 "
        f"{launches['pairwise_l2']}")
    rows = [(lam, np.bincount(engine.choose(s_hat, c_hat, lam), minlength=len(names)))
            for lam in DEFAULT_LAMBDA_GRID]
    log(f"[recurrent] routing split of the {len(te)} held-out queries, counts "
        f"{'/'.join(names)} per lambda:")
    for i in range(0, len(rows), 5):
        log("[recurrent]   " + "; ".join(f"{lam:.3g}: " + "/".join(str(int(c)) for c in counts)
                                         for lam, counts in rows[i:i + 5]))

    # xlstm's prompts as one left-padded batch, then each alone.
    member = engine.pool[x_idx]
    cfg = member.cfg
    rng = np.random.default_rng(37)
    rec_prompts = [rng.integers(0, cfg.vocab_size, size=n, dtype=np.int32)
                   for n in RECURRENT_PROMPTS]
    tok, mask = (pad_prompts(rec_prompts, cfg).cuda(),
                 prompt_pad_mask(rec_prompts, cfg).cuda())
    torch.cuda.reset_peak_memory_stats()
    t_batch, (batch_toks, batch_gaps) = _synced(
        lambda: greedy_margins(cfg, member.params, tok, mask, MAX_NEW))
    peak = torch.cuda.max_memory_allocated() / 2**30
    check(batch_toks.shape == (len(rec_prompts), MAX_NEW) and 0 <= batch_toks.min()
          and batch_toks.max() < cfg.vocab_size, "xlstm batch tokens in vocab")
    log(f"[recurrent] {XLSTM_MEMBER} prompts {list(RECURRENT_PROMPTS)} as one left-padded "
        f"batch (S {tok.shape[1]}): {t_batch:.3f}s for {MAX_NEW} tokens each; device memory "
        f"peak {peak:.2f} GiB")
    parts = []
    for i, p in enumerate(rec_prompts):
        ptok = pad_prompts([p], cfg)
        t_alone, (alone, alone_gaps) = _synced(lambda p=p, ptok=ptok: greedy_margins(
            cfg, member.params, ptok.cuda(), prompt_pad_mask([p], cfg).cuda(), MAX_NEW))
        same = np.array_equal(alone[0], batch_toks[i])
        log(f"[recurrent]   {len(p)} tokens alone (S {ptok.shape[1]}): {t_alone:.3f}s, "
            + ("equal to its batch tokens" if same else "parts from its batch tokens"))
        if same:
            continue
        j = int(np.flatnonzero(alone[0] != batch_toks[i])[0])
        gap = float(min(alone_gaps[0, j], batch_gaps[i, j]))
        parts.append(i)
        log(f"[recurrent]   request {i} alone parts from the batch at token {j}: logit "
            f"margin {gap:.3g}")
        check(gap <= 1e-4, f"{len(p)}-token request alone parts from the batch at token {j} "
                           f"with logit margin {gap:.3g} above 1e-4")
    log(f"[recurrent] each xlstm request alone vs in the batch ({time.perf_counter() - t_phase:.1f}s "
        f"into the phase): "
        f"{len(rec_prompts) - len(parts)} of {len(rec_prompts)} equal"
        + (f"; parts at near ties: requests {parts}" if parts else ""))

    # One full-width mLSTM layer: chunkwise vs the step recurrence; one
    # full-width Mamba layer: chunked scan vs its decode step.
    errs = {}
    gen = torch.Generator(device="cuda").manual_seed(41)
    with torch.inference_mode():
        li = next(i for i, sp in enumerate(cfg.layer_plan()) if sp.mixer == "mlstm")
        p = member.params["layers"][li]["mixer"]
        x = torch.randn((1, CHUNK_CHECK_SEQ, cfg.d_model), generator=gen, device="cuda")
        xc, xv, _, _ = xlstm._mlstm_front(p, x)
        q, k, v = xlstm._mlstm_qkv(cfg, p, xc, xv)
        log_i, log_f = xlstm._mlstm_gates(p, xc)
        # The init's input-gate bias -10 makes h small (about 1e-5), so the
        # gates are also shifted to a bias of 0, where h is of order 0.1.
        for shift in (0.0, 10.0):
            li_s = log_i + shift
            t_chunk, (h_chunk, final) = _synced(
                lambda: xlstm.mlstm_chunkwise(q, k, v, li_s, log_f))
            state = xlstm.init_mlstm_cache(cfg, 1, "cuda")
            hs = []
            t0 = time.perf_counter()
            for t in range(CHUNK_CHECK_SEQ):
                h_t, state = xlstm.mlstm_step(q[:, t], k[:, t], v[:, t], li_s[:, t],
                                              log_f[:, t], state)
                hs.append(h_t)
            torch.cuda.synchronize()
            t_step = time.perf_counter() - t0
            e_h = float((torch.stack(hs, 1) - h_chunk).abs().max())
            e_c = float((state["C"] - final["C"]).abs().max())
            h_max, c_max = float(h_chunk.abs().max()), float(final["C"].abs().max())
            check(e_h <= 3e-5 and e_c <= 1e-5,
                  f"full-width mLSTM layer {li} chunkwise vs step at S {CHUNK_CHECK_SEQ}, "
                  f"input-gate bias shifted by {shift:g}: h {e_h:.3g} (tol 3e-5), C "
                  f"{e_c:.3g} (tol 1e-5)")
            errs[f"mlstm chunkwise vs step, gate shift {shift:g}, h"] = e_h
            errs[f"mlstm chunkwise vs step, gate shift {shift:g}, C"] = e_c
            log(f"[recurrent] full-width {XLSTM_MEMBER} mLSTM layer {li} (4 heads of "
                f"{cfg.xlstm_d_inner // cfg.xlstm_n_heads}), input-gate bias shifted by "
                f"{shift:g}, S {CHUNK_CHECK_SEQ} (chunks of {xlstm.MLSTM_CHUNK}): chunkwise vs "
                f"mlstm_step token by token max |err| h {e_h:.3g} (tol 3e-5, |h| up to "
                f"{h_max:.3g}), C {e_c:.3g} (tol 1e-5, |C| up to {c_max:.3g}); chunkwise {t_chunk * 1e3:.2f} ms, "
                f"{CHUNK_CHECK_SEQ} steps {t_step * 1e3:.2f} ms (host clock)")
        jamba = engine.pool[names.index(JAMBA_MEMBER)]
        jcfg = jamba.cfg
        p = jamba.params["layers"][0]["mixer"]
        x = torch.randn((1, CHUNK_CHECK_SEQ, jcfg.d_model), generator=gen, device="cuda")
        t_scan, (out, final) = _synced(lambda: ssm.apply_mamba_prefill(jcfg, p, x))
        cache = ssm.init_mamba_cache(jcfg, 1, "cuda")
        steps = [ssm.apply_mamba_decode(jcfg, p, x[:, t:t + 1], cache)[0]
                 for t in range(CHUNK_CHECK_SEQ)]
        e_y = float((torch.cat(steps, 1) - out).abs().max())
        e_s = float((cache["h"] - final["h"]).abs().max())
        check(torch.allclose(torch.cat(steps, 1), out, rtol=1e-4, atol=1e-4)
              and torch.allclose(cache["h"], final["h"], rtol=1e-4, atol=1e-4),
              f"full-width Mamba layer chunked scan vs step: out {e_y:.3g}, h {e_s:.3g} "
              f"(tol 1e-4)")
        errs["mamba scan vs step, out"], errs["mamba scan vs step, h"] = e_y, e_s
        log(f"[recurrent] full-width {JAMBA_MEMBER} Mamba layer 0 (d_inner "
            f"{jcfg.ssm_d_inner}, d_state {jcfg.ssm_d_state}), S {CHUNK_CHECK_SEQ} (chunks of "
            f"{ssm.SSM_CHUNK}): chunked scan vs the decode step token by token max |err| out "
            f"{e_y:.3g}, state {e_s:.3g} (tol 1e-4); scan {t_scan * 1e3:.2f} ms (host clock)")
        del out, final, cache, steps, hs, state, h_chunk

    # Prefill and decode times of the recurrent members, against the decode bound.
    times = {}
    for name, lengths in RECURRENT_TIMES:
        m = engine.pool[names.index(name)]
        rng = np.random.default_rng(43)
        for n in lengths:
            for b in (1, 8):
                t0 = time.perf_counter()
                p = [rng.integers(0, m.cfg.vocab_size, size=n, dtype=np.int32)
                     for _ in range(b)]
                tok, mask = pad_prompts(p, m.cfg).cuda(), prompt_pad_mask(p, m.cfg).cuda()
                prof = member_profile(m, tok, mask, "recurrent")
                shares = {}
                if name == XLSTM_MEMBER and n == lengths[0]:
                    shares = mixer_shares(m, tok, mask)
                bound_ms, by, n_bytes = decode_step_bound(
                    m, b, tok.shape[1] + MAX_NEW - 1, _decode_experts(m, tok, mask))
                log(f"[recurrent] {name} B={b} S={tok.shape[1]} decode step bound {n_bytes / 1e9:.3f} GB "
                    f"-> {bound_ms:.4f} ms ({by}); device busy {prof['decode_busy_ms']:.2f} ms "
                    f"(bound / busy {bound_ms / prof['decode_busy_ms']:.3f})"
                    + "".join(f"; {k} {v:.3f} of prefill" for k, v in shares.items())
                    + f"; measured in {time.perf_counter() - t0:.1f}s")
                times[f"{name} B={b} S={n}"] = {**prof, "decode_bound_ms": bound_ms,
                                                "decode_bound_by": by, **shares}
    log(f"[recurrent] device memory {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
        f"allocated, {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB peak since the "
        f"batch of long prompts")
    del engine, pool
    return {"launches": launches, "max_abs_err": errs, "times": times}


def build_cut_pool(names, cut):
    """A pool on the card, fp32: ``build_pool``'s members of ``names[:-1]``
    at published size, then the last member at published width cut in depth
    by ``cut`` (its published config -> the cut one), with its seed, stub
    media and published cost rate drawn as ``build_pool`` draws them."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import build_pool, stub_media
    from repro_torch.models import lm
    from repro_torch.serving.engine import PoolMember, arch_cost_rate

    pool = build_pool(names[:-1], seed=0, device="cuda")
    full = get_config(names[-1])
    cfg = cut(full)
    gen = torch.Generator(device="cuda").manual_seed(len(pool))
    params = lm.init_lm(gen, cfg)
    pool.append(PoolMember(name=names[-1], cfg=cfg, params=params,
                           cost_rate=arch_cost_rate(full), media=stub_media(cfg, gen)))
    return pool


def cut_depth(n_layers=None, layers=None):
    """A ``cut`` for :func:`build_cut_pool`: one repeat of the published
    pattern, the pattern's ``layers`` slice, or ``n_layers`` layers of it."""
    def cut(full):
        pattern = full.pattern if layers is None else full.pattern[layers]
        return dataclasses.replace(full, pattern=pattern, n_repeats=1,
                                   n_layers=n_layers or len(pattern))
    return cut


def memory(tag, what) -> None:
    log(f"[{tag}] device memory {what}: {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
        f"allocated, {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB peak")


def _prefill_drops(member, tok, mask) -> int:
    """Real (token, expert) assignments one prefill's capacity drops."""
    from repro_torch.models import lm, moe

    drops, dispatch = [], moe._dispatch_groups

    def counting(*args, **kwargs):
        out = dispatch(*args, **kwargs)
        drops.append(out[2].sum())
        return out

    b, s = tok.shape
    with torch.inference_mode():
        moe._dispatch_groups = counting
        try:
            lm.apply_lm_prefill(member.cfg, member.params, tok,
                                lm.init_caches(member.cfg, b, s + 1, "cuda"), mask,
                                media=member.batch_media(b))
        finally:
            moe._dispatch_groups = dispatch
    return int(torch.stack(drops).sum()) if drops else 0


def phase_multimodal(rx, pl2) -> dict:
    """The last three configs: smoke musicgen, llama4 and llama-3.2-vision
    card vs CPU; pools A and B in turn (``multimodal_pool``), each freed
    before the next is built (checked < 1 GiB left)."""
    t_phase = time.perf_counter()
    for name in (MUSIC_MEMBER, LLAMA4_MEMBER, VISION_MEMBER):
        for lengths in ((5, 17, 9), (600,)):
            smoke_card_vs_cpu(name, lengths, "multimodal")
    rx.router_xattn_cuda.launches = 0
    pl2.pairwise_l2_cuda.launches = 0
    by_pool, errs, times = {}, {}, {}
    for label, names in MULTIMODAL_POOLS:
        by_pool[label], pool_errs, pool_times = multimodal_pool(label, names, rx, pl2)
        errs.update(pool_errs)
        times.update(pool_times)
        gc.collect()
        torch.cuda.empty_cache()
        left = torch.cuda.memory_allocated() / 2**30
        check(left < 1.0, f"{left:.2f} GiB still allocated after pool {label} was freed")
        log(f"[multimodal] pool {label} freed: {left:.2f} GiB allocated "
            f"({time.perf_counter() - t_phase:.1f}s into the phase)")
    launches = {"router_xattn": rx.router_xattn_cuda.launches,
                "pairwise_l2": pl2.pairwise_l2_cuda.launches}
    check(launches["router_xattn"] >= 1, "the multimodal path launched router_xattn")
    return {"launches": launches, "launches_by_pool": by_pool, "max_abs_err": errs,
            "times": times}


def multimodal_pool(label, names, rx, pl2) -> tuple:
    """One pool of ``build_cut_pool`` with its router trained through
    ``train_engine``: 8 requests served, each member but the first
    generating them too (MoE decode drop log set), the routing split of the
    240 held-out queries through router_xattn (1e-5 against the plain
    predictor); on pool A the vision checks; prefill and decode times of
    the members but the first at S 1024, B 1 and 8, against their decode
    bounds. Returns (launches, max |err|s, times); the pool is released on
    return."""
    from repro_torch.common.tree import flatten_with_paths
    from repro_torch.core import DEFAULT_LAMBDA_GRID
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models import moe
    from repro_torch.serving.engine import pad_prompts, prompt_pad_mask

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pool = build_cut_pool(names, cut_depth())
    torch.cuda.synchronize()
    log(f"[multimodal] pool {label} built in {time.perf_counter() - t0:.2f}s")
    for m in pool:
        n = sum(p.numel() for p in flatten_with_paths(m.params).values())
        plan = " ".join(f"{sp.mixer}+{sp.ffn}" for sp in m.cfg.layer_plan())
        if len(set(m.cfg.layer_plan())) == 1:
            plan = f"{plan.split()[0]} x {m.cfg.n_layers}"
        log(f"[multimodal] {m.name}: {m.cfg.n_layers} layers {plan}, d_model={m.cfg.d_model}, "
            f"{m.cfg.n_heads}/{m.cfg.n_kv_heads} heads of {m.cfg.resolved_head_dim}, vocab "
            f"{m.cfg.vocab_size}; {n / 1e9:.4f}B params ({4 * n / 2**30:.2f} GiB) fp32 "
            f"(counted for $: {m.cfg.param_count() / 1e9:.4f}B); $ {m.cost_rate:.6g} per request"
            + ("" if m.media is None else f"; stub media {tuple(m.media.shape)}"))
    memory("multimodal", f"after pool {label}'s build")
    t0 = time.perf_counter()
    engine = serve_mod.train_engine(pool, seed=0, device="cuda")
    torch.cuda.synchronize()
    log(f"[multimodal] pool {label} router trained on the card through train_engine in "
        f"{time.perf_counter() - t0:.2f}s (K = {engine.router.n_members})")

    # The path: serve 8 requests, each member but the first generates them, the split.
    before = (rx.router_xattn_cuda.launches, pl2.pairwise_l2_cuda.launches)
    data, _, _ = serve_mod.synthetic_pool_traffic(engine.pool, seed=0)
    _, _, te = data.split(seed=0)
    vocab = min(m.cfg.vocab_size for m in engine.pool)
    texts, prompts = serve_mod.synthetic_requests(N_REQUESTS, vocab, seed=0)
    moe.DECODE_DROP_LOG = []
    try:
        t_serve, res = _synced(lambda: engine.serve(texts, prompts, max_new=MAX_NEW))
        gens = [(mi, *_synced(lambda mi=mi: engine.generate_member(mi, prompts,
                                                                  max_new=MAX_NEW)))
                for mi in range(1, len(engine.pool))]
        drop_log = list(moe.DECODE_DROP_LOG)
    finally:
        moe.DECODE_DROP_LOG = None
    s_hat, c_hat = engine.score_emb(data.emb[te])
    torch.cuda.synchronize()
    launches = {"router_xattn": rx.router_xattn_cuda.launches - before[0],
                "pairwise_l2": pl2.pairwise_l2_cuda.launches - before[1]}
    check(launches["router_xattn"] == 2, f"pool {label}: the serve and the routing split "
          f"launched router_xattn {launches['router_xattn']} times, not 2")
    served = [(int(res["choices"][i]), out) for i, out in enumerate(res["outputs"])]
    served += [(mi, out) for mi, _, (outs, _) in gens for out in outs]
    for mi, out in served:
        cfg = engine.pool[mi].cfg
        check(len(out) == MAX_NEW and 0 <= int(out.min()) and int(out.max()) < cfg.vocab_size,
              f"pool {label}: {len(out)} tokens in {names[mi]}'s vocab")
    s_plain, c_plain = engine.router.predict(data.emb[te])
    e = float(np.abs(s_hat - s_plain).max())
    check(np.allclose(s_hat, s_plain, rtol=1e-5, atol=1e-5),
          f"router_xattn K={len(names)} on pool {label}'s router, max |err| {e:.3g}")
    check(np.array_equal(c_hat, c_plain), "cost path identical on both scoring paths")
    log(f"[multimodal] router_xattn K={len(names)} B={len(te)} on the trained params: max "
        f"|err| {e:.3g} vs the plain predictor (tol 1e-5); launches on the path: router_xattn "
        f"{launches['router_xattn']} (serve 1, split 1), pairwise_l2 {launches['pairwise_l2']}")
    rows = [(lam, np.bincount(engine.choose(s_hat, c_hat, lam), minlength=len(names)))
            for lam in DEFAULT_LAMBDA_GRID]
    log(f"[multimodal] routing split of the {len(te)} held-out queries, counts "
        f"{'/'.join(names)} per lambda:")
    for i in range(0, len(rows), 5):
        log("[multimodal]   " + "; ".join(f"{lam:.3g}: " + "/".join(str(int(c)) for c in counts)
                                          for lam, counts in rows[i:i + 5]))
    for mi, name in enumerate(names):
        lams = [lam for lam, counts in rows if counts[mi] > 0]
        log(f"[multimodal] {name} is chosen at {len(lams)} of {len(rows)} lambdas"
            + (f", from {min(lams):.3g} to {max(lams):.3g}" if lams else ""))
    log(f"[multimodal] pool {label} engine.serve: {N_REQUESTS} requests, prompts "
        f"{min(map(len, prompts))}-{max(map(len, prompts))} tokens drawn below the pool's "
        f"least vocab ({vocab}), max_new={MAX_NEW}, wall {t_serve:.3f}s; per-member counts "
        + ", ".join(f"{n}={int(c)}" for n, c in zip(names, res["per_member_counts"]))
        + f"; total $ {res['total_cost']:.6g}")
    for mi, t_gen, (_, costs) in gens:
        log(f"[multimodal] pool {label} generate_member {names[mi]}: {N_REQUESTS} requests, "
            f"wall {t_gen:.3f}s, $ {costs.sum():.6g}")
    # One drop-log entry per MoE layer and decode step of each generate call.
    n_calls = sum(sum(1 for sp in m.cfg.layer_plan() if sp.ffn == "moe") * (MAX_NEW - 1)
                  * (int(res["per_member_counts"][mi] > 0) + int(mi > 0))
                  for mi, m in enumerate(engine.pool))
    check(len(drop_log) == n_calls and not any(drop_log),
          f"pool {label} decode drop log {drop_log}: {n_calls} calls of 0 expected")
    if n_calls:
        log(f"[multimodal] pool {label} MoE decode drop log: {len(drop_log)} calls (MoE "
            f"layers x {MAX_NEW - 1} steps x generate calls), all 0")
    memory("multimodal", f"after pool {label}'s serve")

    errs = {f"pool {label} router_xattn vs plain predictor": e}
    if VISION_MEMBER in names:
        errs.update(vision_checks(engine.pool[names.index(VISION_MEMBER)]))
    times = {}
    for m in engine.pool[1:]:
        rng = np.random.default_rng(43)
        n_moe = sum(1 for sp in m.cfg.layer_plan() if sp.ffn == "moe")
        n_x = sum(1 for sp in m.cfg.layer_plan() if sp.mixer == "xattn")
        for b in (1, 8):
            p = [rng.integers(0, m.cfg.vocab_size, size=MULTIMODAL_TIMES_S, dtype=np.int32)
                 for _ in range(b)]
            tok, mask = pad_prompts(p, m.cfg).cuda(), prompt_pad_mask(p, m.cfg).cuda()
            tag = f"{m.name} B={b} S={MULTIMODAL_TIMES_S}"
            torch.cuda.reset_peak_memory_stats()
            prof = member_profile(m, tok, mask, "multimodal")
            memory("multimodal", f"after {tag}")
            s_kv = tok.shape[1] + MAX_NEW - 1
            chosen = _decode_experts(m, tok, mask)
            bound_ms, by, n_bytes = decode_step_bound(m, b, s_kv, chosen)
            busy = prof["decode_busy_ms"]
            entry = {**prof, "decode_bound_ms": bound_ms, "decode_bound_by": by}
            if n_moe:
                all_ms, all_by, all_bytes = decode_step_bound(m, b, s_kv, n_moe * m.cfg.n_experts)
                drops = _prefill_drops(m, tok, mask)
                n_real = int(mask.sum()) * m.cfg.top_k * n_moe
                entry.update(decode_bound_all_experts_ms=all_ms, prefill_drops=drops,
                             prefill_assignments=n_real)
                log(f"[multimodal] {tag}: prefill capacity drops {drops} of {n_real} real "
                    f"(token, expert) assignments (factor {m.cfg.capacity_factor}); decode step "
                    f"bound with the {chosen} experts its tokens chose {n_bytes / 1e9:.3f} GB -> "
                    f"{bound_ms:.4f} ms ({by}), with all {m.cfg.n_experts} as the decode rule "
                    f"reads them {all_bytes / 1e9:.3f} GB -> {all_ms:.4f} ms ({all_by}); device "
                    f"busy {busy:.2f} ms (bound / busy {bound_ms / busy:.3f} with the chosen, "
                    f"{all_ms / busy:.3f} with all)")
            else:
                media_kv = 4 * 2 * b * n_x * m.cfg.n_frontend_tokens * m.cfg.n_kv_heads \
                    * m.cfg.resolved_head_dim
                log(f"[multimodal] {tag} decode step bound {n_bytes / 1e9:.3f} GB"
                    + (f" (media K/V {media_kv / 1e6:.1f} MB)" if n_x else "")
                    + f" -> {bound_ms:.4f} ms ({by}); device busy {busy:.2f} ms (bound / busy "
                    f"{bound_ms / busy:.3f})")
            times[tag] = entry
    return launches, errs, times


def vision_checks(member) -> dict:
    """The vision member's prompts as one left-padded batch and each alone,
    with its stub media; the full-width cross layer's decode step on the
    prefilled media cache against the full sequence's last position."""
    from repro_torch.configs.base import XATTN, LayerSpec
    from repro_torch.models import attention as attn_mod
    from repro_torch.serving.engine import pad_prompts, prompt_pad_mask

    cfg = member.cfg
    rng = np.random.default_rng(37)
    prompts = [rng.integers(0, cfg.vocab_size, size=n, dtype=np.int32) for n in VISION_PROMPTS]
    tok, mask = pad_prompts(prompts, cfg).cuda(), prompt_pad_mask(prompts, cfg).cuda()
    torch.cuda.reset_peak_memory_stats()
    t_batch, (batch_toks, batch_gaps) = _synced(lambda: greedy_margins(
        cfg, member.params, tok, mask, MAX_NEW, member.batch_media(len(prompts))))
    log(f"[multimodal] {member.name} prompts {list(VISION_PROMPTS)} as one left-padded batch "
        f"(S {tok.shape[1]}) with the stub media: {t_batch:.3f}s for {MAX_NEW} tokens each")
    scores = len(prompts) * cfg.n_heads * tok.shape[1] * cfg.n_frontend_tokens * 4
    memory("multimodal", f"after the vision batch (B {len(prompts)}, S {tok.shape[1]}; dense "
                         f"cross-attention scores {scores / 2**30:.2f} GiB a copy)")
    parts = []
    for i, p in enumerate(prompts):
        t_alone, (alone, alone_gaps) = _synced(lambda p=p: greedy_margins(
            cfg, member.params, pad_prompts([p], cfg).cuda(),
            prompt_pad_mask([p], cfg).cuda(), MAX_NEW, member.batch_media(1)))
        same = np.array_equal(alone[0], batch_toks[i])
        log(f"[multimodal]   {len(p)} tokens alone: {t_alone:.3f}s, "
            + ("equal to its batch tokens" if same else "parts from its batch tokens"))
        if same:
            continue
        j = int(np.flatnonzero(alone[0] != batch_toks[i])[0])
        gap = float(min(alone_gaps[0, j], batch_gaps[i, j]))
        parts.append(i)
        log(f"[multimodal]   request {i} alone parts from the batch at token {j}: logit "
            f"margin {gap:.3g}")
        check(gap <= 1e-4, f"{len(p)}-token vision request alone parts from the batch at "
                           f"token {j} with logit margin {gap:.3g} above 1e-4")
    log(f"[multimodal] each vision request alone vs in the batch: "
        f"{len(prompts) - len(parts)} of {len(prompts)} equal"
        + (f"; parts at near ties: requests {parts}" if parts else ""))

    b, s = CROSS_CHECK
    li = next(i for i, sp in enumerate(cfg.layer_plan()) if sp.mixer == XATTN)
    p = member.params["layers"][li]["mixer"]
    gen = torch.Generator(device="cuda").manual_seed(53)
    x = torch.randn((b, s, cfg.d_model), generator=gen, device="cuda")
    media = member.batch_media(b)
    with torch.inference_mode():
        t_full, full = _synced(lambda: attn_mod.cross_attention_full_seq(cfg, p, x, media))
        cache = attn_mod.prefill_cross_cache(
            cfg, p, media, attn_mod.init_kv_cache(cfg, LayerSpec(mixer=XATTN), b, 1, "cuda"))
        t_step, (step, _) = _synced(lambda: attn_mod.cross_attention_decode(
            cfg, p, x[:, -1:], cache))
    e = float((step - full[:, -1:]).abs().max())
    check(e <= 1e-5, f"full-width cross layer {li}: decode vs full sequence max |err| {e:.3g}")
    log(f"[multimodal] full-width {member.name} cross layer {li} ({cfg.n_frontend_tokens} media "
        f"tokens of {cfg.frontend_dim}, {cfg.n_heads}/{cfg.n_kv_heads} heads), B {b}, S {s}: "
        f"cross_attention_decode on the prefilled cache vs cross_attention_full_seq's last "
        f"position max |err| {e:.3g} (tol 1e-5); full {t_full * 1e3:.2f} ms, step "
        f"{t_step * 1e3:.2f} ms (host clock, one call)")
    return {"cross decode vs full sequence": e}


def mixer_shares(member, tok, mask) -> dict:
    """Host-clock share of one prefill of ``tok`` taken by the sLSTM and the
    mLSTM mixers: each kind's first layer run alone on a unit-normal input
    of the prompt's shape (its time does not depend on the values), times
    the number of layers of that kind, over the whole prefill's time. Each
    time is the least of three runs ending in a device sync: the host's
    clock spreads by tens of percent between runs on a shared machine."""
    from repro_torch.models import lm, xlstm

    cfg, plan = member.cfg, member.cfg.layer_plan()
    b, s = tok.shape
    gen = torch.Generator(device="cuda").manual_seed(47)
    shares = {}
    with torch.inference_mode():
        t_all = min(_synced(lambda: lm.apply_lm_prefill(
            cfg, member.params, tok, lm.init_caches(cfg, b, s + 1, "cuda"), mask))[0]
                    for _ in range(3))
        x = torch.randn((b, s, cfg.d_model), generator=gen, device="cuda")
        for kind, fn in (("slstm", xlstm.apply_slstm_prefill),
                         ("mlstm", xlstm.apply_mlstm_prefill)):
            layers = [i for i, spec in enumerate(plan) if spec.mixer == kind]
            p = member.params["layers"][layers[0]]["mixer"]
            t_one = min(_synced(lambda: fn(cfg, p, x, mask=mask))[0] for _ in range(3))
            shares[f"{kind} share"] = len(layers) * t_one / t_all
    return shares


def pairwise_l2_bound(n, k, d) -> tuple:
    """Least time on an H100 SXM for one fp32 ``pairwise_l2`` call: bytes
    (x and c read once, the output written once) over HBM bandwidth vs fp32
    operations (2NKd for the cross term, 2(N+K)d for the norms, 4 per
    output for the epilogue) over the CUDA-core peak.
    Returns (ms, "bytes" | "operations")."""
    n_bytes = 4 * (n * d + k * d + n * k)
    ops = 2 * n * k * d + 2 * (n + k) * d + 4 * n * k
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, ops / FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def points(seed, n, k, d, unit=False):
    """(x (N, d), c (K, d)) fp32 on the card: N(0, 1) rows, or unit-norm rows
    like the featurizer's embeddings."""
    rng = np.random.default_rng(seed)
    out = []
    for m in (n, k):
        a = rng.standard_normal((m, d))
        if unit:
            a /= np.linalg.norm(a, axis=1, keepdims=True)
        out.append(torch.from_numpy(a.astype(np.float32)).cuda())
    return out


def phase_pairwise(pl2, ref):
    from repro_torch.data.routerbench import generate

    err = {"float32": 0.0, "bfloat16": 0.0}
    for n, k, d in PL2_SWEEP:
        x, c = points(n * 31 + k + d, n, k, d)
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 5e-2)):
            xd, cd = x.to(dtype), c.to(dtype)
            got = pl2.pairwise_l2_cuda(xd, cd)
            torch.cuda.synchronize()
            want = ref.pairwise_l2_ref(xd, cd)
            check(tuple(got.shape) == (n, k) and bool(torch.isfinite(got).all()),
                  f"pairwise_l2 shape and finite N={n} K={k} d={d}")
            e = float((got - want).abs().max())
            check(torch.allclose(got, want, rtol=tol, atol=tol),
                  f"pairwise_l2 {dtype} N={n} K={k} d={d}: max |err| {e:.3g} above tol {tol}")
            name = "float32" if dtype == torch.float32 else "bfloat16"
            err[name] = max(err[name], e)
    log(f"[pairwise_l2] {2 * len(PL2_SWEEP)} cases within tolerance; max |err| fp32 "
        f"{err['float32']:.3g} (tol 1e-4), bf16 {err['bfloat16']:.3g} (tol 5e-2)")
    ones = torch.ones((8, 32), device="cuda")
    check(torch.equal(pl2.pairwise_l2_cuda(ones, ones), torch.zeros((8, 8), device="cuda")),
          "pairwise_l2 of 8 x 32 ones against themselves is exactly 0")
    emb = torch.from_numpy(generate(64, seed=5).emb.astype(np.float32)).cuda()
    diag = torch.diagonal(pl2.pairwise_l2_cuda(emb, emb))
    check(torch.equal(diag, torch.zeros_like(diag)),
          f"pairwise_l2 of 64 embeddings against themselves: diagonal max {float(diag.max()):.3g}")
    log("[pairwise_l2] identical rows give exactly 0 (8 x 32 ones; diagonal of 64 "
        "featurizer embeddings)")
    return err


def time_pairwise(pl2, ref, label, shape) -> dict:
    n, k, d = shape
    x, c = points(7, n, k, d, unit=True)
    ms = time_ms(lambda: pl2.pairwise_l2_cuda(x, c))
    plain_ms = time_ms(lambda: ref.pairwise_l2_ref(x, c))
    cdist_ms = time_ms(lambda: torch.cdist(x, c).square())
    _, by_name = profile_device(lambda: pl2.pairwise_l2_cuda(x, c), n=50)
    device_ms = sum(v for name, v in by_name.items() if "pairwise_l2" in name) or None
    plain_device_ms, _ = profile_device(lambda: ref.pairwise_l2_ref(x, c), n=50)
    bound_ms, bound_by = pairwise_l2_bound(n, k, d)
    pl = pl2.plan(n, k, d)
    log(f"[launch] pairwise_l2 {label} N={n} K={k} d={d}: cluster {pl.cluster}, grid "
        f"{pl.grid} = {pl.grid[0] * pl.grid[1]} blocks of {pl.threads} threads, "
        f"{pl.smem} bytes shared per block ({pl.spr} slices of 32 per rank)")
    log(f"[pairwise_l2] {label} N={n} K={k} d={d} fp32: kernel {ms:.5f} ms/call "
        f"(device {device_ms} ms), plain {plain_ms:.5f} ms/call (device "
        f"{plain_device_ms:.5f} ms), bound {bound_ms:.3g} ms ({bound_by}), "
        f"yardstick torch.cdist(x, c).square() {cdist_ms:.5f} ms/call")
    return {"call_site": label, "shape": {"N": n, "K": k, "d": d}, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "device_ms": device_ms, "plain_device_ms": plain_device_ms,
            "library_ms": cdist_ms, "cluster": pl.cluster, "grid": list(pl.grid),
            "smem_bytes": pl.smem}


def phase_trace(engine, rx, pl2) -> dict:
    """The cached streaming path at full width: scheduler, semantic cache
    (rung 0), cache-owned drift detector, on the pool ``phase_train`` built."""
    from repro_torch.data.routerbench import generate
    from repro_torch.launch.serve import (
        build_drift_proto, build_scheduler, fit_router_centroids, make_semcache,
    )
    from repro_torch.serving.queue import DONE
    from repro_torch.serving.traffic import TraceConfig, make_trace

    t0 = time.perf_counter()
    data = generate(1200, seed=0)
    tr, _, te = data.split(seed=0)
    train = data.emb[tr]
    t_corpus = time.perf_counter() - t0
    t0 = time.perf_counter()
    fit_router_centroids(engine.router, train, seed=0, device="cuda")
    log(f"[trace] corpus of 1200 (train {len(tr)}, held-out {len(te)}) in {t_corpus:.2f}s; "
        f"router centroids {engine.router.centroids.shape} from training (checked in "
        f"{time.perf_counter() - t0:.2f}s)")
    vocab = min(m.cfg.vocab_size for m in engine.pool)
    trace = make_trace(TraceConfig(kind="neardup", n_requests=TRACE_REQUESTS, rate=400.0,
                                   seed=0, max_new=4, prompt_len_min=8, prompt_len_max=96,
                                   hot_set=32, dup_frac=0.7, vocab=vocab),
                       [data.texts[i] for i in te])

    rx.router_xattn_cuda.launches = 0
    pl2.pairwise_l2_cuda.launches = 0
    t0 = time.perf_counter()
    drift = build_drift_proto(train, engine.router.centroids, window=DRIFT_WINDOW,
                              seed=0, device="cuda")
    cache = make_semcache(train, cap=256, drift=drift, device="cuda")
    sched = build_scheduler(engine, score_batch=64, max_batch=8, max_wait_s=0.02,
                            queue_capacity=256, semcache=cache, device="cuda")
    t_setup = time.perf_counter() - t0
    rung_s, served_ok = [0.0], []
    inner = sched._cache_rung

    def timed_rung(batch, q_emb, lam, outcomes):
        t = time.perf_counter()
        out = inner(batch, q_emb, lam, outcomes)
        rung_s[0] += time.perf_counter() - t
        for r in out[2]:     # cache-served: the output is its entry's, cut to max_new
            j = cache.match(r.q_emb)[0][0]
            served_ok.append(np.array_equal(
                r.output, np.asarray(cache._entries[j].output)[: r.max_new]))
        return out

    sched._cache_rung = timed_rung
    host_s = {"embed": 0.0, "score_emb": 0.0, "generate_member": 0.0}

    def timed(name):
        fn = getattr(engine, name)

        def wrapper(*args, **kwargs):
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            host_s[name] += time.perf_counter() - t
            return out
        return wrapper

    for name in host_s:     # instance attributes shadow the methods for this phase
        setattr(engine, name, timed(name))
    t0 = time.perf_counter()
    try:
        summary = sched.run_trace(trace)
        torch.cuda.synchronize()
    finally:
        for name in host_s:
            delattr(engine, name)
    wall = time.perf_counter() - t0
    launches = {"router_xattn": rx.router_xattn_cuda.launches,
                "pairwise_l2": pl2.pairwise_l2_cuda.launches}

    n_done = summary["completed"] + summary["rejected"] + summary["expired"]
    check(n_done == TRACE_REQUESTS, f"trace accounts for {n_done} of {TRACE_REQUESTS}")
    check(cache.stats["served"] > 0, "the cache served part of the trace")
    check(len(served_ok) == cache.stats["served"] and all(served_ok),
          "every cache-served output is its entry's output cut to max_new")
    for r in trace:
        if r.status != DONE:
            continue
        member = engine.pool[r.member]
        check(len(r.output) == r.max_new and 0 <= int(r.output.min())
              and int(r.output.max()) < member.cfg.vocab_size,
              f"request {r.rid}: {len(r.output)} tokens in {member.name}'s vocab")
    check(launches["router_xattn"] > 0, "the trace path launched router_xattn")
    need = 2 + TRACE_REQUESTS // DRIFT_WINDOW
    check(launches["pairwise_l2"] >= need,
          f"pairwise_l2 launched {launches['pairwise_l2']} times on the trace path, "
          f"fewer than calibrate + fit + {TRACE_REQUESTS // DRIFT_WINDOW} windows")

    for line in sched.telemetry.report(summary.get("duration_s")).splitlines():
        log(f"[trace] {line}")
    rep = cache.report()
    log(f"[trace] semcache: radius {cache.radius:.6f}, {rep['served']} served / "
        f"{rep['lookups']} lookups (hit rate {rep['hit_rate']:.3f}), {rep['stale_hits']} "
        f"stale, {rep['admitted']} admitted, {rep['refreshed']} refreshed, "
        f"{rep['evicted']} evicted, {rep['entries']} entries")
    log(f"[trace] drift: {drift.windows_seen} windows, {drift.alarms} alarms, "
        f"{rep['invalidations']} entries invalidated; last stats "
        + ", ".join(f"{k} {v:.4g}" for k, v in drift.last_stats.items()))
    log(f"[trace] generate calls {summary['generate_calls']}, per-member counts "
        + ", ".join(f"{k}={v}" for k, v in summary["per_member_counts"].items())
        + f", total $ {summary['total_spend']:.6g}")
    log(f"[trace] host wall: set-up (calibrate + drift fit) {t_setup:.3f}s, trace "
        f"{wall:.3f}s for {TRACE_REQUESTS} requests; cache rung (featurizer excluded) "
        f"{rung_s[0] * 1e3:.2f} ms = {rung_s[0] / wall:.4f} of the trace wall")
    rest = wall - rung_s[0] - sum(host_s.values())
    log("[trace] trace wall by part: " + ", ".join(
        f"{name} {v:.3f}s ({v / wall:.4f})" for name, v in
        [("generate_member", host_s["generate_member"]), ("featurizer", host_s["embed"]),
         ("scoring", host_s["score_emb"]), ("cache rung", rung_s[0]),
         ("scheduler and the rest", rest)]))
    log(f"[trace] launches on the trace path: router_xattn {launches['router_xattn']}, "
        f"pairwise_l2 {launches['pairwise_l2']} (at least {need})")
    return {"launches": launches, "radius": cache.radius}


def phase_lookup(radius, pl2) -> dict:
    """A deployment-size cache answers one query bucket through the kernel;
    its hits must equal a CPU twin's (plain version) outside a band of 1e-4
    around r^2, where the two sums may round to different sides."""
    from repro_torch.data.routerbench import generate
    from repro_torch.serving.semcache import _KERNEL_MIN_CELLS, SemanticCache

    t0 = time.perf_counter()
    corpus = generate(LOOKUP_CAP, seed=1)
    fresh = generate(LOOKUP_QUERIES // 2, seed=2)
    t_corpus = time.perf_counter() - t0
    card = SemanticCache(radius, cap=LOOKUP_CAP, device="cuda")
    twin = SemanticCache(radius, cap=LOOKUP_CAP, device="cpu")
    t0 = time.perf_counter()
    for i, e in enumerate(corpus.emb):
        kw = dict(output=np.full(4, i, np.int32), member_name="m", quality=1.0, cost=0.0)
        card.admit(e, **kw)
        twin.admit(e, **kw)
    t_fill = time.perf_counter() - t0
    n = len(card)
    check(n == len(twin) and card.stats == twin.stats, "card and twin admit alike")
    check(n >= 512 and LOOKUP_QUERIES * n >= _KERNEL_MIN_CELLS,
          f"{n} entries: a bucket of {LOOKUP_QUERIES} must take the kernel branch")
    check(torch.equal(card._emb_dev[:n].cpu(), torch.from_numpy(card._emb_buf[:n])),
          "the device mirror holds the entry buffer")
    rng = np.random.default_rng(0)
    q = np.concatenate([corpus.emb[rng.choice(LOOKUP_CAP, LOOKUP_QUERIES // 2,
                                              replace=False)], fresh.emb])
    pl2.pairwise_l2_cuda.launches = 0
    got = card.match(q)
    launches = pl2.pairwise_l2_cuda.launches
    check(launches == 1, f"the lookup launched pairwise_l2 {launches} times, not once")
    want = twin.match(q)
    q64, e64 = q.astype(np.float64), card._emb_buf[:n].astype(np.float64)
    d2 = (q64 * q64).sum(1)[:, None] - 2.0 * q64 @ e64.T + (e64 * e64).sum(1)[None]
    band = np.abs(d2.min(axis=1) - float(np.float32(radius)) ** 2) < 1e-4
    n_hits = 0
    for i, (g, w) in enumerate(zip(got, want)):
        if band[i]:
            continue
        check((g is None) == (w is None), f"query {i}: card {g} vs twin {w}")
        if g is not None:
            n_hits += 1
            check(g[0] == w[0] and abs(g[1] ** 2 - w[1] ** 2) <= 1e-4,
                  f"query {i}: card {g} vs twin {w}")
    check(n_hits > 0, "the deployment-size lookup found hits")

    def per_call(c, reps=20):
        walls = []
        for _ in range(7):
            t = time.perf_counter()
            for _ in range(reps):
                c.match(q)
            walls.append((time.perf_counter() - t) / reps)
        return float(np.median(walls)) * 1e3

    card_ms, twin_ms = per_call(card), per_call(twin)
    log(f"[lookup] corpus {LOOKUP_CAP} + {LOOKUP_QUERIES // 2} fresh in {t_corpus:.2f}s; "
        f"filled card + twin in {t_fill:.2f}s: {n} entries ({card.stats['refreshed']} "
        f"refreshed), radius {radius:.6f}")
    log(f"[lookup] {LOOKUP_QUERIES} queries x {n} entries: kernel branch, 1 launch; "
        f"hits {n_hits}, equal to the CPU twin's; {int(band.sum())} queries within 1e-4 "
        f"of r^2 left out")
    log(f"[lookup] match host wall per call (query copy in, distances out): card "
        f"{card_ms:.4f} ms, CPU twin (plain version) {twin_ms:.4f} ms")
    return {"launches": launches, "entries": n, "card_ms": card_ms, "twin_ms": twin_ms}


def _online_trace(kind, n, seed, data, te, vocab, **kw):
    """A seeded open-loop trace over the held-out split at the serving shape
    of ``[trace]``: 400/s, ``max_new`` 4, prompts of 8 to 96 tokens."""
    from repro_torch.serving.traffic import TraceConfig, make_trace

    return make_trace(TraceConfig(kind=kind, n_requests=n, rate=400.0, seed=seed, max_new=4,
                                  prompt_len_min=8, prompt_len_max=96, vocab=vocab, **kw),
                      [data.texts[i] for i in te], [data.benchmark[i] for i in te])


class _Launches:
    """Launch counts summed over the runs of one path: ``start`` sets both
    counters to 0 just before a run, ``take`` adds them just after, so the
    kernel checks between runs are not counted."""

    def __init__(self, rx, pl2):
        self.rx, self.pl2 = rx, pl2
        self.total = {"router_xattn": 0, "pairwise_l2": 0}

    def start(self):
        self.rx.router_xattn_cuda.launches = 0
        self.pl2.pairwise_l2_cuda.launches = 0

    def take(self) -> dict:
        got = {"router_xattn": self.rx.router_xattn_cuda.launches,
               "pairwise_l2": self.pl2.pairwise_l2_cuda.launches}
        for k, v in got.items():
            self.total[k] += v
        return got


def _router_leaves(router) -> dict:
    from repro_torch.common.tree import flatten_with_paths

    return {**{"q/" + k: v for k, v in flatten_with_paths(router.quality_params).items()},
            **{"c/" + k: v for k, v in flatten_with_paths(router.cost_params).items()}}


def _kernel_vs_plain(engine, q, what) -> float:
    """``router_xattn`` scores of ``q`` on the live router against its plain
    predictor (1e-5); returns the max |err|."""
    s_kernel, c_kernel = engine.score_emb(q)
    s_plain, c_plain = engine.router.predict(q)
    e = float(np.abs(s_kernel - s_plain).max())
    check(s_kernel.shape == (len(q), engine.router.n_members),
          f"{what}: scores {s_kernel.shape}")
    check(np.allclose(s_kernel, s_plain, rtol=1e-5, atol=1e-5),
          f"{what}: router_xattn vs the plain predictor, max |err| {e:.3g}")
    check(np.array_equal(c_kernel, c_plain), f"{what}: cost path identical")
    return e


def _host_parts(engine, adapter) -> tuple:
    """Wrap the engine's and the adapter's hooks (instance attributes shadow
    the methods) to sum host seconds per part, each ending in a device sync;
    returns (seconds by part, undo)."""
    parts = {"featurizer": (engine, "embed"), "scoring": (engine, "score_emb"),
             "exploration": (adapter, "choose"), "generation": (engine, "generate_member"),
             "observe/_commit": (adapter, "observe"),
             "update steps": (adapter.updater, "run_steps"),
             "publish": (adapter.updater, "publish")}
    secs = {name: 0.0 for name in parts}

    def timed(name, fn):
        def wrapper(*args, **kwargs):
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            secs[name] += time.perf_counter() - t
            return out
        return wrapper

    for name, (obj, attr) in parts.items():
        setattr(obj, attr, timed(name, getattr(obj, attr)))

    def undo():
        for obj, attr in parts.values():
            delattr(obj, attr)
    return secs, undo


def _log_parts(tag, secs, wall):
    # observe runs _commit, which runs the update steps and the publish.
    own = dict(secs)
    own["observe/_commit"] -= secs["update steps"] + secs["publish"]
    rest = wall - sum(own.values())
    log(f"[{tag}] host wall {wall:.3f}s by part: " + ", ".join(
        f"{name} {v:.3f}s ({v / wall:.4f})" for name, v in
        [*own.items(), ("scheduler and the rest", rest)]))


def phase_online(engine, rx, pl2) -> dict:
    """Online adaptation on the default pool at published size: replay,
    exploration, drift alarms, incremental updates published by swap,
    staged feedback, and a published-size member hot-added and removed."""
    from repro_torch.common.tree import flatten_with_paths
    from repro_torch.data.routerbench import generate
    from repro_torch.launch import serve
    from repro_torch.serving.queue import DONE

    t0 = time.perf_counter()
    data = generate(1200, seed=0)
    tr, _, te = data.split(seed=0)
    train = data.emb[tr]
    truth = serve.quality_truth(engine.pool, data)
    vocab = min(m.cfg.vocab_size for m in engine.pool)
    held_out = data.emb[te][:HELD_OUT_CHECK]
    log(f"[online] corpus of 1200 and the truth lookup in {time.perf_counter() - t0:.2f}s")
    counts = _Launches(rx, pl2)

    # 1. a drift trace, feedback at completion.
    trace = _online_trace("drift", ONLINE_REQUESTS, 0, data, te, vocab)
    v0 = engine.router.version
    counts.start()
    t0 = time.perf_counter()
    adapter = serve.make_adapter(engine, truth, train, window=DRIFT_WINDOW, seed=0)
    sched = serve.build_scheduler(engine, score_batch=64, max_batch=8, max_wait_s=0.02,
                                  queue_capacity=256, adapter=adapter, device="cuda")
    t_setup = time.perf_counter() - t0
    secs, undo = _host_parts(engine, adapter)
    run_steps = adapter.updater.run_steps
    unchanged, step_log = [], []

    def checked_run_steps(replay, model_emb, n_steps):
        live = engine.router
        snap = {k: v.clone() for k, v in _router_leaves(live).items()}
        memb = np.array(live.model_emb, copy=True)
        out = run_steps(replay, model_emb, n_steps)
        leaves = _router_leaves(live)
        unchanged.append(engine.router is live and leaves.keys() == snap.keys()
                         and all(torch.equal(leaves[k], v) for k, v in snap.items())
                         and np.array_equal(live.model_emb, memb))
        step_log.append(out["steps"])
        return out

    adapter.updater.run_steps = checked_run_steps
    t0 = time.perf_counter()
    try:
        summary = sched.run_trace(trace)
        torch.cuda.synchronize()
    finally:
        adapter.updater.run_steps = run_steps
        undo()
    wall = time.perf_counter() - t0
    got = counts.take()
    st = adapter.stats
    n_done = summary["completed"] + summary["rejected"] + summary["expired"]
    legs = sum(1 for r in trace if r.status == DONE and r.member >= 0)
    check(n_done == ONLINE_REQUESTS, f"online trace accounts for {n_done} of {ONLINE_REQUESTS}")
    check(st["outcomes"] == legs == summary["completed"],
          f"outcomes {st['outcomes']} vs {legs} generate legs")
    check(st["updates"] >= 1 and st["router_swaps"] == st["updates"],
          f"updates {st['updates']}, swaps {st['router_swaps']}")
    check(engine.router.version == v0 + st["router_swaps"],
          f"router v{engine.router.version} after {st['router_swaps']} swaps from v{v0}")
    check(len(unchanged) > 0 and all(unchanged),
          "the live router's tensors unchanged across every run_steps")
    check(sum(step_log) == st["update_steps"], "update steps counted")
    check(got["router_xattn"] > 0, "the online path launched router_xattn")
    windows = adapter.drift.windows_seen
    check(windows >= ONLINE_REQUESTS // DRIFT_WINDOW and got["pairwise_l2"] >= 1 + windows,
          f"pairwise_l2 launched {got['pairwise_l2']} times for {windows} drift windows")
    for r in trace:
        if r.status == DONE:
            member = engine.pool[r.member]
            check(len(r.output) == r.max_new and 0 <= int(r.output.min())
                  and int(r.output.max()) < member.cfg.vocab_size,
                  f"request {r.rid}: {len(r.output)} tokens in {member.name}'s vocab")
    e_swap = _kernel_vs_plain(engine, held_out, f"after the last swap (v{engine.router.version})")
    for line in sched.telemetry.report(summary.get("duration_s")).splitlines():
        log(f"[online] {line}")
    log(f"[online] {adapter.report()}")
    log(f"[online] drift: {windows} windows, {adapter.drift.alarms} alarms; set-up (drift "
        f"fit) {t_setup:.3f}s; trace of {ONLINE_REQUESTS} in {wall:.3f}s; losses quality "
        f"{st['last_quality_loss']:.6g}, cost {st['last_cost_loss']:.6g}")
    _log_parts("online", secs, wall)
    log(f"[online] live router unchanged across all {len(unchanged)} run_steps calls; "
        f"router_xattn on router v{engine.router.version}, {HELD_OUT_CHECK} held-out "
        f"queries: max |err| {e_swap:.3g} vs the plain predictor (tol 1e-5)")
    log(f"[online] launches: router_xattn {got['router_xattn']}, pairwise_l2 "
        f"{got['pairwise_l2']} (fit + {windows} windows + refits)")

    # The incremental step alone: host ms per step and the device's busy time.
    upd, memb = adapter.updater, adapter.membership.model_emb
    walls = [_synced(lambda: upd.run_steps(adapter.replay, memb, 8))[0] / 8 * 1e3
             for _ in range(5)]
    step_wall = float(np.median(walls))
    busy, by_name = profile_device(lambda: upd.run_steps(adapter.replay, memb, 8))
    step_busy = busy / 8
    in_trace = secs["update steps"] / max(1, sum(step_log)) * 1e3
    log(f"[online] incremental step (batch {adapter.config.batch_size}, quality + cost, one "
        f"float() per loss): {step_wall:.4f} ms host per step (median of 5 x 8), device "
        f"busy {step_busy:.4f} ms -> idle share {max(0.0, 1 - step_busy / step_wall):.3f}; "
        f"in the trace {in_trace:.4f} ms per step")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:3]:
        log(f"[online]   step {ms / 8:8.4f} ms  {name[:100]}")
    result = {"wall_s": wall, "updates": st["updates"], "step_ms": step_wall,
              "step_busy_ms": step_busy, "max_abs_err_after_swap": e_swap}

    # 2. staged feedback, delivered late and out of order.
    trace = _online_trace("poisson", STAGED_REQUESTS, 1, data, te, vocab)
    counts.start()
    t0 = time.perf_counter()
    staged = serve.make_adapter(engine, truth, train, window=DRIFT_WINDOW,
                                feedback_delay=FEEDBACK_DELAY, seed=0)
    sched = serve.build_scheduler(engine, score_batch=64, max_batch=8, max_wait_s=0.02,
                                  queue_capacity=256, adapter=staged, device="cuda")
    summary = sched.run_trace(trace)
    in_trace = staged.stats["delayed_resolved"]
    # Drain the feedback channel: every delivery is due 1.5 delays after its
    # request finished, before the stage's timeout of 20 delays.
    staged.tick(sched.clock.now + 2 * FEEDBACK_DELAY)
    torch.cuda.synchronize()
    wall2 = time.perf_counter() - t0
    got = counts.take()
    st = staged.stats
    check(summary["completed"] == STAGED_REQUESTS, f"staged trace completed "
          f"{summary['completed']} of {STAGED_REQUESTS}")
    check(st["staged"] == STAGED_REQUESTS and st["delayed_resolved"] == st["staged"]
          and st["outcomes"] == st["staged"] and len(staged.stage) == 0,
          f"staged outcomes resolve: {staged.report()}")
    check(st["feedback_expired"] == 0 and staged.feedback_source.in_flight == 0,
          f"no staged outcome expired: {staged.report()}")
    log(f"[online] staged (delay {FEEDBACK_DELAY}s, jitter {FEEDBACK_DELAY * 0.5}s): "
        f"{staged.report()}; {in_trace} resolved during the trace, the rest at the drain; "
        f"{wall2:.3f}s; launches router_xattn {got['router_xattn']}, pairwise_l2 "
        f"{got['pairwise_l2']}")

    # 3. a published-size member hot-added, served at K = 4, removed.
    gc.collect()
    base = torch.cuda.memory_allocated() / 2**30
    t0 = time.perf_counter()
    (new,) = serve.build_pool([HOTADD_MEMBER], seed=len(engine.pool), device="cuda")
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    grown = torch.cuda.memory_allocated() / 2**30
    n_new = sum(p.numel() for p in flatten_with_paths(new.params).values())
    truth4 = serve.quality_truth(engine.pool + [new], data)
    counts.start()
    hot = serve.make_adapter(engine, truth4, train, window=DRIFT_WINDOW, seed=0)
    idx = hot.add_member(new)
    got_add = counts.take()
    del new
    check(idx == 3 and engine.router.n_members == 4 and len(engine.pool) == 4
          and hot.membership.in_probation(idx), "hot add: K = 4, the new member probationary")
    check(engine.pool[idx].device.type == "cuda", "the new member's weights on the card")
    v_add = engine.router.version
    e_k4 = _kernel_vs_plain(engine, held_out, "K = 4 after the hot add")
    seen = {"exploit": 0, "explored": 0}
    choose = hot.choose

    def spy(s_hat, c_hat, lam, now=0.0):
        probation = hot.membership.in_probation(idx)
        out = choose(s_hat, c_hat, lam, now)
        if probation:
            ex = hot.last_explored
            seen["exploit"] += int((out[~ex] == idx).sum())
            seen["explored"] += int((out[ex] == idx).sum())
        return out

    hot.choose = spy
    trace = _online_trace("poisson", HOTADD_REQUESTS, 2, data, te,
                          min(m.cfg.vocab_size for m in engine.pool))
    counts.start()
    t0 = time.perf_counter()
    sched = serve.build_scheduler(engine, score_batch=64, max_batch=8, max_wait_s=0.02,
                                  queue_capacity=256, adapter=hot, device="cuda")
    summary = sched.run_trace(trace)
    torch.cuda.synchronize()
    wall3 = time.perf_counter() - t0
    got = counts.take()
    del hot.choose
    check(summary["completed"] == HOTADD_REQUESTS, f"hot-add trace completed "
          f"{summary['completed']} of {HOTADD_REQUESTS}")
    check(got["router_xattn"] > 0, "the K = 4 trace launched router_xattn")
    check(seen["exploit"] == 0, f"the probationary member was the exploit argmax "
          f"{seen['exploit']} times")
    e_k4_after = _kernel_vs_plain(engine, held_out, "K = 4 after the hot-add trace")
    log(f"[online] hot add {HOTADD_MEMBER}: {n_new / 1e9:.4f}B params ({4 * n_new / 2**30:.2f} "
        f"GiB) built in {t_build:.2f}s; memory {base:.2f} -> {grown:.2f} GiB; router_xattn "
        f"at K = 4: max |err| "
        f"{e_k4:.3g} (v{v_add}), {e_k4_after:.3g} "
        f"after the trace (v{engine.router.version}); launches at the add: "
        f"{got_add['router_xattn']} / {got_add['pairwise_l2']}")
    log(f"[online] K = 4 trace of {HOTADD_REQUESTS} in {wall3:.3f}s: {hot.report()}; "
        f"the new member chosen {seen['explored']} times through exploration, 0 by the "
        f"exploit argmax; per-member counts " + ", ".join(
            f"{k}={v}" for k, v in summary["per_member_counts"].items())
        + f"; launches router_xattn {got['router_xattn']}, pairwise_l2 {got['pairwise_l2']}")
    hot.remove_member(idx)
    gc.collect()
    torch.cuda.empty_cache()
    back = torch.cuda.memory_allocated() / 2**30
    check(engine.router.n_members == 3 and len(engine.pool) == 3, "removed: K = 3")
    check(abs(back - base) < 0.1, f"memory after the removal {back:.2f} GiB vs {base:.2f}")
    log(f"[online] removed {HOTADD_MEMBER}: memory {grown:.2f} -> {back:.2f} GiB "
        f"(before the add {base:.2f})")
    result.update(launches=counts.total, memory_gib=(base, grown, back),
                  max_abs_err_k4=max(e_k4, e_k4_after), data=data)
    log(f"[online] launches on the online path: router_xattn "
        f"{counts.total['router_xattn']}, pairwise_l2 {counts.total['pairwise_l2']}")
    return result


def phase_cascade(engine, data, rx, pl2) -> dict:
    """The stop-vs-escalate ladder on the default pool with an attn-ens
    router trained on the card: a near-duplicate trace through the cascade
    with the semantic cache as rung 0, then the cascade with the online
    adapter observing every leg."""
    from repro_torch.cascade import cost_ladder
    from repro_torch.launch import serve
    from repro_torch.serving.queue import DONE
    from repro_torch.serving.semcache import _KERNEL_MIN_CELLS

    tr, _, te = data.split(seed=0)
    train = data.emb[tr]
    t0 = time.perf_counter()
    cengine = serve.train_engine(engine.pool, quality_kind="attn-ens", device="cuda")
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    cengine.lam = CASCADE_LAM
    truth = serve.quality_truth(cengine.pool, data)
    vocab = min(m.cfg.vocab_size for m in cengine.pool)
    ladder = cost_ladder(cengine.router)
    mu = np.asarray(cengine.router.cost_scaler["mu"])
    check(cengine.router.quality_kind == "attn-ens", "the cascade router is attn-ens")
    check(bool(np.all(np.diff(mu[ladder]) >= 0)), f"ladder {ladder} ascends in mu {mu}")
    s_mean, s_std, _ = cengine.score_emb_uncertainty(data.emb[te][:HELD_OUT_CHECK])
    check(bool(np.all(np.isfinite(s_mean))) and float(s_std.max()) > 0,
          "attn-ens scores finite with nonzero head spread")
    log(f"[cascade] attn-ens router trained on the card in {t_train:.2f}s; ladder "
        + " < ".join(f"{cengine.pool[i].name} ({mu[i]:.6g})" for i in ladder)
        + f"; head spread on {HELD_OUT_CHECK} held-out queries: mean std "
        f"{float(s_std.mean()):.4g}, max {float(s_std.max()):.4g}; lambda {CASCADE_LAM}")
    counts = _Launches(rx, pl2)

    trace = _online_trace("neardup", CASCADE_REQUESTS, 0, data, te, vocab,
                          hot_set=32, dup_frac=0.7)
    counts.start()
    t0 = time.perf_counter()
    coord = serve.make_cascade(cengine, truth, max_legs=3)
    drift = serve.build_drift_proto(train, cengine.router.centroids, window=DRIFT_WINDOW,
                                    device="cuda")
    cache = serve.make_semcache(train, cap=256, drift=drift, device="cuda")
    sched = serve.build_scheduler(cengine, score_batch=64, max_batch=8, max_wait_s=0.02,
                                  queue_capacity=256, semcache=cache, cascade=coord,
                                  device="cuda")
    check(cache.policy is coord.policy, "rung 0 decides with the cascade's policy")
    rung0 = {"calls": 0, "stops": 0}
    decide_rung0 = coord.policy.decide_rung0

    def spy(**kw):
        d = decide_rung0(**kw)
        rung0["calls"] += 1
        rung0["stops"] += not d.escalate
        return d

    coord.policy.decide_rung0 = spy
    summary = sched.run_trace(trace)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = counts.take()
    n_done = summary["completed"] + summary["rejected"] + summary["expired"]
    check(n_done == CASCADE_REQUESTS, f"cascade trace accounts for {n_done}")
    check(summary["escalations"] > 0 and summary["escalations"] == coord.stats["escalations"],
          f"escalations {summary['escalations']} (coordinator {coord.stats['escalations']})")
    check(sum(summary["finalized_by_leg"]) == summary["completed"],
          f"finalized by leg {summary['finalized_by_leg']} vs {summary['completed']}")
    for r in trace:
        check(abs(r.cum_cost - sum(r.leg_costs)) <= 1e-12,
              f"request {r.rid}: cumulative $ {r.cum_cost} vs legs {r.leg_costs}")
        if r.status == DONE:
            member = cengine.pool[r.member]
            check(len(r.output) == r.max_new and 0 <= int(r.output.min())
                  and int(r.output.max()) < member.cfg.vocab_size,
                  f"request {r.rid}: {len(r.output)} tokens in {member.name}'s vocab")
    check(rung0["stops"] > 0 and cache.stats["served"] == rung0["stops"],
          f"the cache served {cache.stats['served']} requests, decide_rung0 stopped "
          f"{rung0['stops']} of {rung0['calls']}")
    check(got["pairwise_l2"] > 0, "the cascade path launched pairwise_l2")
    for line in sched.telemetry.report(summary.get("duration_s")).splitlines():
        log(f"[cascade] {line}")
    log(f"[cascade] {coord.report()}")
    rep = cache.report()
    log(f"[cascade] rung 0: {rung0['calls']} decide_rung0 calls, {rung0['stops']} stops = "
        f"{rep['served']} served, {rep['fallthroughs']} fallthroughs; {rep['lookups']} "
        f"lookups, {rep['entries']} entries; drift {drift.windows_seen} windows, "
        f"{drift.alarms} alarms")
    escalations = summary["escalations"]
    log(f"[cascade] trace of {CASCADE_REQUESTS} in {wall:.3f}s (set-up included); launches "
        f"router_xattn {got['router_xattn']} (attn-ens scores on the plain predictor), "
        f"pairwise_l2 {got['pairwise_l2']} (calibrate, drift fit and windows, lookups of "
        f"{_KERNEL_MIN_CELLS} cells or more)")

    trace = _online_trace("poisson", COMPOSED_REQUESTS, 3, data, te, vocab)
    counts.start()
    t0 = time.perf_counter()
    adapter = serve.make_adapter(cengine, truth, train, window=DRIFT_WINDOW, seed=0)
    coord2 = serve.make_cascade(cengine, truth, max_legs=3)
    sched = serve.build_scheduler(cengine, score_batch=64, max_batch=8, max_wait_s=0.02,
                                  queue_capacity=256, adapter=adapter, cascade=coord2,
                                  device="cuda")
    summary = sched.run_trace(trace)
    torch.cuda.synchronize()
    wall2 = time.perf_counter() - t0
    got2 = counts.take()
    legs = sum(r.leg for r in trace)
    check(summary["completed"] == COMPOSED_REQUESTS, "composed trace completed")
    check(adapter.stats["outcomes"] == legs > summary["completed"],
          f"the adapter observed {adapter.stats['outcomes']} outcomes for {legs} legs of "
          f"{summary['completed']} requests")
    log(f"[cascade] --online --cascade, {COMPOSED_REQUESTS} requests in {wall2:.3f}s: "
        f"{coord2.report()}")
    log(f"[cascade] {adapter.report()}; launches router_xattn {got2['router_xattn']}, "
        f"pairwise_l2 {got2['pairwise_l2']}")
    log(f"[cascade] launches on the cascade path: router_xattn "
        f"{counts.total['router_xattn']}, pairwise_l2 {counts.total['pairwise_l2']}")
    return {"launches": counts.total, "escalations": escalations,
            "train_s": t_train, "wall_s": wall + wall2}


def _segment_bytes(out_dir) -> dict:
    return {name: open(os.path.join(out_dir, name), "rb").read()
            for name in sorted(os.listdir(out_dir))}


def _obs_run(engine, data, counts, out_dir, stack: bool) -> dict:
    """One neardup trace through the scheduler with the semantic cache, with
    the whole obs stack when ``stack``; the kernel profiler is installed
    just before the run's first dispatch (the cache's calibration) and
    removed in the end, whatever happens."""
    import shutil

    from repro_torch import obs
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.serving.budget import BudgetGovernor

    tr, _, te = data.split(seed=0)
    train = data.emb[tr]
    vocab = min(m.cfg.vocab_size for m in engine.pool)
    trace = _online_trace("neardup", OBS_REQUESTS, 0, data, te, vocab,
                          hot_set=32, dup_frac=0.7)
    shutil.rmtree(out_dir, ignore_errors=True)
    recorder = registry = slo = flusher = profiler = None
    governor = BudgetGovernor(*OBS_BUDGET, lam0=1.0)
    if stack:
        recorder = obs.TraceRecorder(
            label="chip-obs-neardup",
            sampler=obs.TraceSampler(OBS_SAMPLE, seed=0, head=OBS_HEAD),
            max_buffered_per_worker=OBS_CAP)
        registry = obs.MetricsRegistry()
        slo = obs.build_slo_tracker(tracer=recorder, **OBS_SLO)
        flusher = obs.ObsFlusher(out_dir, recorder=recorder, registry=registry,
                                 scrape_every_s=OBS_SCRAPE_EVERY, label=recorder.label)
        profiler = obs.KernelProfiler(tracer=recorder)
    counts.start()
    t0 = time.perf_counter()
    ops.set_kernel_profiler(profiler)
    try:
        drift = serve.build_drift_proto(train, engine.router.centroids, window=DRIFT_WINDOW,
                                        device="cuda")
        cache = serve.make_semcache(train, cap=256, drift=drift, device="cuda")
        sched = serve.build_scheduler(
            engine, score_batch=64, max_batch=8, max_wait_s=0.02, queue_capacity=256,
            semcache=cache, governor=governor,
            tracer=recorder.scoped(0) if stack else None, slo=slo, flusher=flusher,
            device="cuda")
        if stack:
            obs.register_scheduler_metrics(registry, sched)
            obs.register_governor_metrics(registry, governor, lambda: sched.clock.now)
            obs.register_slo_metrics(registry, slo, lambda: sched.clock.now)
            obs.register_stream_metrics(registry, flusher)
        summary = sched.run_trace(trace)
        torch.cuda.synchronize()
    finally:
        ops.set_kernel_profiler(None)
    wall = time.perf_counter() - t0
    got = counts.take()
    n_done = summary["completed"] + summary["rejected"] + summary["expired"]
    check(n_done == OBS_REQUESTS, f"obs trace accounts for {n_done} of {OBS_REQUESTS}")
    out = {"wall": wall, "launches": got, "summary": summary, "cache": cache.report(),
           "lam": governor.lam}
    if not stack:
        return out
    t0 = time.perf_counter()
    slo.check(sched.clock.now, force=True)
    flusher.finalize(sched.clock.now)
    doc = obs.concat_dir(out_dir)
    out.update(
        t_export=time.perf_counter() - t0, doc=doc, profiler=profiler, recorder=recorder,
        slo=slo, flusher=flusher,
        trace_json=obs.trace.trace_doc_to_json(doc),
        snapshot=json.dumps(registry.snapshot(deterministic=True), sort_keys=True),
        prom=registry.prometheus(deterministic=True),
        segments=_segment_bytes(out_dir))
    return out


def phase_obs(engine, data, rx, pl2, kernel_times, pl2_times) -> dict:
    """The obs stack on the cached serving path at full width: a sampled,
    capped recorder, the metrics registry, SLOs, a streaming flusher and the
    kernel-dispatch profiler, twice on one seeded neardup trace (their
    deterministic artifacts byte-identical), and once without the stack."""
    from repro_torch import obs

    counts = _Launches(rx, pl2)
    lam = engine.lam
    engine.lam = 1.0
    base = os.path.join(ROOT, "build", "obs_smoke")
    try:
        runs = [_obs_run(engine, data, counts, os.path.join(base, f"run{i}"), stack)
                for i, stack in enumerate((True, True, False))]
    finally:
        engine.lam = lam
    a, b, off = runs
    for i, run in enumerate((a, b)):
        doc, prof = run["doc"], run["profiler"].summary()
        errs = obs.validate_chrome_trace(doc) + obs.validate_span_tree(doc)
        check(not errs, f"obs run {i}: trace validates ({errs[:3]})")
        for kernel, op in (("router_xattn", "router_xattn_pool"), ("pairwise_l2", "pairwise_l2")):
            calls = prof.get(op, {}).get("calls", 0)
            check(calls == run["launches"][kernel] > 0,
                  f"obs run {i}: profiler saw {calls} {op} dispatches, the kernel "
                  f"launched {run['launches'][kernel]} times")
        n_req = sum(1 for e in doc["traceEvents"] if e.get("name") == "request")
        check(0 < n_req <= OBS_REQUESTS, f"obs run {i}: {n_req} request trees kept")
    check(a["trace_json"] == b["trace_json"], "obs: the two runs' traces are byte-identical")
    check(a["segments"] == b["segments"],
          f"obs: the two runs' {len(a['segments'])} segment files are byte-identical")
    check(a["snapshot"] == b["snapshot"] and a["prom"] == b["prom"],
          "obs: the two runs' deterministic metrics are byte-identical")
    check(a["summary"]["completed"] == off["summary"]["completed"]
          and a["summary"]["per_member_counts"] == off["summary"]["per_member_counts"]
          and a["summary"]["total_spend"] == off["summary"]["total_spend"],
          "obs: the stack leaves what is served unchanged")
    rec, fl = a["recorder"], a["flusher"]
    stats = rec.drop_stats
    log(f"[obs] {OBS_REQUESTS} neardup requests at lambda 1 (governor {OBS_BUDGET[0]} $ per "
        f"{OBS_BUDGET[1]} s, final lambda {a['lam']:.4g}), cache "
        f"{a['cache']['served']} served / {a['cache']['lookups']} lookups")
    log(f"[obs] recorder: {stats['events']} events, {stats['requests_closed']} trees closed, "
        f"{stats['requests_sampled_out']} sampled out, {stats['requests_shed']} shed "
        f"(cap {OBS_CAP}), peak {rec.peak_buffered} buffered; {fl.seq} flushes, "
        f"{len(a['segments'])} files; trace {len(a['trace_json'])} bytes, "
        f"{len(a['doc']['traceEvents'])} events (kernel spans, wall clock, left out)")
    log(f"[obs] slo: {a['slo'].alerts_total} alert transitions, firing "
        f"{a['slo'].firing() or 'none'}; validators clean; both runs byte-identical "
        f"(trace, {len(a['segments'])} segments, metrics JSON and Prometheus text)")
    log(f"[obs] trace wall: stack on {a['wall']:.3f}s and {b['wall']:.3f}s, off "
        f"{off['wall']:.3f}s ({(a['wall'] + b['wall']) / 2 / off['wall']:.3f}x); export "
        f"{a['t_export']:.3f}s")
    prof = a["profiler"].summary()
    for op, label, times in (
            ("router_xattn_pool", "router_xattn", [("[kernel] B 8", kernel_times[0]),
                                                   ("[kernel] B 256", kernel_times[1])]),
            ("pairwise_l2", "pairwise_l2", [(f"[pairwise_l2] {t['call_site']}", t)
                                            for t in pl2_times])):
        p = prof[op]
        log(f"[obs] profiler {op}: {p['calls']} calls = {a['launches'][label]} launches, "
            f"{p['elements']} rows, p50 {p['p50_us']:.1f} us, p99 {p['p99_us']:.1f} us "
            f"(synced dispatch, host clock); beside "
            + ", ".join(f"{name} {t['ms'] * 1e3:.1f} us/call" for name, t in times))
    total = {k: a["launches"][k] + b["launches"][k] + off["launches"][k]
             for k in a["launches"]}
    log(f"[obs] launches on the obs path (three runs): router_xattn "
        f"{total['router_xattn']}, pairwise_l2 {total['pairwise_l2']}")
    return {"launches": total, "profiler": prof, "wall_on": [a["wall"], b["wall"]],
            "wall_off": off["wall"]}


def _fleet_rollup(summary) -> dict:
    """The plane's summary without its wall-clock fields (routing latency)."""
    return {k: v for k, v in summary.items() if not k.startswith("routing_")}


def _fleet_run(engine, args, data, counts) -> dict:
    from repro_torch import obs
    from repro_torch.launch import serve

    tr, _, te = data.split(seed=0)
    vocab = min(m.cfg.vocab_size for m in engine.pool)
    truth = serve.quality_truth(engine.pool, data)
    trace = _online_trace(args.trace, args.requests, 0, data, te, vocab)
    recorder = obs.TraceRecorder(label="chip-fleet-drift")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    counts.start()
    t0 = time.perf_counter()
    plane, ledger = serve.build_plane(engine, args, data.emb[tr], truth, None,
                                      recorder=recorder)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    mem_delta = (torch.cuda.memory_allocated() - mem0) / 2**30
    workers = sorted(plane.workers.values(), key=lambda w: w.wid)
    check(all(w.engine.pool is engine.pool for w in workers),
          "every worker's engine holds the one pool")
    secs = {"featurizer": 0.0, "scoring": 0.0, "generation": 0.0, "sync rounds": 0.0}

    def timed(name, fn):
        def wrapper(*a, **kw):
            t = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            secs[name] += time.perf_counter() - t
            return out
        return wrapper

    hooks = [(w.engine, attr, name) for w in workers for attr, name in
             (("embed", "featurizer"), ("score_emb", "scoring"),
              ("generate_member", "generation"))]
    hooks.append((plane.coordinator, "sync_round", "sync rounds"))
    for obj, attr, name in hooks:
        setattr(obj, attr, timed(name, getattr(obj, attr)))
    t0 = time.perf_counter()
    try:
        summary = plane.run_trace(trace)
        torch.cuda.synchronize()
    finally:
        for obj, attr, _ in hooks:
            delattr(obj, attr)
    wall = time.perf_counter() - t0
    got = counts.take()
    return {"plane": plane, "ledger": ledger, "summary": summary, "recorder": recorder,
            "wall": wall, "t_build": t_build, "mem_delta": mem_delta, "secs": secs,
            "launches": got, "trace": trace}


def phase_fleet(engine, data, rx, pl2) -> dict:
    """Three in-process workers on the default pool (``serve.build_plane``
    from the serve CLI's flags): online with leader/follower sync, a crash
    and rejoin, one shared budget ledger; run twice from one seed."""
    from repro_torch import obs
    from repro_torch.launch import serve

    args = serve.parse_args(FLEET_ARGV)
    counts = _Launches(rx, pl2)
    runs = [_fleet_run(engine, args, data, counts) for _ in range(2)]
    tr, _, te = data.split(seed=0)
    q = data.emb[te][:HELD_OUT_CHECK]
    errs = []
    for i, run in enumerate(runs):
        plane, summary = run["plane"], run["summary"]
        stats = plane.coordinator.stats
        alive = [w for w in plane.workers.values() if w.alive]
        versions = {w.router_version for w in alive}
        n_done = summary["completed"] + summary["rejected"] + summary["expired"]
        check(n_done == args.requests, f"fleet run {i}: {n_done} of {args.requests}")
        check(len(alive) == FLEET_WORKERS, f"fleet run {i}: {len(alive)} workers alive")
        check(len(versions) == 1, f"fleet run {i}: alive workers on versions {versions}")
        check(stats["stale_rejected"] == 0, f"fleet run {i}: stale publishes rejected "
                                            f"{stats['stale_rejected']}")
        check(summary["reassigned"] > 0, f"fleet run {i}: reassigned {summary['reassigned']}")
        check(stats["updates"] > 0, f"fleet run {i}: {stats['updates']} leader updates")
        check(abs(run["mem_delta"]) <= FLEET_SHARED_GIB,
              f"fleet run {i}: building {FLEET_WORKERS} workers took "
              f"{run['mem_delta']:.3f} GiB of device memory")
        for w in sorted(alive, key=lambda w: w.wid):
            errs.append(_kernel_vs_plain(w.engine, q, f"fleet run {i} w{w.wid} v"
                                                      f"{w.router_version}"))
        doc = run["recorder"].chrome_trace()
        bad = obs.validate_chrome_trace(doc) + obs.validate_span_tree(doc)
        check(not bad, f"fleet run {i}: trace validates ({bad[:3]})")
        n_rpc = sum(1 for e in doc["traceEvents"] if e.get("cat") == "rpc")
        check(n_rpc > 0, f"fleet run {i}: {n_rpc} rpc spans")
        check(run["launches"]["router_xattn"] > 0 and run["launches"]["pairwise_l2"] > 0,
              f"fleet run {i}: launches {run['launches']}")
        run["n_rpc"] = n_rpc
    a, b = runs
    check(_fleet_rollup(a["summary"]) == _fleet_rollup(b["summary"]),
          "fleet: the two seeded runs' rollups are equal")
    check(a["recorder"].to_json() == b["recorder"].to_json(),
          "fleet: the two seeded runs' traces are byte-identical")
    plane, s, ledger = a["plane"], a["summary"], a["ledger"]
    st = plane.coordinator.stats
    for line in plane.report(s.get("duration_s")).splitlines():
        log(f"[fleet] {line}")
    for w in sorted(plane.workers.values(), key=lambda w: w.wid):
        log(f"[fleet] w{w.wid} {w.adapter.report()}")
    g = ledger.summary(max(w.clock.now for w in plane.workers.values()))
    log(f"[fleet] shared ledger ${g['budget_per_window']:.4f} per {args.budget_window}s: "
        f"spend ${g['total_spend']:.6f}, final lambda {g['lam']:.6g} (nominal "
        f"{g['lam0']:.3g}), tightened x{int(g['tightened'])} relaxed "
        f"x{int(g['relaxed'])} throttled x{ledger.throttled}")
    log(f"[fleet] syncs {st['syncs']}, merged {st['merged']}, updates {st['updates']} "
        f"({st['update_steps']} steps), broadcasts {st['broadcasts']}, stale rejected "
        f"{st['stale_rejected']}, reassigned {s['reassigned']}; {a['n_rpc']} rpc spans; "
        f"router_xattn vs plain on every alive worker, max |err| {max(errs):.3g}")
    for i, run in enumerate(runs):
        wall = run["wall"]
        rest = wall - sum(run["secs"].values())
        log(f"[fleet] run {i}: build {run['t_build']:.3f}s (device memory "
            f"{run['mem_delta'] * 1024:+.1f} MiB for {FLEET_WORKERS} workers); trace wall "
            f"{wall:.3f}s by part: " + ", ".join(
                f"{name} {v:.3f}s ({v / wall:.4f})" for name, v in
                [*run["secs"].items(), ("plane and the rest", rest)]))
    total = {k: a["launches"][k] + b["launches"][k] for k in a["launches"]}
    log(f"[fleet] launches on the fleet path (two runs): router_xattn "
        f"{total['router_xattn']}, pairwise_l2 {total['pairwise_l2']}")
    return {"launches": total, "max_abs_err": max(errs), "wall_s": [a["wall"], b["wall"]],
            "mem_delta_gib": [a["mem_delta"], b["mem_delta"]], "lam": g["lam"]}


def _smi_rows() -> list:
    """[(pid, MiB)] of the processes nvidia-smi lists on the card. In a
    container whose processes it cannot tell apart it lists one row for
    each, every row pid 1 (``/process_api``) holding the container's whole
    use."""
    out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,used_memory",
                          "--format=csv,noheader,nounits"], capture_output=True,
                         text=True, timeout=30).stdout
    rows = []
    for row in out.strip().splitlines():
        parts = [x.strip() for x in row.split(",")]
        if len(parts) == 2 and parts[1].isdigit():
            rows.append((parts[0], int(parts[1])))
    return rows


def _smi_used(rows) -> int:
    """MiB that nvidia-smi's ``rows`` hold together: their sum, or where
    every row carries one pid (the container's whole use in each), one row."""
    mibs = [mib for _, mib in rows]
    if len({pid for pid, _ in rows}) == 1:
        return max(mibs)
    return sum(mibs)


def _wait_for_card(base, timeout=120.0) -> float:
    """Wait until nvidia-smi lists no more rows than ``base`` and they hold
    no more than ``base``'s memory + 256 MiB (a finished child's memory can
    outlive its exit for a moment); returns the wait."""
    def busy():
        rows = _smi_rows()
        return len(rows) > len(base) or _smi_used(rows) > _smi_used(base or [("", 0)]) + 256

    t0 = time.perf_counter()
    while busy() and time.perf_counter() - t0 < timeout:
        time.sleep(0.2)
    check(not busy(), f"socket: a finished run still holds the card after {timeout:.0f} s")
    return time.perf_counter() - t0


def _serve_child(argv, sample_smi=False) -> dict:
    """Run the serve CLI as a child process (its own session, so a timeout
    kills its followers too): each output line with its arrival time, the
    exit code, the wall, and with ``sample_smi`` nvidia-smi's rows polled
    every 0.2 s while it runs: the peak MiB of each pid it lists, the peak
    of the card's use (:func:`_smi_used`, ``total``) and the most rows
    listed at once (``rows``)."""
    import signal
    import threading

    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), PYTHONUNBUFFERED="1")
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", "repro_torch.launch.serve", *argv],
                            cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, start_new_session=True)
    lines, smi, peak, done = [], {}, {"total": 0, "rows": 0}, threading.Event()

    def read():
        for line in proc.stdout:
            lines.append((time.perf_counter() - t0, line.rstrip("\n")))

    def sample():
        while not done.is_set():
            rows = _smi_rows()
            for pid, mib in rows:
                smi[pid] = max(smi.get(pid, 0), mib)
            if rows:
                peak["total"] = max(peak["total"], _smi_used(rows))
                peak["rows"] = max(peak["rows"], len(rows))
            done.wait(0.2)

    threads = [threading.Thread(target=read, daemon=True)]
    if sample_smi:
        threads.append(threading.Thread(target=sample, daemon=True))
    for t in threads:
        t.start()
    try:
        rc = proc.wait(timeout=SOCKET_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()
        rc = "timeout"
    wall = time.perf_counter() - t0
    done.set()
    for t in threads:
        t.join(timeout=60)
    return {"lines": lines, "rc": rc, "wall": wall, "smi": smi, **peak}


def _first(lines, prefix) -> tuple:
    """(arrival time, text from ``prefix`` on) of the first line holding
    ``prefix``: the fleet's processes share one stdout, so a line of one
    can land inside a line of another."""
    for t, line in lines:
        if prefix in line:
            return t, line[line.index(prefix):]
    raise RuntimeError(f"chip_smoke check failed: no line starting with {prefix!r}")


def phase_socket(rx, pl2) -> dict:
    """The serve CLI with the [fleet] argv as child processes, over
    ``--transport local`` and ``--transport socket``: equal rollups, three
    OS processes each holding only the members it owns, equal router
    digests, every GENERATE hop paired, the followers' metrics federated,
    and both kernels launched in every process."""
    from repro_torch import obs

    out_dir = os.path.join(ROOT, "build", "socket")
    os.makedirs(out_dir, exist_ok=True)
    counts = _Launches(rx, pl2)
    runs = {}
    base = _smi_rows()                 # this process's own memory
    base_mib = _smi_used(base) if base else 0
    log(f"[socket] nvidia-smi before the runs: {base}")
    for transport in ("local", "socket"):
        paths = {k: os.path.join(out_dir, f"{transport}.{k}") for k in ("json", "prom")}
        for path in (*paths.values(), paths["prom"] + ".fleet.prom"):
            if os.path.exists(path):
                os.remove(path)
        gc.collect()
        torch.cuda.empty_cache()
        counts.start()
        run = _serve_child([*FLEET_ARGV, "--transport", transport,
                            "--trace-out", paths["json"], "--metrics-out", paths["prom"],
                            "--trace-profile"], sample_smi=True)
        run["parent_launches"] = counts.take()
        run["card_wait"] = _wait_for_card(base)
        for _, line in run["lines"]:
            log(f"[socket] {transport}| {line}")
        check(run["rc"] == 0, f"socket: the {transport} run exited {run['rc']}")
        check(run["parent_launches"] == {"router_xattn": 0, "pairwise_l2": 0},
              f"socket: the {transport} run launched in this process "
              f"{run['parent_launches']}")
        run["doc"] = json.load(open(paths["json"]))
        run["paths"] = paths
        runs[transport] = run
    loc, sock = runs["local"], runs["socket"]
    rollup = {name: [line for _, line in run["lines"] if line.startswith(SOCKET_ROLLUP)]
              for name, run in runs.items()}
    check(len(rollup["local"]) == len(SOCKET_ROLLUP) and rollup["local"] == rollup["socket"],
          f"socket: rollups differ\n  local  {rollup['local']}\n  socket {rollup['socket']}")
    lines = sock["lines"]
    digest = re.compile(r"router v(\d+) digest ([0-9a-f]{16})")
    _, ctrl = _first(lines, "socket plane: controller")
    pids = {0: int(re.search(r"controller pid (\d+)", ctrl).group(1))}
    pids.update({int(w): int(p) for w, p in re.findall(r"w(\d+):pid(\d+)", ctrl)})
    check(len(set(pids.values())) == FLEET_WORKERS,
          f"socket: {len(set(pids.values()))} distinct pids {pids}")
    _, owners = _first(lines, "pool ownership:")
    owner_of = dict(pair.split("->") for pair in owners.split(": ", 1)[1].split())
    check(sorted(owner_of) == sorted(POOL) and len(owners.split()) - 2 == len(POOL),
          f"socket: every member has exactly one owner ({owners})")
    ready = {0: digest.search(ctrl).groups()}
    done = {0: digest.search(_first(lines, "socket plane: w0")[1]).groups()}
    held, peaks, reserved, t_ready = {}, {}, {}, {}
    gib = re.compile(r"\(([0-9.]+) GiB of params\)")
    peak = re.compile(r"peak device memory ([0-9.]+) GiB \(reserved ([0-9.]+) GiB\)")
    held[0] = float(gib.search(ctrl).group(1))
    peaks[0], reserved[0] = map(float, peak.search(_first(lines, "socket plane: w0")[1]).groups())
    for wid in range(1, FLEET_WORKERS):
        t_ready[wid], line = _first(lines, f"[w{wid}] ready")
        ready[wid] = digest.search(line).groups()
        held[wid] = float(gib.search(line).group(1))
        line = _first(lines, f"[w{wid}] done")[1]
        done[wid] = digest.search(line).groups()
        peaks[wid], reserved[wid] = map(float, peak.search(line).groups())
    from repro_torch.configs import get_config

    want = {wid: sum(get_config(n).param_count() * 4 for n, o in owner_of.items()
                     if o == f"w{wid}") / 2**30 for wid in pids}
    # Each process's peak is its own caching allocator's (what it reserved
    # from the card), as it reports it. nvidia-smi lists the run's pids on
    # some machines; in a container every row may hold the container's
    # whole use, so it bounds the run's sum, and its row count counts
    # processes.
    smi = {pid: mib / 1024 for pid, mib in sock["smi"].items()}
    smi_of = {w: smi[str(pid)] for w, pid in pids.items() if str(pid) in smi}
    run_gib = {name: (run["total"] - base_mib) / 1024 for name, run in runs.items()}
    log(f"[socket] nvidia-smi peak MiB by listed pid: local run {loc['smi']}, socket run "
        f"{sock['smi']}; beside this process ({base_mib} MiB) the local run held "
        f"{run_gib['local']:.3f} GiB at its peak, the socket run's {len(pids)} processes "
        f"{run_gib['socket']:.3f} GiB; rows listed at most {loc['rows']} / {sock['rows']} "
        f"({len(base)} before); the socket run's pids {pids}; waited "
        f"{loc['card_wait']:.2f} / {sock['card_wait']:.2f} s for each run's memory to go")
    for wid in sorted(pids):
        log(f"[socket] w{wid} pid {pids[wid]}: params held {held[wid]:.4f} GiB "
            f"(members {want[wid]:.4f}), allocator peak {peaks[wid]:.3f} GiB (reserved "
            f"{reserved[wid]:.3f})" + (f", nvidia-smi peak {smi_of[wid]:.3f} GiB"
                                      if wid in smi_of else ""))
    check(all(v == ready[0] for v in ready.values()),
          f"socket: router digests when ready {ready}")
    check(all(v == done[0] for v in done.values()), f"socket: router digests at the end {done}")
    check(sock["rows"] == len(base) + len(pids),
          f"socket: nvidia-smi listed at most {sock['rows']} processes, {len(base)} before")
    check(0 < run_gib["socket"] < sum(held.values()) + len(pids) * SOCKET_MARGIN_GIB,
          f"socket: the socket run's processes held {run_gib['socket']:.3f} GiB on the card, "
          f"over their params {sum(held.values()):.3f} + {len(pids)} x {SOCKET_MARGIN_GIB}")
    for wid in sorted(pids):
        check(abs(held[wid] - want[wid]) < 0.01,
              f"socket: w{wid} holds {held[wid]:.4f} GiB of params, its members "
              f"{want[wid]:.4f}")
        check(reserved[wid] < held[wid] + SOCKET_ALLOC_MARGIN_GIB,
              f"socket: w{wid} allocator peak {peaks[wid]:.3f} GiB, reserved "
              f"{reserved[wid]:.3f}, over {held[wid]:.3f} + {SOCKET_ALLOC_MARGIN_GIB}")
        check(smi_of.get(wid, 0.0) < held[wid] + SOCKET_MARGIN_GIB,
              f"socket: w{wid} nvidia-smi peak {smi_of.get(wid)} GiB over {held[wid]:.3f} "
              f"+ {SOCKET_MARGIN_GIB}")
    check(max(reserved.values()) < sum(held.values()), "socket: no process held the whole pool")
    doc = sock["doc"]
    bad = obs.validate_chrome_trace(doc) + obs.validate_span_tree(doc)
    check(not bad, f"socket: merged trace validates ({bad[:3]})")
    check({e["pid"] for e in doc["traceEvents"]} == set(range(FLEET_WORKERS)),
          "socket: the merged trace holds every worker's pid")
    gen = [e for e in doc["traceEvents"] if e.get("name") == "rpc"
           and e["args"]["kind"] == "generate"]
    servers = {e["args"]["rpc"]: e["pid"] for e in gen if e["args"]["side"] == "server"}
    clients = [e for e in gen if e["args"]["side"] == "client"]
    check(clients and all(e["args"]["rpc"] in servers and servers[e["args"]["rpc"]] != e["pid"]
                          for e in clients),
          f"socket: {len(clients)} GENERATE client spans, each paired with a server span "
          f"in another process")
    fleet_prom = open(sock["paths"]["prom"] + ".fleet.prom").read()
    check(all(f'worker="{w}"' in fleet_prom for w in range(1, FLEET_WORKERS)),
          "socket: the fleet exposition holds every follower's series")
    kernels = {}
    for name, run in runs.items():
        per = {}
        for e in run["doc"]["traceEvents"]:
            if e.get("cat") == "kernel":
                key = "router_xattn" if "router_xattn" in e["name"] else "pairwise_l2"
                per.setdefault(e["pid"], {"router_xattn": 0, "pairwise_l2": 0})[key] += 1
        kernels[name] = per
    for wid in range(FLEET_WORKERS):
        got = kernels["socket"].get(wid, {})
        check(got.get("router_xattn", 0) > 0 and got.get("pairwise_l2", 0) > 0,
              f"socket: w{wid} launched {got}")
    total = {k: sum(v[k] for v in kernels["socket"].values())
             for k in ("router_xattn", "pairwise_l2")}
    log(f"[socket] launches from the profiler's kernel spans by pid: local {kernels['local']}, "
        f"socket {kernels['socket']}")
    t_build = _first(lines, "device: ")[0]
    t_plane = _first(lines, "socket plane: controller")[0]
    t_followers = max(t_ready.values())
    t_trace = _first(lines, "trace=")[0]
    t_end = _first(lines, "socket plane: w0")[0]
    parts = [("controller build", t_build),
             ("controller set-up to the plane", t_plane - t_build),
             ("waiting for the followers", max(t_followers - t_plane, 0.0)),
             ("trace run and fleet drain", t_trace - max(t_plane, t_followers)),
             ("report", t_end - t_trace), ("save and shutdown", sock["wall"] - t_end)]
    log(f"[socket] walls: local {loc['wall']:.3f} s, socket {sock['wall']:.3f} s "
        f"(child process, start to exit)")
    log("[socket] socket wall by part (line arrival times in this process): " + ", ".join(
        f"{name} {v:.3f}s ({v / sock['wall']:.4f})" for name, v in parts)
        + "; followers ready at " + ", ".join(f"w{w} {t:.3f}s" for w, t in sorted(t_ready.items())))
    t_loc = _first(loc["lines"], "trace=")[0] - _first(loc["lines"], "device: ")[0]
    log(f"[socket] local: build {_first(loc['lines'], 'device: ')[0]:.3f}s, set-up and "
        f"trace run {t_loc:.3f}s")
    return {"launches": total, "by_pid": kernels["socket"], "local_launches": kernels["local"],
            "wall_s": {"local": loc["wall"], "socket": sock["wall"]}, "held_gib": held,
            "alloc_peak_gib": peaks, "reserved_gib": reserved, "smi_run_gib": run_gib}


def bench_defaults() -> tuple:
    """(queries, epochs): the defaults of REPRO_BENCH_QUERIES and
    REPRO_BENCH_EPOCHS in benchmarks/common.py, read from the file (the
    benchmark package imports JAX, which the port's machine lacks)."""
    text = open(os.path.join(ROOT, "benchmarks", "common.py")).read()
    get = lambda name: int(re.search(  # noqa: E731
        rf'os\.environ\.get\("{name}", "(\d+)"\)', text).group(1))
    return get("REPRO_BENCH_QUERIES"), get("REPRO_BENCH_EPOCHS")


def _sweep_metrics(s_hat, c_hat, quality, cost):
    from repro_torch.core import DEFAULT_LAMBDA_GRID, evaluate_sweep, rewards

    choices = np.stack([rewards.route("R2", s_hat, c_hat, lam).numpy()
                        for lam in DEFAULT_LAMBDA_GRID])
    return evaluate_sweep(choices, quality, cost, DEFAULT_LAMBDA_GRID)


def phase_table2(rx, ref) -> dict:
    """Paper Table 2 on pool1: trained routers, baselines and the oracle, each
    with AIQ and perf_max over the lambda grid; the card's attention training
    against the CPU's from the same initial params; the kernel at K = 5."""
    from repro_torch.core import (
        DEFAULT_LAMBDA_GRID, aiq, build_model_embeddings, evaluate_sweep, oracle_sweep,
    )
    from repro_torch.core.baselines import KNNRouter, SVMRouter, llm_blender_eval
    from repro_torch.core.predictors import PREDICTORS
    from repro_torch.core.router import PredictiveRouter
    from repro_torch.data.routerbench import generate
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import RoutedEngine
    from repro_torch.training import QUALITY_TRAIN, train_dual_predictors, train_predictor

    n_queries, epochs = bench_defaults()
    lams = DEFAULT_LAMBDA_GRID
    t0 = time.perf_counter()
    data = generate(n_queries, seed=0).pool("pool1")
    tr, va, te = data.split(seed=0)
    emb, quality, cost = data.emb, data.quality, data.cost
    t_corpus = time.perf_counter() - t0
    t0 = time.perf_counter()
    memb, _ = build_model_embeddings(emb[tr], quality[tr], seed=0, device="cuda")
    t_memb = time.perf_counter() - t0
    log(f"[table2] pool1 {data.model_names}: corpus generate({n_queries}, seed=0) in "
        f"{t_corpus:.2f}s (train {len(tr)}, val {len(va)}, test {len(te)}); model "
        f"embeddings {memb.shape} in {t_memb:.3f}s; {epochs} epochs, {len(lams)} lambdas")

    split = dict(q_emb_val=emb[va], quality_val=quality[va], cost_val=cost[va],
                 epochs=epochs, seed=0, device="cuda")
    init = PREDICTORS["attn"].init(torch.Generator(device="cuda").manual_seed(0), 768, 5, 20)
    rows, routers, hists, walls = {}, {}, {}, {}
    for name, kind, q_init in (("attn", "attn", init), ("mlp", "2fcn", None)):
        t0 = time.perf_counter()
        qp, cp, scaler, hist = train_dual_predictors(
            kind, kind, emb[tr], quality[tr], cost[tr], memb, **split, quality_init=q_init)
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        routers[name] = PredictiveRouter(kind, kind, qp, cp, memb, cost_scaler=scaler)
        hists[name] = hist
        rows[name] = evaluate_sweep(routers[name].sweep(emb[te], lams), quality[te],
                                    cost[te], lams)
    steps = epochs * max(1, len(tr) // QUALITY_TRAIN.batch_size)
    t0 = time.perf_counter()
    rows["knn"] = _sweep_metrics(*KNNRouter(emb[tr], quality[tr], cost[tr], k=20,
                                            device="cuda").predict(emb[te]),
                                 quality[te], cost[te])
    walls["knn"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rows["svm"] = _sweep_metrics(*SVMRouter.fit(emb[tr], quality[tr], cost[tr],
                                                device="cuda").predict(emb[te]),
                                 quality[te], cost[te])
    walls["svm"] = time.perf_counter() - t0
    # LLM-Blender queries every member: one operating point, no lambda sweep,
    # so its AIQ is that point's quality (metrics.aiq of one point).
    perf, per_query = llm_blender_eval(quality[te], cost[te])
    rows["blender"] = {"aiq": aiq(np.array([per_query]), np.array([perf])), "perf_max": perf,
                       "cost_per_query": per_query}
    rows["oracle"] = evaluate_sweep(oracle_sweep(quality[te], cost[te], lams, "R2"),
                                    quality[te], cost[te], lams)
    for name, m in rows.items():
        check(np.isfinite(m["aiq"]) and 0.0 <= m["perf_max"] <= 1.0, f"{name} metrics")
    for name in ("attn", "mlp"):
        h = hists[name]
        log(f"[table2] {name} ({routers[name].quality_kind}/{routers[name].cost_kind}) "
            f"trained on the card in {walls[name]:.3f}s: 2 x {steps} steps "
            f"({walls[name] / (2 * steps) * 1e3:.3f} ms/step, validation included); final "
            f"train loss quality {h['quality']['train_loss'][-1]:.6g} cost "
            f"{h['cost']['train_loss'][-1]:.6g}; best val loss quality "
            f"{min(h['quality']['val_loss']):.6g} cost {min(h['cost']['val_loss']):.6g}")
    log(f"[table2] knn (k=20) {walls['knn']:.3f}s; svm (5 hinge-loss fits of 200 steps) "
        f"{walls['svm']:.3f}s; blender queries every member at ${per_query:.6f} per query")
    for name, m in rows.items():
        log(f"[table2] pool1 {name:8s} AIQ {m['aiq']:.5f}  perf_max {m['perf_max']:.5f}"
            + (f"  (one point at ${per_query:.6f} per query)" if name == "blender" else ""))
    ranked = sorted(("attn", "mlp", "knn", "svm"), key=lambda n: -rows[n]["aiq"])
    log(f"[table2] routers by AIQ: {' > '.join(ranked)}; the attention router "
        f"{'leads' if ranked[0] == 'attn' else 'does not lead'}; oracle "
        f"{rows['oracle']['aiq']:.5f}; blender {perf:.5f} at "
        f"{per_query / rows['oracle']['avg_costs'].max():.1f}x the oracle's priciest "
        f"point's cost")

    # The same attention quality predictor on the CPU from the same params.
    t0 = time.perf_counter()
    qp_cpu, hist_cpu = train_predictor(
        "attn", emb[tr], quality[tr], memb,
        dataclasses.replace(QUALITY_TRAIN, epochs=epochs, seed=0), (emb[va], quality[va]),
        init_params={k: v.cpu() for k, v in init.items()}, device="cpu")
    t_cpu = time.perf_counter() - t0
    card = hists["attn"]["quality"]
    rel = {key: float(np.max(np.abs(np.subtract(card[key], hist_cpu[key]))
                             / np.abs(hist_cpu[key]))) for key in ("train_loss", "val_loss")}
    attn = routers["attn"]
    cpu_router = PredictiveRouter("attn", "attn", qp_cpu,
                                  {k: v.cpu() for k, v in attn.cost_params.items()},
                                  memb, cost_scaler=attn.cost_scaler)
    aiq_cpu = evaluate_sweep(cpu_router.sweep(emb[te], lams), quality[te], cost[te],
                             lams)["aiq"]
    d_aiq = abs(aiq_cpu - rows["attn"]["aiq"])
    check(rel["train_loss"] <= 1e-3 and rel["val_loss"] <= 1e-3,
          f"card vs CPU loss histories, max relative gap {rel}")
    check(d_aiq <= 5e-3, f"card vs CPU attn AIQ {rows['attn']['aiq']:.6f} vs {aiq_cpu:.6f}")
    log(f"[table2] attn quality predictor on the CPU from the same params: {t_cpu:.2f}s for "
        f"{steps} steps ({t_cpu / steps * 1e3:.3f} ms/step); loss histories within "
        f"{rel['train_loss']:.3g} (train) and {rel['val_loss']:.3g} (val) relative of the "
        f"card's (tol 1e-3); AIQ {aiq_cpu:.6f} vs the card's {rows['attn']['aiq']:.6f} "
        f"(|diff| {d_aiq:.3g}, tol 5e-3)")

    # The kernel on the trained params, K = 5, over the 1000 held-out queries.
    held = np.concatenate([va, te])
    engine = RoutedEngine(router=attn, pool=[], device="cuda")
    rx.router_xattn_cuda.launches = 0
    s_kernel, _ = engine.score_emb(emb[held])
    torch.cuda.synchronize()
    launches = rx.router_xattn_cuda.launches
    s_plain, _ = attn.predict(emb[held])
    e = float(np.abs(s_kernel - s_plain).max())
    check(launches == 1, f"table2 scoring launched router_xattn {launches} times")
    check(np.allclose(s_kernel, s_plain, rtol=1e-5, atol=1e-5),
          f"router_xattn K=5 B={len(held)} on trained params, max |err| {e:.3g}")
    qp = attn.quality_params
    kt, vt = ops.pool_projections(qp["wk"], qp["wv"], attn.model_emb_tensor())
    args = (torch.from_numpy(emb[held].astype(np.float32)).cuda(), qp["wq"], kt, vt,
            qp["wo"], qp["bo"])
    b, dq = args[0].shape
    ms = time_ms(lambda: rx.router_xattn_cuda(*args))
    plain_ms = time_ms(lambda: ref.router_xattn_pool_ref(*args))
    _, by_name = profile_device(lambda: rx.router_xattn_cuda(*args), n=50)
    device_ms = sum(v for name, v in by_name.items() if "router_xattn" in name) or None
    plain_device_ms, _ = profile_device(lambda: ref.router_xattn_pool_ref(*args), n=50)
    bound_ms, bound_by = router_xattn_bound(b, 5, 20, dq)
    pl = rx.plan(b, dq, 20, 5)
    log(f"[launch] router_xattn B={b} dq={dq} d=20 K=5: cluster {pl.cluster}, grid {pl.grid} "
        f"blocks of {pl.threads} threads, {pl.smem} bytes shared per block")
    log(f"[table2] router_xattn K=5 B={b} on trained params: max |err| {e:.3g} (tol 1e-5), "
        f"1 launch; kernel {ms:.5f} ms/call (device {device_ms} ms), plain {plain_ms:.5f} "
        f"ms/call (device {plain_device_ms:.5f} ms), bound {bound_ms:.3g} ms ({bound_by})")
    return {"rows": rows, "launches": launches,
            "timing": {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                       "bound_by": bound_by, "device_ms": device_ms,
                       "plain_device_ms": plain_device_ms, "max_abs_err": e,
                       "shape": {"B": b, "K": 5, "d": 20, "dq": dq}}}


# [lm_train]: the LM training path. Smoke configs card vs CPU at (B, S);
# gemma3 smoke once more at the flash length; two published configs through
# train_loop at (B, S) for LM_TRAIN_STEPS steps; the train CLI as a child.
LM_SMOKE_SHAPE = (2, 64)
LM_FLASH_S = 2048
LM_TRAIN_RUNS = (("qwen3-0.6b", False), ("granite-moe-1b-a400m", True))
LM_TRAIN_SHAPE = (8, 1024)
LM_TRAIN_STEPS = 5
LM_CLI_ARCH, LM_CLI_STEPS = "qwen3-0.6b", 20
LM_CLI_TIMEOUT_S = 300


def _smoke_train_cfg(name):
    """A smoke config; MoE at capacity factor 8.0, so no assignment drops."""
    from repro_torch.configs import get_smoke_config

    cfg = get_smoke_config(name)
    return dataclasses.replace(cfg, capacity_factor=8.0) if cfg.n_experts else cfg


def lm_train_card_vs_cpu(name, b, s) -> tuple:
    """``lm_loss`` and its gradient for every param, on the card and on the
    CPU from the same seeded params, corpus batch and stub media: the loss
    within 1e-5 relative, each gradient leaf within 1e-4 of its largest
    magnitude. Returns (loss rel err, worst leaf's err / its scale)."""
    from repro_torch.common.tree import flatten_with_paths, tree_map
    from repro_torch.data.lm_data import MarkovCorpus
    from repro_torch.launch.serve import stub_media
    from repro_torch.models import lm
    from repro_torch.training.optim import value_and_grad

    cfg = _smoke_train_cfg(name)
    gen = torch.Generator().manual_seed(5)
    params_cpu = lm.seed_qkv_biases(lm.init_lm(gen, cfg), cfg)
    media = stub_media(cfg, gen)
    tok, lab = (torch.from_numpy(a) for a in
                next(MarkovCorpus(cfg.vocab_size, seed=0).batches(b, s, seed=1)))
    out = {}
    for dev in ("cpu", "cuda"):
        m = None if media is None else media.expand(b, -1, -1).to(dev)
        loss, grads = value_and_grad(lambda p: lm.lm_loss(
            cfg, p, tok.to(dev), lab.to(dev), media=m), tree_map(lambda t: t.to(dev), params_cpu))
        out[dev] = float(loss), flatten_with_paths(tree_map(lambda t: t.cpu(), grads))
    (l_cpu, g_cpu), (l_gpu, g_gpu) = out["cpu"], out["cuda"]
    loss_err = abs(l_gpu - l_cpu) / abs(l_cpu)
    check(np.isfinite(l_gpu) and loss_err <= 1e-5,
          f"lm_loss {name} B={b} S={s} card {l_gpu} vs CPU {l_cpu}")
    worst = 0.0
    for key, want in g_cpu.items():
        scale = float(want.abs().max())
        err = float((g_gpu[key] - want).abs().max())
        check(bool(torch.isfinite(g_gpu[key]).all()) and err <= 1e-4 * scale,
              f"lm_loss {name} S={s} gradient {key}: card vs CPU max |err| {err:.3g}, "
              f"largest |grad| {scale:.3g}")
        worst = max(worst, err / scale if scale else 0.0)
    log(f"[lm_train] smoke {name} B={b} S={s}: loss {l_gpu:.6f} (rel err {loss_err:.2e}, tol "
        f"1e-5), {len(g_cpu)} gradient leaves, worst max|err| / max|grad| {worst:.2e} "
        f"(tol 1e-4)")
    return loss_err, worst


def _matmul_params(cfg, params) -> float:
    """Parameters a token multiplies by: all but the embedding table (a
    gather), the MoE experts' weights counted at ``top_k / n_experts``."""
    from repro_torch.common.tree import flatten_with_paths

    n = 0.0
    for key, t in flatten_with_paths(params).items():
        if key == "embedding/table":
            continue
        expert = "/ffn/" in key and key.rsplit("/", 1)[-1] in ("w_gate", "w_up", "w_down") \
            and t.dim() == 3
        n += t.numel() * (cfg.top_k / cfg.n_experts if expert else 1.0)
    return n


def lm_train_full(name, var_len) -> dict:
    """A published config through ``train_loop`` on the card: losses, wall,
    the allocator's peak against params + grads + two moments, then the
    loop's own step (``make_train_step``, which updates in place) timed
    alone on the host clock ending in a sync, with the device's busy time
    under torch.profiler and the FLOP bound of the step."""
    from repro_torch.common.tree import flatten_with_paths
    from repro_torch.configs import get_config
    from repro_torch.data.lm_data import MarkovCorpus
    from repro_torch.launch import train
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import lm
    from repro_torch.training.optim import AdamConfig, adam_init, adam_update, value_and_grad

    cfg = get_config(name)
    b, s = LM_TRAIN_SHAPE
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    wall, (params, losses) = _synced(lambda: train.train_loop(
        cfg, steps=LM_TRAIN_STEPS, batch=b, seq=s, seed=0, log_every=1, var_len=var_len,
        device="cuda"))
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    n = sum(t.numel() for t in flatten_with_paths(params).values())
    state_gib = 16 * n / 2**30
    check(all(np.isfinite(losses)), f"{name} losses finite: {losses}")
    check(losses[-1] < losses[0], f"{name} loss fell over {LM_TRAIN_STEPS} steps: {losses}")
    log(f"[lm_train] {name} ({cfg.n_layers} layers, d_model {cfg.d_model}, vocab "
        f"{cfg.vocab_size} padded to {cfg.padded_vocab}; {n / 1e9:.4f}B params) train_loop "
        f"B={b} S={s}{' var_len' if var_len else ''}, {LM_TRAIN_STEPS} steps, seed 0: losses "
        + " ".join(f"{x:.4f}" for x in losses) + f"; {wall:.2f} s wall (params init, the "
        f"host corpus and the first step's set-up included)")
    log(f"[lm_train] {name} allocator peak {peak:.2f} GiB over the loop against params + "
        f"grads + two moments {state_gib:.2f} GiB (16 bytes x {n / 1e9:.4f}B): "
        f"{peak - state_gib:+.2f} GiB of activations and temporaries")

    adam_cfg = AdamConfig(lr=3e-4, b1=0.9, b2=0.95, weight_decay=0.1, t_max=LM_TRAIN_STEPS)
    corpus = MarkovCorpus(cfg.vocab_size, seed=0)
    if var_len:
        tok, lab, mask = next(corpus.padded_batches(b, s, seed=1))
    else:
        (tok, lab), mask = next(corpus.batches(b, s, seed=1)), None
    batch = {"tokens": torch.from_numpy(tok).cuda(), "labels": torch.from_numpy(lab).cuda()}
    if mask is not None:
        batch["attn_mask"] = torch.from_numpy(mask).cuda()
    tokens = int(mask.sum()) if mask is not None else b * s
    box = [params, adam_init(adam_cfg, params)]
    del params
    step = make_train_step(cfg, adam_cfg=adam_cfg)

    def one():
        loss, box[0], box[1] = step(box[0], box[1], batch)
        return float(loss)

    one()
    times = [_synced(one)[0] * 1e3 for _ in range(2)]
    step_ms = float(np.median(times))
    # Two profiled steps of the same work, both printed, the larger kept: a
    # profile that loses device records reads low (a granite-moe step was
    # seen at half of each kernel's time, on the same host time).
    profiles = [profile_device(one) for _ in range(2)]
    busy, by_name = max(profiles, key=lambda pr: pr[0])
    idle = max(0.0, 1 - busy / step_ms)
    n_mm = _matmul_params(cfg, box[0])
    bound6 = 6 * n_mm * tokens / FP32_FLOPS * 1e3
    bound8 = 8 * n_mm * tokens / FP32_FLOPS * 1e3
    log(f"[lm_train] {name} train step alone (in place), B={b} S={s}: {step_ms:.2f} ms host "
        f"wall (median of {len(times)}, after one warm step; each ends in float(loss)); "
        f"profiled: device busy {busy:.2f} ms (the two readings "
        f"{profiles[0][0]:.2f} / {profiles[1][0]:.2f}) -> idle share {idle:.3f}")
    log(f"[lm_train] {name} FLOP bound: 6 x {n_mm / 1e9:.4f}B matmul params x {tokens} tokens "
        f"/ 67 TFLOP/s fp32 = {bound6:.2f} ms ({bound6 / step_ms:.3f} of the step); with "
        f"remat's second forward 8 x = {bound8:.2f} ms ({bound8 / busy:.3f} of busy); "
        f"attention's S^2 terms not counted")
    for kname, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:4]:
        log(f"[lm_train]   {ms:9.3f} ms  {kname[:100]}")
    out = {"losses": losses, "loop_s": wall, "peak_gib": peak, "state_gib": state_gib,
           "params": n, "step_ms": step_ms, "busy_ms": busy, "idle": idle,
           "bound_ms": bound6, "bound_remat_ms": bound8, "tokens": tokens}

    if cfg.n_experts:
        # The MoE aux: its value at the trained params, and its gradient on
        # the first MoE layer's router, so it reaches the params as a gradient.
        layer = next(i for i, spec in enumerate(cfg.layer_plan()) if spec.ffn == "moe")
        router = box[0]["layers"][layer]["ffn"]["router"].detach().requires_grad_(True)
        layers = list(box[0]["layers"])
        layers[layer] = {**layers[layer], "ffn": {**layers[layer]["ffn"], "router": router}}
        with torch.enable_grad():
            logits, aux = lm.apply_lm_train(cfg, {**box[0], "layers": layers},
                                            batch["tokens"], attn_mask=batch.get("attn_mask"))
            del logits
            (g,) = torch.autograd.grad(cfg.router_aux_coef * aux, [router])
        aux, gnorm = float(aux.detach()), float(g.norm())
        check(np.isfinite(aux) and aux > 0 and gnorm > 0,
              f"{name} MoE aux {aux} and its router gradient norm {gnorm}")
        log(f"[lm_train] {name} MoE aux over {sum(sp.ffn == 'moe' for sp in cfg.layer_plan())} "
            f"layers at the trained params: {aux:.6f} (x coef {cfg.router_aux_coef} = "
            f"{cfg.router_aux_coef * aux:.6f} of the loss); |d(coef * aux) / d router| "
            f"of layer {layer} = {gnorm:.3e}")
        out.update(aux=aux, aux_router_grad_norm=gnorm)
        del router, layers, g, aux
    else:
        # The same step's numbers without donation (value_and_grad, then the
        # functional adam_update): old and new params and moments at once.
        params, opt = box
        box.clear()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        loss, grads = value_and_grad(lambda p: lm.lm_loss(
            cfg, p, batch["tokens"], batch["labels"]), params)
        params, opt = adam_update(adam_cfg, grads, opt, params)
        del grads
        float(loss)
        functional_peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        box[:] = [params, opt]
        del params, opt
        torch.cuda.reset_peak_memory_stats()
        one()
        donated_peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        log(f"[lm_train] {name} one step's allocator peak: donated {donated_peak:.2f} GiB, "
            f"functional {functional_peak:.2f} GiB ({(before - base) / 2**30:.2f} GiB held "
            f"before the step)")
        out.update(donated_peak_gib=donated_peak, functional_peak_gib=functional_peak)
    box.clear()
    del batch
    gc.collect()
    torch.cuda.empty_cache()
    return out


def lm_train_cli() -> dict:
    """The train CLI as a child process on the card: its loss falls, and its
    checkpoint loads back with ``load_checkpoint`` into the port."""
    from repro_torch import bridge
    from repro_torch.checkpoint import load_checkpoint
    from repro_torch.configs import get_smoke_config
    from repro_torch.data.lm_data import MarkovCorpus
    from repro_torch.models import lm

    path = os.path.join(ROOT, "build", "lm_train", "cli.npz")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    if os.path.exists(path):
        os.remove(path)
    argv = [sys.executable, "-m", "repro_torch.launch.train", "--arch", LM_CLI_ARCH,
            "--smoke", "--steps", str(LM_CLI_STEPS), "--checkpoint", path]
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"), "PYTHONUNBUFFERED": "1"}
    t0 = time.perf_counter()
    proc = subprocess.run(argv, cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=LM_CLI_TIMEOUT_S)
    wall = time.perf_counter() - t0
    check(proc.returncode == 0, f"train CLI exited {proc.returncode}: {proc.stderr[-2000:]}")
    last = proc.stdout.strip().splitlines()[-2:]
    m = re.match(r"first loss ([\d.]+) -> last loss ([\d.]+)", last[-1])
    check(m is not None, f"train CLI's last line: {last}")
    first, final = float(m.group(1)), float(m.group(2))
    check(final < first, f"train CLI loss {first} -> {final}")
    cfg = get_smoke_config(LM_CLI_ARCH)
    template = bridge.lm_params_to_jax(cfg, lm.init_lm(torch.Generator().manual_seed(1), cfg))
    tree, meta = load_checkpoint(path, template)
    check(meta == {"arch": cfg.name, "steps": LM_CLI_STEPS}, f"checkpoint meta {meta}")
    params = bridge.lm_params_from_jax(cfg, tree, "cuda")
    tok, lab = (torch.from_numpy(a).cuda() for a in
                next(MarkovCorpus(cfg.vocab_size, seed=0).batches(8, 128, seed=1)))
    with torch.no_grad():
        loss = float(lm.lm_loss(cfg, params, tok, lab))
    # The trained params: on the CLI's first batch they beat its first step's loss.
    check(np.isfinite(loss) and loss < first,
          f"loss of the loaded checkpoint on the CLI's first batch {loss} (first step {first})")
    log(f"[lm_train] CLI `python -m repro_torch.launch.train --arch {LM_CLI_ARCH} --smoke "
        f"--steps {LM_CLI_STEPS} --checkpoint build/lm_train/cli.npz`: exit 0 in {wall:.2f} s, "
        f"loss {first:.4f} -> {final:.4f}; the checkpoint ({os.path.getsize(path)} bytes) "
        f"loads with load_checkpoint; its loss on the CLI's first batch {loss:.4f}")
    return {"wall_s": wall, "first_loss": first, "last_loss": final, "loaded_loss": loss}


def phase_lm_train(rx, pl2) -> dict:
    """The LM training path on the card; no kernel of the port is on it, so
    both launch counts must stay 0."""
    from repro_torch.configs import ARCH_IDS

    rx.router_xattn_cuda.launches = 0
    pl2.pairwise_l2_cuda.launches = 0
    b, s = LM_SMOKE_SHAPE
    smoke = {name: lm_train_card_vs_cpu(name, b, s) for name in ARCH_IDS}
    smoke["gemma3-27b@2048"] = lm_train_card_vs_cpu("gemma3-27b", 1, LM_FLASH_S)
    full = {}
    for name, var_len in LM_TRAIN_RUNS:
        t0 = time.perf_counter()
        full[name] = lm_train_full(name, var_len)
        log(f"[lm_train] {name} done in {time.perf_counter() - t0:.2f}s; "
            f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB still allocated")
    cli = lm_train_cli()
    launches = {"router_xattn": rx.router_xattn_cuda.launches,
                "pairwise_l2": pl2.pairwise_l2_cuda.launches}
    check(launches == {"router_xattn": 0, "pairwise_l2": 0},
          f"the LM training path launched a kernel of the port: {launches}")
    log(f"[lm_train] launches on the path: {launches} (no kernel of the port is on it)")
    return {"smoke": smoke, "full": full, "cli": cli, "launches": launches}


# [mesh]: the LM steps on a 1x1 NCCL mesh (DTensor params, moments, batch),
# qwen3-0.6b at published size against mesh=None, one granite-moe var_len
# step; the dry-run's counts against the real step's; one production cell.
MESH_ARCH, MESH_MOE = "qwen3-0.6b", "granite-moe-1b-a400m"
MESH_STEPS = 3
# [lm_train]'s qwen3-0.6b step (ms, host clock) and allocator peak (GiB)
# on an H100 80GB HBM3 at 700 W, as PERF.md section 5 records them.
LM_TRAIN_QWEN3 = (1345.86, 19.28)
MESH_DRYRUN_TIMEOUT_S = 400
MESH_DIR = os.path.join(ROOT, "build", "mesh")


def _mesh_steps(cfg, mesh, batches, count_flops=False) -> dict:
    """Train steps from seed-0 params over ``batches`` on ``mesh`` (None:
    the plain step): losses, each step's ms on the host clock ending in a
    sync, the first step's ``FlopCounterMode`` count, one more step under
    torch.profiler for the busy time, and the allocator's peak."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch import sharding
    from repro_torch.launch.steps import TRAIN_ADAM, make_train_step
    from repro_torch.models import lm
    from repro_torch.training.optim import adam_init

    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    params = lm.init_lm(torch.Generator("cuda").manual_seed(0), cfg)
    if mesh is not None:
        params = sharding.distribute_params(cfg, mesh, params)
    box = [params, adam_init(TRAIN_ADAM, params)]
    del params
    step = make_train_step(cfg, mesh)
    place = (lambda b: b) if mesh is None else (lambda b: sharding.distribute_batch(mesh, b))

    def one(b):
        loss, box[0], box[1] = step(box[0], box[1], place(b))
        return float(loss)

    losses, ms, flops = [], [], None
    for i, b in enumerate(batches):
        if i == 0 and count_flops:
            with FlopCounterMode(display=False) as counter:
                secs, loss = _synced(lambda: one(b))
            flops = counter.get_total_flops()
        else:
            secs, loss = _synced(lambda: one(b))
        losses.append(loss)
        ms.append(secs * 1e3)
    busy, _ = profile_device(lambda: one(batches[-1]))
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    n_mm = _matmul_params(cfg, box[0])
    box.clear()
    gc.collect()
    torch.cuda.empty_cache()
    warm = float(np.mean(ms[1:])) if len(ms) > 1 else ms[0]
    return {"losses": losses, "ms": ms, "warm_ms": warm, "busy_ms": busy,
            "idle": max(0.0, 1 - busy / warm), "peak_gib": peak, "flops": flops,
            "matmul_params": n_mm}


def _dryrun_child(*args) -> dict:
    """``python -m repro_torch.launch.dryrun`` as a child process that sees
    no card (a host tool): its record."""
    argv = [sys.executable, "-m", "repro_torch.launch.dryrun", "--out-dir", MESH_DIR, *args]
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"), "CUDA_VISIBLE_DEVICES": "",
           "OMP_NUM_THREADS": "2"}
    t0 = time.perf_counter()
    proc = subprocess.run(argv, cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=MESH_DRYRUN_TIMEOUT_S)
    wall = time.perf_counter() - t0
    check(proc.returncode == 0, f"dry-run {args} exited {proc.returncode}: {proc.stderr[-2000:]}")
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("[dryrun]")][-1]
    tag = line.split()[1].rstrip(":")
    with open(os.path.join(MESH_DIR, tag + ".json")) as fh:
        rec = json.load(fh)
    check(rec["status"] == "ok", f"dry-run {tag}: {rec}")
    log(f"[mesh] dry-run child ({wall:.2f} s wall): {line}")
    return {**rec, "wall_s": wall}


def phase_mesh(rx, pl2) -> dict:
    """The LM steps on a 1x1 NCCL mesh against the plain steps, and the
    dry-run's per-device accounting; no kernel of the port is on the path."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.data.lm_data import MarkovCorpus
    from repro_torch.launch.mesh import make_debug_mesh

    rx.router_xattn_cuda.launches = 0
    pl2.pairwise_l2_cuda.launches = 0
    b, s = LM_TRAIN_SHAPE
    mesh = make_debug_mesh(1, 1)
    check(dist.get_backend() == "nccl" and dist.get_world_size() == 1,
          f"mesh process group {dist.get_backend()} of {dist.get_world_size()}")
    log(f"[mesh] {mesh} over {dist.get_backend()} (world size {dist.get_world_size()})")
    try:
        cfg = get_config(MESH_ARCH)
        corpus = MarkovCorpus(cfg.vocab_size, seed=0).batches(b, s, seed=1)
        batches = [{k: torch.from_numpy(a).cuda() for k, a in zip(("tokens", "labels"),
                                                                   next(corpus))}
                   for _ in range(MESH_STEPS)]
        plain = _mesh_steps(cfg, None, batches, count_flops=True)
        meshed = _mesh_steps(cfg, mesh, batches, count_flops=True)
        for tag, run in (("mesh=None", plain), ("1x1 mesh", meshed)):
            log(f"[mesh] {MESH_ARCH} B={b} S={s} {tag}: losses "
                + " ".join(f"{x:.6f}" for x in run["losses"]) + "; step ms "
                + " / ".join(f"{x:.2f}" for x in run["ms"])
                + f" (the first under FlopCounterMode: {run['flops']:.4e} FLOPs); warm "
                f"{run['warm_ms']:.2f} ms, device busy {run['busy_ms']:.2f} ms -> idle share "
                f"{run['idle']:.3f}; allocator peak {run['peak_gib']:.2f} GiB "
                f"([lm_train]: {LM_TRAIN_QWEN3[0]} ms, {LM_TRAIN_QWEN3[1]} GiB)")
        rel = max(abs(m - p) / abs(p) for m, p in zip(meshed["losses"], plain["losses"]))
        check(rel <= 1e-6, f"{MESH_ARCH} mesh losses {meshed['losses']} vs {plain['losses']}")
        check(meshed["flops"] == plain["flops"],
              f"FlopCounterMode: mesh step {meshed['flops']} vs plain {plain['flops']}")
        overhead = meshed["warm_ms"] - plain["warm_ms"]
        log(f"[mesh] losses within {rel:.2e} relative (tol 1e-6); DTensor's overhead per "
            f"warm step {overhead:+.2f} ms ({overhead / plain['warm_ms']:+.3f} of the plain "
            f"step), busy {meshed['busy_ms'] - plain['busy_ms']:+.2f} ms")

        moe_cfg = get_config(MESH_MOE)
        tok, lab, mask = next(MarkovCorpus(moe_cfg.vocab_size, seed=0).padded_batches(
            b, s, seed=1))
        moe_batch = [{"tokens": torch.from_numpy(tok).cuda(),
                      "labels": torch.from_numpy(lab).cuda(),
                      "attn_mask": torch.from_numpy(mask).cuda()}]
        moe_plain = _mesh_steps(moe_cfg, None, moe_batch)
        moe_mesh = _mesh_steps(moe_cfg, mesh, moe_batch)
        moe_rel = abs(moe_mesh["losses"][0] - moe_plain["losses"][0]) / moe_plain["losses"][0]
        check(moe_rel <= 1e-5, f"{MESH_MOE} var_len mesh loss {moe_mesh['losses']} vs "
              f"{moe_plain['losses']}")
        log(f"[mesh] {MESH_MOE} var_len B={b} S={s} ({int(mask.sum())} real tokens), one "
            f"step: loss {moe_mesh['losses'][0]:.6f} on the mesh (one-hot einsum dispatch) vs "
            f"{moe_plain['losses'][0]:.6f} plain (index dispatch), rel {moe_rel:.2e} (tol "
            f"1e-5); {moe_mesh['ms'][0]:.2f} vs {moe_plain['ms'][0]:.2f} ms (first step); "
            f"allocator peak {moe_mesh['peak_gib']:.2f} vs {moe_plain['peak_gib']:.2f} GiB")
    finally:
        dist.destroy_process_group()
    check(not dist.is_initialized(), "the mesh's process group is destroyed")

    # The two host-side children at once: neither touches the card.
    with ThreadPoolExecutor(2) as pool:
        jobs = [pool.submit(_dryrun_child, "--mesh", "1x1", "--arch", MESH_ARCH, "--shape",
                            "train_4k", "--batch", str(b), "--seq", str(s)),
                pool.submit(_dryrun_child, "--arch", MESH_ARCH, "--shape", "train_4k")]
        one, prod = [job.result() for job in jobs]
    bound = 6 * meshed["matmul_params"] * b * s
    check(abs(one["flops"] - meshed["flops"]) <= 1e-2 * meshed["flops"],
          f"dry-run 1x1 FLOPs {one['flops']} vs the real step's {meshed['flops']}")
    peak_ratio = one["peak_bytes_per_device"] / 2**30 / meshed["peak_gib"]
    log(f"[mesh] dry-run 1x1 at B={b} S={s}: {one['flops']:.4e} FLOPs, the real step's "
        f"FlopCounterMode {meshed['flops']:.4e} (ratio {one['flops'] / meshed['flops']:.6f}), "
        f"6·N·T {bound:.4e} ({one['flops'] / bound:.3f} of it); peak "
        f"{one['peak_bytes_per_device'] / 2**30:.2f} GiB per device against the allocator's "
        f"{meshed['peak_gib']:.2f} GiB (ratio {peak_ratio:.3f}); traced in {one['compile_s']} s")
    log(f"[mesh] production cell {MESH_ARCH} train_4k on {prod['mesh']} ({prod['chips']} "
        f"chips, B 256, S 4096, full depth): {prod['flops']:.4e} FLOPs, peak "
        f"{prod['peak_bytes_per_device'] / 2**30:.2f} GiB, collectives "
        f"{prod['collective_bytes_per_device']:.4e} B in {prod['n_collectives']} ("
        + ", ".join(f"{k} {v:.4e}" for k, v in sorted(prod["collective_breakdown"].items()))
        + f") per device and step; traced in {prod['compile_s']} s")
    launches = {"router_xattn": rx.router_xattn_cuda.launches,
                "pairwise_l2": pl2.pairwise_l2_cuda.launches}
    check(launches == {"router_xattn": 0, "pairwise_l2": 0},
          f"the mesh path launched a kernel of the port: {launches}")
    log(f"[mesh] launches on the path: {launches} (no kernel of the port is on it)")
    return {"plain": plain, "mesh": meshed, "loss_rel": rel, "overhead_ms": overhead,
            "moe": {"plain": moe_plain, "mesh": moe_mesh, "loss_rel": moe_rel},
            "dryrun_1x1": one, "production": prod, "launches": launches}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on an NVIDIA GPU",
              file=sys.stderr)
        return 2
    from repro_torch.kernels import pairwise_l2 as pl2
    from repro_torch.kernels import ref
    from repro_torch.kernels import router_xattn as rx

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    log(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[device] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
        f"torch {torch.__version__} CUDA {torch.version.cuda}; TF32 off for matmul and cuDNN")
    t_start = time.perf_counter()
    phase_build([rx, pl2])

    t0 = time.perf_counter()
    err = phase_kernel(rx, ref)
    timing = time_kernel(rx, ref, b=N_REQUESTS, k=len(POOL))
    timing_256 = time_kernel(rx, ref, b=256, k=len(POOL))
    log(f"[kernel] phase wall {time.perf_counter() - t0:.2f}s")

    t0 = time.perf_counter()
    pl2_err = phase_pairwise(pl2, ref)
    pl2_timing = [time_pairwise(pl2, ref, label, shape) for label, shape in PL2_PATH_SHAPES]
    log(f"[pairwise_l2] phase wall {time.perf_counter() - t0:.2f}s")

    t0 = time.perf_counter()
    engine, train = phase_train(rx)
    log(f"[train] phase wall {time.perf_counter() - t0:.2f}s")

    t0 = time.perf_counter()
    engine, texts, prompts, serve_launches = phase_serve(engine, rx, pl2)
    log(f"[serve] phase wall {time.perf_counter() - t0:.2f}s")

    t0 = time.perf_counter()
    phase_breakdown(engine, texts, prompts)
    log(f"[breakdown] phase wall {time.perf_counter() - t0:.2f}s")

    t0 = time.perf_counter()
    phase_reference(engine, texts)
    log(f"[reference] phase wall {time.perf_counter() - t0:.2f}s")

    t0 = time.perf_counter()
    moe_run = phase_moe(engine, rx, pl2)
    log(f"[moe] phase wall {time.perf_counter() - t0:.2f}s")

    t0 = time.perf_counter()
    trace = phase_trace(engine, rx, pl2)
    log(f"[trace] phase wall {time.perf_counter() - t0:.2f}s")

    t0 = time.perf_counter()
    lookup = phase_lookup(trace["radius"], pl2)
    log(f"[lookup] phase wall {time.perf_counter() - t0:.2f}s")

    t0 = time.perf_counter()
    online = phase_online(engine, rx, pl2)
    log(f"[online] phase wall {time.perf_counter() - t0:.2f}s")

    data = online.pop("data")
    t0 = time.perf_counter()
    cascade = phase_cascade(engine, data, rx, pl2)
    log(f"[cascade] phase wall {time.perf_counter() - t0:.2f}s")

    t0 = time.perf_counter()
    obs_run = phase_obs(engine, data, rx, pl2, (timing, timing_256), pl2_timing)
    log(f"[obs] phase wall {time.perf_counter() - t0:.2f}s")

    t0 = time.perf_counter()
    fleet = phase_fleet(engine, data, rx, pl2)
    log(f"[fleet] phase wall {time.perf_counter() - t0:.2f}s")

    del engine
    gc.collect()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated() / 2**30
    check(left < 1.0, f"{left:.2f} GiB still allocated after the default pool was freed")
    log(f"[socket] default pool freed: {left:.2f} GiB allocated")
    t0 = time.perf_counter()
    socket_run = phase_socket(rx, pl2)
    log(f"[socket] phase wall {time.perf_counter() - t0:.2f}s")

    t0 = time.perf_counter()
    attn_long = phase_attn_long(rx, pl2)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[attn_long] phase wall {time.perf_counter() - t0:.2f}s")

    left = torch.cuda.memory_allocated() / 2**30
    check(left < 1.0, f"{left:.2f} GiB still allocated after the attention pool was freed")
    log(f"[recurrent] attention pool freed: {left:.2f} GiB allocated")
    t0 = time.perf_counter()
    recurrent = phase_recurrent(rx, pl2)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[recurrent] phase wall {time.perf_counter() - t0:.2f}s")

    left = torch.cuda.memory_allocated() / 2**30
    check(left < 1.0, f"{left:.2f} GiB still allocated after the recurrent pool was freed")
    log(f"[multimodal] recurrent pool freed: {left:.2f} GiB allocated")
    t0 = time.perf_counter()
    multimodal = phase_multimodal(rx, pl2)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[multimodal] phase wall {time.perf_counter() - t0:.2f}s")

    t0 = time.perf_counter()
    table2 = phase_table2(rx, ref)
    log(f"[table2] phase wall {time.perf_counter() - t0:.2f}s")

    gc.collect()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated() / 2**30
    check(left < 1.0, f"{left:.2f} GiB still allocated before the LM training phase")
    t0 = time.perf_counter()
    lm_train = phase_lm_train(rx, pl2)
    log(f"[lm_train] phase wall {time.perf_counter() - t0:.2f}s")

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    mesh_run = phase_mesh(rx, pl2)
    log(f"[mesh] phase wall {time.perf_counter() - t0:.2f}s")
    log(f"[device] all phases {time.perf_counter() - t_start:.2f}s")

    log(smi)
    window = pl2_timing[0]
    log(json.dumps({"kernels": [{
        "name": "router_xattn", "route": "cuda",
        "source": "src/repro_torch/csrc/router_xattn.cu",
        "replaces": "src/repro/kernels/router_xattn.py:34",
        "launches": serve_launches["router_xattn"],
        "launches_by_path": {"serve": serve_launches["router_xattn"],
                             "moe": moe_run["launches"]["router_xattn"],
                             "trace": trace["launches"]["router_xattn"],
                             "online": online["launches"]["router_xattn"],
                             "cascade": cascade["launches"]["router_xattn"],
                             "obs": obs_run["launches"]["router_xattn"],
                             "fleet": fleet["launches"]["router_xattn"],
                             "socket": socket_run["launches"]["router_xattn"],
                             "train": train["launches"], "table2": table2["launches"],
                             "attn_long": attn_long["launches"]["router_xattn"],
                             "recurrent": recurrent["launches"]["router_xattn"],
                             "multimodal": multimodal["launches"]["router_xattn"],
                             "lm_train": lm_train["launches"]["router_xattn"],
                             "mesh": mesh_run["launches"]["router_xattn"]},
        "max_abs_err_trained": {"train": train["max_abs_err"],
                                "table2": table2["timing"]["max_abs_err"],
                                "online_after_swap": online["max_abs_err_after_swap"],
                                "online_K_4": online["max_abs_err_k4"],
                                "fleet_after_broadcast": fleet["max_abs_err"]},
        "max_abs_err": err["float32"], "max_abs_err_bf16": err["bfloat16"],
        "shape": {"B": N_REQUESTS, "K": len(POOL), "d": 20, "dq": 768},
        **timing, "library_ms": None, "at_B_256": timing_256,
        "at_K_5_B_1000_trained": table2["timing"],
    }, {
        "name": "pairwise_l2", "route": "cuda",
        "source": "src/repro_torch/csrc/pairwise_l2.cu",
        "replaces": "src/repro/kernels/pairwise_l2.py:19",
        "launches": trace["launches"]["pairwise_l2"],
        "launches_by_path": {"serve": serve_launches["pairwise_l2"],
                             "moe": moe_run["launches"]["pairwise_l2"],
                             "trace": trace["launches"]["pairwise_l2"],
                             "lookup": lookup["launches"],
                             "online": online["launches"]["pairwise_l2"],
                             "cascade": cascade["launches"]["pairwise_l2"],
                             "obs": obs_run["launches"]["pairwise_l2"],
                             "fleet": fleet["launches"]["pairwise_l2"],
                             "socket": socket_run["launches"]["pairwise_l2"],
                             "attn_long": attn_long["launches"]["pairwise_l2"],
                             "recurrent": recurrent["launches"]["pairwise_l2"],
                             "multimodal": multimodal["launches"]["pairwise_l2"],
                             "lm_train": lm_train["launches"]["pairwise_l2"],
                             "mesh": mesh_run["launches"]["pairwise_l2"]},
        "max_abs_err": pl2_err["float32"], "max_abs_err_bf16": pl2_err["bfloat16"],
        **window,
        "library_call": "torch.cdist(x, c).square(), a yardstick: cdist takes a "
                        "square root, so it is not one call of the same function",
        "by_call_site": pl2_timing,
    }]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
