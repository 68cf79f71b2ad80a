#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero before the last line):
  1. device: the card's name and power limit (nvidia-smi); TF32 off.
  2. build: ``router_xattn`` and ``pairwise_l2`` from src/repro_torch/csrc,
     one nvcc for each source, both started together; ptxas's register and
     spill lines.
  3. kernel: hold ``router_xattn`` against its plain PyTorch version over
     B x K x d (fp32 within 1e-5, bf16 q within 2e-2) and time both at the
     serving engine's shape.
  4. pairwise_l2: hold the kernel against its plain version over N x K x d
     (fp32 within 1e-4, bf16 within 5e-2), identical rows exactly 0, and
     time kernel, plain version and the ``torch.cdist`` yardstick at the
     four shapes the cached serving path gives it.
  5. serve: qwen3-0.6b and granite-3-8b at published width and depth, fp32,
     on the card, behind a seeded router; ``engine.serve`` on 8 seeded
     requests, then ``generate_member`` on each member.
  6. breakdown and reference: where a warm serve's time goes; engine scores
     against the plain predictor; a smoke-size member's logits and tokens
     on the card against the CPU; finite full-size logits.
  7. trace: on the same pool, a seeded ``neardup`` trace of 192 requests
     through the streaming scheduler with the semantic cache as rung 0 (a
     calibrated radius, cap 256) and a cache-owned drift detector fitted on
     the training split against the router's k-means centroids.
  8. lookup: a deployment-size cache (cap 4096, at least 512 entries)
     answers 64 queries through the kernel; its hits equal a CPU twin's.
Each path (serve, trace, lookup) runs with every kernel's launch count set
to 0 just before it and read just after; a kernel of the path that was not
launched fails the run. The second-to-last line is a JSON object with the
kernels' numbers, the last ``{"ok": true, "device": {...}}``. The kernel
libraries are built into build/repro_torch/ under the checkout.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

POOL = ["qwen3-0.6b", "granite-3-8b"]
N_REQUESTS = 8
MAX_NEW = 8
# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, fp32 FLOP/s off the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
SWEEP_B, SWEEP_K, SWEEP_D = (1, 37, 64, 256, 1000), (2, 5, 11), (4, 20, 64)
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
            if "registers" in line or "spill" in line:
                log(f"[build] {name} ptxas: {line.split(':', 1)[-1].strip()}")
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
    log(f"[kernel] B={b} K={k} d={d} dq={dq} fp32: kernel {ms:.5f} ms/call "
        f"(device {device_ms} ms), plain {plain_ms:.5f} ms/call "
        f"(device {plain_device_ms:.5f} ms), bound {bound_ms:.3g} ms ({bound_by})")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "device_ms": device_ms, "plain_device_ms": plain_device_ms}


def profile_device(fn, n=1):
    """Device time per call from torch.profiler over ``n`` calls: (busy ms,
    {kernel or copy name: ms}). Busy is the sum over device events; the
    port runs on one stream, so they do not overlap."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    by_name = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            by_name[ev.name] = by_name.get(ev.name, 0.0) + ev.time_range.elapsed_us() / 1e3 / n
    return sum(by_name.values()), by_name


def phase_serve(rx, pl2):
    from repro_torch.common.tree import flatten_with_paths
    from repro_torch.launch.serve import build_engine, synthetic_requests

    t0 = time.perf_counter()
    engine = build_engine(POOL, seed=0, device="cuda")
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    for m in engine.pool:
        n = sum(p.numel() for p in flatten_with_paths(m.params).values())
        log(f"[serve] {m.name}: {m.cfg.n_layers} layers d_model={m.cfg.d_model} "
            f"{n / 1e9:.3f}B params fp32 on {m.device}")
    log(f"[serve] pool + router built in {t_build:.2f}s; "
        f"device memory {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
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


def phase_breakdown(engine, texts, prompts):
    """Where a warm serve's time goes: host clock per layer, then the device's
    busy time and idle share from torch.profiler."""
    from repro_torch.models import lm
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
    tok, mask = pad_prompts(prompts).cuda(), prompt_pad_mask(prompts).cuda()
    b, s = tok.shape
    for member in engine.pool:
        cfg = member.cfg
        with torch.inference_mode():
            caches = lm.init_caches(cfg, b, s + MAX_NEW, "cuda")
            t_pre, (logits, caches) = _synced(
                lambda: lm.apply_lm_prefill(cfg, member.params, tok, caches, mask))
            nxt = torch.argmax(logits[:, -1, :cfg.vocab_size], -1)[:, None]
            steps = [_synced(lambda i=i: lm.apply_lm_decode(cfg, member.params, nxt,
                                                            caches, s + i))[0]
                     for i in range(MAX_NEW - 2)]
            busy, by_name = profile_device(lambda: lm.apply_lm_decode(
                cfg, member.params, nxt, caches, s + MAX_NEW - 2))
        step = float(np.median(steps))
        log(f"[breakdown] {member.name} B={b} S={s}: prefill {t_pre * 1e3:.2f} ms "
            f"({b * s / t_pre:.0f} prompt tokens/s), decode step median "
            f"{step * 1e3:.2f} ms ({b / step:.0f} tokens/s); profiled step: device busy "
            f"{busy:.2f} ms -> idle share {max(0.0, 1 - busy / (step * 1e3)):.3f}")
        for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:3]:
            log(f"[breakdown]   {ms:8.3f} ms  {name[:100]}")
    busy, by_name = profile_device(lambda: engine.serve(texts, prompts, max_new=MAX_NEW))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    log(f"[breakdown] profiled serve: device busy {busy:.2f} ms of a {wall * 1e3:.2f} ms "
        f"unprofiled wall -> idle share {max(0.0, 1 - busy / (wall * 1e3)):.3f}")
    for name, ms in top:
        log(f"[breakdown]   {ms:8.3f} ms  {name[:100]}")


def phase_reference(engine, texts):
    from repro_torch.common.tree import tree_map
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import lm
    from repro_torch.serving.engine import pad_prompts, prompt_pad_mask

    s_kernel, c_kernel = engine.score_texts(texts)
    s_plain, c_plain = engine.router.predict(engine.embed(texts))
    e = float(np.abs(s_kernel - s_plain).max())
    check(np.allclose(s_kernel, s_plain, rtol=1e-5, atol=1e-5),
          f"engine kernel scores vs plain predictor, max |err| {e:.3g}")
    check(np.array_equal(c_kernel, c_plain), "cost path identical on both scoring paths")
    log(f"[reference] engine scores: kernel vs plain predictor max |err| {e:.3g}")

    cfg = get_smoke_config("qwen3-0.6b")
    params_cpu = lm.init_lm(torch.Generator().manual_seed(5), cfg)
    params_gpu = tree_map(lambda t: t.cuda(), params_cpu)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, size=n, dtype=np.int32) for n in (5, 17, 9)]
    tok, mask = pad_prompts(prompts), prompt_pad_mask(prompts)
    with torch.inference_mode():
        lg_cpu, _ = lm.apply_lm_prefill(cfg, params_cpu, tok,
                                        lm.init_caches(cfg, 3, 17, "cpu"), mask)
        lg_gpu, _ = lm.apply_lm_prefill(cfg, params_gpu, tok.cuda(),
                                        lm.init_caches(cfg, 3, 17, "cuda"), mask.cuda())
    e = float((lg_gpu.cpu() - lg_cpu).abs().max())
    check(torch.allclose(lg_gpu.cpu(), lg_cpu, rtol=1e-4, atol=1e-4),
          f"smoke qwen3 prefill logits card vs CPU, max |err| {e:.3g}")
    t_cpu = lm.greedy_generate(cfg, params_cpu, tok, 6, attn_mask=mask)
    t_gpu = lm.greedy_generate(cfg, params_gpu, tok.cuda(), 6, attn_mask=mask.cuda())
    check(torch.equal(t_cpu, t_gpu.cpu()), "smoke qwen3 greedy tokens card vs CPU")
    log(f"[reference] smoke qwen3-0.6b on card vs CPU: logits max |err| {e:.3g} "
        "(tol 1e-4), greedy tokens equal")

    for member in engine.pool:
        p = [np.arange(1, 17, dtype=np.int32), np.arange(3, 11, dtype=np.int32)]
        with torch.inference_mode():
            lg, _ = lm.apply_lm_prefill(member.cfg, member.params, pad_prompts(p).cuda(),
                                        lm.init_caches(member.cfg, 2, 16, "cuda"),
                                        prompt_pad_mask(p).cuda())
        check(tuple(lg.shape) == (2, 1, member.cfg.padded_vocab), f"{member.name} logits shape")
        check(bool(torch.isfinite(lg).all()), f"{member.name} full-size logits finite")
    log("[reference] full-size prefill logits finite, shape (B, 1, padded_vocab), both members")


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
    log(f"[pairwise_l2] {label} N={n} K={k} d={d} fp32: kernel {ms:.5f} ms/call "
        f"(device {device_ms} ms), plain {plain_ms:.5f} ms/call (device "
        f"{plain_device_ms:.5f} ms), bound {bound_ms:.3g} ms ({bound_by}), "
        f"yardstick torch.cdist(x, c).square() {cdist_ms:.5f} ms/call")
    return {"call_site": label, "shape": {"N": n, "K": k, "d": d}, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "device_ms": device_ms, "plain_device_ms": plain_device_ms,
            "library_ms": cdist_ms}


def phase_trace(engine, rx, pl2) -> dict:
    """The cached streaming path at full width: scheduler, semantic cache
    (rung 0), cache-owned drift detector, on the pool ``phase_serve`` built."""
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
        f"router centroids {engine.router.centroids.shape} by k-means in "
        f"{time.perf_counter() - t0:.2f}s")
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
    time_kernel(rx, ref, b=256, k=len(POOL))
    log(f"[kernel] phase wall {time.perf_counter() - t0:.2f}s")

    t0 = time.perf_counter()
    pl2_err = phase_pairwise(pl2, ref)
    pl2_timing = [time_pairwise(pl2, ref, label, shape) for label, shape in PL2_PATH_SHAPES]
    log(f"[pairwise_l2] phase wall {time.perf_counter() - t0:.2f}s")

    t0 = time.perf_counter()
    engine, texts, prompts, serve_launches = phase_serve(rx, pl2)
    log(f"[serve] phase wall {time.perf_counter() - t0:.2f}s")

    t0 = time.perf_counter()
    phase_breakdown(engine, texts, prompts)
    log(f"[breakdown] phase wall {time.perf_counter() - t0:.2f}s")

    t0 = time.perf_counter()
    phase_reference(engine, texts)
    log(f"[reference] phase wall {time.perf_counter() - t0:.2f}s")

    t0 = time.perf_counter()
    trace = phase_trace(engine, rx, pl2)
    log(f"[trace] phase wall {time.perf_counter() - t0:.2f}s")

    t0 = time.perf_counter()
    lookup = phase_lookup(trace["radius"], pl2)
    log(f"[lookup] phase wall {time.perf_counter() - t0:.2f}s")
    log(f"[device] all phases {time.perf_counter() - t_start:.2f}s")

    log(smi)
    window = pl2_timing[0]
    log(json.dumps({"kernels": [{
        "name": "router_xattn", "route": "cuda",
        "source": "src/repro_torch/csrc/router_xattn.cu",
        "replaces": "src/repro/kernels/router_xattn.py:34",
        "launches": serve_launches["router_xattn"],
        "launches_by_path": {"serve": serve_launches["router_xattn"],
                             "trace": trace["launches"]["router_xattn"]},
        "max_abs_err": err["float32"], "max_abs_err_bf16": err["bfloat16"],
        "shape": {"B": N_REQUESTS, "K": len(POOL), "d": 20, "dq": 768},
        **timing, "library_ms": None,
    }, {
        "name": "pairwise_l2", "route": "cuda",
        "source": "src/repro_torch/csrc/pairwise_l2.cu",
        "replaces": "src/repro/kernels/pairwise_l2.py:19",
        "launches": trace["launches"]["pairwise_l2"],
        "launches_by_path": {"serve": serve_launches["pairwise_l2"],
                             "trace": trace["launches"]["pairwise_l2"],
                             "lookup": lookup["launches"]},
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
