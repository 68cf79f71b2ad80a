#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero before the last line):
  1. device: the card's name and power limit (nvidia-smi); TF32 off.
  2. kernel: build ``router_xattn`` from src/repro_torch/csrc with nvcc, hold
     it against its plain PyTorch version over B x K x d (fp32 within 1e-5,
     bf16 q within 2e-2) and time both at the serving engine's shape.
  3. serve: qwen3-0.6b and granite-3-8b at published width and depth, fp32,
     on the card, behind a seeded router; ``engine.serve`` on 8 seeded
     requests, then ``generate_member`` on each member. The kernel's launch
     count is zeroed just before and read just after; it must be above 0.
  4. reference: engine scores against the plain predictor; a smoke-size
     member's logits and tokens on the card against the same params on the
     CPU; finite full-size logits.
The second-to-last line is a JSON object with the kernel's numbers, the
last ``{"ok": true, "device": {...}}``. The kernel library is built into
build/repro_torch/ under the checkout.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

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


def phase_kernel(rx, ref):
    t0 = time.perf_counter()
    lib, ptxas = rx.build()
    log(f"[kernel] built {os.path.relpath(lib, ROOT)} in {time.perf_counter() - t0:.2f}s")
    for line in ptxas.splitlines():
        if "registers" in line or "spill" in line:
            log(f"[kernel] ptxas: {line.split(':', 1)[-1].strip()}")
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


def phase_serve(rx):
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
    t0 = time.perf_counter()
    res = engine.serve(texts, prompts, max_new=MAX_NEW)
    t_serve = time.perf_counter() - t0
    per_member = []
    for mi, member in enumerate(engine.pool):
        t0 = time.perf_counter()
        outs, costs = engine.generate_member(mi, prompts, max_new=MAX_NEW)
        per_member.append((member, outs, costs, time.perf_counter() - t0))
    launches = rx.router_xattn_cuda.launches

    check(launches > 0, "the serve path launched router_xattn")
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
        f"router_xattn launches {launches}")
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on an NVIDIA GPU",
              file=sys.stderr)
        return 2
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

    t0 = time.perf_counter()
    err = phase_kernel(rx, ref)
    timing = time_kernel(rx, ref, b=N_REQUESTS, k=len(POOL))
    time_kernel(rx, ref, b=256, k=len(POOL))
    log(f"[kernel] phase wall {time.perf_counter() - t0:.2f}s")

    t0 = time.perf_counter()
    engine, texts, prompts, launches = phase_serve(rx)
    log(f"[serve] phase wall {time.perf_counter() - t0:.2f}s")

    t0 = time.perf_counter()
    phase_breakdown(engine, texts, prompts)
    log(f"[breakdown] phase wall {time.perf_counter() - t0:.2f}s")

    t0 = time.perf_counter()
    phase_reference(engine, texts)
    log(f"[reference] phase wall {time.perf_counter() - t0:.2f}s")

    log(smi)
    log(json.dumps({"kernels": [{
        "name": "router_xattn", "route": "cuda",
        "source": "src/repro_torch/csrc/router_xattn.cu",
        "replaces": "src/repro/kernels/router_xattn.py:34",
        "launches": launches, "max_abs_err": err["float32"],
        "max_abs_err_bf16": err["bfloat16"],
        "shape": {"B": N_REQUESTS, "K": len(POOL), "d": 20, "dq": 768},
        **timing, "library_ms": None,
    }]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
