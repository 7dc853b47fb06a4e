"""Smoke run of the PyTorch port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

Phases, each a hard failure (nonzero exit, no result line):

1. the card (nvidia-smi name and power limit), torch/CUDA versions, and the
   build of every kernel of the serving path from ``src/repro_torch``;
2. each kernel against its plain PyTorch version on the card, at the
   serving path's shapes and the reference test sweep's, with the
   tolerance stated per case;
3. kernel, plain version and the PyTorch library call timed with CUDA
   events at the serving shapes, beside the card's bound for the same work;
4. full-width gemma-2b (random weights from a seed, bf16) served through
   ``Server`` + ``MetronomePolicy`` with the kernel route, with every
   launch counter set to 0 just before and read just after.

The second-to-last line is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM datasheet peaks (dense): bf16 tensor cores, f32 without them, HBM3.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES_PER_S = 3.35e12
TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5),
       torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}
SERVE_BUCKETS = (128, 512, 1024)
PROMPT_LENS = (40, 100, 200, 400, 600, 900, 1000, 64)
MAX_NEW = 16


def log(*args) -> None:
    print(*args, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def time_ms(fn, *args, iters: int = 20, warmup: int = 3, **kwargs) -> float:
    """Median of ``iters`` CUDA-event timings of ``fn(*args, **kwargs)``
    after warm-up."""
    for _ in range(warmup):
        fn(*args, **kwargs)
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn(*args, **kwargs)
        e1.record()
        pairs.append((e0, e1))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def attn_inputs(gen, b, s, h, kv, hd, dtype):
    def r(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)
    return r(b, s, h, hd), r(b, s, kv, hd), r(b, s, kv, hd)


def attn_bound(b, s, h, kv, hd, dtype, *, causal, window):
    """Least time for the work these inputs need: each of q, k, v read once
    and the output written once, 4*hd FLOPs per unmasked (q, k) pair."""
    qpos = np.arange(s)[:, None]
    kpos = np.arange(s)[None, :]
    mask = np.ones((s, s), bool)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    flops = 4.0 * b * h * hd * int(mask.sum())
    itemsize = torch.tensor([], dtype=dtype).element_size()
    nbytes = itemsize * hd * b * s * (2 * h + 2 * kv)
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def phase_card() -> None:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    t0 = time.perf_counter()
    fa_kernel.build()
    info = _build.BUILD_INFO["flash_attention.cu"]
    regs = [ln.strip() for ln in info["log"].splitlines() if "registers" in ln]
    log(f"phase 1: built flash_attention.cu in {info['seconds']:.2f} s "
        f"(load {time.perf_counter() - t0:.2f} s); ptxas: {regs}")


def phase_compare() -> float:
    """Kernel vs plain version; returns the max abs error at the serving
    shapes (gemma-2b prefill, bf16)."""
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 plain version in full f32
    torch.backends.cudnn.allow_tf32 = False
    log("phase 2: kernel vs plain version (TF32 off for the f32 cases)")
    gen = torch.Generator("cuda").manual_seed(0)
    cases = [("gemma-2b prefill", 1, s, 8, 1, 256, torch.bfloat16, True, 0, 0.0)
             for s in (16, *SERVE_BUCKETS)]
    for dtype in (torch.float32, torch.bfloat16):
        for b, s, h, kv, hd in ((1, 128, 4, 4, 64), (2, 256, 8, 2, 64),
                                (1, 192, 4, 1, 128), (1, 64, 2, 2, 256)):
            for causal in (True, False):
                cases.append(("test sweep", b, s, h, kv, hd, dtype, causal, 0, 0.0))
        cases.append(("gemma2-2b window+softcap", 1, 1024, 8, 4, 256, dtype, True, 256, 50.0))
    serving_err = 0.0
    for name, b, s, h, kv, hd, dtype, causal, window, cap in cases:
        q, k, v = attn_inputs(gen, b, s, h, kv, hd, dtype)
        out = flash_attention(q, k, v, causal=causal, window=window, softcap=cap)
        torch.cuda.synchronize()
        ref = flash_attention_ref(q, k, v, causal=causal, window=window, softcap=cap)
        diff = (out.float() - ref.float()).abs()
        err = float(diff.max())
        tol = TOL[dtype]
        ok = bool((diff <= tol["atol"] + tol["rtol"] * ref.float().abs()).all())
        if not torch.isfinite(out).all():
            ok = False
        log(f"  {name}: B={b} S=T={s} H={h} KV={kv} hd={hd} {str(dtype)[6:]} "
            f"causal={causal} window={window} softcap={cap}: max_abs_err={err:.3e} "
            f"tol atol={tol['atol']} rtol={tol['rtol']} {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"flash_attention disagrees with its plain version ({name}, S={s})")
        if name == "gemma-2b prefill":
            serving_err = max(serving_err, err)
    return serving_err


def phase_time() -> list[dict]:
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref
    log("phase 3: times at the serving shapes (gemma-2b: H=8 KV=1 hd=256 bf16 causal), "
        "median of 20 CUDA-event timings after 3 warm-up calls, inputs warm in L2")
    gen = torch.Generator("cuda").manual_seed(1)
    rows = []
    for s in SERVE_BUCKETS:
        q, k, v = attn_inputs(gen, 1, s, 8, 1, 256, torch.bfloat16)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        ms = time_ms(flash_attention, q, k, v)
        plain_ms = time_ms(flash_attention_ref, q, k, v)
        lib_ms = time_ms(F.scaled_dot_product_attention, qt, kt, vt,
                         is_causal=True, enable_gqa=True)
        bound_ms, bound_by = attn_bound(1, s, 8, 1, 256, torch.bfloat16,
                                        causal=True, window=0)
        row = {"S": s, "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
               "bound_ms": bound_ms, "bound_by": bound_by}
        log(f"  S=T={s}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"sdpa {lib_ms:.4f} ms, bound {bound_ms * 1e3:.2f} us ({bound_by})")
        rows.append(row)
    return rows


def phase_serve() -> dict:
    from repro_torch.configs import get_config
    from repro_torch.core import MetronomeConfig
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import Model
    from repro_torch.runtime import MetronomePolicy
    from repro_torch.serving import EngineConfig, InferenceEngine, Request, Server

    cfg = get_config("gemma-2b")
    log(f"phase 4: serve {cfg.name} at full width ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads} heads, {cfg.n_kv_heads} KV head, head_dim "
        f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.param_dtype}), "
        "random weights from seed 0, attn=kernel")
    model = Model(cfg, attn="kernel", device="cuda")
    t0 = time.perf_counter()
    params = model.init(torch.Generator("cuda").manual_seed(0))
    torch.cuda.synchronize()
    log(f"  init {time.perf_counter() - t0:.2f} s, "
        f"{sum(x.numel() for x in _leaves(params)) / 1e9:.3f} B parameters")

    # the kernel route against the plain (sdpa) route on the same weights
    plain_model = Model(cfg, attn=None, device="cuda")
    tok_gen = np.random.default_rng(0)
    with torch.no_grad():
        for s in (SERVE_BUCKETS[0], SERVE_BUCKETS[-1]):
            toks = torch.from_numpy(tok_gen.integers(0, cfg.vocab_size, (1, s))).cuda()
            lk, _ = model.prefill(params, {"tokens": toks})
            lp, _ = plain_model.prefill(params, {"tokens": toks})
            if lk.shape != (1, s, cfg.vocab_size) or not torch.isfinite(lk).all():
                fail(f"prefill logits at S={s}: shape {tuple(lk.shape)} or not finite")
            rel = float((lk - lp).abs().max() / lp.abs().max())
            top1 = float((lk.argmax(-1) == lp.argmax(-1)).float().mean())
            log(f"  prefill S={s}: kernel route vs sdpa route max|diff|/max|logit| "
                f"{rel:.3e} (limit 5e-2), top-1 agreement {top1:.4f} (limit 0.9)")
            if rel > 5e-2 or top1 < 0.9:
                fail(f"kernel route disagrees with the sdpa route at S={s}")
    del lk, lp

    engine = InferenceEngine(model, params, EngineConfig(
        max_slots=4, max_len=2048, prefill_buckets=SERVE_BUCKETS))
    for n in SERVE_BUCKETS:                 # warm-up: one request per bucket
        engine.submit([Request(prompt=[1] * (n - 1), max_new_tokens=2)])
    engine.pump()
    torch.cuda.synchronize()

    policy = MetronomePolicy(MetronomeConfig(m=3, v_target_us=2_000.0,
                                             t_long_us=50_000.0))
    server = Server(engine, policy)
    rng = np.random.default_rng(0)
    reqs = [Request(prompt=[int(t) for t in rng.integers(1, cfg.vocab_size, n)],
                    max_new_tokens=MAX_NEW) for n in PROMPT_LENS]
    prefills_before = engine.prefill_tokens
    flash_attention.launches = 0            # counts from the main path only
    server.start()
    t_start = time.perf_counter()
    for r in reqs:
        r.arrival_ns = time.monotonic_ns()
        server.submit(r)
        time.sleep(rng.exponential(1.0 / 20.0))
    done = all(r.wait(120.0) for r in reqs)
    wall_s = time.perf_counter() - t_start
    stats = server.stop()
    launches = flash_attention.launches
    if not done:
        fail("not every request completed within 120 s")
    completed = sum(len(r.tokens) == MAX_NEW for r in reqs)
    if completed != len(reqs):
        fail(f"completed {completed}/{len(reqs)}")
    if not all(0 <= t < cfg.vocab_size for r in reqs for t in r.tokens):
        fail("a generated token lies outside the vocabulary")
    want = cfg.n_layers * len(reqs)
    if launches != want:
        fail(f"flash_attention launched {launches} times, want {want} "
             f"({cfg.n_layers} per prefill x {len(reqs)} prefills)")
    if engine.prefill_tokens - prefills_before != sum(PROMPT_LENS):
        fail("prefill token count does not match the prompts")
    ttft = statistics.median((r.first_token_ns - r.arrival_ns) / 1e6 for r in reqs)
    tokens = sum(len(r.tokens) for r in reqs)
    log(f"  completed={completed}/{len(reqs)} cpu={stats.cpu_fraction:.3f} "
        f"ttft_ms_median={ttft:.2f} tokens={tokens} wall_s={wall_s:.3f} "
        f"tokens_per_s={tokens / wall_s:.1f} flash_attention_launches={launches}")
    ctrl = policy.controller
    log(f"  controller: rho={ctrl.rho:.3f} T_S={ctrl.t_short_us:.0f}us cycles={ctrl.cycles}")

    # per-bucket prefill and per-step decode times, after the counted run
    prefill_ms = {}
    with torch.no_grad():
        for n in SERVE_BUCKETS:
            toks = torch.ones((1, n), dtype=torch.long, device="cuda")
            prefill_ms[n] = time_ms(model.prefill, params, {"tokens": toks},
                                    iters=5, warmup=1)
        cache = model.init_cache(4, 2048)
        dtoks = torch.ones(4, dtype=torch.long, device="cuda")
        dpos = torch.full((4,), 1000, dtype=torch.long, device="cuda")
        decode_ms = time_ms(model.decode_step, params, dtoks, cache, dpos,
                            iters=20, warmup=2)
    log("  prefill ms per bucket (CUDA events, median of 5): "
        + ", ".join(f"{n}: {ms:.2f}" for n, ms in prefill_ms.items())
        + f"; decode ms per step (4 slots, max_len 2048, median of 20): {decode_ms:.2f}")
    with torch.no_grad():
        toks = torch.ones((1, SERVE_BUCKETS[-1]), dtype=torch.long, device="cuda")
        profile(f"prefill S={SERVE_BUCKETS[-1]}", model.prefill, params, {"tokens": toks})
        profile("decode step (4 slots)", model.decode_step, params, dtoks, cache, dpos)
    return {"launches": launches}


def profile(name: str, fn, *args) -> None:
    """Device busy share of one call of ``fn(*args)``: the sum of its CUDA
    kernels' times (torch.profiler) over its wall time (host clock around a
    synchronised call), and the kernels that take the most of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    fn(*args)
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn(*args)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    if not by_name:
        log(f"  profile {name}: wall {wall_ms:.2f} ms; device time not measured "
            "(the profiler recorded no CUDA kernels)")
        return
    busy = sum(by_name.values())
    flash = sum(ms for n, ms in by_name.items() if "flash_fwd" in n)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
    log(f"  profile {name}: wall {wall_ms:.2f} ms, device busy {busy:.2f} ms "
        f"({100 * busy / wall_ms:.1f}%), flash_attention {flash:.3f} ms, "
        f"{sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)} kernels; top: "
        + "; ".join(f"{n[:60]} {ms:.3f} ms" for n, ms in top))


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a "
              "CUDA device", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails here, before any output, outside a checkout)
    phase_card()
    max_err = phase_compare()
    rows = phase_time()
    served = phase_serve()
    main_row = rows[-1]                     # the largest prefill bucket
    kernels = [{
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:81",
        "launches": served["launches"],
        "max_abs_err": max_err,
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "shape": f"B=1 S=T={main_row['S']} H=8 KV=1 hd=256 bf16 causal",
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
