"""Smoke run of the PyTorch port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

Phases, each a hard failure (nonzero exit, no result line):

1. the card (nvidia-smi name and power limit), torch/CUDA versions, and the
   build of every kernel of ``src/repro_torch/kernels`` (flash attention,
   decode attention, SSD chunk scan; one nvcc per source, in parallel),
   with every kernel's registers and spills (the wgmma kernel, the mma
   decode split and the K3 kernels must not spill);
2. each kernel against its plain PyTorch version on the card, at the
   serving path's shapes, the reference test sweep's and the full widths of
   gemma-2b, gemma2-2b and mamba2-370m, with the tolerance stated per case;
   flash attention's bf16 cases go to its "wgmma" route, decode
   attention's to its "mma" route, f32 to "simt"; the SSD scan also against
   its plain version in f64; and each kernel must refuse an input that
   requires grad under grad mode (they have no backward);
3. kernel, plain version and the PyTorch library call (where one computes
   the same function) timed with CUDA events at those shapes, beside the
   card's bound for the same work, with the achieved TFLOP/s and the share
   of the bound; decode attention also at every piece length it can pick,
   and its split and combine apart (torch.profiler);
4. full-width gemma-2b (random weights from a seed, bf16) served through
   ``Server`` + ``MetronomePolicy`` with the kernel route, with every
   launch counter set to 0 just before and read just after (flash
   attention 18 per prefill, all on the "wgmma" route; decode attention
   and the SSD scan 0 on every route: no model path reaches them, in the
   reference or in the port).

The second-to-last line is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM datasheet peaks (dense): bf16 tensor cores, f32 without them, TF32
# tensor cores, HBM3.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_TF32 = 495e12
PEAK_BYTES_PER_S = 3.35e12
TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5),
       torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}
SERVE_BUCKETS = (128, 512, 1024)
PROMPT_LENS = (40, 100, 200, 400, 600, 900, 1000, 64)
MAX_NEW = 16
# decode attention at full width: gemma-2b with the serving engine (4 slots,
# max_len 2048), a gemma2-2b local layer, and kernels_bench's shape
# (name, B, H, KV, hd, T, dtype, window, softcap, pos, q scale); q is scaled
# where a softcap is set so that the logits (std 32) reach past it
DECODE_SHAPES = (
    ("gemma-2b decode", 4, 8, 1, 256, 2048, torch.bfloat16, 0, 0.0, (2047, 1024, 7, 1948), 1.0),
    ("gemma2-2b local", 4, 8, 4, 256, 8192, torch.bfloat16, 4096, 50.0, (8191, 4096, 7, 8092),
     32.0),
    ("kernels_bench", 4, 8, 2, 64, 8192, torch.float32, 0, 0.0, (8191, 4096, 7, 8092), 1.0),
)
FLUSH_BYTES = 256 << 20      # written between timed launches to empty the 50 MB L2


def log(*args) -> None:
    print(*args, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def time_ms(fn, *args, iters: int = 20, warmup: int = 3, flush=None, **kwargs) -> float:
    """Median of ``iters`` CUDA-event timings of ``fn(*args, **kwargs)``
    after warm-up.  The card spins ~0.5 ms before each timed call (outside
    the events) while the host enqueues it, so the events time the card's
    work, not up to 0.5 ms of host-side dispatch.  With ``flush`` (a large
    tensor), it is zeroed before each timed call, outside the events, so the
    call finds L2 cold."""
    for _ in range(warmup):
        fn(*args, **kwargs)
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        if flush is not None:
            flush.zero_()
        torch.cuda._sleep(1_000_000)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn(*args, **kwargs)
        e1.record()
        pairs.append((e0, e1))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def bound(flops: float, nbytes: float, dtype) -> tuple[float, str]:
    """Least time in ms for ``flops`` at the card's peak for ``dtype`` and
    ``nbytes`` at its memory rate, and which of the two binds."""
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def within(out, ref, *, atol: float, rtol: float) -> tuple[bool, float]:
    """(all finite and |out - ref| <= atol + rtol |ref|, max abs error)."""
    diff = (out.float() - ref.float()).abs()
    ok = bool((diff <= atol + rtol * ref.float().abs()).all()) and bool(torch.isfinite(out).all())
    return ok, float(diff.max())


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
    return (*bound(flops, itemsize * hd * b * s * (2 * h + 2 * kv), dtype), flops)


def phase_card() -> None:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    from repro_torch.kernels import _build
    from repro_torch.kernels.decode_attention import kernel as da_kernel
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
    builds = {"flash_attention.cu": fa_kernel.build, "decode_attention.cu": da_kernel.build,
              "ssd_scan.cu": ssd_kernel.build}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(builds)) as pool:
        for future in [pool.submit(fn) for fn in builds.values()]:
            future.result()
    log(f"phase 1: built {len(builds)} sources in parallel in "
        f"{time.perf_counter() - t0:.2f} s")
    for source in builds:
        info = _build.BUILD_INFO[source]
        regs = [ln.strip() for ln in info["log"].splitlines() if "registers" in ln]
        log(f"  {source}: nvcc {info['seconds']:.2f} s; ptxas: {regs}")
    for source, kernel in (("flash_attention.cu", "flash_fwd_wgmma_bf16"),
                           ("decode_attention.cu", "decode_split_mma_bf16")):
        kernels = ptxas_kernels(_build.BUILD_INFO[source]["log"])
        for name, (regs, spills) in kernels.items():
            log(f"  {name}: {regs} registers, {spills} bytes of spill stores + loads")
        tc = {n: v for n, v in kernels.items() if n.startswith(kernel + "<")}
        if len(tc) != 3 or any(spills for _, spills in tc.values()):
            fail(f"want {kernel} at hd 64, 128 and 256 without spills; ptxas gave {tc}")
    # K3: chunk states and chunk outputs (one per type pair and hd) and the
    # state pass; every one that ptxas lists must be free of spills
    kernels = ptxas_kernels(_build.BUILD_INFO["ssd_scan.cu"]["log"])
    for name, (regs, spills) in kernels.items():
        log(f"  {name}: {regs} registers, {spills} bytes of spill stores + loads")
    names = {n.split("<")[0] for n in kernels}
    if not {"ssd_chunk_state", "ssd_chunk_out", "ssd_state_pass"} <= names or any(
            spills for _, spills in kernels.values()):
        fail(f"want the three K3 kernels, none spilling; ptxas gave {kernels}")


def ptxas_kernels(log_text: str) -> dict[str, tuple[int, int]]:
    """``nvcc -Xptxas -v`` output -> {kernel<[types, ]HD>: (registers, spill
    bytes)} for every kernel of the three sources."""
    out, name, spills = {}, None, 0
    for ln in log_text.splitlines():
        if m := re.search(r"Compiling entry function '.*?(flash_fwd_\w+?|decode_split_mma_bf16|"
                          r"decode_split|decode_combine|ssd_chunk_state|ssd_chunk_out)"
                          r"I((?:f|13__nv_bfloat16|S\d*_)*)((?:Li\d+E)+)", ln):
            # a repeated type is a substitution (S<n>_); only bf16 repeats
            types = ["float" if t == "f" else "bf16"
                     for t in re.findall(r"f|13__nv_bfloat16|S\d*_", m.group(2))]
            ints = re.findall(r"Li(\d+)E", m.group(3))
            name, spills = f"{m.group(1)}<{', '.join([*types, *ints])}>", 0
        elif m := re.search(r"Compiling entry function '.*?(ssd_state_pass)", ln):
            name, spills = m.group(1), 0
        elif name and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)):
            spills = int(m.group(1)) + int(m.group(2))
        elif name and (m := re.search(r"Used (\d+) registers", ln)):
            out[name] = (int(m.group(1)), spills)
            name = None
    return out


def phase_compare() -> dict[str, float]:
    """Kernel vs plain version; returns the max abs error per route at the
    shapes of the ``kernels`` line: gemma-2b prefill in bf16 ("wgmma") and
    in f32 ("simt")."""
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 plain version in full f32
    torch.backends.cudnn.allow_tf32 = False
    log("phase 2: kernel vs plain version (TF32 off for the f32 cases); tolerance: the "
        "reference's, f32 2e-5 and bf16 2e-2 (rounding P to bf16 moves a bf16 output by "
        "about one ulp, ~0.016 at |o| ~ 3; dropping one 64-key tile moves it by ~0.36)")
    gen = torch.Generator("cuda").manual_seed(0)
    # (name, B, S, H, KV, hd, dtype, causal, window, softcap, q scale)
    cases = [("gemma-2b prefill", 1, s, 8, 1, 256, torch.bfloat16, True, 0, 0.0, 1.0)
             for s in (16, *SERVE_BUCKETS)]
    for dtype in (torch.float32, torch.bfloat16):
        for b, s, h, kv, hd in ((1, 128, 4, 4, 64), (2, 256, 8, 2, 64),
                                (1, 192, 4, 1, 128), (1, 64, 2, 2, 256)):
            for causal in (True, False):
                cases.append(("test sweep", b, s, h, kv, hd, dtype, causal, 0, 0.0, 1.0))
        cases.append(("gemma2-2b window+softcap", 1, 1024, 8, 4, 256, dtype, True, 256, 50.0,
                      1.0))
    # bf16 edges of the wgmma kernel: rows past S and T zero-filled by TMA,
    # a window that cuts tiles, logits past the softcap (q scaled by 32, so
    # the logits' std is 32), and the batch stride at gemma-2b widths
    cases += [("ragged S=100", 1, 100, 4, 2, 64, torch.bfloat16, True, 0, 0.0, 1.0),
              ("ragged S=192, window 100", 1, 192, 8, 2, 128, torch.bfloat16, True, 100, 0.0,
               1.0),
              ("gemma2-2b window+softcap, q x32", 1, 1024, 8, 4, 256, torch.bfloat16, True, 256,
               50.0, 32.0),
              ("gemma-2b prefill B=2", 2, 512, 8, 1, 256, torch.bfloat16, True, 0, 0.0, 1.0),
              ("gemma-2b prefill f32", 1, 1024, 8, 1, 256, torch.float32, True, 0, 0.0, 1.0)]
    flash_attention.launches_by_route = {"wgmma": 0, "simt": 0}
    route_err = {"wgmma": 0.0, "simt": 0.0}
    for name, b, s, h, kv, hd, dtype, causal, window, cap, q_scale in cases:
        q, k, v = attn_inputs(gen, b, s, h, kv, hd, dtype)
        q = (q_scale * q.float()).to(dtype)
        out = flash_attention(q, k, v, causal=causal, window=window, softcap=cap)
        torch.cuda.synchronize()
        ref = flash_attention_ref(q, k, v, causal=causal, window=window, softcap=cap)
        tol = TOL[dtype]
        ok, err = within(out, ref, **tol)
        log(f"  {name}: B={b} S=T={s} H={h} KV={kv} hd={hd} {str(dtype)[6:]} "
            f"causal={causal} window={window} softcap={cap} q scale {q_scale}: "
            f"max_abs_err={err:.3e} (max|ref| {float(ref.float().abs().max()):.3e}) "
            f"tol atol={tol['atol']} rtol={tol['rtol']} {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"flash_attention disagrees with its plain version ({name}, S={s})")
        if name.startswith("gemma-2b prefill"):
            route = "wgmma" if dtype == torch.bfloat16 else "simt"
            route_err[route] = max(route_err[route], err)
    want = {"wgmma": sum(c[6] == torch.bfloat16 for c in cases),
            "simt": sum(c[6] == torch.float32 for c in cases)}
    if flash_attention.launches_by_route != want:
        fail(f"flash_attention routes {flash_attention.launches_by_route}, want {want}")
    log(f"  launches by route: {flash_attention.launches_by_route}")
    return route_err


def phase_time() -> dict[str, list[dict]]:
    """K1 rows by route: "wgmma" holds gemma-2b's three prefill buckets and
    a gemma2-2b softcap row, "simt" the f32 row at gemma-2b heads."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref
    log("phase 3: flash attention, median of 20 CUDA-event timings after 3 warm-up calls, "
        "each behind a device-side spin (host dispatch not timed), inputs warm in L2")
    gen = torch.Generator("cuda").manual_seed(1)
    # (name, route, S, H, KV, dtype, window, softcap, q scale); hd 256, causal
    shapes = [(f"gemma-2b prefill S={s}", "wgmma", s, 8, 1, torch.bfloat16, 0, 0.0, 1.0)
              for s in SERVE_BUCKETS]
    shapes += [("gemma2-2b prefill S=1024, local layer (window 4096, softcap 50, q x32)",
                "wgmma", 1024, 8, 4, torch.bfloat16, 4096, 50.0, 32.0),
               ("gemma-2b prefill S=1024 f32", "simt", 1024, 8, 1, torch.float32, 0, 0.0, 1.0)]
    rows = {"wgmma": [], "simt": []}
    for name, route, s, h, kv, dtype, window, cap, q_scale in shapes:
        q, k, v = attn_inputs(gen, 1, s, h, kv, 256, dtype)
        q = (q_scale * q.float()).to(dtype)
        kw = dict(causal=True, window=window, softcap=cap)
        flash_attention.launches_by_route = {"wgmma": 0, "simt": 0}
        ms = time_ms(flash_attention, q, k, v, **kw)
        launches = flash_attention.launches_by_route[route]
        if launches != 23:
            fail(f"{name}: {flash_attention.launches_by_route} for 23 timed calls on {route}")
        plain_ms = time_ms(flash_attention_ref, q, k, v, **kw)
        lib_ms = None
        if not cap:       # no one PyTorch call applies a softcap
            qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
            lib_ms = time_ms(F.scaled_dot_product_attention, qt, kt, vt,
                             is_causal=True, enable_gqa=True)
        bound_ms, bound_by, flops = attn_bound(1, s, h, kv, 256, dtype, causal=True,
                                               window=window)
        rows[route].append({"name": name, "ms": ms, "plain_ms": plain_ms,
                            "library_ms": lib_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                            "launches": launches, "tflops": flops / ms / 1e9,
                            "bound_share": bound_ms / ms})
        lib = "none" if lib_ms is None else f"{lib_ms:.4f} ms"
        ratio = "" if lib_ms is None else f", kernel/sdpa {ms / lib_ms:.2f}"
        log(f"  {name} [{route}]: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa {lib}, "
            f"bound {bound_ms * 1e3:.2f} us ({bound_by}, {str(dtype)[6:]} peak); "
            f"{flops / ms / 1e9:.1f} TFLOP/s, {100 * bound_ms / ms:.1f}% of the bound{ratio}")
    return rows


def decode_inputs(gen, b, h, kv, hd, t, dtype, pos, q_scale=1.0):
    def r(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=gen, device="cuda")).to(dtype)
    pos = torch.tensor(pos, dtype=torch.int32, device="cuda") if pos is not None else \
        torch.randint(0, t, (b,), generator=gen, device="cuda", dtype=torch.int32)
    return r(b, h, hd, scale=q_scale), r(b, t, kv, hd), r(b, t, kv, hd), pos


def decode_tol(dtype, ref) -> dict:
    """f32: the reference's 2e-5.  bf16: 5e-3 of max|ref| (about ten bf16
    ulps of the largest output) and 1e-2 relative (one ulp of rounding the
    output).  An output is a softmax average over up to thousands of rows,
    so it is far below the reference's 2e-2: dropping one 64-position piece
    of a row moves it by more than this tolerance."""
    if dtype == torch.float32:
        return dict(TOL[torch.float32])
    return dict(atol=5e-3 * float(ref.float().abs().max()), rtol=1e-2)


def decode_bound(b, h, kv, hd, dtype, pos, window):
    """Bytes: q and out once, k and v once for each visible position (the
    kernel reads no other row); operations: 4*hd per query head and visible
    position.  ``pos`` and ``window`` are this run's."""
    visible = sum(min(p + 1, window) if window else p + 1 for p in pos)
    itemsize = torch.tensor([], dtype=dtype).element_size()
    nbytes = itemsize * hd * (2 * b * h + 2 * kv * visible) + 4 * b
    return (*bound(4.0 * hd * h * visible, nbytes, dtype), visible)


def phase_compare_decode() -> dict[str, float]:
    """Decode attention against its plain version; returns the max abs error
    per route at the shapes of the ``kernels`` line: gemma-2b decode in bf16
    ("mma") and kernels_bench in f32 ("simt")."""
    from repro_torch.kernels import decode_attention, reference_decode_attention
    from repro_torch.kernels.decode_attention.ops import ROUTES
    log("phase 2: decode attention vs plain version (TF32 off)")
    gen = torch.Generator("cuda").manual_seed(2)
    cases = [("test sweep", b, h, kv, hd, t, dtype, 0, 0.0, None, 1.0)
             for dtype in (torch.float32, torch.bfloat16)
             for b, h, kv, hd, t in ((2, 4, 4, 64, 256), (3, 8, 2, 64, 512),
                                     (1, 4, 1, 128, 256))]
    for dtype in (torch.float32, torch.bfloat16):
        cases += [("ragged pos", 4, 4, 2, 64, 128, dtype, 0, 0.0, (0, 1, 63, 127), 1.0),
                  ("window 16", 2, 4, 4, 64, 128, dtype, 16, 0.0, (100, 127), 1.0)]
    # bf16 edges of the mma split: logits past the softcap, two head chunks
    # of 8, rows past T and past hi zero-filled (T=200), and pieces of 512
    # positions (8 tiles, the first cut by the window) at hd 64 and 128
    cases += [("softcap, q x32", 2, 8, 4, 128, 256, torch.bfloat16, 0, 50.0, None, 32.0),
              ("16 heads a group", 2, 16, 1, 64, 192, torch.bfloat16, 0, 0.0, (191, 70), 1.0),
              ("T=200", 2, 8, 2, 128, 200, torch.bfloat16, 0, 0.0, (199, 130), 1.0),
              ("pieces of 512, window 1000", 8, 16, 8, 64, 4096, torch.bfloat16, 1000, 0.0, None,
               1.0),
              ("pieces of 512", 8, 32, 8, 128, 4096, torch.bfloat16, 0, 0.0, None, 1.0),
              *DECODE_SHAPES,
              ("gemma2-2b local f32", *DECODE_SHAPES[1][1:6], torch.float32,
               *DECODE_SHAPES[1][7:])]
    decode_attention.launches = 0
    decode_attention.launches_by_route = {"mma": 0, "simt": 0}
    route_err = {}
    for name, b, h, kv, hd, t, dtype, window, cap, pos, q_scale in cases:
        q, k, v, p = decode_inputs(gen, b, h, kv, hd, t, dtype, pos, q_scale)
        out = decode_attention(q, k, v, p, window=window, softcap=cap)
        torch.cuda.synchronize()
        ref = reference_decode_attention(q, k, v, p, window=window, softcap=cap)
        tol = decode_tol(dtype, ref)
        ok, err = within(out, ref, **tol)
        log(f"  {name}: B={b} H={h} KV={kv} hd={hd} T={t} {str(dtype)[6:]} window={window} "
            f"softcap={cap} q scale {q_scale} pos={p.tolist() if b <= 4 else '...'}: "
            f"max_abs_err={err:.3e} (max|ref| {float(ref.float().abs().max()):.3e}) "
            f"tol atol={tol['atol']:.3e} rtol={tol['rtol']} {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"decode_attention disagrees with its plain version ({name})")
        if name in (DECODE_SHAPES[0][0], DECODE_SHAPES[2][0]):
            route_err[ROUTES[dtype]] = err
    want = {route: sum(ROUTES[c[6]] == route for c in cases) for route in ROUTES.values()}
    if decode_attention.launches != len(cases) or decode_attention.launches_by_route != want:
        fail(f"decode_attention counted {decode_attention.launches} launches, by route "
             f"{decode_attention.launches_by_route}, for {len(cases)} calls ({want})")
    log(f"  launches by route: {decode_attention.launches_by_route}")
    return route_err


def ssd_inputs(gen, b, length, nh, hd, n, x_dtype, bc_dtype):
    """As tests/test_kernels.py draws them: x normal, dt = softplus(normal),
    a = -exp(0.3 normal), B and C = 0.3 normal."""
    def r(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")
    x = r(b, length, nh, hd).to(x_dtype)
    dt = torch.nn.functional.softplus(r(b, length, nh))
    a = -torch.exp(0.3 * r(nh))
    return x, dt, a, (0.3 * r(b, length, n)).to(bc_dtype), (0.3 * r(b, length, n)).to(bc_dtype)


def ssd_bound(b, length, nh, hd, n, chunk, x_dtype, bc_dtype):
    """The least time for the scan's work, two ways.  Operations: C B^T once
    per (batch row, chunk) over the i >= j pairs, and per (head, chunk) att @
    x over the same pairs, C h_prev^T and the state update; bytes: each input
    read once, y and h_final written once.

    Returns (route bound ms, what binds it, f32 bound ms, what binds it,
    bytes ms, FLOPs, TF32-pass FLOPs).  The f32 bound runs the FLOPs on the
    CUDA cores (67 TFLOP/s).  The route's bound runs them as the kernel does:
    each product once per TF32 pass (3 with two f32 operands, 2 with one
    bf16 operand, which is exact in TF32) at the 495 TFLOP/s TF32 peak, and
    C B^T from bf16 B/C once on the bf16 tensor cores."""
    nc = length // chunk
    pairs = chunk * (chunk + 1) // 2
    cb = b * nc * 2.0 * pairs * n
    att_x = b * nh * nc * 2.0 * pairs * hd
    c_h = state = b * nh * nc * 2.0 * chunk * hd * n
    flops = cb + att_x + c_h + state
    x_bf16, bc_bf16 = x_dtype == torch.bfloat16, bc_dtype == torch.bfloat16
    bc_passes = 2 if bc_bf16 else 3
    tf32_flops = ((0 if bc_bf16 else 3 * cb) + (2 if x_bf16 else 3) * att_x
                  + bc_passes * (c_h + state))
    bf16_flops = cb if bc_bf16 else 0.0
    xs = torch.tensor([], dtype=x_dtype).element_size()
    bs = torch.tensor([], dtype=bc_dtype).element_size()
    nbytes = (2 * xs * b * length * nh * hd + 4 * b * length * nh + 4 * nh
              + 2 * bs * b * length * n + 4 * b * nh * hd * n)
    bytes_ms = 1e3 * nbytes / PEAK_BYTES_PER_S
    route_ops_ms = 1e3 * (tf32_flops / PEAK_TF32 + bf16_flops / PEAK_FLOPS[torch.bfloat16])
    route_ms = max(route_ops_ms, bytes_ms)
    route_by = "operations" if route_ops_ms >= bytes_ms else "bytes"
    f32_ms, f32_by = bound(flops, nbytes, torch.float32)
    return route_ms, route_by, f32_ms, f32_by, bytes_ms, flops, tf32_flops + bf16_flops


def ssd_shapes():
    """mamba2-370m's SSD at B=1 and B=4 (widths from its config) and
    kernels_bench's shape: (name, B, L, nh, hd, N, chunk, x dtype, B/C dtype)."""
    from repro_torch.configs import get_config
    cfg = get_config("mamba2-370m")
    d_in = cfg.ssm_expand * cfg.d_model
    nh, hd = d_in // cfg.ssm_head_dim, cfg.ssm_head_dim
    return tuple((f"mamba2-370m B={b}", b, 2048, nh, hd, cfg.ssm_state, cfg.ssm_chunk,
                  torch.float32, torch.bfloat16) for b in (1, 4)) + (
        ("kernels_bench", 1, 1024, 4, 32, 32, 128, torch.float32, torch.float32),)


def ssd_test_inputs(seed, b, length, nh, hd, n, x_dtype, bc_dtype):
    """tests/test_torch_ssd_scan.py's draw (numpy, ``seed``), moved to the card."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, length, nh, hd)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, length, nh)))).astype(np.float32)
    a = (-np.exp(0.3 * rng.standard_normal(nh))).astype(np.float32)
    bm = (0.3 * rng.standard_normal((b, length, n))).astype(np.float32)
    cm = (0.3 * rng.standard_normal((b, length, n))).astype(np.float32)
    dtypes = (x_dtype, torch.float32, torch.float32, bc_dtype, bc_dtype)
    return tuple(torch.from_numpy(v).cuda().to(d) for v, d in zip((x, dt, a, bm, cm), dtypes))


def phase_compare_ssd() -> float:
    """SSD scan against its plain version (the sequential recurrence in
    f32), every case also against the same recurrence in f64, and each
    case's block layout of ssd_chunk_out (heads a block, paired row tiles)
    against the one it must take; returns the max abs error of y at
    mamba2-370m B=1.  Every case is printed before a disagreement fails the
    phase."""
    from repro_torch.kernels import ssd_scan
    from repro_torch.kernels.ssd_scan.ops import fold_and_scan
    log("phase 2: ssd_scan vs plain version (TF32 off); 'f64' is each side's error against "
        "the plain recurrence run in float64")
    gen = torch.Generator("cuda").manual_seed(3)
    f32, bf16 = torch.float32, torch.bfloat16
    # the last item of a case is the layout it must take on an H100 (114 or
    # 132 SMs): small grids take single tiles of one head, (1, 0)
    cases = [("test sweep", b, length, nh, hd, n, chunk, dtype, f32, (1, 0))
             for dtype in (f32, bf16)
             for b, length, nh, hd, n, chunk in ((1, 64, 2, 16, 16, 16),
                                                 (2, 128, 4, 32, 64, 32),
                                                 (1, 256, 2, 64, 128, 64))]
    # the gpu test's largest case, with its draw: 256-step chunks, whose
    # decays exp(cum_i - cum_j) lose ~1e-4 if taken from one f32 cumsum
    cases += [("gpu test, chunk 256", 1, 512, 2, 64, 128, 256, x_dtype, bc_dtype, (1, 0))
              for x_dtype, bc_dtype in ((f32, f32), (bf16, f32), (f32, bf16))]
    # mamba2-370m's widths (nh 32, hd 64, N 128) at shorter L and smaller
    # chunks reach the other layouts: fewer heads a block, and pairs of 2
    # row tiles (chunk 128) or 1 (chunk 64); nh = 30 rules out 4 heads
    nh, hd, n = ssd_shapes()[0][3:6]
    cases += [("layouts", 1, 512, nh, hd, n, 256, f32, bf16, (1, 1)),
              ("layouts", 1, 1024, nh, hd, n, 256, f32, bf16, (2, 1)),
              ("layouts", 1, 2048, nh, hd, n, 128, f32, bf16, (4, 1)),
              ("layouts", 1, 2048, nh, hd, n, 64, f32, bf16, (4, 1)),
              ("layouts", 1, 2048, 30, hd, n, 256, f32, f32, (2, 1))]
    cases += [(*shape, want) for shape, want in zip(ssd_shapes(), ((4, 1), (4, 1), (1, 0)))]
    ssd_scan.launches = 0
    main_err, failed = 0.0, []
    for name, b, length, nh, hd, n, chunk, x_dtype, bc_dtype, want in cases:
        if name.startswith("gpu test"):
            args = ssd_test_inputs(0, b, length, nh, hd, n, x_dtype, bc_dtype)
        else:
            args = ssd_inputs(gen, b, length, nh, hd, n, x_dtype, bc_dtype)
        before = dict(ssd_scan.launches_by_layout)
        y, h = ssd_scan(*args, chunk=chunk)
        torch.cuda.synchronize()
        layout = [k for k, v in ssd_scan.launches_by_layout.items() if v != before.get(k, 0)]
        yr, hr = fold_and_scan(*args, chunk=chunk)
        y64, h64 = fold_and_scan(*(t.double() for t in args), chunk=chunk)
        if name.startswith(("test sweep", "gpu test")):
            tol_y = tol_h = TOL[x_dtype]
            why = "the reference's test tolerance"
        else:
            # the plain version sums L steps in order, the kernel by chunks:
            # f32 rounding of sums in another order, bounded relative to the
            # output scale
            tol_y = dict(atol=2e-4 * float(yr.abs().max()), rtol=0.0)
            tol_h = dict(atol=2e-4 * float(hr.abs().max()), rtol=0.0)
            why = "2e-4 of max|ref|: summation order over L"
        ok_y, err_y = within(y, yr, **tol_y)
        ok_h, err_h = within(h, hr, **tol_h)
        f64 = {side: (float((yy.double() - y64).abs().max()), float((hh - h64).abs().max()))
               for side, yy, hh in (("kernel", y, h), ("plain", yr, hr))}
        ok = (ok_y and ok_h and y.dtype == x_dtype and h.shape == (b, nh, hd, n)
              and layout == [want])
        log(f"  {name}: B={b} L={length} nh={nh} hd={hd} N={n} chunk={chunk} x "
            f"{str(x_dtype)[6:]} B/C {str(bc_dtype)[6:]}: y max_abs_err={err_y:.3e} "
            f"(max|y| {float(yr.abs().max()):.3e}), h max_abs_err={err_h:.3e} "
            f"(max|h| {float(hr.abs().max()):.3e}); tol y atol={tol_y['atol']:.3e} "
            f"rtol={tol_y['rtol']}, h atol={tol_h['atol']:.3e} ({why}); f64: kernel y "
            f"{f64['kernel'][0]:.3e} h {f64['kernel'][1]:.3e}, plain y {f64['plain'][0]:.3e} "
            f"h {f64['plain'][1]:.3e}; layout (heads a block, paired) {layout}, want "
            f"{want} {'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(f"{name} x {str(x_dtype)[6:]} B/C {str(bc_dtype)[6:]} L={length} "
                          f"nh={nh} chunk={chunk}")
        if name == "mamba2-370m B=1":
            main_err = err_y
    if failed:
        fail(f"ssd_scan disagrees with its plain version ({'; '.join(failed)})")
    if ssd_scan.launches != len(cases):
        fail(f"ssd_scan counted {ssd_scan.launches} launches for {len(cases)} calls")
    return main_err


def phase_grad_guard() -> None:
    """Each kernel on the card with an input that requires grad, under grad
    mode: the kernels have no backward, so each wrapper must raise, and
    launch nothing, rather than return an output autograd cannot see into."""
    from repro_torch.kernels import decode_attention, flash_attention, ssd_scan
    gen = torch.Generator("cuda").manual_seed(6)
    q, k, v = attn_inputs(gen, 1, 128, 4, 2, 64, torch.bfloat16)
    dq, dk, dv, pos = decode_inputs(gen, 2, 8, 2, 64, 128, torch.bfloat16, (127, 40))
    ssd_args = ssd_inputs(gen, 1, 128, 2, 64, 128, torch.float32, torch.bfloat16)
    calls = {"flash_attention": (flash_attention, (q.requires_grad_(True), k, v), {}),
             "decode_attention": (decode_attention, (dq, dk.requires_grad_(True), dv, pos), {}),
             "ssd_scan": (ssd_scan, (ssd_args[0].requires_grad_(True), *ssd_args[1:]),
                          {"chunk": 64})}
    for name, (fn, args, kw) in calls.items():
        before = fn.launches
        try:
            fn(*args, **kw)
        except RuntimeError as err:
            if "no backward" not in str(err) or fn.launches != before:
                fail(f"{name} raised {err!r} (launches {before} -> {fn.launches})")
            log(f"phase 2: {name} under grad mode with an input that requires grad raised: "
                f"{err}")
        else:
            fail(f"{name} returned under grad mode with an input that requires grad")


def phase_time_decode() -> list[dict]:
    """K2 rows, one per ``DECODE_SHAPES`` entry: bf16 on the "mma" route,
    f32 on "simt"."""
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention, reference_decode_attention
    from repro_torch.kernels.decode_attention import kernel as da_kernel
    from repro_torch.kernels.decode_attention.ops import ROUTES
    log("phase 3: decode attention at full width, median of 20 CUDA-event timings after "
        f"3 warm-up calls, each behind a device-side spin (host dispatch not timed); "
        f"'flushed' zeroes a {FLUSH_BYTES >> 20} MB buffer before each timed call "
        "(outside the events), as a decode step finds its layer's cache cold")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator("cuda").manual_seed(4)
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    rows = []
    for name, b, h, kv, hd, t, dtype, window, cap, pos, q_scale in DECODE_SHAPES:
        route = ROUTES[dtype]
        q, k, v, p = decode_inputs(gen, b, h, kv, hd, t, dtype, pos, q_scale)
        decode_attention.launches = 0
        decode_attention.launches_by_route = {"mma": 0, "simt": 0}
        warm = time_ms(decode_attention, q, k, v, p, window=window, softcap=cap)
        ms = time_ms(decode_attention, q, k, v, p, window=window, softcap=cap, flush=flush)
        launches = decode_attention.launches_by_route[route]
        if launches != 46 or decode_attention.launches != 46:
            fail(f"decode_attention counted {decode_attention.launches_by_route} launches "
                 f"for 46 timed calls on {route}")
        plain_ms = time_ms(reference_decode_attention, q, k, v, p, window=window,
                           softcap=cap, flush=flush)
        lib_ms = lib_warm = None
        if not cap:       # no one PyTorch call applies a softcap
            kpos = torch.arange(t, device="cuda")[None, :]
            mask = kpos <= p.long()[:, None]
            if window:
                mask &= kpos > p.long()[:, None] - window
            qt, kt, vt = q[:, :, None], k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
            sdpa_args = (qt, kt, vt)
            sdpa_kw = dict(attn_mask=mask[:, None, None, :], enable_gqa=True)
            lib_warm = time_ms(F.scaled_dot_product_attention, *sdpa_args, **sdpa_kw)
            lib_ms = time_ms(F.scaled_dot_product_attention, *sdpa_args, flush=flush, **sdpa_kw)
        # the piece length the kernel picks, against every length it could pick
        out = torch.empty_like(q)
        pieces = {piece: time_ms(da_kernel.launch_decode_attention, q, k, v, p, out,
                                 window=window, softcap=cap, scale=hd ** -0.5, piece=piece,
                                 flush=flush)
                  for piece in da_kernel.PIECES}
        chosen = da_kernel.piece_len(b, h, kv, t, sms)
        log(f"  {name}: flushed ms by piece length: "
            + ", ".join(f"{n}: {t_ms:.4f}" for n, t_ms in pieces.items())
            + f"; the kernel picks {chosen} ({sms} SMs)")
        bound_ms, bound_by, visible = decode_bound(b, h, kv, hd, dtype, pos, window)
        rows.append({"name": name, "route": route, "ms": ms, "warm_ms": warm,
                     "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "launches": launches,
                     "shape": f"B={b} H={h} KV={kv} hd={hd} T={t} {str(dtype)[6:]} "
                              f"window={window} softcap={cap} pos={list(pos)}"})
        by_name = profile(f"decode_attention {name} (warm)", decode_attention, q, k, v, p,
                          kernel=("decode_attention", "decode_"), window=window, softcap=cap)
        split_ms = sum(t_ms for n, t_ms in by_name.items() if "decode_split" in n)
        combine_ms = sum(t_ms for n, t_ms in by_name.items() if "decode_combine" in n)
        if by_name:
            log(f"  {name} [{route}]: split {split_ms:.4f} ms, combine {combine_ms:.4f} ms "
                "(torch.profiler, one warm call)")
        lib = "none" if lib_ms is None else f"{lib_ms:.4f} ms flushed ({lib_warm:.4f} warm)"
        ratio = "" if lib_ms is None else f", kernel/sdpa {ms / lib_ms:.2f} flushed"
        log(f"  {name} [{route}] ({rows[-1]['shape']}, {visible} visible positions): kernel "
            f"{ms:.4f} ms flushed ({warm:.4f} warm), plain {plain_ms:.4f} ms flushed, "
            f"sdpa {lib}, bound {bound_ms * 1e3:.2f} us ({bound_by}), "
            f"{100 * bound_ms / ms:.1f}% of the bound flushed{ratio}; launches {launches}")
    return rows


def phase_time_ssd() -> list[dict]:
    from repro_torch.kernels import ssd_scan
    from repro_torch.kernels.ssd_scan.ops import fold_and_scan
    log("phase 3: ssd_scan at full width, inputs warm in L2: kernel median of 20 "
        "CUDA-event timings after 3 warm-up calls, each behind a device-side spin (host "
        "dispatch not timed), plain version median of 3 after 1; each launch's time from "
        "torch.profiler over one warm call")
    gen = torch.Generator("cuda").manual_seed(5)
    rows = []
    for name, b, length, nh, hd, n, chunk, x_dtype, bc_dtype in ssd_shapes():
        args = ssd_inputs(gen, b, length, nh, hd, n, x_dtype, bc_dtype)
        ssd_scan.launches = 0
        ms = time_ms(ssd_scan, *args, chunk=chunk)
        launches = ssd_scan.launches
        if launches != 23:
            fail(f"ssd_scan counted {launches} launches for 23 timed calls")
        plain_ms = time_ms(fold_and_scan, *args, chunk=chunk, iters=3, warmup=1)
        by_name = profile(f"ssd_scan {name}", ssd_scan, *args, kernel=("ssd_scan", "ssd_"),
                          chunk=chunk)
        per_launch = {k: sum(t for kn, t in by_name.items() if k in kn)
                      for k in ("ssd_chunk_state", "ssd_state_pass", "ssd_chunk_out")}
        route_ms, route_by, f32_ms, f32_by, bytes_ms, flops, pass_flops = ssd_bound(
            b, length, nh, hd, n, chunk, x_dtype, bc_dtype)
        shape = (f"B={b} L={length} nh={nh} hd={hd} N={n} chunk={chunk} x "
                 f"{str(x_dtype)[6:]} B/C {str(bc_dtype)[6:]}")
        rows.append({"name": name, "ms": ms, "plain_ms": plain_ms, "library_ms": None,
                     "bound_ms": route_ms, "bound_by": route_by, "launches": launches,
                     "per_launch_ms": per_launch, "shape": shape})
        if by_name:
            log(f"  {name}: " + ", ".join(f"{k} {t:.4f} ms" for k, t in per_launch.items())
                + " (torch.profiler, one warm call)")
        log(f"  {name} ({shape}): kernel {ms:.4f} ms, plain {plain_ms:.2f} ms, library none; "
            f"route bound {route_ms * 1e3:.2f} us ({route_by}: {pass_flops / 1e9:.3f} GFLOP of "
            f"TF32 passes and bf16 products, bytes {bytes_ms * 1e3:.2f} us), "
            f"{100 * route_ms / ms:.1f}% of it; f32 CUDA-core bound {f32_ms * 1e3:.2f} us "
            f"({f32_by}) for {flops / 1e9:.3f} GFLOP, {100 * f32_ms / ms:.1f}% of it; "
            f"kernel {flops / ms / 1e9:.2f} TFLOP/s; launches {launches}")
    return rows


def phase_serve() -> dict:
    from repro_torch.configs import get_config
    from repro_torch.core import MetronomeConfig
    from repro_torch.kernels import decode_attention, flash_attention, ssd_scan
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
    flash_attention.launches_by_route = {"wgmma": 0, "simt": 0}
    decode_attention.launches = 0
    decode_attention.launches_by_route = {"mma": 0, "simt": 0}
    ssd_scan.launches = 0
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
    by_route = dict(flash_attention.launches_by_route)
    decode_by_route = dict(decode_attention.launches_by_route)
    other_launches = {"decode_attention": decode_attention.launches,
                      "ssd_scan": ssd_scan.launches}
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
    if by_route != {"wgmma": want, "simt": 0}:
        fail(f"flash_attention routes {by_route}: every bf16 prefill launch must be wgmma")
    if any(other_launches.values()) or any(decode_by_route.values()):
        fail(f"the serving path launched {other_launches} (decode attention by route "
             f"{decode_by_route}); no model path reaches them")
    if engine.prefill_tokens - prefills_before != sum(PROMPT_LENS):
        fail("prefill token count does not match the prompts")
    ttft = statistics.median((r.first_token_ns - r.arrival_ns) / 1e6 for r in reqs)
    tokens = sum(len(r.tokens) for r in reqs)
    log(f"  completed={completed}/{len(reqs)} cpu={stats.cpu_fraction:.3f} "
        f"ttft_ms_median={ttft:.2f} tokens={tokens} wall_s={wall_s:.3f} "
        f"tokens_per_s={tokens / wall_s:.1f} flash_attention_launches={launches} "
        f"(by route {by_route}) "
        f"decode_attention_launches={other_launches['decode_attention']} "
        f"(by route {decode_by_route}) "
        f"ssd_scan_launches={other_launches['ssd_scan']}")
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
    log("  prefill ms per bucket (CUDA events behind the spin, median of 5): "
        + ", ".join(f"{n}: {ms:.2f}" for n, ms in prefill_ms.items())
        + f"; decode ms per step (4 slots, max_len 2048, median of 20): {decode_ms:.2f}")
    with torch.no_grad():
        toks = torch.ones((1, SERVE_BUCKETS[-1]), dtype=torch.long, device="cuda")
        profile(f"prefill S={SERVE_BUCKETS[-1]}", model.prefill, params, {"tokens": toks})
        profile("decode step (4 slots)", model.decode_step, params, dtoks, cache, dpos)
    return {"launches": launches, "by_route": by_route, **other_launches,
            "decode_by_route": decode_by_route}


def profile(name: str, fn, *args, kernel: tuple[str, str] = ("flash_attention", "flash_fwd"),
            **kwargs) -> dict[str, float]:
    """Device busy share of one call of ``fn(*args, **kwargs)``: the sum of
    its CUDA kernels' times (torch.profiler) over its wall time (host clock
    around a synchronised call), the time of the kernels whose names
    contain ``kernel[1]`` (reported as ``kernel[0]``), and the kernels that
    take the most of it.  Returns ms by kernel name (empty where the
    profiler recorded no CUDA kernel)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    fn(*args, **kwargs)
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn(*args, **kwargs)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    if not by_name:
        log(f"  profile {name}: wall {wall_ms:.2f} ms; device time not measured "
            "(the profiler recorded no CUDA kernels)")
        return by_name
    busy = sum(by_name.values())
    focus = sum(ms for n, ms in by_name.items() if kernel[1] in n)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
    log(f"  profile {name}: wall {wall_ms:.2f} ms, device busy {busy:.2f} ms "
        f"({100 * busy / wall_ms:.1f}%), {kernel[0]} {focus:.3f} ms, "
        f"{sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)} kernels; top: "
        + "; ".join(f"{n[:60]} {ms:.4f} ms" for n, ms in top))
    return by_name


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
    route_err = phase_compare()
    decode_err = phase_compare_decode()
    ssd_err = phase_compare_ssd()
    phase_grad_guard()
    rows = phase_time()
    decode_rows = phase_time_decode()
    ssd_rows = phase_time_ssd()
    served = phase_serve()
    # K1 has one kernel per type: bf16 ("wgmma", the serving path; its
    # numbers at the largest prefill bucket, every row beside them) and f32
    # ("simt", on no model path: launches are its timing phase's, the
    # serving run's count, 0, beside them)
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    main_row, f32_row = rows["wgmma"][len(SERVE_BUCKETS) - 1], rows["simt"][0]
    k1 = {"route": "cuda", "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
          "replaces": "src/repro/kernels/flash_attention/kernel.py:81"}
    kernels = [
        {"name": "flash_attention (wgmma, bf16)", **k1, "launches": served["by_route"]["wgmma"],
         "max_abs_err": route_err["wgmma"], **{k: main_row[k] for k in keys},
         "shape": "B=1 S=T=1024 H=8 KV=1 hd=256 bf16 causal",
         "rows": [{k: r[k] for k in ("name", "ms", "plain_ms", "library_ms", "bound_ms",
                                     "bound_by", "tflops", "bound_share")}
                  for r in rows["wgmma"]]},
        {"name": "flash_attention (simt, f32)", **k1, "launches": f32_row["launches"],
         "max_abs_err": route_err["simt"], **{k: f32_row[k] for k in keys},
         "shape": "B=1 S=T=1024 H=8 KV=1 hd=256 f32 causal",
         "serving_launches": served["by_route"]["simt"]},
    ]
    # decode attention and the SSD scan are on no model path: their launches
    # are the timing phase's, at the shape of the row (K2: bf16 "mma" at
    # gemma-2b decode with the serving engine's cache, f32 "simt" at
    # kernels_bench's shape; K3: mamba2-370m at B=1); the serving run's
    # counts (0, checked) go beside them
    # K3's bound is its route's (TF32 passes on the tensor cores); the time
    # of each launch goes beside it, and its other shapes (mamba2-370m B=4,
    # kernels_bench) in "rows"
    da = "decode_attention"
    ssd_keys = ("per_launch_ms",)
    for name, source, replaces, row, err, serving, extra in (
            (f"{da} (mma, bf16)", da, "src/repro/kernels/decode_attention/kernel.py:73",
             decode_rows[0], decode_err["mma"], served["decode_by_route"]["mma"], {}),
            (f"{da} (simt, f32)", da, "src/repro/kernels/decode_attention/kernel.py:73",
             decode_rows[2], decode_err["simt"], served["decode_by_route"]["simt"], {}),
            ("ssd_scan", "ssd_scan", "src/repro/kernels/ssd_scan/kernel.py:78", ssd_rows[0],
             ssd_err, served["ssd_scan"],
             {**{k: ssd_rows[0][k] for k in ssd_keys},
              "rows": [{k: r[k] for k in ("name", "shape", *keys, *ssd_keys)}
                       for r in ssd_rows[1:]]})):
        kernels.append({
            "name": name, "route": "cuda", "source": f"src/repro_torch/kernels/csrc/{source}.cu",
            "replaces": replaces, "launches": row["launches"], "max_abs_err": err,
            **{k: row[k] for k in keys}, "shape": f"{row['name']}: {row['shape']}",
            "serving_launches": serving, **extra})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
