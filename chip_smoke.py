"""Smoke run of the PyTorch port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

Phases, each a hard failure (nonzero exit, no result line):

1. the card (nvidia-smi name and power limit), torch/CUDA versions, and the
   build of every kernel of ``src/repro_torch/kernels`` (flash attention,
   decode attention, SSD chunk scan, the sweep; one nvcc per source, in
   parallel), with every kernel's registers and spills (the wgmma kernel,
   the mma decode split, the K3 kernels and the sweep must not spill);
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

Then the fixed-slot sweep S1 (``slot_sweep``, the reference's
``runtime/batched.py`` ``lax.scan``; producer warps and a consumer warp
over a ring of stages in shared memory), built in phase 1 with the others
(its builds, <4, 1> and <4, 4> each with 3 and 6 producer warps, must not
spill; their registers, static shared memory and ring sizes are printed):

- phase 2: the kernel against its plain version at 4,000 slots: 64 points
  (m 1-4 x n_queues 1-4, and one queue a point) with every noise family,
  schedules and windows, the main path's grid (sweep_frontier's 2016
  points, quiet and noisy) cut in duration only, and the edges of the
  kernel's ring (runs of C - 1, C, C + 1 and 4 C + 13 slots, windows and
  schedule edges inside a stage, 1, 5 and 33 points, both builds): every
  output bit-equal, a diverging point reported with its slot;
- phase 3: the kernel timed at sweep_frontier's full grid (quiet and
  noisy), power.py's and adaptation.py's sweeps and the 1296-point test
  grid, beside its bound and the plain version's time over its first 400
  slots; at the quiet frontier grid also the <4, 1> build against <4, 4>;
- band phase: the kernel against the port's event engine inside the
  reference's parity bands (24 quiet and 16 noisy configs at 120 ms);
- main path: ``simulate_batch`` over sweep_frontier's full quiet grid, one
  launch with every counter set to 0 just before, the exact identities at
  every point.

The second-to-last line is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

    python3 chip_smoke.py --sweep-ab SRC [SRC ...]

times this checkout's sweep kernel against other sources with its C
interface (a parent commit's ``csrc/slot_sweep.cu``, a variant) at phase
3's five sweeps, in the order this, SRC1 .. SRCn, SRCn .. SRC1, this, and
reports whether each gives this kernel's bits (``phase_sweep_source_ab``).
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
    from repro_torch.kernels.slot_sweep import kernel as sweep_kernel
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
    builds = {"flash_attention.cu": fa_kernel.build, "decode_attention.cu": da_kernel.build,
              "ssd_scan.cu": ssd_kernel.build, "slot_sweep.cu": sweep_kernel.build}
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
        for name, (regs, spills, _) in kernels.items():
            log(f"  {name}: {regs} registers, {spills} bytes of spill stores + loads")
        tc = {n: v for n, v in kernels.items() if n.startswith(kernel + "<")}
        if len(tc) != 3 or any(spills for _, spills, _ in tc.values()):
            fail(f"want {kernel} at hd 64, 128 and 256 without spills; ptxas gave {tc}")
    # K3: chunk states and chunk outputs (one per type pair and hd) and the
    # state pass; every one that ptxas lists must be free of spills
    kernels = ptxas_kernels(_build.BUILD_INFO["ssd_scan.cu"]["log"])
    for name, (regs, spills, _) in kernels.items():
        log(f"  {name}: {regs} registers, {spills} bytes of spill stores + loads")
    names = {n.split("<")[0] for n in kernels}
    if not {"ssd_chunk_state", "ssd_chunk_out", "ssd_state_pass"} <= names or any(
            spills for _, spills, _ in kernels.values()):
        fail(f"want the three K3 kernels, none spilling; ptxas gave {kernels}")
    # S1: the (M_MAX, Q_MAX) builds <4, 1> and <4, 4>, each with 3 and 6
    # producer warps, built with -fmad=false; none may spill.  Their ring of
    # stages is dynamic shared memory, sized per launch by the fields a
    # sweep's noise needs
    kernels = ptxas_kernels(_build.BUILD_INFO["slot_sweep.cu"]["log"])
    for name, (regs, spills, smem) in kernels.items():
        log(f"  {name}: {regs} registers, {spills} bytes of spill stores + loads, {smem} "
            "bytes of static shared memory")
    want = {f"slot_sweep_kernel<4, {q}, {n}>" for q in (1, 4) for n in (3, 6)}
    if set(kernels) != want or any(spills for _, spills, _ in kernels.values()):
        fail(f"want the 4 slot_sweep_kernel builds (<4, 1> and <4, 4>, each with 3 and 6 "
             f"producer warps), none spilling; ptxas gave {kernels}")
    from repro_torch.runtime.batched import sweep_inputs
    for name, grid, cfg, slot_us in sweep_settings()[:2]:       # quiet; stalls on
        _, params = sweep_inputs(grid, cfg, slot_us, "cpu")
        for q in (1, 4):
            lay = sweep_kernel.layout(params, q)
            log(f"  slot_sweep_kernel<4, {q}> at {name}: {lay}")
            if lay["stage_slots"] != sweep_kernel.STAGE_SLOTS or lay["smem_bytes"] > 232_448:
                fail(f"slot_sweep layout {lay}: want {sweep_kernel.STAGE_SLOTS} slots a "
                     "stage (kernel.STAGE_SLOTS) in at most 227 KB of shared memory")


def ptxas_kernels(log_text: str) -> dict[str, tuple[int, int, int]]:
    """``nvcc -Xptxas -v`` output -> {kernel<[types, ]ints>: (registers, spill
    bytes, static shared memory bytes)} for every kernel of the four
    sources."""
    out, name, spills = {}, None, 0
    for ln in log_text.splitlines():
        if m := re.search(r"Compiling entry function '.*?(flash_fwd_\w+?|decode_split_mma_bf16|"
                          r"decode_split|decode_combine|ssd_chunk_state|ssd_chunk_out|"
                          r"slot_sweep_kernel)"
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
            smem = re.search(r"(\d+) bytes smem", ln)
            out[name] = (int(m.group(1)), spills, int(smem.group(1)) if smem else 0)
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


# -- S1: the fixed-slot sweep (runtime/batched.py's lax.scan) ----------------

MU_MPPS = 29.76
# benchmarks/sweep_frontier.py's noisy-host mode (:54) and
# tests/test_batched_engine.py's interference band (INTERFERENCE_ENV)
FRONTIER_NOISY = dict(interference_prob=0.2, interference_mean_us=15.0,
                      stall_rate_per_us=1.0 / 5_000.0, stall_mean_us=100.0)
BAND_NOISY = dict(interference_prob=0.25, interference_mean_us=20.0,
                  stall_rate_per_us=1.0 / 4000.0, stall_mean_us=150.0)
SWEEP_COUNTERS = ("wakeups", "busy_tries", "cycles", "ts_arms")
SWEEP_RTOL = 1e-5
# instruction rates of one H100 SXM (132 SMs at the 1.98 GHz boost clock of
# the data sheet's 67 TFLOP/s float32, which counts an fma as two): float32
# 128 lanes an SM a clock, int32 64, the special-function units and
# int-to-float converts 16 (the CUDA C programming guide's throughput table
# for compute capability 9.0)
PEAK_F32_OPS = 33.5e12
PEAK_INT32_OPS = PEAK_F32_OPS / 2
PEAK_SFU_OPS = PEAK_F32_OPS / 8
RESIDENT_THREADS = 132 * 2048
# benchmarks/sweep_frontier.py's full grid (:73-84): 2016 points, 50 ms
FRONTIER = dict(t_s_grid=np.linspace(3.0, 80.0, 14),
                t_l_grid=np.asarray([120.0, 250.0, 500.0, 900.0]), m_grid=(2, 3, 4),
                rhos=np.asarray([0.1, 0.25, 0.4, 0.55, 0.7, 0.85]), seeds=(0, 1))
FRONTIER_US = 50_000.0


def frontier_grid():
    from repro_torch.runtime import SweepGrid
    f = FRONTIER
    return SweepGrid.product(t_s_us=f["t_s_grid"], t_l_us=f["t_l_grid"], m=f["m_grid"],
                             rate_mpps=f["rhos"] * MU_MPPS, seeds=f["seeds"])


def sweep_settings():
    """(name, grid, cfg, slot_us): the sweeps phase 3 times, each as the
    repo runs it."""
    from repro_torch.runtime import (
        DEEP_CSTATE_ENERGY_MODEL,
        HR_SLEEP_MODEL,
        MMPPSchedule,
        RampSchedule,
        SimRunConfig,
        SinusoidSchedule,
        StepSchedule,
        SweepGrid,
    )
    out = [("sweep_frontier full, quiet", frontier_grid(),
            SimRunConfig(duration_us=FRONTIER_US), 0.5),
           ("sweep_frontier full, noisy", frontier_grid(),
            SimRunConfig(duration_us=FRONTIER_US, **FRONTIER_NOISY), 0.5)]
    # benchmarks/power.py's objective-divergence grid (:134-140), full mode
    out.append(("power.py energy grid", SweepGrid.product(
        t_s_us=(24.0, 36.0, 48.0, 60.0), t_l_us=(300.0, 600.0), m=(2, 3),
        rate_mpps=np.asarray((0.2, 0.3)) * MU_MPPS, seeds=(0, 1)),
        SimRunConfig(duration_us=60_000.0, sleep_model=HR_SLEEP_MODEL,
                     energy_model=DEEP_CSTATE_ENERGY_MODEL), 0.5))
    # benchmarks/adaptation.py's windowed schedule sweep (:223-229), full mode
    d = 100_000.0
    scheds = [StepSchedule(times_us=(0.0, d * 0.375), scales=(0.3, 1.0)),
              StepSchedule(times_us=(0.0, d * 0.375), scales=(1.0, 0.3)),
              RampSchedule(t_start_us=d * 0.25, t_end_us=d * 0.75, scale_from=0.3,
                           scale_to=1.0),
              SinusoidSchedule(period_us=d / 4.0, amplitude=0.35, mean=0.65),
              MMPPSchedule(states=(0.3, 0.65, 1.0), mean_dwell_us=d / 6.0, seed=11)]
    out.append(("adaptation.py windowed schedule sweep", SweepGrid.product(
        t_s_us=[10.0, 16.0, 24.0], t_l_us=[300.0], m=(2, 3), rate_mpps=[0.75 * MU_MPPS],
        seeds=(0,), schedules=scheds), SimRunConfig(duration_us=d, window_us=1_000.0), 1.0))
    # tests/test_batched_engine.py's thousand-point grid (:160-169)
    out.append(("test_batched_engine 1296-point grid", SweepGrid.product(
        t_s_us=np.linspace(4.0, 40.0, 8), t_l_us=[150.0, 500.0], m=[2, 3, 4],
        rate_mpps=np.linspace(2.0, 25.0, 9), seeds=(0, 1, 2)),
        SimRunConfig(duration_us=10_000.0), 1.0))
    return out


def sweep_compare_grid(one_queue: bool = False):
    """64 points: every (m, n_queues) in 1..4 x 1..4 (one queue throughout
    with ``one_queue``), four each, two of the four sharing a seed, two of
    the four on a load schedule."""
    from repro_torch.runtime import RampSchedule, StepSchedule, SweepGrid
    rng = np.random.default_rng(0)
    pts = []
    for m in (1, 2, 3, 4):
        for q in (1,) * 4 if one_queue else (1, 2, 3, 4):
            for s in range(4):
                p = dict(t_s_us=float(rng.uniform(4.0, 40.0)),
                         t_l_us=float(rng.uniform(100.0, 600.0)), m=m, n_queues=q,
                         rate_mpps=float(rng.uniform(0.1, 0.9) * MU_MPPS * q / 2.0),
                         seed=s // 2)
                if s == 1:
                    p["schedule"] = StepSchedule(times_us=(0.0, 700.0), scales=(0.4, 1.5))
                elif s == 3:
                    p["schedule"] = RampSchedule(t_start_us=300.0, t_end_us=1_500.0,
                                                 scale_from=0.3, scale_to=1.4)
                pts.append(p)
    return SweepGrid.of_points(pts)


def sweep_edge_cases():
    """(name, grid, cfg): the edges of the kernel's ring of stages, as
    tests/test_torch_batched.py's _edge_case makes them: runs of C - 1, C,
    C + 1 and 4 C + 13 slots of 0.5 us (C the kernel's slots a stage; the
    last wraps the three-stage ring and ends inside a stage), windows of 10.5
    slots and schedule edges at fractions of a slot (both inside a stage),
    every noise family on, at 1, 5 and 33 points (partial consumer warps),
    one queue a point (<4, 1>) and up to four (<4, 4>)."""
    from repro_torch.kernels.slot_sweep.kernel import STAGE_SLOTS as C
    from repro_torch.runtime import RampSchedule, SimRunConfig, SleepModel, StepSchedule, SweepGrid
    sleep = SleepModel(base_us=2.8, slope=0.027, sigma_us=0.5, tail_prob=0.2, tail_mean_us=6.0)
    scheds = (StepSchedule(times_us=(0.0, 7.25), scales=(0.4, 1.5)),
              RampSchedule(t_start_us=3.1, t_end_us=41.3, scale_from=0.3, scale_to=1.4), None)
    out = []
    for n_points in (1, 5, 33):
        for live in (C - 1, C, C + 1, 4 * C + 13):
            for one_queue in (True, False):
                rng = np.random.default_rng(n_points)
                pts = []
                for i in range(n_points):
                    q = 1 if one_queue else int(rng.integers(1, 5))
                    p = dict(t_s_us=(t_s := float(rng.uniform(1.5, 8.0))),
                             t_l_us=float(t_s * rng.uniform(2.0, 6.0)),
                             m=int(rng.integers(1, 5)), n_queues=q,
                             rate_mpps=float(rng.uniform(0.2, 0.95) * MU_MPPS * q / 2.0),
                             seed=i // 2)
                    if scheds[i % 3] is not None:
                        p["schedule"] = scheds[i % 3]
                    pts.append(p)
                cfg = SimRunConfig(duration_us=0.5 * live, sleep_model=sleep, window_us=5.25,
                                   queue_capacity=24, interference_prob=0.25,
                                   interference_mean_us=4.0, stall_rate_per_us=1.0 / 40.0,
                                   stall_mean_us=6.0)
                out.append((f"edge: {n_points} points, {live} slots, "
                            f"{'one queue' if one_queue else 'up to four'}",
                            SweepGrid.of_points(pts), cfg))
    return out


def sweep_diff(out, ref) -> tuple[list[int], float, float]:
    """(points whose integer counters differ, max abs difference and max
    difference over max(|ref|, 1), over every float output)."""
    bad = set()
    for name in SWEEP_COUNTERS:
        bad |= set(torch.nonzero(out[name] != ref[name]).flatten().tolist())
    abs_err = rel_err = 0.0
    for name in (*SWEEP_COUNTERS, "offered", "dropped", "serviced", "awake_us", "lat_area",
                 "vac_sum", "nv_sum", "energy_uj", "backlog", "win"):
        if out[name].numel():
            a, b = out[name].double(), ref[name].double()
            abs_err = max(abs_err, float((a - b).abs().max()))
            rel_err = max(rel_err, float(((a - b).abs() / b.abs().clamp(min=1.0)).max()))
    return sorted(bad), abs_err, rel_err


def first_divergence(args, params, i: int) -> int:
    """The first slot after which point ``i``'s outputs differ between the
    kernel and the plain version: both run the point alone on prefixes of
    the run (its draws depend on its seed and the slot alone), and a
    bisection finds the shortest prefix that differs."""
    import dataclasses

    from repro_torch.kernels.slot_sweep import reference_slot_sweep, slot_sweep
    one = [None if a is None else a[i:i + 1].contiguous() for a in args]

    def differs(n: int) -> bool:
        p = dataclasses.replace(params, duration_us=n * params.slot_us)
        out, ref = slot_sweep(*one, params=p), reference_slot_sweep(*one, p)
        return not all(torch.equal(out[k], ref[k]) for k in out)

    lo, hi = 0, params.live_slots()
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if differs(mid):
            hi = mid
        else:
            lo = mid
    return hi - 1


def phase_compare_sweep() -> dict:
    """The sweep kernel against its plain version on the card at short
    shapes: 64 points (m 1-4 x n_queues 1-4, shared seeds, schedules), 4,000
    slots of 0.5 us, every noise family (overshoot noise and tail,
    interference, stall windows) and windows; the same 64 points with one
    queue each (the other build), and quiet over 1,000 slots (the
    kernel's block of three producer warps; the cases with every family
    take six); the main path's own grid,
    sweep_frontier's 2016 points in its quiet and its noisy config, cut in
    duration only (2,000 us: the first 4,000 of the main path's 100,000
    slots, whose draws depend on the seed and the slot alone); and the
    edges of the kernel's ring (``sweep_edge_cases``).  Every output must
    be bit-equal (the same float32 operations in the same order, no fma
    contraction, the same math library on both sides); the largest
    differences are logged beside.  A point that differs is reported with
    the slot where it diverges.  Returns the max abs error and the builds
    compared."""
    from repro_torch.kernels.slot_sweep import reference_slot_sweep, slot_sweep
    from repro_torch.runtime import SimRunConfig, SleepModel
    from repro_torch.runtime.batched import sweep_inputs
    t0 = time.perf_counter()
    every = SleepModel(base_us=2.8, slope=0.027, sigma_us=0.5, tail_prob=0.01,
                       tail_mean_us=40.0)
    every_cfg = SimRunConfig(duration_us=2_000.0, sleep_model=every, queue_capacity=256,
                             window_us=300.0, **dict(BAND_NOISY, stall_rate_per_us=1 / 400.0))
    cut_us = 2_000.0
    cases = [("m 1-4 x n_queues 1-4", sweep_compare_grid(), every_cfg),
             ("m 1-4, one queue a point", sweep_compare_grid(one_queue=True), every_cfg),
             # overshoot noise alone: the block of three producer warps
             ("m 1-4 x n_queues 1-4, quiet, first 1000 slots", sweep_compare_grid(),
              SimRunConfig(duration_us=500.0, window_us=75.0)),
             ("sweep_frontier full grid, quiet, first 4000 slots", frontier_grid(),
              SimRunConfig(duration_us=cut_us)),
             ("sweep_frontier full grid, noisy, first 4000 slots", frontier_grid(),
              SimRunConfig(duration_us=cut_us, **FRONTIER_NOISY)), *sweep_edge_cases()]
    log("phase 2: slot_sweep vs plain version, 4000 slots of 0.5 us: 64 points with every "
        "noise family, schedules, windows; the main path's grid (sweep_frontier, 2016 "
        f"points) cut from {FRONTIER_US:g} to {cut_us:g} us; and the ring's edges; every "
        "output bit-equal")
    slot_sweep.launches = 0
    slot_sweep.launches_by_build = {}
    max_abs, failed = 0.0, []
    for name, grid, cfg in cases:
        args, params = sweep_inputs(grid, cfg, 0.5, "cuda")
        before = dict(slot_sweep.launches_by_build)
        out = slot_sweep(*args, params=params)
        (build,) = [b for b, n in slot_sweep.launches_by_build.items()
                    if n != before.get(b, 0)]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        ref = reference_slot_sweep(*args, params)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t1
        bad, abs_err, rel_err = sweep_diff(out, ref)
        finite = all(bool(torch.isfinite(v).all()) for v in out.values())
        outputs = [k for k in out if out[k].numel()]
        exact = [k for k in outputs if torch.equal(out[k], ref[k])]
        ok = not bad and finite and exact == outputs
        log(f"  {name}: {len(grid)} points, build <{build[0]}, {build[1]}>, flags "
            f"{params.flags}, {params.live_slots()} slots, {params.n_windows} windows: max_abs_err="
            f"{abs_err:.3e} max_rel_err={rel_err:.3e}, counters differ at {len(bad)} points; "
            f"bit-equal: {len(exact)} of {len(outputs)} outputs"
            f"{'' if ok else ' ' + str(sorted(set(outputs) - set(exact)))}; plain "
            f"{plain_s:.2f} s {'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(name)
            for i in (bad or [int(torch.argmax((out['offered'] - ref['offered']).abs()))])[:3]:
                p = grid.point(i)
                log(f"    point {i} (m={p['m']} n_queues={p['n_queues']} seed={p['seed']}) "
                    f"diverges at slot {first_divergence(args, params, i)}")
        max_abs = max(max_abs, abs_err)
    builds = set(slot_sweep.launches_by_build)
    if slot_sweep.launches != len(cases) or len(builds) != 2:
        fail(f"slot_sweep counted {slot_sweep.launches} launches "
             f"({slot_sweep.launches_by_build}) for {len(cases)} calls of two builds")
    # the wrapper checks its bounds: five threads a point is refused
    args, params = sweep_inputs(sweep_compare_grid(), every_cfg, 0.5, "cuda")
    try:
        slot_sweep(args[0], args[1], torch.full_like(args[2], 5), *args[3:], params=params)
    except ValueError as err:
        log(f"  m=5 refused: {err}")
    else:
        fail("slot_sweep took m=5")
    if failed:
        fail(f"slot_sweep disagrees with its plain version ({'; '.join(failed)})")
    log(f"  phase 2 (slot_sweep) took {time.perf_counter() - t0:.1f} s")
    return {"max_abs_err": max_abs, "builds": builds}


def check_builds_compared(name: str, compared: set) -> None:
    """Fail unless every build ``slot_sweep`` launched since its counters
    were reset was held against the plain version in phase 2."""
    from repro_torch.kernels.slot_sweep import slot_sweep
    launched = set(slot_sweep.launches_by_build)
    if not launched <= compared:
        fail(f"{name} launched builds {sorted(launched - compared)} that phase 2 did not "
             "compare with the plain version")


def sweep_bound(args, params, out) -> dict:
    """Least time for a sweep's work on the card, counted from the code
    (csrc/slot_sweep.cu) for this run's points and slots.  A Philox4x32-10
    block is 10 rounds of 4 integer multiplies (low and high words of two
    products) and 2 three-input XORs: 60 int32 operations (the key schedule
    depends on the seed alone and counts once a point).  A word that a draw
    uses costs a shift (int32) and a convert.  Every slot draws the
    queues' normals (one block) and, with stall windows on, the stall start
    (one block).  A slot where a thread re-arms also draws its overshoot:
    one block of normals, one block each for the tail and interference hit
    uniforms; such slots are counted at the fewest that this run's re-arms
    (T_S arms + busy tries) can fall in, re-arms / m.  A Box-Muller pair is
    a log, a sqrt, a cos and a sin (each one special-function operation)
    and 7 float32 operations; a queue's arrivals a sqrt and 14 float32
    operations, its drain, vacation and backlog sum 6; a thread's countdown
    3; the slot's sums 22 (+5 with windows).  Bytes: each input read once
    (7 words a point and its schedule rows), each output written once (13
    words a point and its windows).  Returns the time by resource and the
    largest, the bound."""
    m = args[2].double().cpu().numpy()
    q = args[3].double().cpu().numpy()
    n = float(params.live_slots())
    fl = {k: float(v) for k, v in params.flags.items()}
    pq, pm = np.ceil(q / 2.0), np.ceil(m / 2.0)
    win = 1.0 if params.n_windows else 0.0
    rearms = (out["ts_arms"].double().cpu().numpy()
              + out["busy_tries"].double().cpu().numpy())
    rs = rearms / m                                   # fewest slots with a re-arm
    int32 = n * (60.0 + 2.0 * pq + fl["stall"] * 62.0) + 18.0 \
        + rs * (fl["sigma"] * (60.0 + 2.0 * pm) + (fl["tail"] + fl["intf"]) * (60.0 + m))
    cvt = n * (2.0 * pq + fl["stall"] + 1.0) \
        + rs * (fl["sigma"] * 2.0 * pm + (fl["tail"] + fl["intf"]) * m)
    sfu = n * (4.0 * pq + q) + rs * fl["sigma"] * 4.0 * pm
    f32 = n * (7.0 * pq + 20.0 * q + 3.0 * m + 22.0 + 5.0 * win + fl["stall"]) \
        + rs * (fl["sigma"] * (7.0 * pm + 3.0 * m) + (fl["tail"] + fl["intf"]) * m) \
        + 2.0 * rearms
    ops = {"f32": float(f32.sum()), "int32": float(int32.sum()), "cvt": float(cvt.sum()),
           "sfu": float(sfu.sum())}
    nbytes = 4.0 * (20 * len(m) + out["win"].numel())
    if args[7] is not None:
        nbytes += 4.0 * (args[7].numel() + args[8].numel())
    times = {"f32": ops["f32"] / PEAK_F32_OPS * 1e3,
             "int32": ops["int32"] / PEAK_INT32_OPS * 1e3,
             "cvt": ops["cvt"] / PEAK_SFU_OPS * 1e3,
             "sfu": ops["sfu"] / PEAK_SFU_OPS * 1e3,
             "bytes": nbytes / PEAK_BYTES_PER_S * 1e3}
    worst = max(times, key=times.get)
    point_slots = len(m) * n
    per = {k: v / point_slots for k, v in (*ops.items(), ("bytes", nbytes))}
    return {"bound_ms": times[worst], "bound_by": "bytes" if worst == "bytes" else "operations",
            "bound_resource": worst, "bound_times_ms": times, "ops": ops, "bytes": nbytes,
            "point_slots": point_slots, "per_point_slot": per}


def check_sweep_invariants(name: str, bs, em) -> None:
    """The exact identities of a sweep at every point, to float32 rounding:
    offered = served + dropped + final backlog, window sums = totals,
    energy = active power x awake + per-arm charges; counters are whole
    numbers; every output finite.  Each side is a float32 sum over the
    run's n slots, so the two agree within n * 2^-24 of their size (the
    bound of a sequential float32 sum)."""
    rel = max(SWEEP_RTOL, float(bs.n_steps.max()) * 2.0 ** -24)

    def close(a, b):
        return bool(np.all(np.abs(a - b) <= rel * np.maximum(np.abs(b), 1.0)))
    checks = {"packets": close(bs.offered, bs.serviced + bs.dropped + bs.final_backlog)}
    arm_s = np.array([em.arm_energy_uj(t) for t in bs.grid.t_s_us])
    arm_l = np.array([em.arm_energy_uj(t) for t in bs.grid.t_l_us])
    checks["energy"] = close(bs.energy_uj, em.active_power_w * bs.awake_us
                             + bs.ts_arms * arm_s + bs.busy_tries * arm_l)
    if bs.win.size:
        checks["windows"] = all(
            close(bs.win[:, :, col].sum(1), getattr(bs, k))
            for col, k in enumerate(("offered", "serviced", "lat_area", "awake_us",
                                     "energy_uj")))
    checks["counts"] = all(np.array_equal(getattr(bs, k), np.round(getattr(bs, k)))
                           for k in SWEEP_COUNTERS)
    checks["finite"] = all(bool(np.isfinite(getattr(bs, k)).all()) for k in (
        "offered", "serviced", "dropped", "awake_us", "lat_area", "energy_uj",
        "final_backlog")) and bool(np.isfinite(bs.win).all())
    if not all(checks.values()):
        fail(f"{name}: the sweep breaks an exact identity: {checks}")


def launch_build(args, params, m_max: int, q_max: int, lib=None):
    """One launch of the sweep kernel's build for ``q_max`` queues a point,
    past the wrapper (which picks the build from the grid): phase 3's A/B of
    the two builds on one grid, and ``--sweep-ab``'s of two sources
    (``lib``, default this checkout's)."""
    from repro_torch.kernels.slot_sweep.ops import STAT_NAMES
    from repro_torch.kernels.slot_sweep.kernel import launch_slot_sweep
    cols = dict(zip(("t_s", "t_l", "m", "nq", "lam", "seed_lo", "seed_hi"), args[:7]))
    n = args[0].shape[0]
    stats = torch.empty((len(STAT_NAMES), n), dtype=torch.float32, device="cuda")
    win = torch.empty((n, params.n_windows, 5), dtype=torch.float32, device="cuda")
    backlog = torch.empty(n, dtype=torch.float32, device="cuda")
    build = launch_slot_sweep(cols, args[7], args[8], params, stats, win, backlog,
                              m_max=m_max, q_max=q_max, lib=lib)
    return build, stats, win, backlog


def sweep_build_ab(args, params) -> dict:
    """The <4, 1> build against <4, 4> on a one-queue grid: each timed as
    the median of 5 CUDA-event timings after 1 warm-up, in the order A B B
    A, both launched the same way (``launch_build``); their outputs must be
    bit-equal (lanes past a point's queues add exact zeros)."""
    m_max = int(args[2].max())
    outs = {q: launch_build(args, params, m_max, q) for q in (1, 4)}
    if {q: o[0] for q, o in outs.items()} != {1: (4, 1), 4: (4, 4)}:
        fail(f"launch_build launched {[o[0] for o in outs.values()]}")
    if not all(torch.equal(a, b) for a, b in zip(outs[1][1:], outs[4][1:])):
        fail("the <4, 1> and <4, 4> builds disagree on a one-queue grid")
    times = {1: [], 4: []}
    for q in (1, 4, 4, 1):
        times[q].append(time_ms(launch_build, args, params, m_max, q, iters=5, warmup=1))
    return {f"<4, {q}>": t for q, t in times.items()}


def phase_time_sweep(compared: set) -> list[dict]:
    """The sweep kernel at the repo's sweep shapes: median of 5 CUDA-event
    timings after 1 warm-up call, each behind the device-side spin; the
    plain version timed over its first 400 slots (its cost a slot does not
    depend on the slot: the log also gives it scaled to the run's slots, the
    kernels line only the time measured).  One launch a sweep; every build
    launched must be among those phase 2 compared.  At sweep_frontier's
    quiet grid, also the A/B of the two builds (``sweep_build_ab``)."""
    import dataclasses

    from repro_torch.kernels.slot_sweep import reference_slot_sweep, slot_sweep
    from repro_torch.runtime.batched import stats_from_outputs, sweep_inputs
    t0 = time.perf_counter()
    log("phase 3: slot_sweep at the repo's sweep shapes: kernel median of 5 CUDA-event "
        "timings after 1 warm-up; plain version measured over its first 400 slots (and "
        "scaled to the run in this log: not run in full); bound from the code's "
        "operations (sweep_bound)")
    rows = []
    for k, (name, grid, cfg, slot_us) in enumerate(sweep_settings()):
        args, params = sweep_inputs(grid, cfg, slot_us, "cuda")
        slot_sweep.launches = 0
        slot_sweep.launches_by_build = {}
        ms = time_ms(slot_sweep, *args, params=params, iters=5, warmup=1)
        if slot_sweep.launches != 6:
            fail(f"{name}: slot_sweep counted {slot_sweep.launches} launches for 6 calls")
        (build,) = slot_sweep.launches_by_build
        check_builds_compared(name, compared)
        out = slot_sweep(*args, params=params)
        bs = stats_from_outputs(grid, cfg, slot_us, params, out)
        check_sweep_invariants(name, bs, cfg.energy_model)
        cut = dataclasses.replace(params, duration_us=400 * slot_us)
        plain_cut_ms = time_ms(reference_slot_sweep, *args, cut, iters=1, warmup=0)
        n_live = params.live_slots()
        plain_scaled_ms = plain_cut_ms * n_live / cut.live_slots()
        b = sweep_bound(args, params, out)
        rate = b["point_slots"] / (ms / 1e3)
        rows.append({"name": name, "ms": ms, "plain_ms": plain_cut_ms,
                     "plain_slots": cut.live_slots(), "library_ms": None, "launches": 1,
                     "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
                     "bound_resource": b["bound_resource"], "point_slots_per_s": rate,
                     "build": f"<{build[0]}, {build[1]}>",
                     "shape": f"{len(grid)} points x {n_live} slots of {slot_us} us, m <= "
                              f"{int(grid.m.max())}, n_queues <= {int(grid.n_queues.max())}, "
                              f"flags {params.flags}, windows {params.n_windows}; plain_ms "
                              f"over the first {cut.live_slots()} of the slots"})
        log(f"  {name}: {len(grid)} points x {n_live} slots, build <{build[0]}, {build[1]}>: "
            f"kernel {ms:.3f} ms ({rate:.4e} point-slots/s), plain {plain_cut_ms:.1f} ms "
            f"measured for {cut.live_slots()} slots ({plain_scaled_ms:.0f} ms scaled to "
            f"{n_live} slots, not measured), library none; bound "
            f"{b['bound_ms'] * 1e3:.2f} us ({b['bound_resource']}; " + ", ".join(
                f"{k} {v * 1e3:.2f} us" for k, v in b["bound_times_ms"].items())
            + f"), {100 * b['bound_ms'] / ms:.4f}% of it; per point-slot " + ", ".join(
                f"{k} {v:.3g}" for k, v in b["per_point_slot"].items())
            + f"; {len(grid)} threads = "
            f"{100 * len(grid) / RESIDENT_THREADS:.2f}% of the card's resident threads; "
            f"mean latency {float(np.mean(bs.mean_latency_us)):.2f} us, cpu "
            f"{float(np.mean(bs.cpu_fraction)):.3f}")
        if k == 0:
            ab = sweep_build_ab(args, params)
            log(f"  {name}, A/B of the builds (A B B A, each a median of 5, outputs "
                "bit-equal): " + "; ".join(f"{b} " + ", ".join(f"{t:.3f}" for t in ts)
                                            + " ms" for b, ts in ab.items()))
    log(f"  phase 3 (slot_sweep) took {time.perf_counter() - t0:.1f} s")
    return rows


def phase_sweep_source_ab(sources: list[str]) -> list[dict]:
    """``--sweep-ab SRC...``: this checkout's sweep kernel against other
    sources with the same C interface as ``csrc/slot_sweep.cu`` (a parent
    commit's, a variant), each built with the same flags, at the five
    sweeps of phase 3.  Each is timed as the median of 5 CUDA-event timings
    after 1 warm-up, in the order this, SRC1 .. SRCn, SRCn .. SRC1, this (A
    B B A for one source), all launched the same way (``launch_build``);
    every output of each source is compared bit for bit with this
    checkout's (reported, not required: a variant may compute something
    else)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.slot_sweep import kernel as sweep_kernel
    from repro_torch.runtime.batched import sweep_inputs
    named = {"this": sweep_kernel._SOURCE, **{s: str(Path(s).resolve()) for s in sources}}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(named)) as pool:
        libs = dict(zip(named, pool.map(sweep_kernel.build, named.values())))
    log(f"sweep A/B: built {len(named)} sources in parallel in {time.perf_counter() - t0:.2f} s")
    for name, source in named.items():
        info = _build.BUILD_INFO[source]
        log(f"  {name}: nvcc {info['seconds']:.2f} s; ptxas "
            f"{ptxas_kernels(info['log'])}")
    order = [*named, *reversed(named)]
    rows = []
    for name, grid, cfg, slot_us in sweep_settings():
        args, params = sweep_inputs(grid, cfg, slot_us, "cuda")
        m_max, q_max = int(args[2].max()), int(args[3].max())
        outs = {k: launch_build(args, params, m_max, q_max, lib=lib) for k, lib in libs.items()}
        equal = {k: all(torch.equal(a, b) for a, b in zip(outs["this"][1:], o[1:]))
                 for k, o in outs.items() if k != "this"}
        times = {k: [] for k in named}
        for k in order:
            times[k].append(time_ms(launch_build, args, params, m_max, q_max, iters=5,
                                    warmup=1, lib=libs[k]))
        n_live = params.live_slots()
        log(f"  {name} ({len(grid)} points x {n_live} slots, build <{outs['this'][0][0]}, "
            f"{outs['this'][0][1]}>), order {' '.join(order)}: " + "; ".join(
                f"{k} " + ", ".join(f"{t:.3f}" for t in ts) + " ms ("
                f"{1e3 * statistics.mean(ts) / n_live:.4f} us a slot)" for k, ts in times.items())
            + f"; bit-equal to this: {equal}")
        rows.append({"name": name, "points": len(grid), "slots": n_live, "times_ms": times,
                     "bit_equal": equal})
    return rows


def _band_check(name, pts, cfg, lat_abs, lat_rel, cpu_abs, cpu_rel, loss_abs=None) -> None:
    """tests/test_batched_engine.py's parity band: the sweep kernel (one
    launch for the points) against the port's event engine, point by point."""
    from repro_torch.core import MetronomeConfig
    from repro_torch.runtime import (
        MetronomePolicy,
        PoissonWorkload,
        SweepGrid,
        simulate_batch,
        simulate_run,
    )
    bs = simulate_batch(SweepGrid.of_points(pts), cfg, slot_us=0.5)
    check_sweep_invariants(name, bs, cfg.energy_model)
    worst, bad = {"lat": 0.0, "cpu": 0.0, "wake": 0.0, "loss": 0.0}, []
    for i, p in enumerate(pts):
        rs = simulate_run(MetronomePolicy(MetronomeConfig(
            m=p["m"], v_target_us=p["t_s_us"], t_long_us=p["t_l_us"],
            ts_min_us=min(1.0, p["t_s_us"])), adaptive=False),
            PoissonWorkload(p["rate_mpps"]), cfg)
        lat_b, lat_e = float(bs.mean_latency_us[i]), rs.mean_sojourn_us
        cpu_b, cpu_e = float(bs.cpu_fraction[i]), rs.cpu_fraction
        loss_b, loss_e = float(bs.loss_fraction[i]), rs.loss_fraction
        wake = abs(float(bs.wakeups[i]) - rs.wakeups) / max(rs.wakeups, 1)
        ok = (abs(lat_b - lat_e) <= max(lat_abs, lat_rel * lat_e)
              and abs(cpu_b - cpu_e) <= cpu_abs + cpu_rel * cpu_e and wake <= 0.15)
        if loss_abs is None:
            ok &= loss_b < 1e-3 and loss_e < 1e-3
        else:
            ok &= abs(loss_b - loss_e) <= loss_abs
        worst["lat"] = max(worst["lat"], abs(lat_b - lat_e) / max(lat_abs, lat_rel * lat_e))
        worst["cpu"] = max(worst["cpu"], abs(cpu_b - cpu_e) / (cpu_abs + cpu_rel * cpu_e))
        worst["wake"] = max(worst["wake"], wake / 0.15)
        worst["loss"] = max(worst["loss"], abs(loss_b - loss_e))
        if not ok:
            bad.append(f"point {i} {p}: latency {lat_b:.2f} vs {lat_e:.2f} us, cpu "
                       f"{cpu_b:.4f} vs {cpu_e:.4f}, wakeups {bs.wakeups[i]:.0f} vs "
                       f"{rs.wakeups}, loss {loss_b:.4f} vs {loss_e:.4f}")
    log(f"  {name}: {len(pts)} configs at {cfg.duration_us:g} us, worst share of the band: "
        + ", ".join(f"{k} {v:.2f}" for k, v in worst.items() if k != "loss")
        + f", loss gap {worst['loss']:.4f} {'ok' if not bad else 'FAIL'}")
    for line in bad:
        log(f"    {line}")
    if bad:
        fail(f"{name}: the sweep kernel leaves the reference's parity band")


def _band_configs(n: int, seed: int) -> list[dict]:
    """tests/test_batched_engine.py's _random_configs."""
    rng = np.random.default_rng(seed)
    pts = []
    for i in range(n):
        t_s = float(rng.uniform(5.0, 40.0))
        pts.append(dict(t_s_us=t_s, t_l_us=float(t_s * rng.uniform(4.0, 25.0)),
                        m=int(rng.integers(1, 5)),
                        rate_mpps=float(rng.uniform(0.15, 0.85) * MU_MPPS), seed=i))
    return pts


def phase_sweep_bands(compared: set) -> None:
    """tests/test_batched_engine.py's parity bands (:20-35) through the
    kernel: 24 random quiet configs (mean sojourn within max(1.5 us, 12%),
    cpu within 0.02 + 5%, wakeups within 15%, no loss) and the 16 configs
    of its interference environment (max(4.5 us, 22%), 0.025 + 6%, loss
    within 0.03), each against the port's event engine at 120,000 us, and
    the exact identities of both sweeps."""
    from repro_torch.kernels.slot_sweep import slot_sweep
    from repro_torch.runtime import HR_SLEEP_MODEL, SimRunConfig
    t0 = time.perf_counter()
    log("band phase: slot_sweep against the port's event engine (simulate_run) inside "
        "the reference's parity bands")
    slot_sweep.launches_by_build = {}
    _band_check("24 quiet configs", _band_configs(24, 42),
                SimRunConfig(duration_us=120_000.0, sleep_model=HR_SLEEP_MODEL),
                1.5, 0.12, 0.02, 0.05)
    _band_check("16 noisy configs", _band_configs(16, 7),
                SimRunConfig(duration_us=120_000.0, sleep_model=HR_SLEEP_MODEL, **BAND_NOISY),
                4.5, 0.22, 0.025, 0.06, loss_abs=0.03)
    check_builds_compared("the band phase", compared)
    log(f"  band phase took {time.perf_counter() - t0:.1f} s")


def phase_sweep_main(compared: set) -> dict:
    """The sweep's main path: ``repro_torch.runtime.simulate_batch`` on
    sweep_frontier's full quiet grid (2016 points, 50 ms, slots of 0.5 us)
    with every launch counter set to 0 just before and read just after:
    exactly one slot_sweep launch and no other kernel.  Then the exact
    identities at every point, and a few points as ``RunStats``."""
    from repro_torch.kernels import decode_attention, flash_attention, slot_sweep, ssd_scan
    from repro_torch.runtime import SimRunConfig, simulate_batch
    t0 = time.perf_counter()
    log("main path (S1): simulate_batch over sweep_frontier's full quiet grid")
    grid = frontier_grid()
    cfg = SimRunConfig(duration_us=FRONTIER_US)
    counters = (flash_attention, decode_attention, ssd_scan, slot_sweep)
    for k in counters:
        k.launches = 0
    slot_sweep.launches_by_build = {}
    t1 = time.perf_counter()
    bs = simulate_batch(grid, cfg, slot_us=0.5)
    host_s = time.perf_counter() - t1
    launches = {k.__name__: k.launches for k in counters}
    builds = dict(slot_sweep.launches_by_build)
    if launches != {"flash_attention": 0, "decode_attention": 0, "ssd_scan": 0,
                    "slot_sweep": 1}:
        fail(f"simulate_batch launched {launches}; want exactly one slot_sweep launch")
    check_builds_compared("the main path", compared)
    if len(bs) != len(grid) or bs.reshaped("cpu_fraction").shape != grid.shape:
        fail(f"simulate_batch returned {len(bs)} points for a grid of {len(grid)}")
    check_sweep_invariants("the main path", bs, cfg.energy_model)
    rows = []
    for i in (0, len(grid) // 2, len(grid) - 1):
        rs = bs.to_run_stats(i)
        if not (rs.backend == "batched" and rs.items == int(bs.serviced[i])
                and rs.offered == int(bs.offered[i])
                and abs(rs.cpu_fraction - float(bs.cpu_fraction[i])) <= 1e-6 + 1e-3 *
                float(bs.cpu_fraction[i]) and np.isfinite(rs.mean_latency_us)):
            fail(f"to_run_stats({i}) does not carry point {i}'s numbers: {rs.summary()}")
        rows.append(f"{i}: {rs.policy} {rs.workload} mean latency "
                    f"{rs.mean_latency_us:.2f} us cpu {rs.cpu_fraction:.4f} items {rs.items}")
    lat, cpu = bs.reshaped("mean_latency_us"), bs.reshaped("cpu_fraction")
    log(f"  {len(grid)} points in one launch (build {builds}), {host_s:.3f} s host clock "
        f"(inputs, launch, results); launches {launches}; mean latency "
        f"{float(lat.min()):.2f}-{float(lat.max()):.2f} us, cpu {float(cpu.min()):.4f}-"
        f"{float(cpu.max()):.4f}, loss <= {float(bs.loss_fraction.max()):.2e}")
    for line in rows:
        log(f"    RunStats {line}")
    log(f"  main path (S1) took {time.perf_counter() - t0:.1f} s")
    return {"launches": launches["slot_sweep"], "host_s": host_s}


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
    if sys.argv[1:2] == ["--sweep-ab"]:
        log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True,
                           check=True).stdout.strip().splitlines()[0])
        print(json.dumps({"sweep_ab": phase_sweep_source_ab(sys.argv[2:])}), flush=True)
        return 0
    phase_card()
    route_err = phase_compare()
    decode_err = phase_compare_decode()
    ssd_err = phase_compare_ssd()
    phase_grad_guard()
    rows = phase_time()
    decode_rows = phase_time_decode()
    ssd_rows = phase_time_ssd()
    served = phase_serve()
    sweep_cmp = phase_compare_sweep()
    sweep_rows = phase_time_sweep(sweep_cmp["builds"])
    phase_sweep_bands(sweep_cmp["builds"])
    sweep_main = phase_sweep_main(sweep_cmp["builds"])
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
    # S1, the fixed-slot sweep: launches are its main path's (one
    # simulate_batch over sweep_frontier's full quiet grid); its numbers at
    # that shape, the other sweeps of phase 3 in "rows"
    row = sweep_rows[0]
    extra = ("build", "bound_resource", "point_slots_per_s", "plain_slots")
    kernels.append({
        "name": "slot_sweep", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/slot_sweep.cu",
        "replaces": "src/repro/runtime/batched.py:543", "launches": sweep_main["launches"],
        "max_abs_err": sweep_cmp["max_abs_err"], **{k: row[k] for k in keys},
        "shape": f"{row['name']}: {row['shape']}", **{k: row[k] for k in extra},
        "rows": [{k: r[k] for k in ("name", "shape", *keys, *extra)} for r in sweep_rows[1:]]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
