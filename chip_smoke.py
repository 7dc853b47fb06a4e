"""Smoke run of the PyTorch port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

Phases, each a hard failure (nonzero exit, no result line):

1. the card (nvidia-smi name and power limit), torch/CUDA versions, and the
   build of every kernel of ``src/repro_torch/kernels`` (flash attention,
   decode attention, SSD chunk scan, the two sweeps; one nvcc per source, in
   parallel), with every kernel's registers and spills (the wgmma kernel,
   the mma decode split, the K3 kernels and the sweeps must not spill);
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

Then the event-jump sweep S2 (``adaptive_sweep``, the reference's
``runtime/batched_adaptive.py`` ``lax.scan``; one thread a point), built in
phase 1 (its builds <4, 1> and <4, 4> must not spill):

- phase 2: the kernel against its plain version, every output bit-equal: m
  1-4 x n_queues 1-4 (and one queue a point) quiet, noisy and scheduled
  with windows and deep C-states, a budget short enough for the tail's
  pacing (forced steps), the main path's grid cut in duration only, and 1,
  5 and 33 points; a diverging point reported with its step;
- phase 3: the kernel timed at sweep_frontier's full grid (quiet, noisy) and
  stepping.py's three loads, beside S1 on the same grid (live steps against
  slots; at stepping.py's grids S1's bound and plain version too), its
  bound, the plain version over its first 300 steps and the spread of live
  steps over a warp's points;
- the band phase holds S2 too, against the event engine and, on 8-seed
  means, against S1;
- the calibration path: ``build_operating_table(
  stepping="adaptive")`` over sweep_frontier's lattice, uncut, with three
  event-engine spot checks, in one S2 launch; ``table.save``; ``Server(engine,
  MetronomePolicy(cfg), operating_table=path)`` on phase 4's gemma-2b engine,
  serving N/N through K1's ``"wgmma"`` route.

Then the fleet sweep S3 (``fleet_sweep``, the reference's
``runtime/fleet.py`` ``lax.scan``; one block a point, the balancer, link
and hedge stages as block reductions), built in phase 1 (its builds <4, 1>
and <4, 4> must not spill):

- phase 2: the kernel against its plain version, every output bit-equal, at
  1, 3, 4, 33 and 64 hosts over 1,000-2,000 slots and 1,500 hosts (more
  than a block's lanes) over 300: each balancer, the bottleneck link, hedge
  deadlines 0, 20 and 80, every noise family, schedules, m x n_queues 1-4
  and one queue a point; and host h of a uniform fleet without topology or
  hedging equal to S1's kernel at seed s + h;
- phase 3: the kernel timed at benchmarks/fleet.py's shapes, uncut (4, 16
  and 64 hosts x three balancers x the hedge ladder over 60 ms of 0.5 us
  slots, and the 1000-host x 8-point scale row), beside its bound; the
  kernel bit-equal to its plain version on the same inputs over each
  shape's first 801 slots, where the plain version is timed; for the
  uniform rows, S1 on the same host rows;
- the band phase: a 4-host uniform fleet against the merged event engine
  at 60 ms, in the quiet bands;
- the slice's main path: benchmarks/fleet.py's ``fleet_bench`` through
  ``simulate_fleet``, one launch a call, the verdict at 64 hosts.

The second-to-last line is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

    python3 chip_smoke.py --sweep-ab SRC [SRC ...]

times this checkout's sweep kernel against other sources with its C
interface (a parent commit's ``csrc/slot_sweep.cu``, a variant) at phase
3's five sweeps, in the order this, SRC1 .. SRCn, SRCn .. SRC1, this, and
reports whether each gives this kernel's bits (``phase_sweep_source_ab``).
"""

from __future__ import annotations

import dataclasses
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


def time_ms(fn, *args, iters: int = 20, warmup: int = 3, flush=None, return_out: bool = False,
            **kwargs):
    """Median of ``iters`` CUDA-event timings of ``fn(*args, **kwargs)``
    after warm-up.  The card spins ~0.5 ms before each timed call (outside
    the events) while the host enqueues it, so the events time the card's
    work, not up to 0.5 ms of host-side dispatch.  With ``flush`` (a large
    tensor), it is zeroed before each timed call, outside the events, so the
    call finds L2 cold.  With ``return_out``, returns (the median, the last
    call's output)."""
    for _ in range(warmup):
        fn(*args, **kwargs)
    torch.cuda.synchronize()
    pairs, out = [], None
    for _ in range(iters):
        if flush is not None:
            flush.zero_()
        torch.cuda._sleep(1_000_000)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = fn(*args, **kwargs)
        e1.record()
        pairs.append((e0, e1))
    torch.cuda.synchronize()
    ms = statistics.median(a.elapsed_time(b) for a, b in pairs)
    return (ms, out) if return_out else ms


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
    from repro_torch.kernels.adaptive_sweep import kernel as as_kernel
    from repro_torch.kernels.decode_attention import kernel as da_kernel
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.fleet_sweep import kernel as fleet_kernel
    from repro_torch.kernels.slot_sweep import kernel as sweep_kernel
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
    builds = {"flash_attention.cu": fa_kernel.build, "decode_attention.cu": da_kernel.build,
              "ssd_scan.cu": ssd_kernel.build, "slot_sweep.cu": sweep_kernel.build,
              "adaptive_sweep.cu": as_kernel.build, "fleet_sweep.cu": fleet_kernel.build}
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
    # S2: the (M_MAX, Q_MAX) builds <4, 1> and <4, 4>, one thread a point,
    # built with -fmad=false; neither may spill
    kernels = ptxas_kernels(_build.BUILD_INFO["adaptive_sweep.cu"]["log"])
    for name, (regs, spills, smem) in kernels.items():
        log(f"  {name}: {regs} registers, {spills} bytes of spill stores + loads, {smem} "
            "bytes of static shared memory (no dynamic shared memory)")
    want = {f"adaptive_sweep_kernel<4, {q}>" for q in (1, 4)}
    if set(kernels) != want or any(spills for _, spills, _ in kernels.values()):
        fail(f"want the 2 adaptive_sweep_kernel builds (<4, 1> and <4, 4>), none spilling; "
             f"ptxas gave {kernels}")
    # S3: the (M_MAX, Q_MAX) builds <4, 1> and <4, 4>, one block a point,
    # built with -fmad=false; neither may spill
    kernels = ptxas_kernels(_build.BUILD_INFO["fleet_sweep.cu"]["log"])
    for name, (regs, spills, smem) in kernels.items():
        log(f"  {name}: {regs} registers, {spills} bytes of spill stores + loads, {smem} "
            "bytes of static shared memory (no dynamic shared memory)")
    want = {f"fleet_sweep_kernel<4, {q}>" for q in (1, 4)}
    if set(kernels) != want or any(spills for _, spills, _ in kernels.values()):
        fail(f"want the 2 fleet_sweep_kernel builds (<4, 1> and <4, 4>), none spilling; "
             f"ptxas gave {kernels}")
    for hosts in (1, 4, 64, 1000, 1500):
        log(f"  fleet_sweep layout at {hosts} hosts: <4, 1> {fleet_kernel.layout(hosts, 1)}, "
            f"<4, 4> {fleet_kernel.layout(hosts, 4)}")
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
    bytes, static shared memory bytes)} for every kernel of the six
    sources."""
    out, name, spills = {}, None, 0
    for ln in log_text.splitlines():
        if m := re.search(r"Compiling entry function '.*?(flash_fwd_\w+?|decode_split_mma_bf16|"
                          r"decode_split|decode_combine|ssd_chunk_state|ssd_chunk_out|"
                          r"slot_sweep_kernel|adaptive_sweep_kernel|fleet_sweep_kernel)"
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
            "decode_by_route": decode_by_route, "engine": engine}


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


def check_builds_compared(name: str, compared: set, wrapper=None) -> None:
    """Fail unless every build ``wrapper`` (default ``slot_sweep``) launched
    since its counters were reset was held against the plain version in
    phase 2."""
    from repro_torch.kernels.slot_sweep import slot_sweep
    launched = set((wrapper or slot_sweep).launches_by_build)
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


BAND_SEEDS = 8      # S2 against S1: each band config at its seed and 7 more


def _band_check(name, pts, cfg, lat_abs, lat_rel, cpu_abs, cpu_rel, loss_abs=None) -> None:
    """tests/test_batched_engine.py's parity band: both sweep kernels, S1
    and S2, against the port's event engine point by point at each config's
    seed, as the reference holds them; and S2 against S1 in the same band on
    the means over ``BAND_SEEDS`` seeds a config (its seed, then seed +
    1000 k), since the two kernels draw independent sample paths and one
    seed's noise alone can cross the noisy band (the reference's own noisy
    band test fails on its own draws; PERF.md, PR 20).  One launch of each
    kernel covers every seed."""
    from repro_torch.core import MetronomeConfig
    from repro_torch.runtime import (
        MetronomePolicy,
        PoissonWorkload,
        SweepGrid,
        simulate_batch,
        simulate_run,
    )
    n = len(pts)
    grid = SweepGrid.of_points([dict(p, seed=p["seed"] + 1000 * k)
                                for k in range(BAND_SEEDS) for p in pts])
    runs = {"S1": simulate_batch(grid, cfg, slot_us=0.5),
            "S2": simulate_batch(grid, cfg, slot_us=0.5, stepping="adaptive")}
    for tag, bs in runs.items():
        check_sweep_invariants(f"{name} ({tag})", bs, cfg.energy_model)
    events = [simulate_run(MetronomePolicy(MetronomeConfig(
        m=p["m"], v_target_us=p["t_s_us"], t_long_us=p["t_l_us"],
        ts_min_us=min(1.0, p["t_s_us"])), adaptive=False),
        PoissonWorkload(p["rate_mpps"]), cfg) for p in pts]
    bad = []
    for tag, bs in runs.items():
        worst = {"lat": 0.0, "cpu": 0.0, "wake": 0.0, "loss": 0.0}
        for i, (p, rs) in enumerate(zip(pts, events, strict=True)):
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
                bad.append(f"{tag} point {i} {p}: latency {lat_b:.2f} vs {lat_e:.2f} us, cpu "
                           f"{cpu_b:.4f} vs {cpu_e:.4f}, wakeups {bs.wakeups[i]:.0f} vs "
                           f"{rs.wakeups}, loss {loss_b:.4f} vs {loss_e:.4f}")
        log(f"  {name}, {tag} vs the event engine: {n} configs at {cfg.duration_us:g} us, worst "
            "share of the band: " + ", ".join(f"{k} {v:.2f}" for k, v in worst.items()
                                             if k != "loss")
            + f", loss gap {worst['loss']:.4f}")

    def by_seed(bs, metric):
        return getattr(bs, metric).reshape(BAND_SEEDS, n)

    lat_f, lat_a = by_seed(runs["S1"], "mean_latency_us"), by_seed(runs["S2"], "mean_latency_us")
    cpu_f, cpu_a = by_seed(runs["S1"], "cpu_fraction"), by_seed(runs["S2"], "cpu_fraction")
    loss_f, loss_a = by_seed(runs["S1"], "loss_fraction"), by_seed(runs["S2"], "loss_fraction")
    lat_share = np.abs(lat_a - lat_f) / np.maximum(lat_abs, lat_rel * lat_f)
    worst = {"lat": 0.0, "cpu": 0.0, "loss": 0.0}
    for i, p in enumerate(pts):
        lf, la = float(lat_f[:, i].mean()), float(lat_a[:, i].mean())
        cf, ca = float(cpu_f[:, i].mean()), float(cpu_a[:, i].mean())
        loss_gap = abs(float(loss_a[:, i].mean()) - float(loss_f[:, i].mean()))
        worst["lat"] = max(worst["lat"], abs(la - lf) / max(lat_abs, lat_rel * lf))
        worst["cpu"] = max(worst["cpu"], abs(ca - cf) / (cpu_abs + cpu_rel * cf))
        worst["loss"] = max(worst["loss"], loss_gap)
        if (abs(la - lf) > max(lat_abs, lat_rel * lf) or abs(ca - cf) > cpu_abs + cpu_rel * cf
                or (loss_abs is not None and loss_gap > loss_abs)):
            bad.append(f"S2 vs S1 point {i} {p}: mean over {BAND_SEEDS} seeds latency {la:.2f} vs "
                       f"{lf:.2f} us, cpu {ca:.4f} vs {cf:.4f}, loss gap {loss_gap:.4f}")
    s1, s2 = runs["S1"], runs["S2"]
    log(f"  {name}, S2 vs S1 on {BAND_SEEDS}-seed means: worst share of the band: lat "
        f"{worst['lat']:.2f}, cpu {worst['cpu']:.2f}, loss gap {worst['loss']:.4f} (one seed's "
        f"latency share: at the configs' seeds {float(lat_share[0].max()):.2f}, over all "
        f"{BAND_SEEDS} {float(lat_share.max()):.2f}); live steps "
        f"{float(s2.n_steps.mean()):.0f} a point against {float(s1.n_steps.mean()):.0f} slots "
        f"({100 * float(s2.n_steps.mean()) / float(s1.n_steps.mean()):.1f}%) "
        f"{'ok' if not bad else 'FAIL'}")
    for line in bad:
        log(f"    {line}")
    if bad:
        fail(f"{name}: a sweep kernel leaves the reference's parity band")


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


def phase_sweep_bands(compared: set, compared_s2: set) -> None:
    """tests/test_batched_engine.py's parity bands (:20-35) through both
    kernels: 24 random quiet configs (mean sojourn within max(1.5 us, 12%),
    cpu within 0.02 + 5%, wakeups within 15%, no loss) and the 16 configs
    of its interference environment (max(4.5 us, 22%), 0.025 + 6%, loss
    within 0.03), each against the port's event engine at 120,000 us, S2
    against S1 in the same bands on 8-seed means (``_band_check``), and the
    exact identities of every sweep."""
    from repro_torch.kernels.adaptive_sweep.ops import adaptive_sweep
    from repro_torch.kernels.slot_sweep import slot_sweep
    from repro_torch.runtime import HR_SLEEP_MODEL, SimRunConfig
    t0 = time.perf_counter()
    log("band phase: slot_sweep (S1) and adaptive_sweep (S2) against the port's event engine "
        "(simulate_run), and S2 against S1, inside the reference's parity bands")
    slot_sweep.launches_by_build = {}
    adaptive_sweep.launches_by_build = {}
    _band_check("24 quiet configs", _band_configs(24, 42),
                SimRunConfig(duration_us=120_000.0, sleep_model=HR_SLEEP_MODEL),
                1.5, 0.12, 0.02, 0.05)
    _band_check("16 noisy configs", _band_configs(16, 7),
                SimRunConfig(duration_us=120_000.0, sleep_model=HR_SLEEP_MODEL, **BAND_NOISY),
                4.5, 0.22, 0.025, 0.06, loss_abs=0.03)
    check_builds_compared("the band phase", compared)
    check_builds_compared("the band phase", compared_s2, adaptive_sweep)
    log(f"  band phase took {time.perf_counter() - t0:.1f} s")


def phase_sweep_main(compared: set) -> dict:
    """The sweep's main path: ``repro_torch.runtime.simulate_batch`` on
    sweep_frontier's full quiet grid (2016 points, 50 ms, slots of 0.5 us)
    with every launch counter set to 0 just before and read just after:
    exactly one slot_sweep launch and no other kernel.  Then the exact
    identities at every point, and a few points as ``RunStats``."""
    from repro_torch.kernels import (
        adaptive_sweep,
        decode_attention,
        flash_attention,
        fleet_sweep,
        slot_sweep,
        ssd_scan,
    )
    from repro_torch.runtime import SimRunConfig, simulate_batch
    t0 = time.perf_counter()
    log("main path (S1): simulate_batch over sweep_frontier's full quiet grid")
    grid = frontier_grid()
    cfg = SimRunConfig(duration_us=FRONTIER_US)
    counters = (flash_attention, decode_attention, ssd_scan, slot_sweep, adaptive_sweep,
                fleet_sweep)
    for k in counters:
        k.launches = 0
    slot_sweep.launches_by_build = {}
    t1 = time.perf_counter()
    bs = simulate_batch(grid, cfg, slot_us=0.5)
    host_s = time.perf_counter() - t1
    launches = {k.__name__: k.launches for k in counters}
    builds = dict(slot_sweep.launches_by_build)
    if launches != {"flash_attention": 0, "decode_attention": 0, "ssd_scan": 0,
                    "slot_sweep": 1, "adaptive_sweep": 0, "fleet_sweep": 0}:
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


# -- S2: the event-jump sweep (runtime/batched_adaptive.py's lax.scan) --------

# benchmarks/stepping.py's full grid (:44-51): T_S 50 us, T_L 500 us, M 3, two
# queues, 48 seeds a load, 120 ms, HR_SLEEP_MODEL; one simulate_batch a load
STEPPING_RHOS = (0.2, 0.45, 0.7)
ADAPTIVE_PLAIN_STEPS = 300
FRONTIER_TARGET_US = 15.0       # benchmarks/sweep_frontier.py's latency target (:51)


def stepping_grid(rho: float):
    from repro_torch.runtime import HR_SLEEP_MODEL, SimRunConfig, SweepGrid
    pts = [dict(t_s_us=50.0, t_l_us=500.0, m=3, n_queues=2, rate_mpps=rho * MU_MPPS, seed=s)
           for s in range(48)]
    return SweepGrid.of_points(pts), SimRunConfig(duration_us=120_000.0,
                                                  sleep_model=HR_SLEEP_MODEL)


def adaptive_settings():
    """(name, grid, cfg, slot_us): the sweeps S2's phase 3 times, each as the
    repo runs it: sweep_frontier's full grid (quiet, noisy), then
    stepping.py's three loads."""
    from repro_torch.runtime import SimRunConfig
    out = [("sweep_frontier full, quiet", frontier_grid(),
            SimRunConfig(duration_us=FRONTIER_US), 0.5),
           ("sweep_frontier full, noisy", frontier_grid(),
            SimRunConfig(duration_us=FRONTIER_US, **FRONTIER_NOISY), 0.5)]
    for rho in STEPPING_RHOS:
        grid, cfg = stepping_grid(rho)
        out.append((f"stepping.py rho {rho}", grid, cfg, 0.5))
    return out


def adaptive_compare_cases():
    """(name, grid, cfg, slot_us): S2 against its plain version.  16 points,
    every (m, n_queues) in 1..4 x 1..4 (and one queue throughout: the other
    build), quiet, noisy (sleep tails, interference, stall windows) and
    scheduled (per-point schedules, windows of 130 us, deep C-states); a grid
    whose budget is short (slots of 10 us cap it at 157 steps) so that the
    last eighth paces every point (forced steps); the main path's grid,
    sweep_frontier's 2016 points in its quiet and noisy config, cut in
    duration only; and 1, 5 and 33 points (a lone lane, a partial warp, a
    warp and one more)."""
    from repro_torch.runtime import (
        DEEP_CSTATE_ENERGY_MODEL,
        HR_SLEEP_MODEL,
        RampSchedule,
        SimRunConfig,
        SleepModel,
        StepSchedule,
        SweepGrid,
    )
    tail = SleepModel(base_us=2.8, slope=0.027, sigma_us=0.5, tail_prob=0.01,
                      tail_mean_us=40.0)
    noisy = dict(BAND_NOISY, stall_rate_per_us=1.0 / 400.0)

    def multi(seed, scheds=(), t_s=(4.0, 40.0), one_queue=False):
        rng = np.random.default_rng(seed)
        pts = []
        for m in (1, 2, 3, 4):
            for q in (1, 2, 3, 4):
                pts.append(dict(t_s_us=float(rng.uniform(*t_s)),
                                t_l_us=float(rng.uniform(100.0, 600.0)), m=m,
                                n_queues=1 if one_queue else q,
                                rate_mpps=float(rng.uniform(0.1, 0.9) * MU_MPPS * q / 2.0),
                                seed=int(rng.integers(0, 3))))
        for i, s in enumerate(scheds):
            pts[i]["schedule"] = s
        return SweepGrid.of_points(pts)

    scheds = [StepSchedule(times_us=(0.0, 600.0), scales=(0.3, 1.6)),
              RampSchedule(t_start_us=200.0, t_end_us=1_200.0, scale_from=0.2,
                           scale_to=1.5)] * 4
    quiet = SimRunConfig(duration_us=1_500.0, sleep_model=HR_SLEEP_MODEL)
    noisy_cfg = SimRunConfig(duration_us=1_500.0, queue_capacity=64, sleep_model=tail, **noisy)
    sched_cfg = SimRunConfig(duration_us=1_500.0, window_us=130.0,
                             energy_model=DEEP_CSTATE_ENERGY_MODEL)
    cases = []
    for one_queue in (False, True):
        tag = ", one queue a point" if one_queue else ""
        cases += [(f"m 1-4 x n_queues 1-4, quiet{tag}", multi(1, one_queue=one_queue), quiet,
                   0.5),
                  (f"m 1-4 x n_queues 1-4, noisy{tag}", multi(2, one_queue=one_queue),
                   noisy_cfg, 0.5),
                  (f"m 1-4 x n_queues 1-4, scheduled{tag}",
                   multi(3, scheds, one_queue=one_queue), sched_cfg, 0.5),
                  (f"tail pacing (slots of 10 us){tag}",
                   multi(5, t_s=(20.0, 60.0), one_queue=one_queue), noisy_cfg, 10.0)]
    cut_us = 2_000.0
    cases += [(f"sweep_frontier full grid, quiet, first {cut_us:g} us", frontier_grid(),
               SimRunConfig(duration_us=cut_us), 0.5),
              (f"sweep_frontier full grid, noisy, first {cut_us:g} us", frontier_grid(),
               SimRunConfig(duration_us=cut_us, **FRONTIER_NOISY), 0.5)]
    pool = multi(2)
    for n in (1, 5, 33):
        pts = [pool.point(i % len(pool)) for i in range(n)]
        cases.append((f"{n} points, noisy", SweepGrid.of_points(pts), noisy_cfg, 0.5))
        cases.append((f"{n} points, noisy, tail pacing", SweepGrid.of_points(pts), noisy_cfg,
                      10.0))
    return cases


def adaptive_first_divergence(args, params, i: int) -> int:
    """The first step after which point ``i``'s outputs differ between S2
    and its plain version: both run the point alone under the batch's step
    budget (its draws depend on its seed and the step alone) for prefixes of
    the run (``run_steps``), and a bisection finds the shortest that
    differs."""
    from repro_torch.kernels.adaptive_sweep.ops import adaptive_sweep, reference_adaptive_sweep
    one = [None if a is None else a[i:i + 1].contiguous() for a in args]

    def differs(n: int) -> bool:
        p = dataclasses.replace(params, run_steps=n)
        out, ref = adaptive_sweep(*one, params=p), reference_adaptive_sweep(*one, p)
        return not all(torch.equal(out[k], ref[k]) for k in out)

    lo, hi = 0, params.max_steps
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if differs(mid):
            hi = mid
        else:
            lo = mid
    return hi - 1


def warp_spread(n_steps) -> dict:
    """Live steps of a sweep's points by warp (32 points in grid order, as
    the kernel lays them out): a warp runs as long as its longest point, so
    the sum over warps of (longest - mean) is the lanes' idle time."""
    s = n_steps.double().cpu().numpy()
    pad = (-len(s)) % 32
    w = np.pad(s, (0, pad), constant_values=np.nan).reshape(-1, 32)
    longest, mean = np.nanmax(w, 1), np.nanmean(w, 1)
    return {"warps": len(w), "steps_max": float(s.max()), "steps_mean": float(s.mean()),
            "warp_longest_max": float(longest.max()),
            "warp_longest_over_mean": float(np.mean(longest / np.maximum(mean, 1.0))),
            "lane_busy_share": float(s.sum() / (longest * np.sum(~np.isnan(w), 1)).sum())}


def phase_compare_adaptive() -> dict:
    """S2 against its plain version on the card (``adaptive_compare_cases``):
    every output bit-equal (the same float32 operations in the same order, no
    fma contraction, the same math library); a point that differs is
    reported with the step where it diverges.  Returns the max abs error and
    the builds compared."""
    from repro_torch.kernels.adaptive_sweep.ops import adaptive_sweep, reference_adaptive_sweep
    from repro_torch.runtime.batched_adaptive import adaptive_sweep_inputs
    t0 = time.perf_counter()
    log("phase 2: adaptive_sweep (S2) vs plain version: m 1-4 x n_queues 1-4 quiet, noisy and "
        "scheduled, a budget short enough for tail pacing, the main path's grid "
        "(sweep_frontier, 2016 points) cut in duration only, and 1, 5, 33 points; every output "
        "bit-equal")
    adaptive_sweep.launches = 0
    adaptive_sweep.launches_by_build = {}
    cases = adaptive_compare_cases()
    max_abs, failed, forced_seen = 0.0, [], False
    for name, grid, cfg, slot_us in cases:
        args, params = adaptive_sweep_inputs(grid, cfg, slot_us, "cuda")
        before = dict(adaptive_sweep.launches_by_build)
        out = adaptive_sweep(*args, params=params)
        (build,) = [b for b, n in adaptive_sweep.launches_by_build.items()
                    if n != before.get(b, 0)]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        ref = reference_adaptive_sweep(*args, params)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t1
        outputs = [k for k in out if out[k].numel()]
        exact = [k for k in outputs if torch.equal(out[k], ref[k])]
        finite = all(bool(torch.isfinite(v).all()) for v in out.values())
        done = bool((out["sim_time"] == np.float32(cfg.duration_us)).all())
        abs_err = max(float((out[k].double() - ref[k].double()).abs().max()) for k in outputs)
        forced = float(out["forced_steps"].sum())
        forced_seen |= forced > 0
        ok = exact == outputs and finite and done
        sp = warp_spread(out["n_steps"])
        log(f"  {name}: {len(grid)} points, build <{build[0]}, {build[1]}>, flags "
            f"{params.flags}, budget {params.max_steps} steps, live steps max "
            f"{sp['steps_max']:.0f} mean {sp['steps_mean']:.1f}, forced {forced:.0f}, "
            f"{params.n_windows} windows: max_abs_err={abs_err:.3e}; bit-equal: {len(exact)} "
            f"of {len(outputs)} outputs"
            f"{'' if exact == outputs else ' ' + str(sorted(set(outputs) - set(exact)))}; "
            f"every point at its duration: {done}; plain {plain_s:.2f} s "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(name)
            diff = sum((out[k] != ref[k]).reshape(len(grid), -1).any(1).to(torch.int64)
                       for k in outputs)
            for i in torch.nonzero(diff).flatten().tolist()[:3]:
                p = grid.point(i)
                log(f"    point {i} (m={p['m']} n_queues={p['n_queues']} seed={p['seed']}) "
                    f"diverges at step {adaptive_first_divergence(args, params, i)}")
        max_abs = max(max_abs, abs_err)
    builds = set(adaptive_sweep.launches_by_build)
    if adaptive_sweep.launches != len(cases) or builds != {(4, 1), (4, 4)}:
        fail(f"adaptive_sweep counted {adaptive_sweep.launches} launches "
             f"({adaptive_sweep.launches_by_build}) for {len(cases)} calls of two builds")
    if not forced_seen:
        fail("no phase-2 case of adaptive_sweep reached the tail's pacing (forced steps)")
    if failed:
        fail(f"adaptive_sweep disagrees with its plain version ({'; '.join(failed)})")
    log(f"  phase 2 (adaptive_sweep) took {time.perf_counter() - t0:.1f} s")
    return {"max_abs_err": max_abs, "builds": builds}


def adaptive_bound(args, params, out) -> dict:
    """Least time for an event-jump sweep's work on the card, counted from
    the code (csrc/adaptive_sweep.cu) for this run's points and live steps,
    as ``sweep_bound`` counts S1's.  Every live step draws the queues'
    normals (one Philox block, 60 int32 operations; a shift and a convert a
    word used; a Box-Muller pair is a log, a sqrt, a cos and a sin and 7
    float32 operations) and makes the jump: a wake bound 2 float32
    operations a thread; a queue's drain and fill bounds 14 and a division
    each (a reciprocal on the special-function unit and 4 float32
    operations), its arrivals a square root (one special-function
    operation and 4 float32) and 16, its drain, room, vacation and sums 12;
    a thread's countdown and wake test 3; the jump's mins, floor and
    forced test 14, the step's sums 22 (+6 with windows: a product, a
    convert and 5 sums), the step index's convert 1.  A step where a thread
    re-arms also draws its overshoot, as S1's (counted at the fewest such
    steps, re-arms / m); an expected stall start (rate x duration a point)
    draws one block, two logs and 6 float32 operations.  Bytes: each input
    read once (7 words a point and its schedule rows), each output written
    once (16 words a point and its windows).  Returns the time by resource
    and the largest, the bound."""
    m = args[2].double().cpu().numpy()
    q = args[3].double().cpu().numpy()
    n = out["n_steps"].double().cpu().numpy()
    fl = {k: float(v) for k, v in params.flags.items()}
    pq, pm = np.ceil(q / 2.0), np.ceil(m / 2.0)
    win = 1.0 if params.n_windows else 0.0
    rearms = (out["ts_arms"].double().cpu().numpy()
              + out["busy_tries"].double().cpu().numpy())
    rs = rearms / m
    stalls = fl["stall"] * params.stall_rate_per_us * params.duration_us
    int32 = n * (60.0 + 2.0 * pq) + 18.0 + stalls * 62.0 \
        + rs * (fl["sigma"] * (60.0 + 2.0 * pm) + (fl["tail"] + fl["intf"]) * (60.0 + m))
    cvt = n * (2.0 * pq + 1.0 + win) + stalls * 2.0 \
        + rs * (fl["sigma"] * 2.0 * pm + (fl["tail"] + fl["intf"]) * m)
    sfu = n * (4.0 * pq + 3.0 * q) + stalls * 2.0 + rs * fl["sigma"] * 4.0 * pm
    f32 = n * (7.0 * pq + 2.0 * m + 56.0 * q + 3.0 * m + 14.0 + 22.0 + 6.0 * win) \
        + stalls * 6.0 \
        + rs * (fl["sigma"] * (7.0 * pm + 3.0 * m) + (fl["tail"] + fl["intf"]) * m) \
        + 2.0 * rearms
    ops = {"f32": float(f32.sum()), "int32": float(int32.sum()), "cvt": float(cvt.sum()),
           "sfu": float(sfu.sum())}
    nbytes = 4.0 * (23 * len(m) + out["win"].numel())
    if args[7] is not None:
        nbytes += 4.0 * (args[7].numel() + args[8].numel())
    times = {"f32": ops["f32"] / PEAK_F32_OPS * 1e3,
             "int32": ops["int32"] / PEAK_INT32_OPS * 1e3,
             "cvt": ops["cvt"] / PEAK_SFU_OPS * 1e3,
             "sfu": ops["sfu"] / PEAK_SFU_OPS * 1e3,
             "bytes": nbytes / PEAK_BYTES_PER_S * 1e3}
    worst = max(times, key=times.get)
    point_steps = float(n.sum())
    per = {k: v / point_steps for k, v in (*ops.items(), ("bytes", nbytes))}
    return {"bound_ms": times[worst], "bound_by": "bytes" if worst == "bytes" else "operations",
            "bound_resource": worst, "bound_times_ms": times, "point_steps": point_steps,
            "per_point_step": per}


def phase_time_adaptive(compared: set, compared_s1: set) -> list[dict]:
    """S2 at the repo's sweep shapes (``adaptive_settings``): median of 5
    CUDA-event timings after 1 warm-up, each behind the device-side spin; S1
    timed the same way on the same grid (its slots beside S2's live steps);
    the plain version measured over its first ``ADAPTIVE_PLAIN_STEPS`` steps;
    the bound from the code's operations (``adaptive_bound``); the spread of
    live steps over each warp's points; at stepping.py's grids also S1's
    bound (``sweep_bound``) and S1's plain version over its first 400 slots.  One launch a sweep, every build
    among those phase 2 compared; the exact identities at every point."""
    from repro_torch.kernels.adaptive_sweep.ops import adaptive_sweep, reference_adaptive_sweep
    from repro_torch.kernels.slot_sweep import reference_slot_sweep, slot_sweep
    from repro_torch.runtime.batched import simulate_batch, sweep_inputs
    from repro_torch.runtime.batched_adaptive import adaptive_sweep_inputs
    t0 = time.perf_counter()
    log("phase 3: adaptive_sweep (S2) at the repo's sweep shapes: kernel median of 5 CUDA-event "
        "timings after 1 warm-up; S1 (slot_sweep) the same way on the same grid; plain version "
        f"measured over its first {ADAPTIVE_PLAIN_STEPS} steps; bound from the code's operations "
        "(adaptive_bound); live steps by warp")
    rows = []
    for name, grid, cfg, slot_us in adaptive_settings():
        args, params = adaptive_sweep_inputs(grid, cfg, slot_us, "cuda")
        adaptive_sweep.launches = 0
        adaptive_sweep.launches_by_build = {}
        ms = time_ms(adaptive_sweep, *args, params=params, iters=5, warmup=1)
        if adaptive_sweep.launches != 6:
            fail(f"{name}: adaptive_sweep counted {adaptive_sweep.launches} launches for 6 calls")
        (build,) = adaptive_sweep.launches_by_build
        check_builds_compared(name, compared, adaptive_sweep)
        out = adaptive_sweep(*args, params=params)
        bs = simulate_batch(grid, cfg, slot_us=slot_us, stepping="adaptive")
        if not all(np.array_equal(getattr(bs, k), out[k].double().cpu().numpy())
                   for k in ("wakeups", "n_steps", "energy_uj")):
            fail(f"{name}: simulate_batch(stepping='adaptive') differs from its launch")
        check_sweep_invariants(f"{name} (S2)", bs, cfg.energy_model)
        if not np.all(bs.sim_time_us == np.float32(cfg.duration_us)):
            fail(f"{name}: a point of the event-jump sweep ended before its duration")
        s1_args, s1_params = sweep_inputs(grid, cfg, slot_us, "cuda")
        slot_sweep.launches_by_build = {}
        s1_ms = time_ms(slot_sweep, *s1_args, params=s1_params, iters=5, warmup=1)
        check_builds_compared(f"{name} (S1)", compared_s1)
        s1_extra = {}
        if name.startswith("stepping.py"):
            # S1's own bound and plain version at stepping.py's grid, which
            # S1's phase 3 does not time
            s1_b = sweep_bound(s1_args, s1_params, slot_sweep(*s1_args, params=s1_params))
            s1_cut = dataclasses.replace(s1_params, duration_us=400 * slot_us)
            s1_extra = {"s1_bound_ms": s1_b["bound_ms"], "s1_bound_by": s1_b["bound_by"],
                        "s1_bound_resource": s1_b["bound_resource"],
                        "s1_plain_ms": time_ms(reference_slot_sweep, *s1_args, s1_cut, iters=1,
                                               warmup=0),
                        "s1_plain_slots": s1_cut.live_slots()}
        cut = dataclasses.replace(params, run_steps=ADAPTIVE_PLAIN_STEPS)
        plain_ms = time_ms(reference_adaptive_sweep, *args, cut, iters=1, warmup=0)
        b = adaptive_bound(args, params, out)
        sp = warp_spread(out["n_steps"])
        rate = b["point_steps"] / (ms / 1e3)
        n_slots = s1_params.live_slots()
        rows.append({
            "name": name, "ms": ms, "plain_ms": plain_ms, "plain_steps": ADAPTIVE_PLAIN_STEPS,
            "library_ms": None, "launches": 1, "bound_ms": b["bound_ms"],
            "bound_by": b["bound_by"], "bound_resource": b["bound_resource"],
            "point_steps_per_s": rate, "build": f"<{build[0]}, {build[1]}>",
            "s1_ms": s1_ms, "s1_slots": n_slots, **s1_extra, "budget": params.max_steps, **sp,
            "forced_steps": float(out["forced_steps"].sum()),
            "shape": f"{len(grid)} points, budget {params.max_steps} steps, live steps max "
                     f"{sp['steps_max']:.0f} mean {sp['steps_mean']:.1f} (S1: {n_slots} "
                     f"slots), m <= {int(grid.m.max())}, n_queues <= "
                     f"{int(grid.n_queues.max())}, flags {params.flags}; plain_ms over the "
                     f"first {ADAPTIVE_PLAIN_STEPS} steps"})
        log(f"  {name}: {len(grid)} points, build <{build[0]}, {build[1]}>, budget "
            f"{params.max_steps} steps: kernel {ms:.3f} ms ({rate:.4e} point-steps/s); live "
            f"steps max {sp['steps_max']:.0f} mean {sp['steps_mean']:.1f} against S1's "
            f"{n_slots} slots (S1 {s1_ms:.3f} ms on this grid: S2 {s1_ms / ms:.2f}x faster"
            + (f"; S1's bound {s1_extra['s1_bound_ms'] * 1e3:.2f} us "
               f"({s1_extra['s1_bound_resource']}), S1's plain version "
               f"{s1_extra['s1_plain_ms']:.1f} ms measured for {s1_extra['s1_plain_slots']} "
               "slots" if s1_extra else "") + "); "
            f"warps {sp['warps']}, longest point of a warp {sp['warp_longest_over_mean']:.2f}x "
            f"its mean, lanes busy {100 * sp['lane_busy_share']:.1f}% of the warps' steps; "
            f"forced steps {float(out['forced_steps'].sum()):.0f}; plain {plain_ms:.1f} ms "
            f"measured for {ADAPTIVE_PLAIN_STEPS} steps; library none; bound "
            f"{b['bound_ms'] * 1e3:.2f} us ({b['bound_resource']}; " + ", ".join(
                f"{k} {v * 1e3:.2f} us" for k, v in b["bound_times_ms"].items())
            + f"), {100 * b['bound_ms'] / ms:.4f}% of it; per point-step " + ", ".join(
                f"{k} {v:.3g}" for k, v in b["per_point_step"].items())
            + f"; mean latency {float(np.mean(bs.mean_latency_us)):.2f} us, cpu "
            f"{float(np.mean(bs.cpu_fraction)):.3f}")
    log(f"  phase 3 (adaptive_sweep) took {time.perf_counter() - t0:.1f} s")
    return rows


def phase_calibration_main(engine, compared: set) -> dict:
    """The calibration path, the slice's main path, with every launch counter
    set to 0 just before and read just after:
    ``build_operating_table(stepping="adaptive")`` on sweep_frontier's
    lattice and config, uncut (2016 points, 50 ms, slots of 0.5 us, target
    15 us, loss 1e-3, spot_check=3: three points re-run through the port's
    event engine; a CalibrationMismatch fails the run), in exactly one S2
    launch; ``table.save`` to a temporary path; ``Server(engine,
    MetronomePolicy(cfg), operating_table=path)`` on phase 4's gemma-2b
    engine serving a few requests, its pollers sleeping on the OS timer,
    flash attention's launches all on the ``"wgmma"`` route."""
    import tempfile

    from repro_torch.core import MetronomeConfig
    from repro_torch.core.hr_sleep import _get_cal as hr_sleep_cal
    from repro_torch.core.hr_sleep import make_hr_sleep
    from repro_torch.kernels import (
        adaptive_sweep,
        decode_attention,
        flash_attention,
        fleet_sweep,
        slot_sweep,
        ssd_scan,
    )
    from repro_torch.runtime import (
        MetronomePolicy,
        OperatingTable,
        SimRunConfig,
        build_operating_table,
    )
    from repro_torch.serving import Request, Server
    t0 = time.perf_counter()
    f = FRONTIER
    log("main path (calibration): build_operating_table(stepping='adaptive') over "
        "sweep_frontier's lattice, uncut, spot_check=3 -> table.save -> Server(engine, "
        "MetronomePolicy(cfg), operating_table=path) serving gemma-2b")
    counters = (flash_attention, decode_attention, ssd_scan, slot_sweep, adaptive_sweep,
                fleet_sweep)
    for k in counters:
        k.launches = 0
    adaptive_sweep.launches_by_build = {}
    flash_attention.launches_by_route = {"wgmma": 0, "simt": 0}
    t1 = time.perf_counter()
    table = build_operating_table(
        rhos=f["rhos"], target_mean_latency_us=FRONTIER_TARGET_US, t_s_grid=f["t_s_grid"],
        t_l_grid=f["t_l_grid"], m_grid=f["m_grid"], cfg=SimRunConfig(duration_us=FRONTIER_US),
        seeds=f["seeds"], slot_us=0.5, max_loss=1e-3, spot_check=3, stepping="adaptive")
    build_s = time.perf_counter() - t1
    after_build = {k.__name__: k.launches for k in counters}
    if after_build != {"flash_attention": 0, "decode_attention": 0, "ssd_scan": 0,
                       "slot_sweep": 0, "adaptive_sweep": 1, "fleet_sweep": 0}:
        fail(f"build_operating_table launched {after_build}; want exactly one adaptive_sweep")
    check_builds_compared("the calibration path", compared, adaptive_sweep)
    for p in table.points:
        log(f"    rho {p.rho:.2f}: T_S {p.t_s_us:.2f} us, T_L {p.t_l_us:.0f} us, M {p.m}, mean "
            f"latency {p.mean_latency_us:.2f} us, cpu {p.cpu_fraction:.4f}, loss "
            f"{p.loss_fraction:.2e}, meets target {p.meets_target}")
    if not all(p.meets_target for p in table.points):
        fail("the calibrated table misses the latency target at some load")
    cpus = [p.cpu_fraction for p in table.points]
    if cpus != sorted(cpus):
        fail(f"the calibrated table's CPU does not rise with load: {cpus}")
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "operating_table.json"
        table.save(path)
        loaded = OperatingTable.load(path)
        if loaded != table:
            fail("the saved operating table does not load back equal")
        policy = MetronomePolicy(MetronomeConfig(m=3, v_target_us=2_000.0,
                                                 t_long_us=50_000.0))
        # the table's timeouts are tens of us, under hr_sleep's spin margin
        # (hundreds of us on the card's host; logged below): hr_sleep would
        # then spin every sleep out holding the GIL, and three spinning
        # pollers starved the engine's thread (4 requests not done in 120 s;
        # PERF.md, PR 20).  The OS timer alone (spin_cap_ns=0) releases it.
        server = Server(engine, policy, operating_table=path,
                        sleep_fn=make_hr_sleep(spin_cap_ns=0))
    ctl = policy.controller
    margin_ns = hr_sleep_cal().margin_ns
    if server.operating_table != table or ctl.feedforward != table:
        fail("Server(operating_table=path) did not install the table")
    ts0, tl0 = ctl.t_short_us, ctl.t_long_us
    want_ts, want_tl = table.timeouts_us(ctl.rho)
    if abs(ts0 - want_ts) > 1e-9 * max(1.0, want_ts):
        fail(f"the controller starts at T_S {ts0} us, the table gives {want_ts} at rho "
             f"{ctl.rho}")
    rng = np.random.default_rng(1)
    lens = (64, 300, 900, 40)
    reqs = [Request(prompt=[int(t) for t in rng.integers(1, engine.model.cfg.vocab_size, n)],
                    max_new_tokens=8) for n in lens]
    server.start()
    for r in reqs:
        r.arrival_ns = time.monotonic_ns()
        server.submit(r)
        time.sleep(rng.exponential(1.0 / 20.0))
    done = all(r.wait(120.0) for r in reqs)
    stats = server.stop()
    launches = {k.__name__: k.launches for k in counters}
    by_route = dict(flash_attention.launches_by_route)
    if not done:
        fail(f"the calibrated server did not complete every request within 120 s: tokens "
             f"{[len(r.tokens) for r in reqs]}, wakeups {stats.wakeups}, busy tries "
             f"{stats.busy_tries}, cycles {stats.cycles}, launches {launches}, controller rho "
             f"{ctl.rho:.3f} T_S {ctl.t_short_us:.2f} us T_L {ctl.t_long_us:.1f} us")
    completed = sum(len(r.tokens) == 8 for r in reqs)
    n_layers = engine.model.cfg.n_layers
    want = {"flash_attention": n_layers * len(reqs), "decode_attention": 0, "ssd_scan": 0,
            "slot_sweep": 0, "adaptive_sweep": 1, "fleet_sweep": 0}
    if completed != len(reqs) or launches != want or by_route != {
            "wgmma": n_layers * len(reqs), "simt": 0}:
        fail(f"calibrated serving: completed {completed}/{len(reqs)}, launches {launches} "
             f"(want {want}), flash attention by route {by_route}")
    log(f"  table from one adaptive_sweep launch in {build_s:.3f} s host clock (sweep, guard, "
        f"3 event-engine spot checks); server from {path.name}: controller starts at rho "
        f"{ctl.rho:.3f}, T_S {ts0:.2f} us, T_L {tl0:.0f} us (the table's "
        f"{want_ts:.2f} / {want_tl:.0f}; hr_sleep's spin margin on this host {margin_ns} ns); "
        f"completed={completed}/{len(reqs)} "
        f"cpu={stats.cpu_fraction:.3f}; after serving rho {ctl.rho:.3f}, T_S "
        f"{ctl.t_short_us:.2f} us, T_L {ctl.t_long_us:.0f} us; launches {launches}, flash "
        f"attention by route {by_route}")
    log(f"  main path (calibration) took {time.perf_counter() - t0:.1f} s")
    return {"launches": launches["adaptive_sweep"], "build_s": build_s,
            "table": [dataclasses.asdict(p) for p in table.points]}


# -- S3: the fleet sweep (runtime/fleet.py's lax.scan) ------------------------

# benchmarks/fleet.py's full mode (:40-56, :83-125, :147-169): rho 0.5 a host,
# T_S 12 us, T_L 500 us, M 3, the noisy cluster's stall windows, the hedge
# ladder, 60 ms of 0.5 us slots at 4, 16 and 64 hosts under three balancers;
# the scale row, 1000 hosts x 8 points over 5 ms of 1 us slots
FLEET_STALLS = dict(stall_rate_per_us=2.5e-4, stall_mean_us=150.0)
FLEET_HEDGES = (0.0, 80.0, 40.0, 20.0)
FLEET_SIZES = (4, 16, 64)
FLEET_US = 60_000.0
FLEET_SCALE_HOSTS, FLEET_SCALE_US = 1000, 5_000.0
# the plain version runs, and the kernel is held to it, over this prefix of
# every phase-3 shape: least-loaded's snapshot (every 400 slots) refreshes
# twice after slot 0
FLEET_PLAIN_SLOTS = 801
FLEET_COUNTERS = ("wakeups", "busy_tries", "cycles", "ts_arms")


def fleet_lbs(n_hosts: int) -> dict:
    """benchmarks/fleet.py's three balancers (:94-101)."""
    from repro_torch.runtime import FleetConfig
    return {"uniform": FleetConfig(n_hosts=n_hosts),
            "weighted": FleetConfig(n_hosts=n_hosts, lb="weighted",
                                    host_weights=tuple(1.0 + 0.5 * (h % 2)
                                                       for h in range(n_hosts))),
            "least-loaded": FleetConfig(n_hosts=n_hosts, lb="least-loaded", lb_stale_us=200.0)}


def fleet_settings():
    """(name, fgrid, cfg, slot_us): benchmarks/fleet.py's simulate_fleet
    calls, uncut: each size x balancer over the hedge ladder, then the scale
    row."""
    from repro_torch.runtime import FleetConfig, FleetGrid, SimRunConfig
    cfg = SimRunConfig(duration_us=FLEET_US, **FLEET_STALLS)
    out = []
    for hosts in FLEET_SIZES:
        for lb, fleet in fleet_lbs(hosts).items():
            out.append((f"H{hosts}/{lb}", FleetGrid.product(
                fleet=fleet, t_s_us=(12.0,), t_l_us=(500.0,), rate_mpps=(0.5 * MU_MPPS * hosts,),
                m=(3,), hedge_deadline_us=FLEET_HEDGES), cfg, 0.5))
    h = FLEET_SCALE_HOSTS
    out.append((f"scale: {h} hosts x 8 points", FleetGrid.product(
        fleet=FleetConfig(n_hosts=h), t_s_us=(12.0,), t_l_us=(500.0,), m=(3,),
        rate_mpps=(0.35 * MU_MPPS * h, 0.55 * MU_MPPS * h), hedge_deadline_us=FLEET_HEDGES),
        SimRunConfig(duration_us=FLEET_SCALE_US, **FLEET_STALLS), 1.0))
    return out


def fleet_points(n_hosts, hedges, scheduled, one_queue):
    """16 points: every (m, n_queues) in 1..4 x 1..4 (one queue throughout
    with ``one_queue``), knobs from a seed, fleet rates; hedge deadlines
    cycle over ``hedges``; with ``scheduled`` every other point on a step
    schedule."""
    from repro_torch.runtime import StepSchedule
    rng = np.random.default_rng(n_hosts)
    pts = []
    for m in (1, 2, 3, 4):
        for q in (1, 2, 3, 4):
            p = dict(t_s_us=float(rng.uniform(4.0, 40.0)),
                     t_l_us=float(rng.uniform(100.0, 600.0)), m=m,
                     n_queues=1 if one_queue else q,
                     rate_mpps=float(rng.uniform(0.2, 0.8) * MU_MPPS * q / 2.0 * n_hosts),
                     seed=int(rng.integers(0, 3)), hedge_deadline_us=hedges[len(pts) % len(hedges)])
            if scheduled and len(pts) % 2:
                p["schedule"] = StepSchedule(times_us=(0.0, 400.0), scales=(0.4, 1.5))
            pts.append(p)
    return pts


def fleet_compare_cases():
    """(name, fgrid, cfg, slot_us): S3 against its plain version.  Every
    noise family (overshoot noise and tail, interference, stall windows),
    queues of 64 packets so that drops happen, hedge deadlines 0, 20 and 80
    cycling over the points, every other point on a step schedule: 1 host
    (a lone lane; its duplicates come back to it), 3 (weighted, a
    bottleneck link), 4 (least-loaded refreshing every 10 slots, both
    builds), 33 (least-loaded, link: two warps), 64 (uniform, link), each
    over 2,000 slots (1,000 at 33 hosts), and 1,500 hosts (more than a
    block's 256 lanes: six hosts a lane, their states in global scratch)
    over 300 slots; m x n_queues 1-4 (<4, 4>) or one queue a point (<4, 1>,
    the build of benchmarks/fleet.py's grids)."""
    from repro_torch.runtime import FleetConfig, FleetGrid, SimRunConfig, SleepModel
    tail = SleepModel(base_us=2.8, slope=0.027, sigma_us=0.5, tail_prob=0.01,
                      tail_mean_us=40.0)
    noisy = dict(BAND_NOISY, stall_rate_per_us=1.0 / 400.0)
    link = dict(near_cost_us=1.0, far_cost_us=5.0)
    cases = []
    for hosts, kw, slots, one_queue in (
            (1, dict(near_cost_us=2.0), 2_000, True),
            (3, dict(lb="weighted", host_weights=(1.0, 2.0, 3.0), far_fraction=0.34,
                     link_rate_mpps=10.0, **link), 2_000, False),
            (4, dict(lb="least-loaded", lb_stale_us=5.0), 2_000, True),
            (4, dict(lb="least-loaded", lb_stale_us=5.0), 2_000, False),
            (33, dict(lb="least-loaded", lb_stale_us=5.0, far_fraction=0.5,
                      link_rate_mpps=300.0, **link), 1_000, False),
            (64, dict(far_fraction=0.25, link_rate_mpps=400.0, **link), 2_000, True),
            (1_500, dict(lb="least-loaded", lb_stale_us=2.0, far_fraction=0.5,
                         link_rate_mpps=10_000.0, **link), 300, False)):
        cfg = SimRunConfig(duration_us=0.5 * slots, sleep_model=tail, queue_capacity=64,
                           **noisy)
        fleet = FleetConfig(n_hosts=hosts, **kw)
        name = (f"{hosts} host{'s' if hosts > 1 else ''}, {fleet.lb}"
                f"{', link' if fleet.link_rate_mpps else ''}, "
                f"{'one queue' if one_queue else 'm x n_queues 1-4'}, {slots} slots")
        cases.append((name, FleetGrid.of_points(
            fleet_points(hosts, (0.0, 20.0, 80.0), True, one_queue), fleet=fleet), cfg, 0.5))
    return cases


def phase_compare_fleet() -> dict:
    """S3 against its plain version on the card (``fleet_compare_cases``):
    every output bit-equal (the same float32 operations in the same order,
    the host sums in the kernel's tree, no fma contraction, the same math
    library).  Then the per-host rule on the card: with uniform shares and
    topology and hedging off, host h of a point seeded s equals S1's kernel
    at seed s + h and rate float32(rate) x float32(1/H), every output bit
    for bit, at 4 and 33 hosts.  Returns the max abs error and the builds
    compared."""
    from repro_torch.kernels.fleet_sweep import fleet_sweep, reference_fleet_sweep
    from repro_torch.kernels.fleet_sweep.ops import STAT_NAMES as FLEET_STATS
    from repro_torch.kernels.slot_sweep import slot_sweep
    from repro_torch.kernels.slot_sweep.ops import STAT_NAMES
    from repro_torch.runtime import FleetConfig, FleetGrid, SimRunConfig, SweepGrid
    from repro_torch.runtime.batched import sweep_inputs
    from repro_torch.runtime.fleet import fleet_inputs
    t0 = time.perf_counter()
    log("phase 2: fleet_sweep (S3) vs plain version: 1, 3, 4, 33, 64 hosts over 1,000-2,000 "
        "slots and 1,500 hosts over 300, each balancer, topology, hedge deadlines 0/20/80, "
        "every noise family, schedules, m x n_queues 1-4 and one queue; every output "
        "bit-equal; then the per-host rule against S1's kernel")
    fleet_sweep.launches = 0
    fleet_sweep.launches_by_build = {}
    cases = fleet_compare_cases()
    max_abs, failed = 0.0, []
    for name, fgrid, cfg, slot_us in cases:
        args, params, fparams = fleet_inputs(fgrid, cfg, slot_us, "cuda")
        before = dict(fleet_sweep.launches_by_build)
        out = fleet_sweep(*args, params=params, fleet=fparams)
        (build,) = [b for b, n in fleet_sweep.launches_by_build.items()
                    if n != before.get(b, 0)]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        ref = reference_fleet_sweep(*args, params, fparams)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t1
        exact = [k for k in FLEET_STATS if torch.equal(out[k], ref[k])]
        finite = all(bool(torch.isfinite(out[k]).all()) for k in FLEET_STATS)
        abs_err = max(float((out[k].double() - ref[k].double()).abs().max()) for k in FLEET_STATS)
        hedged = float(out["hedge_dup"].sum())
        ok = len(exact) == len(FLEET_STATS) and finite and float(out["wakeups"].sum()) > 0
        log(f"  {name}: {len(fgrid)} points x {fparams.n_hosts} hosts, build <{build[0]}, "
            f"{build[1]}>, flags {params.flags}, {params.live_slots()} slots: max_abs_err="
            f"{abs_err:.3e}; bit-equal: {len(exact)} of {len(FLEET_STATS)} outputs"
            f"{'' if len(exact) == len(FLEET_STATS) else ' ' + str(sorted(set(FLEET_STATS) - set(exact)))}"
            f"; hedge_dup {hedged:.1f}, topo_area {float(out['topo_area'].sum()):.1f}; plain "
            f"{plain_s:.2f} s {'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(name)
        max_abs = max(max_abs, abs_err)
    builds = set(fleet_sweep.launches_by_build)
    if fleet_sweep.launches != len(cases) or builds != {(4, 1), (4, 4)}:
        fail(f"fleet_sweep counted {fleet_sweep.launches} launches "
             f"({fleet_sweep.launches_by_build}) for {len(cases)} calls of two builds")
    # the per-host rule: S3's host h is S1 at seed s + h
    noisy = SimRunConfig(duration_us=1_000.0, queue_capacity=64,
                         **dict(BAND_NOISY, stall_rate_per_us=1.0 / 400.0))
    for hosts in (4, 33):
        pts = fleet_points(hosts, (0.0,), True, False)
        fgrid = FleetGrid.of_points(pts, fleet=FleetConfig(n_hosts=hosts))
        args, params, fparams = fleet_inputs(fgrid, noisy, 0.5, "cuda")
        out = fleet_sweep(*args, params=params, fleet=fparams)
        share = np.float32(1.0 / hosts)
        rows = SweepGrid.of_points([
            dict(p, seed=p["seed"] + h, rate_mpps=float(np.float32(p["rate_mpps"]) * share))
            for p in pts for h in range(hosts)])
        s1_args, s1_params = sweep_inputs(rows, noisy, 0.5, "cuda")
        s1 = slot_sweep(*s1_args, params=s1_params)
        same = [k for k in STAT_NAMES if torch.equal(out[k].flatten(), s1[k])]
        log(f"  per-host rule at {hosts} hosts ({len(pts)} points, m x n_queues 1-4, "
            f"schedules, noisy, {params.live_slots()} slots): S3 host h == S1 at seed s + h on "
            f"{len(same)} of {len(STAT_NAMES)} outputs "
            f"{'ok' if len(same) == len(STAT_NAMES) else 'FAIL'}")
        if len(same) != len(STAT_NAMES):
            failed.append(f"per-host rule at {hosts} hosts")
    # the wrapper checks its bounds: five threads a point is refused
    args, params, fparams = fleet_inputs(cases[0][1], cases[0][2], 0.5, "cuda")
    try:
        fleet_sweep(args[0], args[1], torch.full_like(args[2], 5), *args[3:], params=params,
                    fleet=fparams)
    except ValueError as err:
        log(f"  m=5 refused: {err}")
    else:
        fail("fleet_sweep took m=5")
    if failed:
        fail(f"fleet_sweep disagrees with its plain version or S1 ({'; '.join(failed)})")
    log(f"  phase 2 (fleet_sweep) took {time.perf_counter() - t0:.1f} s")
    return {"max_abs_err": max_abs, "builds": builds}


def fleet_bound(args, params, fparams, out) -> dict:
    """Least time for a fleet sweep's work on the card, counted from the code
    (csrc/fleet_sweep.cu) for this run's points, hosts and slots: each
    (point, host) as a point of S1's count (``sweep_bound``: its draws and
    its slot body), plus the cross-host stages' operations a host-slot.
    Least-loaded: the softmax's negation, product, subtraction and max (4),
    its exp (1 special-function operation), its sum (1), the share's
    division (a reciprocal and 4 float32) and product (1), the two
    reductions' tree (2), the snapshot's queue sum every stale_every slots;
    topology: the rack delay's product and sum (2), the far rack's sum and
    the b1 reduction's tree (2), and, a point-slot, the link's product,
    subtraction, max and division (1 special-function operation and 7);
    hedging, at points with a deadline: the gate's product, subtraction and
    division (1 + 6), exp (1), sum and division (1 + 5), the duplicates'
    products, sum and argmin (4) and the second reduction's tree (2), and,
    a point-slot, the injection into two hosts' queues (8 a queue).  Bytes:
    each input read once (8 words a point, its schedule rows, H shares),
    each output written once (14 words a host)."""
    n_pts, n_h = out["offered"].shape
    m = args[2].repeat_interleave(n_h)
    q = args[3].repeat_interleave(n_h)
    rows_out = {"ts_arms": out["ts_arms"].flatten(), "busy_tries": out["busy_tries"].flatten(),
                "win": torch.empty(0)}
    s1 = sweep_bound([None, None, m, q, None, None, None, None, None], params, rows_out)
    ops = dict(s1["ops"])
    n = float(params.live_slots())
    host_slots = n_pts * n_h * n
    hedged = float((args[7] > 0).sum()) * n_h * n
    f32 = sfu = 0.0
    if fparams.lb_code == 2:
        f32 += host_slots * (4 + 1 + 4 + 1 + 2 + float(q.double().mean()) / fparams.stale_every_slots)
        sfu += host_slots * 2
    if fparams.topo_on or hedged:
        f32 += host_slots * 2
    if fparams.topo_on:
        f32 += host_slots * 2
        if fparams.link_on:
            f32 += n_pts * n * 7
            sfu += n_pts * n
    f32 += hedged * (6 + 5 + 4 + 2) + float((args[7] > 0).sum()) * n * 8 * float(args[3].double().mean()) * 2
    sfu += hedged * 3
    ops["f32"] += f32
    ops["sfu"] += sfu
    nbytes = 4.0 * (8 * n_pts + 14 * n_pts * n_h + n_h)
    if args[8] is not None:
        nbytes += 4.0 * (args[8].numel() + args[9].numel())
    times = {"f32": ops["f32"] / PEAK_F32_OPS * 1e3,
             "int32": ops["int32"] / PEAK_INT32_OPS * 1e3,
             "cvt": ops["cvt"] / PEAK_SFU_OPS * 1e3,
             "sfu": ops["sfu"] / PEAK_SFU_OPS * 1e3,
             "bytes": nbytes / PEAK_BYTES_PER_S * 1e3}
    worst = max(times, key=times.get)
    per = {k: v / host_slots for k, v in (*ops.items(), ("bytes", nbytes))}
    return {"bound_ms": times[worst], "bound_by": "bytes" if worst == "bytes" else "operations",
            "bound_resource": worst, "bound_times_ms": times, "host_slots": host_slots,
            "per_host_slot": per}


def phase_time_fleet(compared: set, compared_s1: set) -> list[dict]:
    """S3 at benchmarks/fleet.py's shapes, uncut (``fleet_settings``): the
    median of 3 CUDA-event timings of the kernel (its first launch of each
    shape is phase 2's or its predecessor's: every launch after the build
    is warm), each behind the device-side spin; host-slots per second; the
    bound (``fleet_bound``); the kernel against its plain version on the
    same inputs with the duration cut to the first ``FLEET_PLAIN_SLOTS``
    slots, every output bit-equal (the main path's shapes, balancers and
    stall windows, which phase 2's cases do not take), the plain version's
    time from that one call; for the uniform rows S1 (``slot_sweep``) on
    the same P x H rows as independent points (what the hosts cost without
    the balancer, topology and hedging stages: their rates differ from the
    fleet's by the rounding of float32(rate) x float32(1/H) alone).  There
    is no PyTorch call that computes a sweep.  Returns the rows, each with
    its outputs for the main path's cross-check."""
    from repro_torch.kernels.fleet_sweep import fleet_sweep, reference_fleet_sweep
    from repro_torch.kernels.fleet_sweep.ops import STAT_NAMES as FLEET_STATS
    from repro_torch.kernels.slot_sweep import slot_sweep
    from repro_torch.runtime import SweepGrid
    from repro_torch.runtime.batched import sweep_inputs
    from repro_torch.runtime.fleet import fleet_inputs
    t0 = time.perf_counter()
    log("phase 3: fleet_sweep (S3) at benchmarks/fleet.py's shapes, uncut: kernel median of 3 "
        "CUDA-event timings; the kernel bit-equal to its plain version over the first "
        f"{FLEET_PLAIN_SLOTS} slots, the plain version timed there; S1 on the same host rows "
        "(uniform rows); bound from the code's operations (fleet_bound)")
    rows = []
    for name, fgrid, cfg, slot_us in fleet_settings():
        args, params, fparams = fleet_inputs(fgrid, cfg, slot_us, "cuda")
        fleet_sweep.launches = 0
        fleet_sweep.launches_by_build = {}
        ms, out = time_ms(fleet_sweep, *args, iters=3, warmup=0, return_out=True,
                          params=params, fleet=fparams)
        cut = dataclasses.replace(params, duration_us=FLEET_PLAIN_SLOTS * slot_us)
        if fparams.lb_code == 2 and (cut.live_slots() - 1) // fparams.stale_every_slots < 2:
            fail(f"{name}: {cut.live_slots()} slots refresh least-loaded's snapshot fewer than "
                 "twice after slot 0")
        kern = fleet_sweep(*args, params=cut, fleet=fparams)
        if fleet_sweep.launches != 4:
            fail(f"{name}: fleet_sweep counted {fleet_sweep.launches} launches for 4 calls")
        (build,) = fleet_sweep.launches_by_build
        check_builds_compared(name, compared, fleet_sweep)
        plain_ms, plain = time_ms(reference_fleet_sweep, *args, cut, fparams, iters=1,
                                  warmup=0, return_out=True)
        differ = [k for k in FLEET_STATS if not torch.equal(kern[k], plain[k])]
        if differ or float(kern["wakeups"].sum()) <= 0:
            fail(f"{name}: fleet_sweep differs from its plain version over {cut.live_slots()} "
                 f"slots on {differ}")
        b = fleet_bound(args, params, fparams, out)
        n_live = params.live_slots()
        rate = b["host_slots"] / (ms / 1e3)
        s1_ms = None
        if fparams.lb_code == 0:
            n_h = fparams.n_hosts
            share = np.float32(1.0 / n_h)
            grid = SweepGrid.of_points([
                dict(fgrid.grid.point(i), seed=int(fgrid.grid.seed[i]) + h,
                     rate_mpps=float(np.float32(fgrid.grid.rate_mpps[i]) * share))
                for i in range(len(fgrid)) for h in range(n_h)])
            s1_args, s1_params = sweep_inputs(grid, cfg, slot_us, "cuda")
            slot_sweep.launches_by_build = {}
            s1_ms = time_ms(slot_sweep, *s1_args, params=s1_params, iters=3, warmup=1)
            check_builds_compared(f"{name} (S1)", compared_s1)
        rows.append({
            "name": name, "ms": ms, "plain_ms": plain_ms, "plain_slots": cut.live_slots(),
            "library_ms": None, "launches": 1, "bound_ms": b["bound_ms"],
            "bound_by": b["bound_by"], "bound_resource": b["bound_resource"],
            "host_slots_per_s": rate, "build": f"<{build[0]}, {build[1]}>", "s1_ms": s1_ms,
            "shape": f"{len(fgrid)} points x {fparams.n_hosts} hosts x {n_live} slots of "
                     f"{slot_us} us, lb {fgrid.fleet.lb}, hedge {list(FLEET_HEDGES)}, stalls; "
                     f"plain_ms over the first {cut.live_slots()} slots",
            "out": out})
        log(f"  {name}: {len(fgrid)} points x {fparams.n_hosts} hosts x {n_live} slots, build "
            f"<{build[0]}, {build[1]}>: kernel {ms:.3f} ms ({rate:.4e} host-slots/s, "
            f"{1e3 * ms / n_live:.3f} us a slot); bit-equal to the plain version over "
            f"{cut.live_slots()} slots on {len(FLEET_STATS)} of {len(FLEET_STATS)} outputs, "
            f"hedge_dup {float(kern['hedge_dup'].sum()):.1f}; plain {plain_ms:.1f} ms measured for "
            f"{cut.live_slots()} slots ({plain_ms * n_live / cut.live_slots() / 1e3:.0f} s "
            f"scaled to {n_live} slots, not measured); "
            + (f"S1 on the {len(fgrid) * fparams.n_hosts} host rows {s1_ms:.3f} ms "
               f"(S3 {ms / s1_ms:.2f}x); " if s1_ms else "")
            + f"library none; bound {b['bound_ms'] * 1e3:.2f} us ({b['bound_resource']}; "
            + ", ".join(f"{k} {v * 1e3:.2f} us" for k, v in b["bound_times_ms"].items())
            + f"), {100 * b['bound_ms'] / ms:.4f}% of it; per host-slot " + ", ".join(
                f"{k} {v:.3g}" for k, v in b["per_host_slot"].items()))
    log(f"  phase 3 (fleet_sweep) took {time.perf_counter() - t0:.1f} s")
    return rows


def check_fleet_identities(name: str, fs, em) -> None:
    """The exact identities of a fleet sweep at every (point, host), to
    float32 rounding: energy = active power x awake + per-arm charges;
    counters whole numbers; no duplicates where a point does not hedge and
    no network delay without a topology; every output finite."""
    rel = max(SWEEP_RTOL, float(fs.n_steps.max()) * 2.0 ** -24)
    arm_s = np.array([em.arm_energy_uj(t) for t in fs.fgrid.grid.t_s_us])[:, None]
    arm_l = np.array([em.arm_energy_uj(t) for t in fs.fgrid.grid.t_l_us])[:, None]
    pred = em.active_power_w * fs.awake_us + fs.ts_arms * arm_s + fs.busy_tries * arm_l
    f = fs.fgrid.fleet
    checks = {
        "energy": bool(np.all(np.abs(fs.energy_uj - pred) <= rel * np.maximum(pred, 1.0))),
        "counts": all(np.array_equal(getattr(fs, k), np.round(getattr(fs, k)))
                      for k in FLEET_COUNTERS),
        "hedge": bool(np.all(fs.hedge_dup[fs.fgrid.hedge_deadline_us <= 0] == 0.0)),
        "topology": bool(f.near_cost_us or f.far_cost_us or f.link_rate_mpps
                         or np.all(fs.topo_area == 0.0)),
        "finite": all(bool(np.isfinite(getattr(fs, k)).all()) for k in (
            "offered", "serviced", "dropped", "awake_us", "lat_area", "energy_uj",
            "hedge_dup", "topo_area")),
        "shape": fs.serviced.shape == (len(fs.fgrid), f.n_hosts)}
    if not all(checks.values()):
        fail(f"{name}: the fleet sweep breaks an exact identity: {checks}")


def phase_fleet_band(compared: set) -> None:
    """tests/test_fleet.py::test_fleet_matches_merged_event_engine_hosts at
    its 60 ms on the card: a uniform fleet of 4 hosts (seed 5, 0.4 mu a
    host, slots of 0.5 us) against the ``RunStats.merge_all`` of 4 runs of
    the port's event engine at rate/4 (seeds 5..8), in the quiet bands:
    mean sojourn within max(1.5 us, 12%), fleet cores within 4 x (0.02 +
    5% a host), loss under 1e-3 on both sides; with shard=False and True,
    which must agree bit for bit (one device)."""
    from repro_torch.core import MetronomeConfig
    from repro_torch.kernels.fleet_sweep import fleet_sweep
    from repro_torch.runtime import (
        FleetConfig,
        FleetGrid,
        MetronomePolicy,
        SimRunConfig,
        simulate_fleet,
        simulate_fleet_run,
    )
    t0 = time.perf_counter()
    hosts, seed, rate_h = 4, 5, 0.4 * MU_MPPS
    cfg = SimRunConfig(duration_us=60_000.0)
    fgrid = FleetGrid.product(fleet=FleetConfig(n_hosts=hosts), t_s_us=(12.0,),
                              t_l_us=(500.0,), m=(3,), rate_mpps=(rate_h * hosts,),
                              seeds=(seed,))
    fleet_sweep.launches_by_build = {}
    runs = [simulate_fleet(fgrid, cfg, slot_us=0.5, shard=shard) for shard in (False, True)]
    check_builds_compared("the fleet band", compared, fleet_sweep)
    if not all(np.array_equal(getattr(runs[0], k), getattr(runs[1], k))
               for k in ("serviced", "lat_area", "awake_us", "energy_uj")):
        fail("simulate_fleet(shard=True) differs from shard=False on one device")
    fs = runs[0]
    check_fleet_identities("the fleet band", fs, cfg.energy_model)
    events = simulate_fleet_run(
        lambda h: MetronomePolicy(MetronomeConfig(m=3, v_target_us=12.0, t_long_us=500.0,
                                                  ts_min_us=1.0), adaptive=False),
        rate_h * hosts, cfg, FleetConfig(n_hosts=hosts))
    merged = events[0].merge_all(events[1:])
    lat_f, lat_e = float(fs.mean_latency_us[0]), merged.mean_sojourn_us
    cpu_f, cpu_e = float(fs.total_cpu_cores[0]), merged.cpu_fraction
    loss_f, loss_e = float(fs.loss_fraction[0]), merged.loss_fraction
    lat_band, cpu_band = max(1.5, 0.12 * lat_e), hosts * (0.02 + 0.05 * cpu_e / hosts)
    ok = (abs(lat_f - lat_e) <= lat_band and abs(cpu_f - cpu_e) <= cpu_band
          and loss_f < 1e-3 and loss_e < 1e-3)
    log(f"band phase (S3): fleet of {hosts} hosts vs the merged event engine at 60 ms: mean "
        f"sojourn {lat_f:.3f} vs {lat_e:.3f} us ({abs(lat_f - lat_e) / lat_band:.2f} of the "
        f"band), cores {cpu_f:.4f} vs {cpu_e:.4f} ({abs(cpu_f - cpu_e) / cpu_band:.2f} of the "
        f"band), loss {loss_f:.2e} vs {loss_e:.2e}; shard=True == shard=False; "
        f"{time.perf_counter() - t0:.1f} s {'ok' if ok else 'FAIL'}")
    if not ok:
        fail("the fleet sweep leaves the merged event engine's quiet band")


def phase_fleet_main(compared: set, timed: list[dict]) -> dict:
    """The fleet's main path, benchmarks/fleet.py's ``fleet_bench`` (full
    mode) through ``repro_torch.runtime``, with every launch counter set to
    0 just before and read just after: the busy-poll comparator's mean from
    the port's event engine (once), one ``simulate_fleet`` per size x
    balancer over the hedge ladder (60 ms of 0.5 us slots, stall windows),
    the verdict at 64 hosts (the best hedged uniform point burns fewer than
    64 cores with p99.9 at or under the busy-poll fleet's), and the scale
    row; exactly one fleet_sweep launch a ``simulate_fleet`` and no other
    kernel.  Each result equals phase 3's launch of its shape bit for bit
    (the kernel is deterministic), and keeps the exact identities."""
    from repro_torch.kernels import (
        adaptive_sweep,
        decode_attention,
        flash_attention,
        fleet_sweep,
        slot_sweep,
        ssd_scan,
    )
    from repro_torch.runtime import (
        BusyPollPolicy,
        PoissonWorkload,
        hedged_latency_quantile,
        simulate_fleet,
        simulate_run,
    )
    t0 = time.perf_counter()
    log("main path (S3): benchmarks/fleet.py's fleet_bench, full mode, through "
        "repro_torch.runtime.simulate_fleet")
    settings = fleet_settings()
    tail_prob = min(FLEET_STALLS["stall_rate_per_us"] * FLEET_STALLS["stall_mean_us"], 0.5)
    tail_scale = FLEET_STALLS["stall_mean_us"]
    counters = (flash_attention, decode_attention, ssd_scan, slot_sweep, adaptive_sweep,
                fleet_sweep)
    for k in counters:
        k.launches = 0
    fleet_sweep.launches_by_build = {}
    t1 = time.perf_counter()
    busy = simulate_run(BusyPollPolicy(), PoissonWorkload(0.5 * MU_MPPS), settings[0][2])
    busy_mean = float(busy.mean_sojourn_us)
    results, verdicts, rows = [], [], []
    for name, fgrid, cfg, slot_us in settings:
        t2 = time.perf_counter()
        fs = simulate_fleet(fgrid, cfg, slot_us=slot_us)
        results.append((name, fs, time.perf_counter() - t2))
    host_s = time.perf_counter() - t1
    launches = {k.__name__: k.launches for k in counters}
    if launches != {"flash_attention": 0, "decode_attention": 0, "ssd_scan": 0,
                    "slot_sweep": 0, "adaptive_sweep": 0, "fleet_sweep": len(settings)}:
        fail(f"fleet_bench launched {launches}; want one fleet_sweep launch for each of its "
             f"{len(settings)} simulate_fleet calls")
    check_builds_compared("the fleet main path", compared, fleet_sweep)
    for (name, fs, wall), row in zip(results, timed, strict=True):
        check_fleet_identities(name, fs, fs.cfg.energy_model)
        if fs.backend != "fleet_sweep" or not all(
                np.array_equal(getattr(fs, k), row["out"][k].double().cpu().numpy())
                for k in ("serviced", "lat_area", "awake_us", "hedge_dup", "energy_uj")):
            fail(f"{name}: simulate_fleet ({fs.backend}) differs from phase 3's launch")
        n_h = fs.n_hosts
        if name.startswith("scale"):
            ph = len(fs) * n_h
            rows.append(f"{name}: {wall:.3f} s host clock, {ph / wall:.0f} points x hosts/s, "
                        f"{ph * int(fs.cfg.duration_us / fs.slot_us) / wall:.3g} host-slots/s")
            continue
        busy_p999 = hedged_latency_quantile(0.999, np.full(n_h, busy_mean),
                                            hedge_deadline_us=0.0, tail_prob=tail_prob,
                                            tail_scale_us=tail_scale)
        for i in range(len(fs)):
            d = float(fs.fgrid.hedge_deadline_us[i])
            p999 = fs.quantile(i, 0.999)
            rows.append(f"fleet/{name}/D{d:g}: cores {float(fs.total_cpu_cores[i]):.3f}, p999 "
                        f"{p999:.1f} us, mean {float(fs.mean_latency_us[i]):.2f} us, loss "
                        f"{float(fs.loss_fraction[i]):.4f}, offered with hedges "
                        f"{float(fs.offered_with_hedges[i]):.0f}")
            if "/uniform" in name and d > 0.0:
                verdicts.append((n_h, d, float(fs.total_cpu_cores[i]), p999, busy_p999))
    hosts = FLEET_SIZES[-1]
    best = min((v for v in verdicts if v[0] == hosts), key=lambda v: v[3])
    _, best_d, best_cpu, best_p999, busy_p999 = best
    ok = bool(best_cpu < hosts and best_p999 <= busy_p999)
    log(f"  busy-poll mean {busy_mean:.3f} us (event engine, one host at rho 0.5); "
        f"{len(settings)} simulate_fleet calls in {host_s:.2f} s host clock; launches {launches}, "
        f"builds {fleet_sweep.launches_by_build}")
    for line in rows:
        log(f"    {line}")
    log(f"  verdict at {hosts} hosts: best hedged uniform point D={best_d:g} us burns "
        f"{best_cpu:.2f} cores (busy-poll {hosts}) at p99.9 {best_p999:.1f} us (busy-poll "
        f"{busy_p999:.1f} us): {'ok' if ok else 'FAIL'}")
    if not ok:
        fail("the hedged Metronome fleet does not beat the busy-poll fleet on cores and p99.9")
    log(f"  main path (S3) took {time.perf_counter() - t0:.1f} s")
    return {"launches": launches["fleet_sweep"], "host_s": host_s,
            "verdict": {"n_hosts": hosts, "hedge_deadline_us": best_d, "cpu_cores": best_cpu,
                        "p999_us": best_p999, "busy_poll_p999_us": busy_p999}}


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
    s2_cmp = phase_compare_adaptive()
    sweep_rows = phase_time_sweep(sweep_cmp["builds"])
    s2_rows = phase_time_adaptive(s2_cmp["builds"], sweep_cmp["builds"])
    phase_sweep_bands(sweep_cmp["builds"], s2_cmp["builds"])
    sweep_main = phase_sweep_main(sweep_cmp["builds"])
    calibration = phase_calibration_main(served["engine"], s2_cmp["builds"])
    s3_cmp = phase_compare_fleet()
    s3_rows = phase_time_fleet(s3_cmp["builds"], sweep_cmp["builds"])
    phase_fleet_band(s3_cmp["builds"])
    fleet_main = phase_fleet_main(s3_cmp["builds"], s3_rows)
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
    # S2, the event-jump sweep: launches are its main path's (one
    # build_operating_table over sweep_frontier's lattice); its numbers at
    # that grid (quiet), the other sweeps of its phase 3 in "rows"
    row = s2_rows[0]
    extra = ("build", "bound_resource", "point_steps_per_s", "plain_steps", "budget",
             "steps_max", "steps_mean", "warp_longest_over_mean", "lane_busy_share", "s1_ms",
             "s1_slots", "forced_steps")
    s1_extra = ("s1_bound_ms", "s1_bound_by", "s1_plain_ms", "s1_plain_slots")
    kernels.append({
        "name": "adaptive_sweep", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/adaptive_sweep.cu",
        "replaces": "src/repro/runtime/batched_adaptive.py:197",
        "launches": calibration["launches"], "max_abs_err": s2_cmp["max_abs_err"],
        **{k: row[k] for k in keys}, "shape": f"{row['name']}: {row['shape']}",
        **{k: row[k] for k in extra},
        "rows": [{**{k: r[k] for k in ("name", "shape", *keys, *extra)},
                  **{k: r[k] for k in s1_extra if k in r}} for r in s2_rows[1:]]})
    # S3, the fleet sweep: launches are its main path's (fleet_bench: one
    # simulate_fleet a size x balancer, and the scale row); its numbers at
    # the verdict's shape (64 hosts, uniform), the other rows in "rows"
    row = next(r for r in s3_rows if r["name"] == f"H{FLEET_SIZES[-1]}/uniform")
    extra = ("build", "bound_resource", "host_slots_per_s", "plain_slots", "s1_ms")
    kernels.append({
        "name": "fleet_sweep", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fleet_sweep.cu",
        "replaces": "src/repro/runtime/fleet.py:234", "launches": fleet_main["launches"],
        "max_abs_err": s3_cmp["max_abs_err"], **{k: row[k] for k in keys},
        "shape": f"{row['name']}: {row['shape']}", **{k: row[k] for k in extra},
        "verdict": fleet_main["verdict"],
        "rows": [{k: r[k] for k in ("name", "shape", *keys, *extra)} for r in s3_rows
                 if r is not row]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
