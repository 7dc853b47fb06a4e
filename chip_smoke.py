"""Smoke run of the PyTorch port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

Phases, each a hard failure (nonzero exit, no result line):

1. the card (nvidia-smi name and power limit), torch/CUDA versions, and the
   build of every kernel of ``src/repro_torch/kernels`` (flash attention,
   decode attention, SSD chunk scan, the four sweeps; one nvcc per source, in
   parallel), with every kernel's registers and spills (both flash-attention
   kernels, both decode splits, the K3 kernels and the sweeps must not
   spill; the f32 decode split's 12 builds also print their stack frame and
   the blocks an SM the card places, 8 warps);
2. each kernel against its plain PyTorch version on the card, at the
   serving path's shapes (flash attention at each served model's prefill
   widths: gemma-2b, granite-3-8b with GQA group 4, starcoder2-15b with
   group 12, dbrx-132b with group 6, llama4-scout-17b-a16e with group 5 and
   jamba-1.5-large-398b / internvl2-76b with group 8, at S = 16 and every
   serving bucket, and whisper-small's decoder, hd 64, at S = 16, 444 and
   448 in bf16 and f32), the reference test
   sweep's and the full widths of gemma-2b, gemma2-2b and mamba2-370m, with
   the tolerance stated per case;
   flash attention's bf16 cases go to its "wgmma" route and its f32 cases to
   "mma" (split TF32), decode attention's bf16 to its "mma" route and f32 to
   "simt" (one launch: every f32 case twice, bit for bit alike, and a row
   with no visible key gives 0); the SSD scan also against
   its plain version in f64; and each kernel must refuse an input that
   requires grad under grad mode (they have no backward);
3. kernel, plain version and the PyTorch library call (where one computes
   the same function) timed with CUDA events at those shapes (flash
   attention also at the hd-128 models' S=1024 and whisper-small's
   decoder at S=448, bf16 and f32), beside the
   card's bound for the same work, with the achieved TFLOP/s and the share
   of the bound; decode attention's bf16 route also at every piece length
   it can pick, its split and combine apart (torch.profiler), and its f32
   route at three shapes (kernels_bench, gemma-2b and gemma2-2b local in
   f32) with its schedule (blocks, rows and tiles a block, blocks a unit)
   and one kernel a call;
4. nine models at full width (random weights from seed 0, bf16), one at a
   time; seven served through ``Server`` + ``MetronomePolicy`` with the
   kernel route, with every launch counter set to 0 just before and read
   just after: gemma-2b (flash attention 18 per prefill, all on the
   "wgmma" route), granite-3-8b and starcoder2-15b (40 per prefill, after
   the kernel route is held against the sdpa route on prefill logits),
   mamba2-370m (no kernel: after the reference's prefill-then-decode check,
   chunked SSD against the recurrent step, within 5e-2), all four at full
   depth, and, cut in depth only (``SERVED_MODELS``), dbrx-132b at 10 of
   its 40 layers, llama4-scout-17b-a16e at 15 of 48 and the hybrid
   jamba-1.5-large-398b at layers 0-4 of its 72 (one attention layer, four
   Mamba2 layers, three MoE and two dense FFNs; a flash-attention launch
   per attention layer per prefill), each MoE model after one full-width
   MoE layer in f32 is held on the card against a per-token loop (the kept
   set equal to the router's plan on the CPU, within 1e-4 relative) and
   after its route check with the sdpa run's routing replayed; then two
   models the engine does not serve with their inputs (its prefill passes
   only tokens, as the reference's), run through the model's own entry
   points: whisper-small at full depth (the reference's prefill-then-decode
   check in f32 within 2e-2 / 5e-2 on K1's f32 route, then a bf16 prefill
   of 444 tokens and 1,500 encoder frames and 4 greedy decode steps with
   the counters set to 0: K1 12 times, its decoder's self-attention only,
   and the bf16 route check at S=448) and internvl2-76b at 36 of 80 layers
   (a prefill of a 256-position vision prefix and 768 tokens and 4 greedy
   decode steps with the counters set to 0: K1 once a layer; the route
   check on that prefill); decode attention and the SSD scan 0 on every
   route for every model: no model path reaches them, in the reference or
   in the port.  Each model logs its peak memory at init, the times and
   the device-busy share of a prefill and a decode step, and each served
   one its median TTFT, tokens/s and CPU fraction.

Then training (``repro_torch.train``), on the reference's training route
(``attn=None``: no Pallas kernel of the repo has a backward):

- ``phase_train``: gemma-2b at full width and depth (bf16, f32 moments),
  four ``make_train_step`` steps of 2 x 1,024 ``TokenDataset`` tokens at lr
  1e-3 with every launch counter set to 0 just before (K1, K2 and K3
  none), each step's loss, grad norm, CUDA-event time, tokens/s, peak
  memory and share of the bf16 peak, one more step under torch.profiler
  (busy share, kernels a step, the heaviest kernels); finite losses and a
  lower fourth loss than the first; the first step again with remat from
  a snapshot of the same state (loss and parameters within 2e-2, a lower
  peak); a train step on the kernel route raises and launches nothing;
- ``phase_train_loop``: ``train_loop`` end to end in a subprocess
  (``--train-loop``, with ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` and
  deterministic algorithms), mamba2-370m at full width, 8 of its 48
  layers: six steps saved every two, then a run crashed at step 3 and
  rerun, which resumes from step 2 with losses equal bit for bit, its
  final checkpoint (restored on the CPU) equal to the uninterrupted run's
  (restored on the card); the prefetcher thread's CPU seconds beside the
  loop's wall time;
- ``phase_train_entry``: ``repro_torch.launch.train --arch gemma-2b
  --smoke --steps 4`` on the card: exit 0 and a falling loss.

Their numbers are on a ``{"training": ..., "training_loop": ...}`` line
before the kernels line, where K1-K3 carry ``training_launches`` (0).

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
``runtime/batched_adaptive.py`` ``lax.scan``; producer warps make every
step's draws into a ring in shared memory and a consumer warp, a point a
lane, runs the jumps), built in phase 1 (its builds <4, 1> and <4, 4> must
not spill; the ring's layout, ``kernel.layout``, is printed and must fit a
block's shared memory):

- phase 2: the kernel against its plain version, every output bit-equal: m
  1-4 x n_queues 1-4 (and one queue a point) quiet, noisy and scheduled
  with windows and deep C-states, a budget short enough for the tail's
  pacing (forced steps), the main path's grid cut in duration only, 1, 5
  and 33 points, the ring's edges (budgets of C - 1, C, C + 1 and 4 C + 13
  steps, runs cut inside a stage) and the early stop (warps that finish
  more than three stages before the budget's end, one paced lane among
  them); a diverging point reported with its step;
- phase 3: the kernel timed at sweep_frontier's full grid (quiet, noisy) and
  stepping.py's three loads, with the us a step of the longest point,
  beside S1 on the same grid (live steps against
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
``runtime/fleet.py`` ``lax.scan``; one block a point: up to 256 hosts,
producer warps make every host's draws into a ring in shared memory and
consumer warps, a host a lane, run the state machine and the balancer,
link and hedge stages as reductions on a named barrier; beyond, the
scratch route), built in phase 1 (its builds <4, 1> and <4, 4> of both
routes must not spill; the ring's layout is printed at 4-1000 hosts):

- phase 2: the kernel against its plain version, every output bit-equal, at
  1, 3, 4, 33 and 64 hosts over 1,000-2,000 slots and 1,500 hosts (more
  than a block's lanes) over 300: each balancer, the bottleneck link, hedge
  deadlines 0, 20 and 80, every noise family, schedules, m x n_queues 1-4
  and one queue a point; at the ring's edges (1, 5 and 33 hosts over 4C -
  1, 4C and 4C + 1 slots, least-loaded refreshing every 1, 3 and 7 slots);
  and host h of a uniform fleet without topology or hedging equal to S1's
  kernel at seed s + h;
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

Then the fleet sweep by event jumps S3b (``fleet_adaptive_sweep``, the
reference's ``runtime/fleet.py`` ``fleet_step_a``; S3's block layout around
S2's host body: up to 256 hosts producer warps make every host's draws of
every step into a ring in shared memory and consumer warps, a host a lane
(below 32 lanes every host in 32 / W lanes, so no result is broadcast),
run the jumps at one dt a point, the dt's minima, the balancer, link and
hedge stages as reductions on a named barrier; beyond, the scratch route),
built in phase 1 (its builds <4, 1> and <4, 4> of both routes, the ring
route's at each of its 9 lane counts, must not spill; the ring's layout is
printed at 1-1000 hosts and must fit 227 KB with the block's static shared
memory):

- phase 2: the kernel against its plain version, every output bit-equal, at
  1, 3, 4, 33, 64, 256 and 257 hosts over 1,000-2,000 steps (each
  balancer, the link, hedge deadlines 0, 20 and 80, every noise family,
  schedules, m x n_queues 1-4 and one queue a point), runs that stop more
  than three stages before their budget's end (some point of them on a
  stage's first step), slots of 10 us (the budget's tail paces), budgets
  on the ring's stage edges, 33, 48, 63 and 64 hosts (least-loaded
  refreshing every 2 us under hedging, the link without hedging), 5 and 40
  hosts at 5% load with every point hedged (equal backlogs), and the H=64
  least-loaded shape of benchmarks/fleet.py over its first 1,000 steps;
- phase 3: the kernel timed at benchmarks/fleet.py's ten shapes, uncut,
  beside S3a's time on the same shape: live steps against S3a's slots, us a
  step, host-steps/s, its bound; bit-equal to its plain version over each
  shape's first 300 steps, where the plain version is timed;
- the slice's main path: ``fleet_bench`` through ``simulate_fleet(stepping=
  "adaptive")`` (one launch a call, each point's cores, mean latency and
  p99.9 beside S3a's, the verdict at 64 hosts), then tests/test_stepping.py's
  fleet parity grid at its full 30 ms against S3a in the reference's bands.

The second-to-last line is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

    python3 chip_smoke.py --ssd-ab SRC [SRC ...]

times this checkout's SSD scan (``csrc/ssd_scan.cu``) against other sources
with its C interface (a parent commit's, a variant, kept under
``scratch/``) at phase 3's three shapes, launched past the wrapper, in the
order this, SRC1 .. SRCn, SRCn .. SRC1, this: each visit the whole call's
median and each launch's (torch.profiler), the state pass beside its own
bytes bound, and whether y and h_final are bit-equal to this checkout's
(``phase_ssd_source_ab``).

    python3 chip_smoke.py --attention-ab SRC [SRC ...]

does the same for flash attention (``csrc/flash_attention.cu``) at phase
3's shapes and the f32 route at hd 128 and 64: bf16 outputs bit for bit
against this checkout's, f32 outputs each against the plain version at
2e-5 (``phase_attention_source_ab``).

    python3 chip_smoke.py --decode-ab SRC [SRC ...]

does the same for decode attention (``csrc/decode_attention.cu``; a parent
commit's source takes its own scratch layout) at the five
``DECODE_SHAPES``, flushed and warm, each f32 visit's kernels by
torch.profiler and each source's registers, stack frame and spills: bf16
outputs bit for bit against this checkout's, f32 outputs each against the
plain version at 2e-5 and two calls of this checkout's bit for bit, masked
SDPA beside the shapes without a softcap (``phase_decode_source_ab``).

    python3 chip_smoke.py --decode-phases [SRC ...]

builds a copy of this checkout's ``csrc/decode_attention.cu`` (and of each
SRC) with clock64 probes in the f32 route's kernel and prints, at the three
f32 ``DECODE_SHAPES``, each phase's cycles a block (min / median / max, and
the slowest blocks): setup, first tile, each tile's parts, segment ends,
the counts and merges after the walk (``phase_decode_phases``).

    python3 chip_smoke.py --sweep-ab SRC [SRC ...]

times this checkout's sweep kernel against other sources with its C
interface (a parent commit's ``csrc/slot_sweep.cu``, a variant) at phase
3's five sweeps, in the order this, SRC1 .. SRCn, SRCn .. SRC1, this, and
reports whether each gives this kernel's bits (``phase_sweep_source_ab``).

    python3 chip_smoke.py --fleet-ab SRC [SRC ...]

does the same for the fleet sweep kernel (a parent commit's
``csrc/fleet_sweep.cu``, a variant with the same C interface and scratch
layout) at phase 3's ten shapes, uncut (``phase_fleet_source_ab``).

    python3 chip_smoke.py --adaptive-ab SRC [SRC ...]

does the same for the event-jump sweep kernel (a parent commit's
``csrc/adaptive_sweep.cu``, a variant with its C interface
``adaptive_sweep_fwd``) at S2's five phase-3 sweeps, uncut, with each
source's us a step of the longest point (``phase_adaptive_source_ab``).

    python3 chip_smoke.py --fleet-adaptive-ab SRC [SRC ...]

does the same for the fleet sweep by event jumps (a parent commit's
``csrc/fleet_adaptive_sweep.cu``, or a variant with its C interface
``fleet_adaptive_sweep_fwd`` and scratch layout, kept in a directory that
``.gitignore`` lists, such as ``scratch/``) at phase 3's ten shapes, uncut,
launched past the wrapper so that no launch counter moves: each row gives
every source's times, us a step of the longest point, its live and forced
steps, and whether every output is bit-equal to this checkout's
(``phase_fleet_adaptive_source_ab``).  Run one source against a copy of
itself first: that A/A spread is the noise a comparison is read against.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import json
import os
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
# max_len 2048), a gemma2-2b local layer, and kernels_bench's shape, then the
# first two in f32 (name, B, H, KV, hd, T, dtype, window, softcap, pos, q
# scale); q is scaled where a softcap is set so that the logits (std 32)
# reach past it
DECODE_SHAPES = (
    ("gemma-2b decode", 4, 8, 1, 256, 2048, torch.bfloat16, 0, 0.0, (2047, 1024, 7, 1948), 1.0),
    ("gemma2-2b local", 4, 8, 4, 256, 8192, torch.bfloat16, 4096, 50.0, (8191, 4096, 7, 8092),
     32.0),
    ("kernels_bench", 4, 8, 2, 64, 8192, torch.float32, 0, 0.0, (8191, 4096, 7, 8092), 1.0),
    ("gemma-2b decode f32", 4, 8, 1, 256, 2048, torch.float32, 0, 0.0, (2047, 1024, 7, 1948),
     1.0),
    ("gemma2-2b local f32", 4, 8, 4, 256, 8192, torch.float32, 4096, 50.0,
     (8191, 4096, 7, 8092), 32.0),
)
FLUSH_BYTES = 256 << 20      # written between timed launches to empty the 50 MB L2
# K1 at each served model's attention widths (name, H, KV, hd): gemma-2b (MQA,
# hd 256), granite-3-8b (GQA group 4), starcoder2-15b (group 12), dbrx-132b
# (group 6), llama4-scout-17b-a16e (group 5), and jamba-1.5-large-398b and
# internvl2-76b (one shape: group 8), hd 128
SERVED_ATTENTION = (("gemma-2b", 8, 1, 256), ("granite-3-8b", 32, 8, 128),
                    ("starcoder2-15b", 48, 4, 128), ("dbrx-132b", 48, 8, 128),
                    ("llama4-scout-17b-a16e", 40, 8, 128),
                    ("jamba-1.5-large-398b / internvl2-76b", 64, 8, 128))
# whisper-small's decoder self-attention (MHA, hd 64), the only K1 launch of
# its prefill, at the decoder's 448 positions and the check's 444
WHISPER_ATTENTION = ("whisper-small decoder", 12, 12, 64)
WHISPER_SEQ = (444, 448)
# phase 4's models after gemma-2b, one at a time, and the layers each is
# served with: the MoE configs at full width do not fit 80 GB at full depth
# (dbrx-132b 3.26 B parameters a layer, llama4-scout-17b-a16e 2.20 B), so
# they are cut in depth only; jamba-1.5-large-398b (a MoE FFN alone 9.66 B)
# keeps layers 0-4 of its plan: its attention layer, four Mamba2 layers,
# three MoE and two dense FFNs
SERVED_MODELS = (("granite-3-8b", 40), ("starcoder2-15b", 40), ("mamba2-370m", 48),
                 ("dbrx-132b", 10), ("llama4-scout-17b-a16e", 15),
                 ("jamba-1.5-large-398b", 5))
MOE_CHECK_TOKENS = 1024
# internvl2-76b at full width, 36 of its 80 layers (0.856 B parameters a
# layer): its vision path, a 256-position prefix and 768 tokens
INTERNVL2_LAYERS = 36
VISION_TOKENS = 768
# whisper-small at full width and depth: the encoder's 30 s window of 1500
# frames (arXiv:2212.04356), the decoder's 448 positions
WHISPER_FRAMES = 1500


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
    diff = (out.double() - ref.double()).abs()
    ok = bool((diff <= atol + rtol * ref.double().abs()).all()) and bool(torch.isfinite(out).all())
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


def attn_route_bound(b, s, h, kv, hd, flops) -> tuple[float, str]:
    """The f32 route's own least time (ms) and what sets it: every product
    as three TF32 passes at the TF32 peak, or the f32 bytes of
    ``attn_bound``."""
    ops_ms = 1e3 * 3 * flops / PEAK_TF32
    bytes_ms = 1e3 * 4.0 * hd * b * s * (2 * h + 2 * kv) / PEAK_BYTES_PER_S
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


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
    from repro_torch.kernels.fleet_adaptive_sweep import kernel as fas_kernel
    from repro_torch.kernels.fleet_sweep import kernel as fleet_kernel
    from repro_torch.kernels.slot_sweep import kernel as sweep_kernel
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
    builds = {"flash_attention.cu": fa_kernel.build, "decode_attention.cu": da_kernel.build,
              "ssd_scan.cu": ssd_kernel.build, "slot_sweep.cu": sweep_kernel.build,
              "adaptive_sweep.cu": as_kernel.build, "fleet_sweep.cu": fleet_kernel.build,
              "fleet_adaptive_sweep.cu": fas_kernel.build}
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
    for source, names in (("flash_attention.cu", ("flash_fwd_wgmma_bf16", "flash_fwd_mma_f32")),
                          ("decode_attention.cu", ("decode_split_mma_bf16",))):
        kernels = ptxas_kernels(_build.BUILD_INFO[source]["log"])
        for name, (regs, spills, _) in kernels.items():
            log(f"  {name}: {regs} registers, {spills} bytes of spill stores + loads")
        for kernel in names:
            tc = {n: v for n, v in kernels.items() if n.startswith(kernel + "<")}
            if len(tc) != 3 or any(spills for _, spills, _ in tc.values()):
                fail(f"want {kernel} at hd 64, 128 and 256 without spills; ptxas gave {tc}")
    # K2's f32 route: decode_split_f32<hd, heads> at hd 64/128/256 x 1/2/4/8
    # heads a unit, none spilling; its blocks an SM as the card places them
    # (its shared memory allows 8 warps an SM, and its registers must not
    # allow fewer)
    recs = ptxas_records(_build.BUILD_INFO["decode_attention.cu"]["log"])
    want = {f"decode_split_f32<{hd}, {gc}>" for hd in (64, 128, 256) for gc in (1, 2, 4, 8)}
    f32 = {n: r for n, r in recs.items() if n.startswith("decode_split_f32<")}
    lib = da_kernel.build()
    placed = {}
    for name, (regs, spills, _, frame) in sorted(f32.items()):
        hd, gc = (int(x) for x in name[len("decode_split_f32<"):-1].split(", "))
        placed[name] = da_kernel._blocks_per_sm(lib, hd, gc, 0) * hd // 32
        log(f"  {name}: {regs} registers ({65536 // (32 * regs)} warps an SM by registers), "
            f"{spills} bytes of spill stores + loads, {frame} bytes of stack frame; the card "
            f"places {placed[name] * 32 // hd} blocks an SM ({placed[name]} warps)")
    if set(f32) != want or any(r[1] for r in f32.values()) or any(
            w != 8 for w in placed.values()):
        fail(f"want {sorted(want)} without spills, 8 warps an SM each; ptxas gave {f32}, the "
             f"card places {placed}")
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
    # S2: the (M_MAX, Q_MAX) builds <4, 1> and <4, 4>, built with
    # -fmad=false; none may spill.  Their ring of stages is dynamic shared
    # memory, sized per launch by the fields a sweep's noise needs
    # (kernel.layout): at most 227 KB with stalls on (the largest ring)
    kernels = ptxas_kernels(_build.BUILD_INFO["adaptive_sweep.cu"]["log"])
    for name, (regs, spills, smem) in kernels.items():
        log(f"  {name}: {regs} registers, {spills} bytes of spill stores + loads, {smem} "
            "bytes of static shared memory")
    want = {f"adaptive_sweep_kernel<4, {q}>" for q in (1, 4)}
    if set(kernels) != want or any(spills for _, spills, _ in kernels.values()):
        fail(f"want the 2 adaptive_sweep_kernel builds (<4, 1> and <4, 4>), none spilling; "
             f"ptxas gave {kernels}")
    from repro_torch.runtime.batched_adaptive import adaptive_sweep_inputs
    _, grid, cfg, slot_us = adaptive_settings()[0]
    _, params = adaptive_sweep_inputs(grid, cfg, slot_us, "cpu")
    for stalls in (False, True):
        p = dataclasses.replace(params, stall_rate_per_us=2e-4 if stalls else 0.0)
        for q in (1, 4):
            lay = as_kernel.layout(p, q)
            log(f"  adaptive_sweep_kernel<4, {q}> ring, stalls {'on' if stalls else 'off'}: "
                f"{lay}")
            if lay["smem_bytes"] > 232_448:
                fail(f"adaptive_sweep_kernel<4, {q}>'s ring takes {lay['smem_bytes']} B; want "
                     "at most 227 KB")
    # S3: the (M_MAX, Q_MAX) builds <4, 1> and <4, 4> of each route, built
    # with -fmad=false; none may spill.  The ring route (up to 256 hosts, one
    # block a point: consumer and producer warps) and the cluster route (up
    # to 256 K_max hosts, a cluster of 8 such blocks a point, 32 K ring lanes
    # a block, one build per K = 2 .. K_max) take their ring as dynamic
    # shared memory, sized per launch, beside their static shared memory;
    # the scratch route (beyond) none. The cluster route's exchange probe
    # builds beside them
    kernels = ptxas_kernels(_build.BUILD_INFO["fleet_sweep.cu"]["log"])
    for name, (regs, spills, smem) in kernels.items():
        log(f"  {name}: {regs} registers, {spills} bytes of spill stores + loads, {smem} "
            "bytes of static shared memory")
    want = ({f"{k}<4, {q}>" for k in ("fleet_sweep_kernel", "fleet_scratch_kernel")
             for q in (1, 4)}
            | {f"fleet_cluster_kernel<4, {q}, {k}>" for q in (1, 4)
               for k in range(2, fleet_kernel.MAX_HOSTS_PER_LANE + 1)})
    if set(kernels) != want | {"cluster_exchange_probe"} or any(
            spills for _, spills, _ in kernels.values()):
        fail(f"want the {len(want)} fleet sweep builds (fleet_sweep_kernel and "
             f"fleet_scratch_kernel <4, 1> and <4, 4>, fleet_cluster_kernel at each K) and "
             f"cluster_exchange_probe, none spilling; ptxas gave {kernels}")
    static = {r: max(smem for name, (_, _, smem) in kernels.items() if name.startswith(k))
              for r, k in (("ring", "fleet_sweep_kernel"), ("cluster", "fleet_cluster_kernel"),
                           ("scratch", "fleet_scratch_kernel"))}
    stalls = 8   # the stall bit of the source's flags: the largest ring
    top = 256 * fleet_kernel.MAX_HOSTS_PER_LANE
    for hosts in (4, 16, 64, 256, 257, 1000, 1500, top, top + 1):
        lays = {q: fleet_kernel.layout(hosts, q, stalls) for q in (1, 4)}
        log(f"  fleet_sweep layout at {hosts} hosts, stalls on: <4, 1> {lays[1]}, <4, 4> "
            f"{lays[4]}")
        for q, lay in lays.items():
            ring = fleet_kernel.ring_bytes(hosts, q, True)
            route = fleet_kernel.route(hosts)
            if lay["ring_bytes"] != ring or ring + static[route] > 232_448 or (
                    lay["route"] != route) or (ring and lay["stage_slots"] !=
                                               fleet_kernel.STAGE_SLOTS):
                fail(f"fleet_sweep layout {lay} at {hosts} hosts: want the {route} route, the "
                     f"ring of kernel.ring_bytes ({ring} bytes, {fleet_kernel.STAGE_SLOTS} slots "
                     f"a stage) and {static[route]} bytes of static shared memory in 227 KB")
    # S3b: the (M_MAX, Q_MAX) builds <4, 1> and <4, 4> of each route (up to
    # 256 hosts the ring of the event-jump sweep's fields, one ring build
    # for each lane count 2^LW, LW = 0..8; up to 256 K_max the cluster route;
    # beyond, the scratch), built with -fmad=false; none may spill.  The ring
    # with the block's static shared memory must fit 227 KB at every host
    # count
    kernels = ptxas_kernels(_build.BUILD_INFO["fleet_adaptive_sweep.cu"]["log"])
    for name, (regs, spills, smem) in kernels.items():
        log(f"  {name}: {regs} registers, {spills} bytes of spill stores + loads, {smem} "
            "bytes of static shared memory")
    want = ({f"fleet_adaptive_kernel<4, {q}, {lw}>" for q in (1, 4) for lw in range(9)}
            | {f"fleet_adaptive_cluster_kernel<4, {q}, {k}>" for q in (1, 4)
               for k in range(2, fas_kernel.MAX_HOSTS_PER_LANE + 1)}
            | {f"fleet_adaptive_scratch_kernel<4, {q}>" for q in (1, 4)})
    if set(kernels) != want or any(spills for _, spills, _ in kernels.values()):
        fail(f"want the {len(want)} fleet_adaptive_sweep builds (fleet_adaptive_kernel <4, 1> "
             f"and <4, 4> at each of 9 lane counts, fleet_adaptive_cluster_kernel at each K, "
             f"fleet_adaptive_scratch_kernel), none spilling; ptxas gave {kernels}")
    static = {r: max(smem for name, (_, _, smem) in kernels.items() if name.startswith(k))
              for r, k in (("ring", "fleet_adaptive_kernel"),
                           ("cluster", "fleet_adaptive_cluster_kernel"),
                           ("scratch", "fleet_adaptive_scratch_kernel"))}
    top = 256 * fas_kernel.MAX_HOSTS_PER_LANE
    for hosts in (1, 4, 16, 33, 64, 256, 257, 1000, 1500, top, top + 1):
        lays = {q: fas_kernel.layout(hosts, q, stalls) for q in (1, 4)}
        log(f"  fleet_adaptive_sweep layout at {hosts} hosts, stalls on: <4, 1> {lays[1]}, "
            f"<4, 4> {lays[4]}")
        for q, lay in lays.items():
            ring = fas_kernel.ring_bytes(hosts, q, True)
            route = fas_kernel.route(hosts)
            if lay["ring_bytes"] != ring or ring + static[route] > 232_448 or (
                    lay["route"] != route) or (ring and lay["stage_steps"] !=
                                               fas_kernel.STAGE_STEPS):
                fail(f"fleet_adaptive_sweep layout {lay} at {hosts} hosts: want the {route} "
                     f"route, the ring of kernel.ring_bytes ({ring} bytes, "
                     f"{fas_kernel.STAGE_STEPS} steps a stage) and {static[route]} bytes of "
                     "static shared memory in 227 KB")
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
    bytes, static shared memory bytes)} for every kernel of the seven
    sources."""
    return {name: rec[:3] for name, rec in ptxas_records(log_text).items()}


def ptxas_records(log_text: str) -> dict[str, tuple[int, int, int, int]]:
    """As ``ptxas_kernels``, with each kernel's stack frame bytes last."""
    out, name, spills, frame = {}, None, 0, 0
    for ln in log_text.splitlines():
        if m := re.search(r"Compiling entry function '.*?(flash_fwd_\w+?|decode_split_mma_bf16|"
                          r"decode_split_f32|decode_split|decode_combine|ssd_chunk_state|"
                          r"ssd_chunk_out|"
                          r"slot_sweep_kernel|adaptive_sweep_kernel|fleet_sweep_kernel|"
                          r"fleet_scratch_kernel|fleet_cluster_kernel|fleet_adaptive_kernel|"
                          r"fleet_adaptive_scratch_kernel|fleet_adaptive_cluster_kernel)"
                          r"I((?:f|13__nv_bfloat16|S\d*_)*)((?:Li\d+E)+)", ln):
            # a repeated type is a substitution (S<n>_); only bf16 repeats
            types = ["float" if t == "f" else "bf16"
                     for t in re.findall(r"f|13__nv_bfloat16|S\d*_", m.group(2))]
            ints = re.findall(r"Li(\d+)E", m.group(3))
            name, spills, frame = f"{m.group(1)}<{', '.join([*types, *ints])}>", 0, 0
        elif m := re.search(r"Compiling entry function '.*?(ssd_state_pass|"
                            r"cluster_exchange_probe)", ln):
            name, spills, frame = m.group(1), 0, 0
        elif name and (m := re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                                      r"(\d+) bytes spill loads", ln)):
            frame, spills = int(m.group(1)), int(m.group(2)) + int(m.group(3))
        elif name and (m := re.search(r"Used (\d+) registers", ln)):
            smem = re.search(r"(\d+) bytes smem", ln)
            out[name] = (int(m.group(1)), spills, int(smem.group(1)) if smem else 0, frame)
            name = None
    return out


def phase_compare() -> dict[str, float]:
    """Kernel vs plain version; returns the max abs error per route at the
    served models' prefill shapes: ``SERVED_ATTENTION`` in bf16
    ("wgmma"), gemma-2b in f32 ("mma", split TF32), whisper-small's decoder
    (``WHISPER_ATTENTION``) in both."""
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 plain version in full f32
    torch.backends.cudnn.allow_tf32 = False
    log("phase 2: kernel vs plain version (TF32 off for the f32 cases); tolerance: the "
        "reference's, f32 2e-5 and bf16 2e-2 (rounding P to bf16 moves a bf16 output by "
        "about one ulp, ~0.016 at |o| ~ 3; dropping one 64-key tile moves it by ~0.36)")
    gen = torch.Generator("cuda").manual_seed(0)
    # (name, B, S, H, KV, hd, dtype, causal, window, softcap, q scale)
    cases = [(f"{name} prefill", 1, s, h, kv, hd, torch.bfloat16, True, 0, 0.0, 1.0)
             for name, h, kv, hd in SERVED_ATTENTION for s in (16, *SERVE_BUCKETS)]
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
    # f32 edges of the split-TF32 kernel: rows past S and T zero-filled by
    # cp.async, windows that cut its 32-row and 64- or 32-key tiles, logits
    # that the softcap bends (q x4) and that reach past it (q x32, held
    # against the plain version in f64: the f32 one is itself up to ~3e-5
    # off there), the batch stride, an odd count of q tiles (a block of one
    # tile under causal), and each hd without causal
    cases += [("f32 ragged S=100", 1, 100, 4, 2, 64, torch.float32, True, 0, 0.0, 1.0),
              ("f32 ragged S=192, window 100", 1, 192, 8, 2, 128, torch.float32, True, 100, 0.0,
               1.0),
              ("f32 ragged S=200, window 40", 1, 200, 4, 1, 256, torch.float32, True, 40, 0.0,
               1.0),
              ("gemma2-2b window+softcap, q x4, f32", 1, 1024, 8, 4, 256, torch.float32, True,
               256, 50.0, 4.0),
              ("gemma2-2b window+softcap, q x32, f32", 1, 1024, 8, 4, 256, torch.float32, True,
               256, 50.0, 32.0),
              ("f32 B=2", 2, 512, 8, 1, 256, torch.float32, True, 0, 0.0, 1.0),
              ("f32 S=1000, not causal", 1, 1000, 8, 2, 256, torch.float32, False, 0, 0.0, 1.0),
              ("f32 S=800, not causal", 1, 800, 8, 8, 128, torch.float32, False, 0, 0.0, 1.0),
              ("f32 S=300, not causal, window 64", 1, 300, 4, 4, 64, torch.float32, False, 64,
               0.0, 1.0)]
    # whisper-small's decoder (hd 64 MHA) in both types: its served prefill
    # (bf16) and the f32 prefill-then-decode check
    name, h, kv, hd = WHISPER_ATTENTION
    cases += [(f"{name} prefill", 1, s, h, kv, hd, dtype, True, 0, 0.0, 1.0)
              for dtype in (torch.bfloat16, torch.float32) for s in (16, *WHISPER_SEQ)]
    flash_attention.launches_by_route = {"wgmma": 0, "mma": 0}
    route_err = {"wgmma": 0.0, "mma": 0.0}
    for name, b, s, h, kv, hd, dtype, causal, window, cap, q_scale in cases:
        q, k, v = attn_inputs(gen, b, s, h, kv, hd, dtype)
        q = (q_scale * q.float()).to(dtype)
        out = flash_attention(q, k, v, causal=causal, window=window, softcap=cap)
        torch.cuda.synchronize()
        f64 = dtype == torch.float32 and q_scale > 4
        ref = flash_attention_ref(*(x.double() if f64 else x for x in (q, k, v)),
                                  causal=causal, window=window, softcap=cap)
        tol = TOL[dtype]
        ok, err = within(out, ref, **tol)
        f64_note = ""
        if f64:
            plain = flash_attention_ref(q, k, v, causal=causal, window=window, softcap=cap)
            f64_note = (f", plain version in f64 (the f32 one is "
                        f"{float((plain.double() - ref).abs().max()):.3e} from it)")
        log(f"  {name}: B={b} S=T={s} H={h} KV={kv} hd={hd} {str(dtype)[6:]} "
            f"causal={causal} window={window} softcap={cap} q scale {q_scale}: "
            f"max_abs_err={err:.3e} (max|ref| {float(ref.float().abs().max()):.3e}{f64_note}) "
            f"tol atol={tol['atol']} rtol={tol['rtol']} {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"flash_attention disagrees with its plain version ({name}, S={s})")
        if " prefill" in name:
            route = "wgmma" if dtype == torch.bfloat16 else "mma"
            route_err[route] = max(route_err[route], err)
    want = {"wgmma": sum(c[6] == torch.bfloat16 for c in cases),
            "mma": sum(c[6] == torch.float32 for c in cases)}
    if flash_attention.launches_by_route != want:
        fail(f"flash_attention routes {flash_attention.launches_by_route}, want {want}")
    log(f"  launches by route: {flash_attention.launches_by_route}")
    return route_err


def phase_time() -> dict[str, list[dict]]:
    """K1 rows by route: "wgmma" holds gemma-2b's three prefill buckets, a
    gemma2-2b softcap row, the hd-128 models' prefill at S=1024
    (``SERVED_ATTENTION[1:]``) and whisper-small's decoder at S=448, "mma"
    the f32 rows at gemma-2b heads and whisper-small's decoder, whose
    ``bound_ms`` is the route's own (its three TF32 passes at the TF32
    peak), the f32 CUDA-core one beside it (``f32_bound_ms``)."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref
    log("phase 3: flash attention, median of 20 CUDA-event timings after 3 warm-up calls, "
        "each behind a device-side spin (host dispatch not timed), inputs warm in L2")
    gen = torch.Generator("cuda").manual_seed(1)
    # (name, route, S, H, KV, hd, dtype, window, softcap, q scale); causal
    shapes = [(f"gemma-2b prefill S={s}", "wgmma", s, 8, 1, 256, torch.bfloat16, 0, 0.0, 1.0)
              for s in SERVE_BUCKETS]
    shapes += [("gemma2-2b prefill S=1024, local layer (window 4096, softcap 50, q x32)",
                "wgmma", 1024, 8, 4, 256, torch.bfloat16, 4096, 50.0, 32.0),
               ("gemma-2b prefill S=1024 f32", "mma", 1024, 8, 1, 256, torch.float32, 0, 0.0,
                1.0)]
    shapes += [(f"{name} prefill S=1024", "wgmma", 1024, h, kv, hd, torch.bfloat16, 0, 0.0, 1.0)
               for name, h, kv, hd in SERVED_ATTENTION[1:]]
    name, h, kv, hd = WHISPER_ATTENTION
    s = WHISPER_SEQ[-1]
    shapes += [(f"{name} prefill S={s}", "wgmma", s, h, kv, hd, torch.bfloat16, 0, 0.0, 1.0),
               (f"{name} prefill S={s} f32", "mma", s, h, kv, hd, torch.float32, 0, 0.0, 1.0)]
    rows = {"wgmma": [], "mma": []}
    for name, route, s, h, kv, hd, dtype, window, cap, q_scale in shapes:
        q, k, v = attn_inputs(gen, 1, s, h, kv, hd, dtype)
        q = (q_scale * q.float()).to(dtype)
        kw = dict(causal=True, window=window, softcap=cap)
        flash_attention.launches_by_route = {"wgmma": 0, "mma": 0}
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
        bound_ms, bound_by, flops = attn_bound(1, s, h, kv, hd, dtype, causal=True,
                                               window=window)
        row = {"name": name, "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
               "launches": launches, "tflops": flops / ms / 1e9,
               "shape": f"B=1 S=T={s} H={h} KV={kv} hd={hd} {str(dtype)[6:]} causal"}
        f32_bound = ""
        if dtype == torch.float32:
            row.update(f32_bound_ms=bound_ms, f32_bound_by=bound_by,
                       f32_bound_share=bound_ms / ms)
            f32_bound = (f"; f32 CUDA-core bound {bound_ms * 1e3:.2f} us ({bound_by}), "
                         f"{100 * bound_ms / ms:.1f}% of it")
            bound_ms, bound_by = attn_route_bound(1, s, h, kv, hd, flops)
            peak = "3 TF32 passes at the TF32 peak"
        else:
            peak = f"{str(dtype)[6:]} peak"
        row.update(bound_ms=bound_ms, bound_by=bound_by, bound_share=bound_ms / ms)
        rows[route].append(row)
        lib = "none" if lib_ms is None else f"{lib_ms:.4f} ms"
        ratio = "" if lib_ms is None else f", kernel/sdpa {ms / lib_ms:.2f}"
        log(f"  {name} [{route}]: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa {lib}, "
            f"bound {bound_ms * 1e3:.2f} us ({bound_by}, {peak}); "
            f"{flops / ms / 1e9:.1f} TFLOP/s, {100 * bound_ms / ms:.1f}% of the bound"
            f"{f32_bound}{ratio}")
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


def f32_schedule_summary(b, h, kv, hd, t, window, pos, sms) -> str:
    """The f32 route's schedule at these inputs on this card (the wrapper's
    grid, ``kernel.f32_schedule``): blocks, rows and slices a block, blocks
    a unit; fails if a block takes no row."""
    from repro_torch.kernels.decode_attention import kernel as da_kernel
    per_sm = da_kernel._blocks_per_sm(da_kernel.build(), hd, h // kv, 0)
    grid = da_kernel.f32_grid(b, h, kv, t, window, sms, per_sm)
    sched = da_kernel.f32_schedule(list(pos), b=b, h=h, kv=kv, t=t, window=window, grid=grid)
    rows = [sum(g["hi"] - g["lo"] for g in segs) for segs in sched["blocks"]]
    slices = [sum(-(-(g["hi"] - g["lo"]) // da_kernel.SLICE) for g in segs)
              for segs in sched["blocks"]]
    per_unit = [len(c) for c in sched["contributors"] if c]
    if min(rows) == 0:
        fail(f"decode_attention f32: {rows.count(0)} of {grid} blocks take no row")
    return (f"f32 schedule: {grid} blocks ({per_sm} an SM x {sms} SMs), rows a block "
            f"{min(rows)}-{max(rows)}, slices a block {min(slices)}-{max(slices)}, blocks "
            f"(partials) a unit {min(per_unit)}-{max(per_unit)} over {len(per_unit)} units")


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
              *DECODE_SHAPES]
    # f32 edges of the one-launch route: logits past the softcap, two units a
    # kv head (16 heads), heads padded to the unit's 4 or 8 (3 and 6 a
    # group), T not a multiple of 32, a window at hd 256, many short units
    # (blocks across many units), fewer rows than blocks, one unit over the
    # whole grid
    f32 = torch.float32
    cases += [("softcap, q x32", 2, 8, 4, 128, 256, f32, 0, 50.0, None, 32.0),
              ("16 heads a group", 2, 16, 1, 64, 192, f32, 0, 0.0, (191, 70), 1.0),
              ("3 heads a group", 3, 12, 4, 128, 300, f32, 0, 0.0, (299, 5, 150), 1.0),
              ("6 heads a group, T=200", 2, 12, 2, 64, 200, f32, 0, 0.0, (199, 130), 1.0),
              ("window 100 hd 256", 3, 8, 2, 256, 1000, f32, 100, 0.0, (999, 50, 640), 1.0),
              ("64 short rows", 64, 8, 2, 64, 512, f32, 0, 0.0, None, 1.0),
              ("fewer rows than blocks", 4, 4, 1, 128, 64, f32, 0, 0.0, (0, 3, 1, 10), 1.0),
              ("one unit", 1, 8, 1, 256, 16384, f32, 0, 0.0, (16383,), 1.0)]
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
        if dtype == torch.float32:     # the merge's fixed order: the same bits again
            if not torch.equal(out, decode_attention(q, k, v, p, window=window, softcap=cap)):
                fail(f"decode_attention f32 gave other bits on a second call ({name})")
    # a batch row whose pos (-1) leaves no visible key gives 0 (the plain
    # version averages v there); the other rows match it
    q, k, v, p = decode_inputs(gen, 3, 8, 2, 128, 300, torch.float32, (299, -1, 40))
    out = decode_attention(q, k, v, p, window=64)
    ref = reference_decode_attention(q, k, v, p, window=64)
    ok, err = within(out[[0, 2]], ref[[0, 2]], **TOL[torch.float32])
    log(f"  f32 pos=[299, -1, 40] window=64: row 1 all zero {bool((out[1] == 0).all())}, rows "
        f"0 and 2 max_abs_err={err:.3e}")
    if not ok or not bool((out[1] == 0).all()):
        fail("decode_attention f32: a row with no visible key must give 0, the others the "
             "plain version's")
    n_f32 = sum(c[6] == torch.float32 for c in cases)
    want = {route: sum(ROUTES[c[6]] == route for c in cases) for route in ROUTES.values()}
    want["simt"] += n_f32 + 1
    if decode_attention.launches != len(cases) + n_f32 + 1 or (
            decode_attention.launches_by_route != want):
        fail(f"decode_attention counted {decode_attention.launches} launches, by route "
             f"{decode_attention.launches_by_route}, for {len(cases) + n_f32 + 1} calls ({want})")
    log(f"  launches by route: {decode_attention.launches_by_route} (f32 cases twice: bit-equal)")
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
        if dtype == torch.bfloat16:
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
        else:
            log(f"  {name}: {f32_schedule_summary(b, h, kv, hd, t, window, pos, sms)}")
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
            log(f"  {name} [{route}]: {len(by_name)} kernel(s) a call: split {split_ms:.4f} ms, "
                f"combine {combine_ms:.4f} ms (torch.profiler, one warm call)")
            if dtype == torch.float32 and (len(by_name) != 1 or combine_ms):
                fail(f"decode_attention f32 ran {sorted(by_name)}; want one launch a call")
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
        pass_ms, pass_bytes = ssd_pass_bound(b, length, nh, hd, n, chunk)
        rows.append({"name": name, "ms": ms, "plain_ms": plain_ms, "library_ms": None,
                     "bound_ms": route_ms, "bound_by": route_by, "launches": launches,
                     "per_launch_ms": per_launch, "state_pass_bound_ms": pass_ms,
                     "shape": shape})
        if by_name:
            log(f"  {name}: " + ", ".join(f"{k} {t:.4f} ms" for k, t in per_launch.items())
                + f" (torch.profiler, one warm call); the state pass's own bound "
                f"{pass_ms * 1e3:.2f} us ({pass_bytes / 1e6:.2f} MB over "
                f"{PEAK_BYTES_PER_S / 1e12:.2f} TB/s), "
                f"{100 * pass_ms / per_launch['ssd_state_pass']:.1f}% of it")
        log(f"  {name} ({shape}): kernel {ms:.4f} ms, plain {plain_ms:.2f} ms, library none; "
            f"route bound {route_ms * 1e3:.2f} us ({route_by}: {pass_flops / 1e9:.3f} GFLOP of "
            f"TF32 passes and bf16 products, bytes {bytes_ms * 1e3:.2f} us), "
            f"{100 * route_ms / ms:.1f}% of it; f32 CUDA-core bound {f32_ms * 1e3:.2f} us "
            f"({f32_by}) for {flops / 1e9:.3f} GFLOP, {100 * f32_ms / ms:.1f}% of it; "
            f"kernel {flops / ms / 1e9:.2f} TFLOP/s; launches {launches}")
    return rows


def ssd_pass_bound(b, length, nh, hd, n, chunk) -> tuple[float, float]:
    """The state pass's own least time (ms) and bytes: the chunk states
    read and written once in place, the decays read once, h_final written
    once, over the card's memory rate (it does 2 FLOPs an element)."""
    nc = length // chunk
    nbytes = 4.0 * b * nh * (2 * nc * hd * n + nc + hd * n)
    return 1e3 * nbytes / PEAK_BYTES_PER_S, nbytes


SSD_LAUNCHES = ("ssd_chunk_state", "ssd_state_pass", "ssd_chunk_out")


def ssd_launch(args, chunk: int, lib=None):
    """One SSD scan past its wrapper (so that no launch counter moves), for
    ``--ssd-ab``'s comparison of two sources (``lib``, default this
    checkout's): (y, h_final)."""
    from repro_torch.kernels.ssd_scan.kernel import launch_ssd_scan
    x, bmat = args[0], args[3]
    b, _, nh, hd = x.shape
    y = torch.empty_like(x)
    h = torch.empty((b, nh, hd, bmat.shape[-1]), dtype=torch.float32, device="cuda")
    launch_ssd_scan(*args, y, h, chunk=chunk, lib=lib)
    return y, h


def phase_ssd_source_ab(sources: list[str]) -> list[dict]:
    """``--ssd-ab SRC...``: this checkout's ``csrc/ssd_scan.cu`` against
    other sources with its C interface (a parent commit's, a variant), each
    built with the same flags, at phase 3's shapes (``ssd_shapes``).  In the
    order this, SRC1 .. SRCn, SRCn .. SRC1, this (A B B A for one source),
    each visit takes the whole call's median of 20 CUDA-event timings after
    3 warm-ups (behind the spin) and each launch's median over 10 calls
    under torch.profiler, all launched the same way (``ssd_launch``); y and
    h_final of each source are compared bit for bit with this checkout's
    (reported, not required: a variant may compute something else)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
    named = {"this": ssd_kernel._SOURCE, **{s: str(Path(s).resolve()) for s in sources}}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(named)) as pool:
        libs = dict(zip(named, pool.map(ssd_kernel.build, named.values())))
    log(f"ssd A/B: built {len(named)} sources in parallel in {time.perf_counter() - t0:.2f} s")
    for name, source in named.items():
        info = _build.BUILD_INFO[source]
        log(f"  {name}: nvcc {info['seconds']:.2f} s; ptxas "
            f"{ {k: v for k, v in ptxas_kernels(info['log']).items() if 'state_pass' in k} }")
    order = [*named, *reversed(named)]
    gen = torch.Generator("cuda").manual_seed(5)
    rows = []
    for name, b, length, nh, hd, n, chunk, x_dtype, bc_dtype in ssd_shapes():
        args = ssd_inputs(gen, b, length, nh, hd, n, x_dtype, bc_dtype)
        outs = {k: ssd_launch(args, chunk, lib) for k, lib in libs.items()}
        torch.cuda.synchronize()
        equal = {k: torch.equal(outs["this"][0], o[0]) and torch.equal(outs["this"][1], o[1])
                 for k, o in outs.items() if k != "this"}
        times = {k: [] for k in named}
        per_launch = {k: [] for k in named}
        for k in order:
            times[k].append(time_ms(ssd_launch, args, chunk, libs[k]))
            by_name = profile(f"ssd_scan {name} {k}", ssd_launch, args, chunk, libs[k],
                              kernel=("ssd_scan", "ssd_"), calls=10)
            per_launch[k].append({s: sum(t for kn, t in by_name.items() if s in kn)
                                  for s in SSD_LAUNCHES if any(s in kn for kn in by_name)})
        pass_ms, pass_bytes = ssd_pass_bound(b, length, nh, hd, n, chunk)
        log(f"  {name} (B={b} L={length} nh={nh} hd={hd} N={n} chunk={chunk}), order "
            f"{' '.join(order)}; state pass bound {pass_ms * 1e3:.2f} us "
            f"({pass_bytes / 1e6:.2f} MB over {PEAK_BYTES_PER_S / 1e12:.2f} TB/s): " + "; ".join(
                f"{k} call " + ", ".join(f"{t:.4f}" for t in ts) + " ms, by launch " + ", ".join(
                    "/".join(f"{d.get(s, float('nan')):.4f}" for s in SSD_LAUNCHES)
                    for d in per_launch[k]) for k, ts in times.items())
            + f"; y and h_final bit-equal to this: {equal}")
        rows.append({"name": name, "times_ms": times, "per_launch_ms": per_launch,
                     "state_pass_bound_ms": pass_ms, "bit_equal": equal})
    log(f"ssd A/B took {time.perf_counter() - t0:.1f} s")
    return rows


def attention_launch(q, k, v, kw: dict, lib=None):
    """One flash attention past its wrapper (so that no launch counter
    moves), for ``--attention-ab``'s comparison of two sources (``lib``,
    default this checkout's)."""
    from repro_torch.kernels.flash_attention.kernel import launch_flash_attention
    out = torch.empty_like(q)
    launch_flash_attention(q, k, v, out, scale=q.shape[-1] ** -0.5, lib=lib, **kw)
    return out


# --attention-ab's shapes: phase 3's (hd 256, causal) and the f32 route at
# hd 64 and 128: (name, B, S, H, KV, hd, dtype, causal, window, softcap, q scale)
ATTENTION_AB_SHAPES = (
    *((f"gemma-2b prefill S={s}", 1, s, 8, 1, 256, torch.bfloat16, True, 0, 0.0, 1.0)
      for s in SERVE_BUCKETS),
    ("gemma2-2b S=1024 window 4096 softcap 50 q x32", 1, 1024, 8, 4, 256, torch.bfloat16,
     True, 4096, 50.0, 32.0),
    ("gemma-2b prefill S=1024 f32", 1, 1024, 8, 1, 256, torch.float32, True, 0, 0.0, 1.0),
    ("S=1024 H=8 KV=2 hd=128 f32", 1, 1024, 8, 2, 128, torch.float32, True, 0, 0.0, 1.0),
    ("S=1024 H=8 KV=8 hd=64 f32, not causal", 1, 1024, 8, 8, 64, torch.float32, False, 0,
     0.0, 1.0),
)


def phase_attention_source_ab(sources: list[str]) -> list[dict]:
    """``--attention-ab SRC...``: this checkout's ``csrc/flash_attention.cu``
    against other sources with its C interface (a parent commit's, a
    variant), each built with the same flags, at ``ATTENTION_AB_SHAPES``.
    Each is timed as the median of 20 CUDA-event timings after 3 warm-ups
    (behind the spin), in the order this, SRC1 .. SRCn, SRCn .. SRC1, this,
    all launched the same way (``attention_launch``).  bf16 outputs are
    compared bit for bit with this checkout's; f32 outputs, which another
    route rounds otherwise, each against the plain version at 2e-5 (both
    reported, not required: a variant may compute something else)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import flash_attention_ref
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    named = {"this": fa_kernel._SOURCE, **{s: str(Path(s).resolve()) for s in sources}}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(named)) as pool:
        libs = dict(zip(named, pool.map(fa_kernel.build, named.values())))
    log(f"attention A/B: built {len(named)} sources in parallel in "
        f"{time.perf_counter() - t0:.2f} s")
    for name, source in named.items():
        info = _build.BUILD_INFO[source]
        log(f"  {name}: nvcc {info['seconds']:.2f} s; ptxas {ptxas_kernels(info['log'])}")
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 plain version in full f32
    order = [*named, *reversed(named)]
    gen = torch.Generator("cuda").manual_seed(1)
    rows = []
    for name, b, s, h, kv, hd, dtype, causal, window, cap, q_scale in ATTENTION_AB_SHAPES:
        q, k, v = attn_inputs(gen, b, s, h, kv, hd, dtype)
        q = (q_scale * q.float()).to(dtype)
        kw = dict(causal=causal, window=window, softcap=cap)
        outs = {n: attention_launch(q, k, v, kw, lib) for n, lib in libs.items()}
        torch.cuda.synchronize()
        if dtype == torch.bfloat16:
            check = {n: torch.equal(outs["this"], o) for n, o in outs.items() if n != "this"}
            what = "bit-equal to this"
        else:
            ref = flash_attention_ref(q, k, v, **kw)
            check = {n: within(o, ref, **TOL[dtype]) for n, o in outs.items()}
            what = "(within 2e-5 of the plain version, max abs err)"
        times = {n: [] for n in named}
        for n in order:
            times[n].append(time_ms(attention_launch, q, k, v, kw, libs[n]))
        bound_ms, bound_by, flops = attn_bound(b, s, h, kv, hd, dtype, causal=causal,
                                               window=window)
        route = ("" if dtype == torch.bfloat16 else
                 f", route bound {attn_route_bound(b, s, h, kv, hd, flops)[0] * 1e3:.2f} us")
        log(f"  {name}, order {' '.join(order)}: " + "; ".join(
            f"{n} " + ", ".join(f"{t:.4f}" for t in ts) + " ms ("
            f"{flops / statistics.mean(ts) / 1e9:.1f} TFLOP/s)" for n, ts in times.items())
            + f"; {str(dtype)[6:]} bound {bound_ms * 1e3:.2f} us ({bound_by}){route}; {what}: "
            f"{check}")
        rows.append({"name": name, "times_ms": times, "check": check, "bound_ms": bound_ms,
                     "bound_by": bound_by})
    log(f"attention A/B took {time.perf_counter() - t0:.1f} s")
    return rows


def decode_launch(q, k, v, p, kw: dict, lib=None):
    """One decode attention past its wrapper (so that no launch counter
    moves), for ``--decode-ab``'s comparison of two sources (``lib``,
    default this checkout's).  An older source without
    ``decode_f32_blocks_per_sm`` has the two-launch f32 route: its scratch
    holds B*H*ceil(T/piece)*(hd + 2) floats, as its bf16 route's."""
    from repro_torch.kernels.decode_attention import kernel as da_kernel
    out = torch.empty_like(q)
    if lib is None or q.dtype != torch.float32 or hasattr(lib, da_kernel._F32_BLOCKS):
        da_kernel.launch_decode_attention(q, k, v, p, out, scale=q.shape[-1] ** -0.5, lib=lib,
                                          **kw)
        return out
    b, h, hd = q.shape
    t, kv = k.shape[1], k.shape[2]
    piece = da_kernel.piece_len(b, h, kv, t, da_kernel._sm_count(0))
    scratch = torch.empty(b * h * -(-t // piece) * (hd + 2), dtype=torch.float32, device="cuda")
    err = lib.decode_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), p.data_ptr(), out.data_ptr(),
        scratch.data_ptr(), b, t, h, kv, hd, 0, piece, kw["window"], kw["softcap"],
        hd ** -0.5, 0, torch.cuda.current_stream().cuda_stream)
    if err:
        fail(f"decode_attention_fwd of an older source returned {err}")
    return out


def phase_decode_source_ab(sources: list[str]) -> list[dict]:
    """``--decode-ab SRC...``: this checkout's ``csrc/decode_attention.cu``
    against other sources with its C interface (a parent commit's, a
    variant), each built with the same flags, at ``DECODE_SHAPES`` (three
    f32 shapes, two bf16).  Each is timed as the median of 20 CUDA-event
    timings after 3 warm-ups (behind the spin), flushed and warm, in the
    order this, SRC1 .. SRCn, SRCn .. SRC1, this, all launched the same way
    (``decode_launch``); each f32 visit's kernels also by torch.profiler
    (medians of 10 calls).  bf16 outputs are compared bit for bit with this
    checkout's; f32 outputs each against the plain version at 2e-5, and two
    calls of this checkout's bit for bit (reported, not required: a variant
    may compute something else).  Masked SDPA is timed beside the shapes
    without a softcap."""
    import torch.nn.functional as F

    from repro_torch.kernels import _build, reference_decode_attention
    from repro_torch.kernels.decode_attention import kernel as da_kernel
    named = {"this": da_kernel._SOURCE, **{s: str(Path(s).resolve()) for s in sources}}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(named)) as pool:
        libs = dict(zip(named, pool.map(da_kernel.build, named.values())))
    log(f"decode A/B: built {len(named)} sources in parallel in "
        f"{time.perf_counter() - t0:.2f} s")
    for name, source in named.items():
        info = _build.BUILD_INFO[source]
        recs = {k: dict(zip(("registers", "spill_bytes", "smem", "stack_frame"), r))
                for k, r in ptxas_records(info["log"]).items() if "combine" not in k}
        log(f"  {name}: nvcc {info['seconds']:.2f} s; ptxas {recs}")
    order = [*named, *reversed(named)]
    gen = torch.Generator("cuda").manual_seed(7)
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    rows = []
    for name, b, h, kv, hd, t, dtype, window, cap, pos, q_scale in DECODE_SHAPES:
        q, k, v, p = decode_inputs(gen, b, h, kv, hd, t, dtype, pos, q_scale)
        kw = dict(window=window, softcap=cap)
        outs = {n: decode_launch(q, k, v, p, kw, lib) for n, lib in libs.items()}
        again = decode_launch(q, k, v, p, kw, libs["this"])
        torch.cuda.synchronize()
        if dtype == torch.bfloat16:
            check = {n: torch.equal(outs["this"], o) for n, o in outs.items() if n != "this"}
            what = "bit-equal to this"
        else:
            ref = reference_decode_attention(q, k, v, p, window=window, softcap=cap)
            check = {n: within(o, ref, **TOL[dtype]) for n, o in outs.items()}
            what = "(within 2e-5 of the plain version, max abs err)"
        repeat = torch.equal(outs["this"], again)
        times = {n: {"flushed": [], "warm": []} for n in named}
        kernels = {n: [] for n in named}
        for n in order:
            times[n]["flushed"].append(time_ms(decode_launch, q, k, v, p, kw, libs[n],
                                               flush=flush))
            times[n]["warm"].append(time_ms(decode_launch, q, k, v, p, kw, libs[n]))
            if dtype == torch.float32:
                kernels[n].append(profile(f"decode {name} {n}", decode_launch, q, k, v, p, kw,
                                          libs[n], kernel=("decode_attention", "decode_"),
                                          calls=10))
        sdpa = None
        if not cap:
            kpos = torch.arange(t, device="cuda")[None, :]
            mask = kpos <= p.long()[:, None]
            if window:
                mask &= kpos > p.long()[:, None] - window
            sdpa_args = (q[:, :, None], k.transpose(1, 2).contiguous(),
                         v.transpose(1, 2).contiguous())
            sdpa_kw = dict(attn_mask=mask[:, None, None, :], enable_gqa=True)
            sdpa = {"flushed": time_ms(F.scaled_dot_product_attention, *sdpa_args, flush=flush,
                                       **sdpa_kw),
                    "warm": time_ms(F.scaled_dot_product_attention, *sdpa_args, **sdpa_kw)}
        bound_ms, bound_by, visible = decode_bound(b, h, kv, hd, dtype, pos, window)
        log(f"  {name} (B={b} H={h} KV={kv} hd={hd} T={t} {str(dtype)[6:]} window={window} "
            f"softcap={cap}, {visible} visible positions), order {' '.join(order)}: " + "; ".join(
                f"{n} flushed " + ", ".join(f"{x:.4f}" for x in ts["flushed"]) + " warm "
                + ", ".join(f"{x:.4f}" for x in ts["warm"]) + " ms"
                + ("" if not kernels[n] else " (kernels " + ", ".join(
                    "/".join(f"{kn.split('<')[0].split('::')[-1]} {x:.4f}" for kn, x in d.items())
                    for d in kernels[n]) + ")")
                for n, ts in times.items())
            + f"; masked SDPA {sdpa}; bound {bound_ms * 1e3:.2f} us ({bound_by}); {what}: "
              f"{check}; this twice bit-equal: {repeat}")
        rows.append({"name": name, "times_ms": times, "kernels_ms": kernels, "check": check,
                     "repeat_bit_equal": repeat, "sdpa_ms": sdpa, "bound_ms": bound_ms,
                     "bound_by": bound_by})
    log(f"decode A/B took {time.perf_counter() - t0:.1f} s")
    return rows


# --decode-phases: clock64 probes spliced into a copy of the f32 route's
# kernel, (anchor, text put before it); each block's thread 0 writes its
# probes to a device array that ``decode_phases_read`` copies out
_PHASE_PROBES = (
    ("namespace {\n", "__device__ long long g_phase[4096 * 16];\n", 1),
    ("  constexpr int NW = L::NW, THREADS = L::THREADS;\n  constexpr int CPR = HD / 4;",
     "  long long ph[16] = {};\n  const long long ph_start = clock64();\n", 1),
    ("  // the ring's first kStages - 1 slices", "  ph[0] = clock64() - ph_start;\n", 1),
    ("  for (int i = 0; cw.u >= 0; ++i) {",
     "  ph[1] = clock64() - ph_start - ph[0];\n  long long ph_t = clock64();\n", 1),
    ("    if (count_first) {", "    ph[2] += clock64() - ph_t; ph_t = clock64(); ++ph[8];\n", 1),
    ("    cp_async_wait<kStages - 2>();  // this thread's part of the next slice",
     "    ph[3] += clock64() - ph_t; ph_t = clock64();\n", 1),
    ("    // O = O corr + P V: lane = column", "    ph[4] += clock64() - ph_t; ph_t = clock64();\n",
     1),
    ("    if (cw.r + kSlice >= cw.hi) {  // the segment's last slice",
     "    ph[5] += clock64() - ph_t; ph_t = clock64();\n", 1),
    ("    walk_next(cw, un, s_end);\n  }", "    ph[6] += clock64() - ph_t; ph_t = clock64();\n", 1),
    ("  // the merge trees of the (at most two) partials",
     "  ph[7] = clock64() - ph_start; ph_t = clock64();\n", 1),
    ("  // Merge count <= 32 partials", "  ph[9] = clock64() - ph_t; ph_t = clock64();\n", 1),
    ("    __syncthreads();\n    float a[GC];", "    ++ph[10];\n", 1),
    ("  if (lane == 0 && warp < n_parts) {  // merge() ends on a barrier",
     "  ph[11] = clock64() - ph_t; ph_t = clock64();\n", 1),
    ("\n}\n\n// Blocks of decode_split_f32<HD, GC> an SM holds",
     "\n  ph[12] = clock64() - ph_t;\n  ph[13] = clock64() - ph_start;\n"
     "  if (tid == 0 && blockIdx.x < 4096)\n"
     "    for (int z = 0; z < 16; ++z) g_phase[blockIdx.x * 16 + z] = ph[z];", 1),
    ("const char* decode_attention_error_string(int err) {",
     "int decode_phases_read(void* dst, int n) {\n"
     "  return (int)cudaMemcpyFromSymbol(dst, g_phase, sizeof(long long) * 16 * n);\n}\n\n", 1),
)
_PHASE_NAMES = ("setup", "first tile in", "q k + barrier", "softmax + loads issued",
                "wait + barrier", "P V", "segment ends", "walk's end", "tiles", "counts",
                "merges run", "level-1 merges", "level-2 count + merges", "block")


def phase_decode_phases(sources: list[str]) -> list[dict]:
    """``--decode-phases [SRC ...]``: where the f32 route's time goes, block
    by block.  A copy of this checkout's ``csrc/decode_attention.cu`` (and of
    each SRC with the same text at the probes' anchors) gets clock64 probes
    (``_PHASE_PROBES``; a missing anchor fails), is built into ``build/``
    and launched at the three f32 ``DECODE_SHAPES``; each block's thread 0
    writes its cycles in each phase: the setup (pos, the tile scan), the
    first tile's arrival, each tile's q kᵀ, softmax with the next loads'
    issue, the wait for the next tile, P V, the segment ends, the whole walk,
    then the counts and the merges after it, and the whole block.  Prints
    min / median / max over blocks and the slowest blocks' own lines."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.decode_attention import kernel as da_kernel
    rows = []
    gen = torch.Generator("cuda").manual_seed(8)
    for src in [str(_build.CSRC_DIR / da_kernel._SOURCE), *sources]:
        text = Path(src).read_text()
        for anchor, probe, count in _PHASE_PROBES:
            if text.count(anchor) != count:
                fail(f"--decode-phases: {src} has {text.count(anchor)} of the anchor "
                     f"{anchor[:60]!r}, want {count}")
            text = text.replace(anchor, anchor + probe if anchor == "namespace {\n"
                                else probe + anchor)
        copy = _build.BUILD_DIR / f"{Path(src).stem}_phases.cu"
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        copy.write_text(text)
        lib = da_kernel.build(str(copy))
        lib.decode_phases_read.restype = ctypes.c_int
        lib.decode_phases_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
        for name, b, h, kv, hd, t, dtype, window, cap, pos, q_scale in DECODE_SHAPES:
            if dtype != torch.float32:
                continue
            q, k, v, p = decode_inputs(gen, b, h, kv, hd, t, dtype, pos, q_scale)
            kw = dict(window=window, softcap=cap)
            ms = time_ms(decode_launch, q, k, v, p, kw, lib)
            decode_launch(q, k, v, p, kw, lib)
            torch.cuda.synchronize()
            grid = da_kernel.f32_grid(b, h, kv, t, window, da_kernel._sm_count(0),
                                      da_kernel._blocks_per_sm(lib, hd, h // kv, 0))
            buf = np.zeros((grid, 16), np.int64)
            if lib.decode_phases_read(buf.ctypes.data, grid):
                fail("--decode-phases: reading the probes failed")
            stats = {n: [int(x) for x in (buf[:, i].min(), np.median(buf[:, i]), buf[:, i].max())]
                     for i, n in enumerate(_PHASE_NAMES)}
            log(f"  {Path(src).name} {name}: {ms:.4f} ms warm (CUDA events), {grid} blocks; "
                "cycles a block, min/median/max: " + "; ".join(
                    f"{n} {'/'.join(map(str, s))}" for n, s in stats.items()))
            for i in np.argsort(-buf[:, 13])[:3]:
                log(f"    block {i}: " + ", ".join(f"{n} {buf[i, j]}"
                                                for j, n in enumerate(_PHASE_NAMES)))
            rows.append({"source": src, "name": name, "ms": ms, "grid": grid, "cycles": stats})
    return rows


def set_launch_counts_to_zero() -> None:
    """Every kernel wrapper of the serving path (K1, K2, K3) counts from 0."""
    from repro_torch.kernels import decode_attention, flash_attention, ssd_scan
    flash_attention.launches = 0
    flash_attention.launches_by_route = {"wgmma": 0, "mma": 0}
    decode_attention.launches = 0
    decode_attention.launches_by_route = {"mma": 0, "simt": 0}
    ssd_scan.launches = 0


@contextlib.contextmanager
def moe_routing(plans: list, *, replay: bool):
    """Within the block every MoE layer's router (``models.moe._route``)
    appends its choice of experts to ``plans``, or, with ``replay``, takes
    the next choice recorded there, with its gates renormalised over this
    run's own probabilities: a run that replays another's plans routes
    every token to the same experts, and so to the same slots and drops."""
    from repro_torch.models import moe
    route, recorded = moe._route, iter(plans)

    def recording(p, cfg, xf):
        probs, gate, idx = route(p, cfg, xf)
        plans.append(idx)
        return probs, gate, idx

    def replaying(p, cfg, xf):
        probs, _, _ = route(p, cfg, xf)
        idx = next(recorded)
        gate = probs.gather(-1, idx)
        return probs, gate / gate.sum(-1, keepdim=True).clamp_min(1e-9), idx

    moe._route = replaying if replay else recording
    try:
        yield plans
    finally:
        moe._route = route


def routed_apart(plans, ref_plans) -> list[int]:
    """Tokens a layer sends to another set of experts than ``ref_plans``."""
    return [int((a.sort(-1).values != b.sort(-1).values).any(-1).sum())
            for a, b in zip(plans, ref_plans)]


def route_check(model, plain_model, params) -> None:
    """The kernel route against the plain (sdpa) route on the same weights:
    prefill logits at the smallest and largest bucket.  A MoE model's
    kernel run replays the sdpa run's routing (``moe_routing``): top-k is
    discontinuous, and the two attention routes, which round apart by
    about a bf16 ulp, flip the choice of tokens whose top-k margin is
    smaller, a flip that then reaches every later token through attention.
    With free routing each route's distance from sdpa, the kernel's and the
    chunked route's (plain PyTorch), is logged beside the tokens each layer
    routes apart, with no limit."""
    cfg = model.cfg
    moe_model = any(ffn == "moe" for _, ffn in cfg.layer_plan())
    tok_gen = np.random.default_rng(0)
    with torch.no_grad():
        for s in (SERVE_BUCKETS[0], SERVE_BUCKETS[-1]):
            toks = torch.from_numpy(tok_gen.integers(0, cfg.vocab_size, (1, s))).to(model.device)
            if moe_model:
                with moe_routing([], replay=False) as sdpa_plans:
                    lp, _ = plain_model.prefill(params, {"tokens": toks})
                for name, free in (("kernel", model),
                                   ("chunked", type(model)(cfg, attn="chunked",
                                                           device=model.device))):
                    with moe_routing([], replay=False) as plans:
                        lf, _ = free.prefill(params, {"tokens": toks})
                    rel = float((lf - lp).abs().max() / lp.abs().max())
                    top1 = float((lf.argmax(-1) == lp.argmax(-1)).float().mean())
                    log(f"  prefill S={s}, free routing: {name} route vs sdpa route "
                        f"max|diff|/max|logit| {rel:.3e}, top-1 agreement {top1:.4f}; tokens "
                        f"routed apart by layer {routed_apart(plans, sdpa_plans)} (no limit)")
                    del lf
                with moe_routing(sdpa_plans, replay=True):
                    lk, _ = model.prefill(params, {"tokens": toks})
            else:
                lk, _ = model.prefill(params, {"tokens": toks})
                lp, _ = plain_model.prefill(params, {"tokens": toks})
            if lk.shape != (1, s, cfg.vocab_size):
                fail(f"{cfg.name} prefill logits at S={s}: shape {tuple(lk.shape)}")
            route_agreement(cfg, lk, lp, f"prefill S={s}" + (
                " (routing replayed from the sdpa run)" if moe_model else ""))
            del lk, lp


def serve_requests(model, params) -> dict:
    """The slice's main path for one model: an engine with 4 slots and the
    serving buckets, warmed with one request a bucket, then 8 Poisson
    requests at 20/s through ``Server`` + ``MetronomePolicy`` with every
    launch counter set to 0 just before and read just after.  Checks that
    every request completes inside the vocabulary and that K1 launched
    once per attention layer per prefill, all on "wgmma", and K2 and K3 not
    at all; logs TTFT, tokens/s, the CPU fraction, per-bucket prefill and
    per-step decode times, and the device-busy share of a prefill and of a
    decode step."""
    from repro_torch.core import MetronomeConfig
    from repro_torch.kernels import decode_attention, flash_attention, ssd_scan
    from repro_torch.runtime import MetronomePolicy
    from repro_torch.serving import EngineConfig, InferenceEngine, Request, Server

    cfg = model.cfg
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
    set_launch_counts_to_zero()             # counts from the main path only
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
        fail(f"{cfg.name}: not every request completed within 120 s")
    completed = sum(len(r.tokens) == MAX_NEW for r in reqs)
    if completed != len(reqs):
        fail(f"{cfg.name}: completed {completed}/{len(reqs)}")
    if not all(0 <= t < cfg.vocab_size for r in reqs for t in r.tokens):
        fail(f"{cfg.name}: a generated token lies outside the vocabulary")
    attn_layers = sum(m.startswith("attn") for m, _ in cfg.layer_plan())
    want = attn_layers * len(reqs)
    if launches != want:
        fail(f"{cfg.name}: flash_attention launched {launches} times, want {want} "
             f"({attn_layers} per prefill x {len(reqs)} prefills)")
    if by_route != {"wgmma": want, "mma": 0}:
        fail(f"{cfg.name}: flash_attention routes {by_route}: every bf16 prefill launch "
             "must be wgmma")
    if any(other_launches.values()) or any(decode_by_route.values()):
        fail(f"{cfg.name}: the serving path launched {other_launches} (decode attention by "
             f"route {decode_by_route}); no model path reaches them")
    if engine.prefill_tokens - prefills_before != sum(PROMPT_LENS):
        fail(f"{cfg.name}: prefill token count does not match the prompts")
    ttft = statistics.median((r.first_token_ns - r.arrival_ns) / 1e6 for r in reqs)
    tokens = sum(len(r.tokens) for r in reqs)
    log(f"  {cfg.name}: completed={completed}/{len(reqs)} cpu={stats.cpu_fraction:.3f} "
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
            toks = torch.ones((1, n), dtype=torch.long, device=model.device)
            prefill_ms[n] = time_ms(model.prefill, params, {"tokens": toks},
                                    iters=5, warmup=1)
        cache = model.init_cache(4, 2048)
        dtoks = torch.ones(4, dtype=torch.long, device=model.device)
        dpos = torch.full((4,), 1000, dtype=torch.long, device=model.device)
        decode_ms = time_ms(model.decode_step, params, dtoks, cache, dpos,
                            iters=20, warmup=2)
    log("  prefill ms per bucket (CUDA events behind the spin, median of 5): "
        + ", ".join(f"{n}: {ms:.2f}" for n, ms in prefill_ms.items())
        + f"; decode ms per step (4 slots, max_len 2048, median of 20): {decode_ms:.2f}")
    with torch.no_grad():
        toks = torch.ones((1, SERVE_BUCKETS[-1]), dtype=torch.long, device=model.device)
        profile(f"{cfg.name} prefill S={SERVE_BUCKETS[-1]}", model.prefill, params,
                {"tokens": toks})
        profile(f"{cfg.name} decode step (4 slots)", model.decode_step, params, dtoks, cache,
                dpos)
    return {"launches": launches, "by_route": by_route, **other_launches,
            "decode_by_route": decode_by_route, "engine": engine, "completed": completed,
            "cpu_fraction": stats.cpu_fraction, "ttft_ms": ttft,
            "tokens_per_s": tokens / wall_s}


def init_full_width(cfg):
    """``cfg`` on the card with the kernel route, random weights from seed 0.
    Logs the parameter count and the allocator's peak during init."""
    from repro_torch.models import Model
    model = Model(cfg, attn="kernel", device="cuda")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(torch.Generator("cuda").manual_seed(0))
    torch.cuda.synchronize()
    log(f"  init {time.perf_counter() - t0:.2f} s, "
        f"{sum(x.numel() for x in _leaves(params)) / 1e9:.3f} B parameters, "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated on the card, "
        f"peak {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB "
        f"(torch.cuda.max_memory_allocated) of "
        f"{torch.cuda.get_device_properties(0).total_memory / 2**30:.1f} GiB")
    return model, params


def moe_layer_check(cfg) -> dict:
    """One MoE layer of ``cfg`` at full width in f32 (random weights from
    seed 0, ``MOE_CHECK_TOKENS`` tokens of N(0, 1), the published capacity
    factor) through ``moe_apply`` on the card, against a per-token loop on
    the card: for each token, the shared expert (if any) plus, for each of
    its kept assignments, the gate times that expert's GLU (``mlp_apply``
    on the expert's weights, no dispatch buffer).  The plan the card
    routes by (each assignment's expert, slot and whether it is kept) must
    equal the one ``_route_logits`` and ``_positions`` make on the CPU from
    the same router logits, and the output must lie within 1e-4 of the
    loop's, relative to the loop's largest value.  Frees the layer and
    returns the check's numbers."""
    import gc

    from repro_torch.models import moe
    from repro_torch.models.layers import mlp_apply
    torch.backends.cuda.matmul.allow_tf32 = False     # both sides in full f32
    e, k, t, d = cfg.n_experts, cfg.experts_per_token, MOE_CHECK_TOKENS, cfg.d_model
    cap = moe._capacity(cfg, t)
    log(f"  MoE layer in f32 at full width: d_model {d}, {e} experts of d_ff {cfg.d_ff} "
        f"{cfg.mlp_type}, top-{k}, {cfg.n_shared_experts} shared, {t} tokens, capacity "
        f"factor {cfg.capacity_factor} (capacity {cap} an expert)")
    t0 = time.perf_counter()
    p = moe.moe_init(torch.Generator("cuda").manual_seed(0), cfg, torch.float32)
    x = torch.randn((1, t, d), generator=torch.Generator("cuda").manual_seed(1),
                    device="cuda")
    with torch.no_grad():
        y, aux = moe.moe_apply(p, cfg, x)
        xf = x[0]
        logits = xf @ p["router"]
        plans = []
        for on in (logits, logits.cpu()):
            _, gate, idx = moe._route_logits(on, k)
            _, pos = moe._positions(idx, e)
            plans.append((gate, idx.cpu(), pos.clamp_max(cap - 1).cpu(), (pos < cap).cpu()))
        (gate, idx, slot, keep), cpu_plan = plans
        for what, a, b in zip(("expert", "slot", "kept"), (idx, slot, keep), cpu_plan[1:]):
            if not torch.equal(a, b):
                fail(f"{cfg.name}: the card's MoE plan differs from the CPU's in {what} "
                     f"({int((a != b).sum())} of {a.numel()} assignments)")
        keep = keep.view(t, k)
        experts = [{n: p[n][j] for n in ("w_gate", "w_up", "w_down")} for j in range(e)]
        rows = []
        for i, (picks, kept) in enumerate(zip(idx.tolist(), keep.tolist())):
            xi = xf[i:i + 1]
            acc = (mlp_apply(p["shared"], xi, "swiglu") if cfg.n_shared_experts
                   else torch.zeros_like(xi))
            for j in range(k):
                if kept[j]:
                    acc = acc + gate[i, j] * mlp_apply(experts[picks[j]], xi, cfg.mlp_type)
            rows.append(acc)
        ref = torch.cat(rows)
        torch.cuda.synchronize()
    rel = float((y[0] - ref).abs().max() / ref.abs().max())
    dropped = int((~keep).sum())
    record = {"tokens": t, "capacity": cap, "dropped": dropped,
              "tokens_all_dropped": int((~keep.any(1)).sum()), "rel_err": rel,
              "aux": float(aux), "seconds": time.perf_counter() - t0}
    log(f"  moe_apply vs the per-token loop: max|diff|/max|ref| {rel:.3e} (limit 1e-4); "
        f"plan equal to the CPU's; {dropped} of {t * k} assignments dropped "
        f"({record['tokens_all_dropped']} tokens lost every one), aux {float(aux):.4f}; "
        f"{record['seconds']:.1f} s")
    if not (rel <= 1e-4 and y.shape == x.shape and torch.isfinite(aux) and float(aux) >= 0):
        fail(f"{cfg.name}: moe_apply disagrees with the per-token loop on the card")
    del p, x, y, ref, rows, experts, logits
    gc.collect()
    torch.cuda.empty_cache()
    return record


def phase_serve() -> dict:
    from repro_torch.configs import get_config
    from repro_torch.models import Model

    cfg = get_config("gemma-2b")
    log(f"phase 4: serve {cfg.name} at full width ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads} heads, {cfg.n_kv_heads} KV head, head_dim "
        f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.param_dtype}), "
        "random weights from seed 0, attn=kernel")
    model, params = init_full_width(cfg)
    route_check(model, Model(cfg, attn=None, device="cuda"), params)
    return serve_requests(model, params)


def padded_cache(model, pre: dict, length: int) -> dict:
    """A B=1 prefill cache copied into a decode cache of ``length``
    positions: KV leaves at [0, S), state leaves whole; an
    encoder-decoder's cross K/V as prefill made them."""
    encdec = model.cfg.is_encdec
    cache = model.init_cache(1, length)
    for name, leaves in (pre["self"] if encdec else pre).items():
        for leaf, x in leaves.items():
            cache[name][leaf][:, :, :x.shape[2]] = x
    return {"self": cache, "cross": pre["cross"]} if encdec else cache


def prefill_decode_check(model, params, batch: dict, split: int, *,
                         decode_tol: dict) -> dict:
    """The reference's prefill-then-decode check (tests/test_models_smoke.py)
    at full width: forward on the batch's S tokens, prefill on the first
    ``split``, then the next 4 tokens teacher-forced through the decode
    step, prefill's logits against forward's within 2e-2 and each step's
    against forward's at its position within ``decode_tol`` (the
    reference's: 5e-2), from the prefill cache copied into one of S
    positions (``padded_cache``).  Returns the
    largest error of each part, and forward's logits at the decode steps'
    positions (``"forward"``)."""
    cfg = model.cfg
    toks = batch["tokens"]
    s = toks.shape[1]
    worst = {"prefill": 0.0, "decode": 0.0, "decode_top1": 1.0}
    dtype = cfg.compute_dtype
    with torch.no_grad():
        full, _ = model.forward(params, batch)
        pre, pre_cache = model.prefill(params, {**batch, "tokens": toks[:, :split]})
        parts = [("prefill", f"prefill on {split} tokens vs forward on {s}", pre,
                  full[:, :split], dict(atol=2e-2, rtol=2e-2))]
        cache = padded_cache(model, pre_cache, s)
        for i in range(split, split + 4):
            logits, cache = model.decode_step(params, toks[:, i], cache,
                                              torch.full((1,), i, device=model.device))
            parts.append(("decode", f"decode step at position {i} vs forward", logits,
                          full[:, i], decode_tol))
        for part, what, out, ref, tol in parts:
            ok, err = within(out, ref, **tol)
            top1 = float((out.argmax(-1) == ref.argmax(-1)).float().mean())
            worst[part] = max(worst[part], err)
            if part == "decode":
                worst["decode_top1"] = min(worst["decode_top1"], top1)
            log(f"  {dtype}: {what}: max_abs_err={err:.3e} (max|logit| "
                f"{float(ref.abs().max()):.3e}; tol atol={tol['atol']:.3e} rtol={tol['rtol']}) "
                f"top-1 {top1:.3f} {'ok' if ok else 'FAIL'}")
            if not ok:
                fail(f"{cfg.name} {dtype}: {what} outside its band")
    worst["forward"] = full[0, split:split + 4].float()
    return worst


def mamba2_consistency(model, params, *, decode_tol: dict) -> dict:
    """``prefill_decode_check`` on 1024 tokens, prefill on the first 512
    (both multiples of the 256-step chunk)."""
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, model.cfg.vocab_size, (1, 1024))).to(model.device)
    return prefill_decode_check(model, params, {"tokens": toks}, 512, decode_tol=decode_tol)


def launch_counts() -> dict:
    """The serving path's launch counters (K1 and K2 by route, K3)."""
    from repro_torch.kernels import decode_attention, flash_attention, ssd_scan
    return {"flash_attention": dict(flash_attention.launches_by_route),
            "decode_attention": dict(decode_attention.launches_by_route),
            "ssd_scan": ssd_scan.launches}


def check_launches(what: str, counts: dict, *, wgmma: int, mma: int) -> None:
    """K1 launched exactly ``wgmma`` / ``mma`` times, K2 and K3 not at all."""
    if (counts["flash_attention"] != {"wgmma": wgmma, "mma": mma}
            or any(counts["decode_attention"].values()) or counts["ssd_scan"]):
        fail(f"{what}: launches {counts}, want flash_attention "
             f"{{'wgmma': {wgmma}, 'mma': {mma}}} and no decode_attention or ssd_scan")
    log(f"  {what}: launches {counts} (counters set to 0 just before)")


def route_agreement(cfg, lk, lp, what: str) -> dict:
    """The kernel route's logits ``lk`` against the sdpa route's ``lp``:
    max|diff|/max|logit| within 5e-2 and top-1 agreement at least 0.9."""
    if lk.shape != lp.shape or not torch.isfinite(lk).all():
        fail(f"{cfg.name} {what}: shape {tuple(lk.shape)} or not finite")
    rel = float((lk - lp).abs().max() / lp.abs().max())
    top1 = float((lk.argmax(-1) == lp.argmax(-1)).float().mean())
    log(f"  {what}: kernel route vs sdpa route max|diff|/max|logit| {rel:.3e} (limit 5e-2), "
        f"top-1 agreement {top1:.4f} (limit 0.9)")
    if rel > 5e-2 or top1 < 0.9:
        fail(f"{cfg.name}: kernel route disagrees with the sdpa route ({what})")
    return {"rel": rel, "top1": top1}


def model_times(name: str, model, params, batch: dict, cache, pos) -> dict:
    """A prefill of ``batch`` and a decode step (one token a row of
    ``cache`` at ``pos``) timed with CUDA events behind the spin, then each
    profiled for its device-busy share."""
    rows = pos.shape[0]
    toks = torch.ones(rows, dtype=torch.long, device=model.device)
    with torch.no_grad():
        prefill_ms = time_ms(model.prefill, params, batch, iters=5, warmup=1)
        decode_ms = time_ms(model.decode_step, params, toks, cache, pos, iters=20, warmup=2)
        s = batch["tokens"].shape[1] + (batch["prefix_embeds"].shape[1]
                                        if "prefix_embeds" in batch else 0)
        log(f"  prefill S={s} {prefill_ms:.2f} ms (CUDA events behind the spin, median of 5); "
            f"decode step ({rows} row) {decode_ms:.2f} ms (median of 20)")
        prof_p = profile(f"{name} prefill S={s}", model.prefill, params, batch)
        prof_d = profile(f"{name} decode step ({rows} row)", model.decode_step, params, toks,
                         cache, pos)
    return {"prefill_ms": prefill_ms, "decode_ms": decode_ms,
            "prefill_busy_ms": sum(prof_p.values()), "decode_busy_ms": sum(prof_d.values())}


def phase_whisper() -> dict:
    """Phase 4, whisper-small at full width and depth (12 encoder and 12
    decoder layers), bf16, random weights from seed 0, and the encoder's
    ``WHISPER_FRAMES`` input frames from a numpy seed (N(0, 1) x 0.02, the
    stub frontend's scale).  The engine serves no encoder-decoder model
    (its prefill passes only tokens, as the reference's), so the model's
    own entry points are its path:

    - the reference's prefill-then-decode check in f32 (the served weights
      widened) at its bands: forward on 448 decoder tokens, prefill on the
      first 444 within 2e-2, 4 teacher-forced decode steps within 5e-2; K1
      on its f32 route ("mma"), one launch a decoder layer a call;
    - bf16, with every launch counter set to 0 just before: prefill on 444
      tokens, then 4 greedy decode steps: K1 12 times, all "wgmma" (the
      decoder's self-attention: the encoder and the cross-attention run
      the plain sdpa), K2 and K3 none;
    - the kernel route against the sdpa route on prefill logits at S=448
      (5e-2 relative, top-1 0.9), and the times of a prefill and a decode
      step with their device-busy share.

    Returns the record (its launches by route under ``"by_route"`` and
    ``"f32_by_route"``)."""
    import gc

    from repro_torch.configs import get_config
    from repro_torch.models import Model

    cfg = get_config("whisper-small")
    s, split = WHISPER_SEQ[-1], WHISPER_SEQ[0]
    log(f"phase 4: whisper-small at full width and depth ({cfg.n_encoder_layers} encoder and "
        f"{cfg.n_layers} decoder layers, d_model {cfg.d_model}, {cfg.n_heads} heads, "
        f"{cfg.n_kv_heads} KV heads, head_dim {cfg.resolved_head_dim}, d_ff {cfg.d_ff} "
        f"{cfg.mlp_type}, learned positions, vocab {cfg.vocab_size}, {cfg.param_dtype}), random "
        f"weights from seed 0, attn=kernel, {WHISPER_FRAMES} encoder frames; run through the "
        "model's own entry points: the engine serves no encoder-decoder model")
    model, params = init_full_width(cfg)
    record = {"peak_init_gib": torch.cuda.max_memory_allocated() / 2**30}
    rng = np.random.default_rng(11)
    frames = torch.from_numpy((rng.standard_normal((1, WHISPER_FRAMES, cfg.d_model)) * 0.02)
                              .astype(np.float32)).to(model.device)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, s))).to(model.device)
    batch = {"tokens": toks, "enc_frames": frames}

    f32 = dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32")
    wide = _tree_map(lambda x: x.float(), params)
    set_launch_counts_to_zero()
    checked = prefill_decode_check(Model(f32, attn="kernel", device="cuda"), wide, batch, split,
                                   decode_tol=dict(atol=5e-2, rtol=5e-2))
    checked.pop("forward")
    counts = launch_counts()
    check_launches("float32 check", counts, wgmma=0, mma=2 * cfg.n_layers)
    record.update(check_float32=checked, f32_by_route=counts["flash_attention"])
    del wide
    torch.cuda.empty_cache()

    set_launch_counts_to_zero()             # counts from the main path only
    with torch.no_grad():
        logits, pre = model.prefill(params, {"tokens": toks[:, :split], "enc_frames": frames})
        cache = padded_cache(model, pre, s)
        tok, made = logits[:, -1].argmax(-1), []
        for i in range(split, s):
            dl, cache = model.decode_step(params, tok, cache,
                                          torch.full((1,), i, device=model.device))
            if dl.shape != (1, cfg.vocab_size) or not torch.isfinite(dl).all():
                fail(f"{cfg.name}: decode step at position {i} gave non-finite logits")
            tok = dl.argmax(-1)
            made.append(int(tok))
        torch.cuda.synchronize()
    counts = launch_counts()
    check_launches(f"bf16 prefill on {split} tokens and 4 greedy decode steps (tokens {made})",
                   counts, wgmma=cfg.n_layers, mma=0)
    record.update(by_route=counts["flash_attention"], decode_by_route=counts["decode_attention"],
                  ssd_scan=counts["ssd_scan"])
    with torch.no_grad():
        lk, _ = model.prefill(params, batch)
        lp, _ = Model(cfg, attn=None, device="cuda").prefill(params, batch)
    record["route_check"] = route_agreement(cfg, lk, lp, f"bf16 prefill S={s}")
    del lk, lp
    record.update(model_times(cfg.name, model, params, batch, cache,
                              torch.full((1,), split, device=model.device)))
    del model, params, cache, pre
    gc.collect()
    torch.cuda.empty_cache()
    return record


def phase_internvl2() -> dict:
    """Phase 4, internvl2-76b at full width, cut in depth to
    ``INTERNVL2_LAYERS`` of its 80 layers (it does not fit 80 GB whole),
    bf16, random weights from seed 0, on its vision path: a prefill of a
    256-position ``prefix_embeds`` (numpy seed, the stub's 0.02 scale) and
    ``VISION_TOKENS`` tokens, S=1024, then 4 greedy decode steps at the
    positions after it, with every launch counter set to 0 just before (K1
    once a layer, all "wgmma"; K2 and K3 none; finite logits); then the
    kernel route against the sdpa route on the same prefill (5e-2
    relative, top-1 0.9), and the times of a prefill and a decode step
    with their device-busy share.  The engine serves this model text only
    (its prefill passes only tokens, as the reference's), so its vision
    path runs through the model's own entry points."""
    import gc

    from repro_torch.configs import get_config
    from repro_torch.models import Model

    full = get_config("internvl2-76b")
    cfg = dataclasses.replace(full, n_layers=INTERNVL2_LAYERS)
    s = cfg.frontend_len + VISION_TOKENS
    log(f"phase 4: internvl2-76b at full width, {cfg.n_layers} of its {full.n_layers} layers "
        f"(d_model {cfg.d_model}, {cfg.n_heads} heads, {cfg.n_kv_heads} KV heads, head_dim "
        f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff} {cfg.mlp_type}, vocab {cfg.vocab_size}, "
        f"{cfg.param_dtype}), random weights from seed 0, attn=kernel; vision path: "
        f"{cfg.frontend_len} prefix positions + {VISION_TOKENS} tokens")
    model, params = init_full_width(cfg)
    record = {"layers": cfg.n_layers, "published_layers": full.n_layers,
              "peak_init_gib": torch.cuda.max_memory_allocated() / 2**30}
    rng = np.random.default_rng(13)
    prefix = torch.from_numpy((rng.standard_normal((1, cfg.frontend_len, cfg.d_model)) * 0.02)
                              .astype(np.float32)).to(model.device, torch.bfloat16)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, VISION_TOKENS))).to(model.device)
    batch = {"tokens": toks, "prefix_embeds": prefix}

    set_launch_counts_to_zero()             # counts from the main path only
    with torch.no_grad():
        lk, pre = model.prefill(params, batch)
        cache = padded_cache(model, pre, s + 8)
        tok, made = lk[:, -1].argmax(-1), []
        for i in range(s, s + 4):
            dl, cache = model.decode_step(params, tok, cache,
                                          torch.full((1,), i, device=model.device))
            if dl.shape != (1, cfg.vocab_size) or not torch.isfinite(dl).all():
                fail(f"{cfg.name}: decode step at position {i} gave non-finite logits")
            tok = dl.argmax(-1)
            made.append(int(tok))
        torch.cuda.synchronize()
    counts = launch_counts()
    check_launches(f"bf16 prefill of {s} positions and 4 greedy decode steps at positions "
                   f"{s}-{s + 3} (tokens {made})", counts, wgmma=cfg.n_layers, mma=0)
    record.update(by_route=counts["flash_attention"], decode_by_route=counts["decode_attention"],
                  ssd_scan=counts["ssd_scan"])
    del pre
    with torch.no_grad():
        lp, _ = Model(cfg, attn=None, device="cuda").prefill(params, batch)
    record["route_check"] = route_agreement(cfg, lk, lp, f"bf16 prefill S={s} with the prefix")
    del lk, lp
    record.update(model_times(cfg.name, model, params, batch, cache,
                              torch.full((1,), s, device=model.device)))
    del model, params, cache
    gc.collect()
    torch.cuda.empty_cache()
    return record


# gemma-2b trained at full width and depth (phase_train): a global batch of
# TRAIN_BATCH sequences of TRAIN_SEQ tokens, TRAIN_STEPS steps at
# launch/train.py's default learning rate
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_LR = 2, 1024, 4, 1e-3
TRAIN_RTOL = 2e-2
# the loop end to end (phase_train_loop): mamba2-370m at full width cut to
# LOOP_LAYERS of its 48 layers, LOOP_STEPS steps saved every
# LOOP_SAVE_EVERY, a crash injected at step LOOP_CRASH
LOOP_LAYERS, LOOP_STEPS, LOOP_SAVE_EVERY, LOOP_CRASH = 8, 6, 2, 3


def _device_batch(batch: dict) -> dict:
    return {k: torch.from_numpy(v).to("cuda") for k, v in batch.items()}


def profile_once(fn, *args) -> dict:
    """One call of ``fn(*args)`` under torch.profiler (``profiled_runs``):
    its wall time, the sum of its CUDA kernels' times, their count and the
    heaviest kernels by name (zeros where the profiler recorded none)."""
    wall_ms, runs = profiled_runs(fn, *args)
    by_name = {n: sum(ts) for n, ts in runs.items()}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {"wall_ms": wall_ms, "busy_ms": sum(by_name.values()),
            "kernels": sum(map(len, runs.values())), "top_ms": {n[:80]: ms for n, ms in top}}


def train_flops(cfg, n_params: int, tokens: int) -> tuple[float, float]:
    """(6 N tokens, the attention term) of one training step: 12 L H hd S
    FLOPs a token for QK^T and PV forward and backward (PaLM's count, the
    whole S x S square, as the plain sdpa route computes it)."""
    attn = 12.0 * cfg.n_layers * cfg.n_heads * cfg.resolved_head_dim * TRAIN_SEQ * tokens
    return 6.0 * n_params * tokens, attn


def phase_train() -> dict:
    """gemma-2b trained at full width and depth (18 layers, 2.51 B
    parameters) in bf16 with f32 moments on the plain sdpa route
    (``attn=None``, the reference's training route), random weights from
    seed 0, ``TokenDataset`` batches: ``TRAIN_STEPS`` steps of
    ``make_train_step`` at a global batch of ``TRAIN_BATCH`` x
    ``TRAIN_SEQ`` tokens, with every launch counter set to 0 just before
    and read just after (K1, K2 and K3 none: training runs no kernel of
    the repo).  Each step's loss, grad norm, time (CUDA events), tokens/s,
    peak memory (``torch.cuda.max_memory_allocated``; the step's own above
    what it started with) and share of the bf16 peak; one more step under
    torch.profiler for the device's busy share and the kernels a step.
    Checks: finite losses and grad norms, the last loss below the first;
    the first step again with remat from the same state (parameters
    snapshotted on the card, zero moments) within ``TRAIN_RTOL`` in loss
    and parameters, at a lower peak; a train step on the kernel route
    raises for want of a backward and launches nothing."""
    import gc

    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.train import OptConfig, TokenDataset, init_opt, make_train_step
    from repro_torch.train.tree import tree_leaves

    t_phase = time.perf_counter()
    cfg = get_config("gemma-2b")
    tokens = TRAIN_BATCH * TRAIN_SEQ
    log(f"phase train: gemma-2b at full width and depth ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads} heads, {cfg.n_kv_heads} KV head, head_dim "
        f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff} {cfg.mlp_type}, vocab {cfg.vocab_size}, "
        f"{cfg.param_dtype}, moments {cfg.moment_dtype}), random weights from seed 0, attn=None "
        f"(sdpa); {TRAIN_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ} tokens, lr {TRAIN_LR}")
    model = Model(cfg, attn=None, device="cuda")
    params = model.init(torch.Generator("cuda").manual_seed(0))
    n_params = sum(x.numel() for x in tree_leaves(params))
    opt = OptConfig(lr=TRAIN_LR, moment_dtype=cfg.moment_dtype)
    state = init_opt(params, opt)
    ds = TokenDataset(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=0)
    batches = [_device_batch(ds.batch(i)) for i in range(TRAIN_STEPS)]
    flops_dense, flops_attn = train_flops(cfg, n_params, tokens)
    log(f"  {n_params / 1e9:.3f} B parameters, {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
        f"with the moments; a step {flops_dense / 1e12:.2f} TFLOP (6 N tokens) + "
        f"{flops_attn / 1e12:.3f} TFLOP attention (12 L H hd S a token)")
    p0 = _tree_map(torch.clone, params)
    step = make_train_step(model, opt, remat=False)

    def timed(fn, batch):
        nonlocal params, state
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        params, state, metrics = fn(params, state, batch)
        e1.record()
        torch.cuda.synchronize()
        ms = e0.elapsed_time(e1)
        peak = torch.cuda.max_memory_allocated()
        row = {"loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]),
               "ms": ms, "tokens_per_s": tokens / ms * 1e3, "peak_gib": peak / 2**30,
               "step_peak_gib": (peak - base) / 2**30,
               "peak_share": (flops_dense + flops_attn) / (PEAK_FLOPS[torch.bfloat16] * ms / 1e3)}
        return row

    set_launch_counts_to_zero()
    rows, p1 = [], None
    for i, batch in enumerate(batches):
        row = timed(step, batch)
        rows.append(row)
        log(f"  step {i}: loss {row['loss']:.5f}, grad norm {row['grad_norm']:.4f}, "
            f"{row['ms']:.2f} ms (CUDA events), {row['tokens_per_s']:.0f} tokens/s, peak "
            f"{row['peak_gib']:.2f} GiB (torch.cuda.max_memory_allocated; the step's own "
            f"{row['step_peak_gib']:.2f} above what it started with), "
            f"{100 * row['peak_share']:.1f}% of the bf16 peak (989 TFLOP/s)")
        if i == 0:
            p1 = _tree_map(torch.clone, params)
    counts = launch_counts()
    if any(counts["flash_attention"].values()) or any(counts["decode_attention"].values()) \
            or counts["ssd_scan"]:
        fail(f"gemma-2b training launched a kernel of the repo: {counts}")
    log(f"  launches over the {TRAIN_STEPS} steps: {counts} (counters set to 0 just before)")
    losses = [r["loss"] for r in rows]
    if not all(np.isfinite([r["loss"] for r in rows] + [r["grad_norm"] for r in rows])):
        fail(f"gemma-2b training: a loss or grad norm is not finite: {rows}")
    if not losses[-1] < losses[0]:
        fail(f"gemma-2b training: the loss did not fall over {TRAIN_STEPS} steps: {losses}")
    prof = profile_once(step, params, state, batches[0])
    log(f"  profile one more step: wall {prof['wall_ms']:.2f} ms, device busy "
        f"{prof['busy_ms']:.2f} ms ({100 * prof['busy_ms'] / prof['wall_ms']:.1f}%), "
        f"{prof['kernels']} kernels a step; top: "
        + "; ".join(f"{n} {ms:.2f} ms" for n, ms in prof["top_ms"].items()))

    # the first step again with remat, from the same state
    for a, b in zip(tree_leaves(params), tree_leaves(p0)):
        a.copy_(b)
    del state, p0
    state = init_opt(params, opt)
    remat = timed(make_train_step(model, opt, remat=True), batches[0])
    diff = max(float(((a.float() - b.float()).abs() - TRAIN_RTOL * b.float().abs()).max())
               for a, b in zip(tree_leaves(params), tree_leaves(p1)))
    loss_rel = abs(remat["loss"] - rows[0]["loss"]) / abs(rows[0]["loss"])
    log(f"  remat: first step again from the same state: loss {remat['loss']:.5f} (rel "
        f"{loss_rel:.2e}), parameters' largest |diff| - {TRAIN_RTOL} |ref| {diff:.2e} "
        f"(limit {TRAIN_RTOL}), {remat['ms']:.2f} ms; the step's own peak "
        f"{remat['step_peak_gib']:.2f} GiB with remat, {rows[0]['step_peak_gib']:.2f} without")
    if loss_rel > TRAIN_RTOL or diff > TRAIN_RTOL:
        fail("gemma-2b: the remat step differs from the step without remat")
    if not remat["step_peak_gib"] < rows[0]["step_peak_gib"]:
        fail("gemma-2b: remat did not lower the step's peak memory")
    del p1

    # the kernel route has no backward: its train step raises, launching nothing
    set_launch_counts_to_zero()
    kstep = make_train_step(Model(cfg, attn="kernel", device="cuda"), opt, remat=False)
    try:
        kstep(params, state, batches[0])
    except RuntimeError as err:
        if "no backward" not in str(err):
            fail(f"the kernel route's train step raised {err!r}")
        log(f"  attn=kernel train step raised: {err}")
    else:
        fail("a train step on the kernel route returned")
    kcounts = launch_counts()
    if any(kcounts["flash_attention"].values()):
        fail(f"the kernel route's refused train step launched {kcounts}")
    record = {"params": n_params, "steps": rows, "remat": remat, "profile": prof,
              "tflop_dense": flops_dense / 1e12, "tflop_attention": flops_attn / 1e12,
              "launches": counts, "kernel_route_launches": kcounts["flash_attention"]}
    del params, state, batches, model
    gc.collect()
    torch.cuda.empty_cache()
    record["seconds"] = time.perf_counter() - t_phase
    log(f"phase train: {record['seconds']:.1f} s")
    return record


def train_loop_child(args: list[str]) -> dict:
    """``--train-loop``: run in a process of its own by
    ``phase_train_loop``, with ``CUBLAS_WORKSPACE_CONFIG`` set before CUDA
    starts.  Deterministic algorithms on (warn only: a refused op is named,
    not fatal); mamba2-370m at full width, ``LOOP_LAYERS`` layers:
    ``train_loop`` for ``LOOP_STEPS`` steps uninterrupted, then again in a
    second directory with a crash injected at step ``LOOP_CRASH`` and a
    rerun, which resumes from the last save.  Returns both runs' losses,
    the rerun's resume step, wall seconds and prefetcher CPU seconds, the
    ops torch warned have no deterministic implementation, and whether the
    two final checkpoints (one restored on the card, one on the CPU) are
    equal leaf for leaf."""
    import shutil
    import tempfile
    import warnings

    from repro_torch.configs import get_config
    from repro_torch.train import OptConfig, init_opt, restore_checkpoint, train_loop
    from repro_torch.train.loop import meta_params
    from repro_torch.train.tree import tree_leaves

    torch.use_deterministic_algorithms(True, warn_only=True)
    cfg = dataclasses.replace(get_config("mamba2-370m"), n_layers=LOOP_LAYERS)
    kw = dict(steps=LOOP_STEPS, save_every=LOOP_SAVE_EVERY, global_batch=TRAIN_BATCH,
              seq_len=TRAIN_SEQ, device="cuda")
    root = tempfile.mkdtemp(prefix="chip_smoke_train_")

    class Preempted(RuntimeError):
        pass

    def crash(step):
        if step == LOOP_CRASH and not os.path.exists(os.path.join(root, "crashed")):
            open(os.path.join(root, "crashed"), "w").close()
            raise Preempted("injected preemption")

    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            ref = train_loop(cfg, ckpt_dir=os.path.join(root, "ref"), **kw)
            try:
                train_loop(cfg, ckpt_dir=os.path.join(root, "ft"), failure_injector=crash, **kw)
            except Preempted:
                pass
            else:
                raise RuntimeError("the injected crash did not stop the loop")
            res = train_loop(cfg, ckpt_dir=os.path.join(root, "ft"), failure_injector=crash,
                             **kw)
        like_p = meta_params(cfg, max_seq=TRAIN_SEQ * 2)
        like = {"params": like_p, "opt": init_opt(like_p, OptConfig(
            moment_dtype=cfg.moment_dtype))}
        t0 = time.perf_counter()
        on_card, _ = restore_checkpoint(os.path.join(root, "ref"), LOOP_STEPS, like,
                                        device="cuda")
        on_cpu, _ = restore_checkpoint(os.path.join(root, "ft"), LOOP_STEPS, like,
                                       device="cpu")
        restore_s = time.perf_counter() - t0
        equal = all(a.dtype == b.dtype and torch.equal(a.cpu(), b)
                    for a, b in zip(tree_leaves(on_card), tree_leaves(on_cpu)))
        last = os.path.join(root, "ref", f"step_{LOOP_STEPS:09d}")
        ckpt_bytes = sum(os.path.getsize(os.path.join(last, f)) for f in os.listdir(last))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    nondet = sorted({str(w.message).split("\n")[0][:160] for w in caught
                     if "deterministic" in str(w.message)})
    return {"layers": LOOP_LAYERS, "params": sum(x.numel() for x in tree_leaves(like_p)),
            "ref_losses": ref["losses"], "losses": res["losses"],
            "resumed_from": res["resumed_from"], "ref_wall_s": ref["wall_s"],
            "ref_prefetch_cpu_s": ref["prefetch_cpu_s"], "wall_s": res["wall_s"],
            "prefetch_cpu_s": res["prefetch_cpu_s"], "final_checkpoints_equal": equal,
            "checkpoint_bytes": ckpt_bytes, "restore_s": restore_s, "nondeterministic": nondet}


def phase_train_loop() -> dict:
    """The training loop end to end on the card, through
    ``train_loop_child`` in a subprocess (deterministic algorithms there
    leave the other phases' timings alone).  Checks: the rerun resumes from
    step ``LOOP_CRASH - 1`` rounded down to a save, its losses equal the
    uninterrupted run's from there bit for bit (the loop's contract), and
    the two final checkpoints, restored on the card and on the CPU, are
    equal leaf for leaf.  Logs the loop's wall seconds beside the input
    prefetcher thread's CPU seconds (the paper's metric, on the input
    path)."""
    t_phase = time.perf_counter()
    resume = (LOOP_CRASH // LOOP_SAVE_EVERY) * LOOP_SAVE_EVERY
    log(f"phase train loop: mamba2-370m at full width, {LOOP_LAYERS} of its 48 layers, "
        f"{LOOP_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ} tokens saved every "
        f"{LOOP_SAVE_EVERY}, a crash at step {LOOP_CRASH}, the rerun resuming from {resume}; "
        "in a subprocess with CUBLAS_WORKSPACE_CONFIG=:4096:8 and deterministic algorithms")
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"), "--train-loop"],
                          capture_output=True, text=True, timeout=600,
                          env={**os.environ, "CUBLAS_WORKSPACE_CONFIG": ":4096:8"})
    if proc.returncode != 0:
        fail(f"the training loop's subprocess exited {proc.returncode}: "
             f"{(proc.stdout + proc.stderr)[-3000:]}")
    rec = json.loads(proc.stdout.strip().splitlines()[-1])["train_loop"]
    log(f"  {rec['params'] / 1e6:.1f} M parameters; a checkpoint {rec['checkpoint_bytes'] / 1e9:.3f} "
        f"GB (f32 leaves); uninterrupted losses {rec['ref_losses']}")
    log(f"  rerun after the crash resumed from step {rec['resumed_from']}: losses {rec['losses']}")
    log(f"  wall {rec['ref_wall_s']:.2f} s uninterrupted, {rec['wall_s']:.2f} s the rerun; the "
        f"prefetcher thread's CPU {rec['ref_prefetch_cpu_s']} s / {rec['prefetch_cpu_s']} s "
        "(/proc/self/task/<tid>/stat)")
    log(f"  ops torch has no deterministic implementation of: {rec['nondeterministic'] or 'none'}")
    if rec["resumed_from"] != resume or rec["losses"] != rec["ref_losses"][resume:]:
        fail("the resumed run's losses differ from the uninterrupted run's")
    if not rec["final_checkpoints_equal"]:
        fail("the two runs' final checkpoints differ")
    log(f"  final checkpoints, one restored on the card and one on the CPU, equal leaf for leaf "
        f"({rec['restore_s']:.2f} s)")
    rec["seconds"] = time.perf_counter() - t_phase
    log(f"phase train loop: {rec['seconds']:.1f} s")
    return rec


def phase_train_entry() -> dict:
    """The launcher, ``repro_torch.launch.train.main`` with ``--arch
    gemma-2b --smoke --steps 4`` on the card (its default device): exit 0
    and a falling loss."""
    import io
    import shutil
    import tempfile

    from repro_torch.launch import train as launch_train

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="chip_smoke_launch_")
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            rc = launch_train.main(["--arch", "gemma-2b", "--smoke", "--steps", "4",
                                    "--ckpt", root])
    finally:
        shutil.rmtree(root, ignore_errors=True)
    line = out.getvalue().strip().splitlines()[-1]
    first, last = (float(x) for x in line.split("loss ")[1].split(" -> "))
    log(f"phase train entry: repro_torch.launch.train --arch gemma-2b --smoke --steps 4: rc {rc}, "
        f"{line}")
    if rc != 0 or not last < first:
        fail("the training launcher failed or its loss did not fall")
    seconds = time.perf_counter() - t_phase
    log(f"phase train entry: {seconds:.1f} s")
    return {"rc": rc, "first": first, "last": last, "seconds": seconds}


# the multi-device layer on the card (phase_mesh): gemma-2b at full width and
# depth through build_cell's steps on a one-rank NCCL mesh, against the plain
# steps; a prefill of MESH_BATCH x TRAIN_SEQ tokens, MESH_DECODE greedy steps
MESH_BATCH, MESH_DECODE = 2, 4
MESH_LOGIT_TOL = 2e-4        # tests/test_torch_model.py
MESH_LOSS_RTOL, MESH_PARAM_TOL = 2e-4, 2e-3    # tests/test_torch_train.py
DRYRUN_CELLS = (("mamba2-370m", "long_500k"), ("gemma-2b", "train_4k"))


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _full(x):
    """A DTensor's whole value (a plain tensor as it is)."""
    return x.full_tensor() if hasattr(x, "full_tensor") else x


def _max_rel(a, b) -> float:
    """max |a - b| over max |b|, in f32."""
    a, b = _full(a).float(), _full(b).float()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def mesh_serve(mesh, cfg, params) -> dict:
    """gemma-2b's prefill and ``MESH_DECODE`` greedy serve steps through
    ``build_cell``'s prefill_32k and decode_32k steps on parameters, tokens
    and caches placed by the cells' specs, against the plain steps on the
    same tensors: the same next tokens, logits within ``MESH_LOGIT_TOL``."""
    from repro_torch.launch.inputs import build_cell, place_like
    from repro_torch.models import Model
    from repro_torch.train import make_prefill_step, make_serve_step
    from repro_torch.train.tree import tree_items

    model = Model(cfg, attn=None, device="cuda")
    cell_p = build_cell("gemma-2b", "prefill_32k", mesh)
    cell_d = build_cell("gemma-2b", "decode_32k", mesh)
    gen = torch.Generator("cuda").manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (MESH_BATCH, TRAIN_SEQ), device="cuda",
                           generator=gen)
    make_prefill_step(model)(params, {"tokens": tokens})      # warm-up, untimed
    out = {}
    for name, run_p, run_d in (
            ("plain", lambda p, b: make_prefill_step(model)(p, b),
             lambda *a: make_serve_step(model)(*a)),
            ("mesh", lambda p, b: cell_p.run(place_like(p, cell_p.args[0]),
                                              place_like(b, cell_p.args[1])),
             lambda p, t, c, q: cell_d.run(place_like(p, cell_d.args[0]),
                                           place_like(t, cell_d.args[1]),
                                           place_like(c, cell_d.args[2]),
                                           place_like(q, cell_d.args[3])))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        next_tok, logits, pre = run_p(params, {"tokens": tokens})
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        cache = model.init_cache(MESH_BATCH, TRAIN_SEQ + MESH_DECODE)
        for (path, leaf), (_, value) in zip(tree_items(cache), tree_items(pre)):
            leaf[:, :, :TRAIN_SEQ] = _full(value)
        toks, tok = [_full(next_tok).clone()], _full(next_tok)
        pos = torch.full((MESH_BATCH,), TRAIN_SEQ, device="cuda", dtype=torch.int32)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(MESH_DECODE - 1):
            tok, cache = run_d(params, tok.int(), cache, pos + i)
            tok = _full(tok)
            toks.append(tok.clone())
        torch.cuda.synchronize()
        out[name] = {"logits": _full(logits)[:, -1].float(), "tokens": torch.stack(toks, 1),
                     "prefill_ms": prefill_ms,
                     "decode_ms": (time.perf_counter() - t0) * 1e3 / (MESH_DECODE - 1)}
        del logits, pre, cache
    plain, mesh_run = out["plain"], out["mesh"]
    rec = {"tokens_equal": bool(torch.equal(plain["tokens"], mesh_run["tokens"])),
           "logits_max_rel": _max_rel(mesh_run["logits"], plain["logits"]),
           "logits_bit_equal": bool(torch.equal(mesh_run["logits"], plain["logits"])),
           **{f"{k}_{n}": out[n][k] for n in out for k in ("prefill_ms", "decode_ms")}}
    log(f"  serve: prefill of {MESH_BATCH} x {TRAIN_SEQ} then {MESH_DECODE - 1} greedy steps "
        f"through build_cell's prefill_32k / decode_32k steps: tokens equal "
        f"{rec['tokens_equal']}, last-position logits max rel {rec['logits_max_rel']:.2e} "
        f"(limit {MESH_LOGIT_TOL}), bit-equal {rec['logits_bit_equal']}; prefill "
        f"{rec['prefill_ms_plain']:.1f} ms plain / {rec['prefill_ms_mesh']:.1f} ms mesh, a "
        f"step {rec['decode_ms_plain']:.1f} / {rec['decode_ms_mesh']:.1f} ms (host clock, after an "
        "untimed plain prefill)")
    if not rec["tokens_equal"] or rec["logits_max_rel"] > MESH_LOGIT_TOL:
        fail(f"the mesh prefill and serve steps differ from the plain ones: {rec}")
    return rec


def mesh_train(mesh, cfg, params) -> dict:
    """One train step of ``MESH_BATCH`` x ``TRAIN_SEQ`` ``TokenDataset``
    tokens through ``build_cell``'s train_4k step on parameters, moments and
    a batch placed by the cell's specs, against the plain step from the same
    state (``params`` snapshotted, zero moments): the loss within
    ``MESH_LOSS_RTOL``, every updated parameter within ``MESH_PARAM_TOL`` of
    its leaf's largest magnitude."""
    import gc

    from repro_torch.launch.inputs import build_cell, place_like
    from repro_torch.models import Model
    from repro_torch.train import TokenDataset, init_opt, make_train_step
    from repro_torch.train.tree import tree_leaves

    cell = build_cell("gemma-2b", "train_4k", mesh, remat=False)
    opt = cell.meta["opt"]
    batch = _device_batch(TokenDataset(cfg.vocab_size, TRAIN_SEQ, MESH_BATCH, seed=0).batch(0))
    p0 = _tree_map(torch.clone, params)
    step = make_train_step(Model(cfg, attn=None, device="cuda"), opt, remat=False)
    step(params, init_opt(params, opt), batch)                # warm-up, untimed
    for a, b in zip(tree_leaves(params), tree_leaves(p0)):
        a.copy_(b)
    times, metrics = {}, {}
    for name in ("plain", "mesh"):
        state = init_opt(params, opt)
        args = (params, state, batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if name == "plain":
            _, _, m = step(*args)
        else:
            out, _, m = cell.run(*place_like(args, cell.args))
        torch.cuda.synchronize()
        times[name] = (time.perf_counter() - t0) * 1e3
        metrics[name] = {k: float(_full(v)) for k, v in m.items()}
        del state, args
        if name == "plain":
            p1 = _tree_map(torch.clone, params)
            for a, b in zip(tree_leaves(params), tree_leaves(p0)):
                a.copy_(b)
            del p0, m
            gc.collect()
            torch.cuda.empty_cache()
    got = [_full(x) for x in tree_leaves(out)]
    worst = max(_max_rel(a, b) for a, b in zip(got, tree_leaves(p1)))
    bit = all(torch.equal(a, b) for a, b in zip(got, tree_leaves(p1)))
    loss_rel = abs(metrics["mesh"]["loss"] - metrics["plain"]["loss"]) / abs(
        metrics["plain"]["loss"])
    rec = {"metrics": metrics, "loss_rel": loss_rel, "params_max_rel": worst,
           "params_bit_equal": bit,
           "loss_bit_equal": metrics["mesh"]["loss"] == metrics["plain"]["loss"],
           **{f"ms_{k}": v for k, v in times.items()}}
    log(f"  train: one step of {MESH_BATCH} x {TRAIN_SEQ} tokens through build_cell's train_4k "
        f"step: loss {metrics['mesh']['loss']:.6f} against {metrics['plain']['loss']:.6f} plain "
        f"(rel {loss_rel:.2e}, limit {MESH_LOSS_RTOL}; bit-equal {rec['loss_bit_equal']}), "
        f"grad norm {metrics['mesh']['grad_norm']:.4f} / {metrics['plain']['grad_norm']:.4f}, "
        f"updated parameters' largest |diff| / leaf max {worst:.2e} (limit {MESH_PARAM_TOL}; "
        f"bit-equal {bit}); {times['plain']:.1f} ms plain / {times['mesh']:.1f} ms mesh "
        "(host clock, after an untimed plain step)")
    del p1, got, out
    if loss_rel > MESH_LOSS_RTOL or worst > MESH_PARAM_TOL:
        fail(f"the mesh train step differs from the plain one: {rec}")
    return rec


def mesh_collectives(mesh) -> dict:
    """``compressed_psum_int8`` and ``make_dp_grad_fn`` over the NCCL data
    axis (int8 on the wire, recorded by ``CostTrace``; compressed against
    exact under 0.02 relative), ``gpipe`` with one stage against the
    sequential layers (1e-5; gradients 2e-4), and ``restore_checkpoint(
    shardings=)`` of a checkpoint written on the host onto the mesh, equal
    leaf for leaf."""
    import shutil
    import tempfile

    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.roofline.analysis import CostTrace
    from repro_torch.sharding.pipeline import gpipe
    from repro_torch.sharding.policy import NamedSharding, to_placements
    from repro_torch.train import (compressed_psum_int8, make_dp_grad_fn, restore_checkpoint,
                                   save_checkpoint)

    rec, t0 = {}, time.perf_counter()
    gen = torch.Generator("cuda").manual_seed(2)
    # the reference test's data-parallel gradient, and one gemma-2b-sized MLP leaf
    params = {"w": torch.randn(6, 1, device="cuda", generator=gen)}
    batch = torch.randn(32, 6, device="cuda", generator=gen)

    def loss(p, bt):
        return torch.mean((bt @ p["w"]) ** 2)

    with CostTrace() as trace:
        gc = make_dp_grad_fn(loss, mesh, compress=True)(params, batch)["w"]
        big = {"w_up": torch.randn(2048, 16384, device="cuda", generator=gen).bfloat16()}
        summed = compressed_psum_int8(big, mesh.get_group("data"))["w_up"]
    ge = make_dp_grad_fn(loss, mesh, compress=False)(params, batch)["w"]
    wire = sorted({(k, str(d)) for k, _, d in trace.collectives})
    rec["dp_rel"] = float((gc - ge).norm() / ge.norm())
    rec["psum_rel"] = float((summed.float() - big["w_up"].float()).norm()
                            / big["w_up"].float().norm())
    rec["wire"] = wire
    rec["collectives_s"] = time.perf_counter() - t0
    log(f"  compression over NCCL: make_dp_grad_fn compressed against exact rel "
        f"{rec['dp_rel']:.2e}, compressed_psum_int8 of a 2048 x 16384 bf16 leaf rel "
        f"{rec['psum_rel']:.2e} (limit 0.02); on the wire {wire}; {rec['collectives_s']:.2f} s")
    if rec["dp_rel"] > 0.02 or rec["psum_rel"] > 0.02 or ("all-gather", "torch.int8") not in wire:
        fail(f"the compressed reduction over NCCL: {rec}")

    t0 = time.perf_counter()
    pipe = init_device_mesh("cuda", (1,), mesh_dim_names=("pipe",))
    w = torch.randn(8, 12, 12, device="cuda", generator=gen) * 0.3
    b = torch.randn(8, 12, device="cuda", generator=gen) * 0.1
    x = torch.randn(16, 12, device="cuda", generator=gen)

    def block(p, h):
        return torch.tanh(h @ p["w"] + p["b"])

    wp, ws = w.clone().requires_grad_(True), w.clone().requires_grad_(True)
    y = gpipe(block, {"w": wp, "b": b}, x, pipe, n_microbatches=4)
    h = x
    for layer in range(8):
        h = block({"w": ws[layer], "b": b[layer]}, h)
    (gp,) = torch.autograd.grad((y ** 2).sum(), wp)
    (gs,) = torch.autograd.grad((h ** 2).sum(), ws)
    rec["gpipe_err"] = float((y - h).abs().max())
    rec["gpipe_grad_err"] = float((gp - gs).abs().max())
    rec["gpipe_s"] = time.perf_counter() - t0
    log(f"  gpipe, one stage of 8 layers, 4 microbatches: output |diff| {rec['gpipe_err']:.2e} "
        f"(limit 1e-5), grad |diff| {rec['gpipe_grad_err']:.2e} (limit 2e-4); "
        f"{rec['gpipe_s']:.2f} s")
    if rec["gpipe_err"] > 1e-5 or rec["gpipe_grad_err"] > 2e-4:
        fail(f"gpipe differs from the sequential layers: {rec}")

    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="chip_smoke_reshard_")
    try:
        tree = {"a": np.arange(48, dtype=np.float32).reshape(8, 6),
                "b": {"c": np.random.default_rng(0).standard_normal((1024, 256)).astype(
                    np.float32)}}
        save_checkpoint(root, 3, tree)
        like = {"a": torch.empty((8, 6), device="meta"),
                "b": {"c": torch.empty((1024, 256), dtype=torch.bfloat16, device="meta")}}
        shd = {"a": NamedSharding(mesh, to_placements(("data", "model"), mesh)),
               "b": {"c": NamedSharding(mesh, to_placements(("data", None), mesh))}}
        got, meta = restore_checkpoint(root, 3, like, shardings=shd)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    ok = (meta["step"] == 3 and got["a"].device.type == "cuda"
          and np.array_equal(got["a"].full_tensor().cpu().numpy(), tree["a"])
          and torch.equal(got["b"]["c"].full_tensor().cpu(),
                          torch.from_numpy(tree["b"]["c"]).bfloat16()))
    rec["reshard_ok"], rec["reshard_s"] = bool(ok), time.perf_counter() - t0
    log(f"  restore_checkpoint(shardings=) onto the cuda mesh: equal {ok}, placements "
        f"{got['a'].placements}; {rec['reshard_s']:.2f} s")
    if not ok:
        fail("the checkpoint restored onto the mesh differs from the one written")
    return rec


def mesh_dryruns() -> dict:
    """``python -m repro_torch.launch.dryrun`` on ``DRYRUN_CELLS`` as
    subprocesses (their fake process groups are theirs): exit 0, one cell
    OK, their roofline lines."""
    rec = {}
    for arch, shape in DRYRUN_CELLS:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape", shape],
            capture_output=True, text=True, timeout=300, cwd=ROOT,
            env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
        lines = [ln.strip() for ln in proc.stdout.splitlines()
                 if ln.strip().startswith(("roofline:", "cost:", "memory", "== "))]
        rec[f"{arch} x {shape}"] = {"rc": proc.returncode, "lines": lines,
                                    "seconds": time.perf_counter() - t0}
        log(f"  dryrun {arch} x {shape} @ 16x16 (a fake group of 256 ranks in the subprocess): "
            f"rc {proc.returncode}, {rec[f'{arch} x {shape}']['seconds']:.1f} s")
        for ln in lines:
            log(f"    {ln}")
        if proc.returncode != 0 or "1 cells compiled OK, 0 failed" not in proc.stdout:
            fail(f"the dry run of {arch} x {shape} failed: "
                 f"{(proc.stdout + proc.stderr)[-3000:]}")
    return rec


def phase_mesh() -> dict:
    """The multi-device layer on the card (``launch.mesh``,
    ``launch.inputs``, ``sharding``, ``train.compression``'s collectives,
    reshard-on-restore, the dry run), on a one-rank NCCL process group
    (not the dry run's fake one) and ``make_host_mesh(1, 1)`` on "cuda":
    gemma-2b at full width and depth (bf16, random weights from seed 0,
    ``attn=None``, the cells' route) through ``build_cell``'s prefill,
    serve and train steps against the plain steps (``mesh_serve``,
    ``mesh_train``), with every launch counter set to 0 just before (the
    cells reach no kernel of the repo); then ``mesh_collectives`` and
    ``mesh_dryruns``.  Each part logs its wall time; any failure fails the
    script."""
    import gc

    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import Model

    t_phase = time.perf_counter()
    log("phase mesh: " + subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0])
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{_free_port()}", rank=0,
                            world_size=1)
    try:
        mesh = make_host_mesh(1, 1, device_type="cuda")
        log(f"  a one-rank NCCL group ({dist.get_backend()}), mesh {mesh}")
        cfg = get_config("gemma-2b")
        params = Model(cfg, attn=None, device="cuda").init(torch.Generator("cuda").manual_seed(0))
        set_launch_counts_to_zero()
        t0 = time.perf_counter()
        rec = {"serve": mesh_serve(mesh, cfg, params)}
        rec["serve"]["seconds"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        rec["train"] = mesh_train(mesh, cfg, params)
        rec["train"]["seconds"] = time.perf_counter() - t0
        rec["launches"] = launch_counts()
        if any(rec["launches"]["flash_attention"].values()) or any(
                rec["launches"]["decode_attention"].values()) or rec["launches"]["ssd_scan"]:
            fail(f"the mesh phase launched a kernel of the repo: {rec['launches']}")
        log(f"  serve {rec['serve']['seconds']:.1f} s, train {rec['train']['seconds']:.1f} s; "
            f"launches {rec['launches']} (counters set to 0 just before)")
        del params
        gc.collect()
        torch.cuda.empty_cache()
        rec["collectives"] = mesh_collectives(mesh)
    finally:
        dist.destroy_process_group()
    rec["dryrun"] = mesh_dryruns()
    rec["seconds"] = time.perf_counter() - t_phase
    log(f"phase mesh: {rec['seconds']:.1f} s")
    return rec


def phase_serve_models() -> dict[str, dict]:
    """Phase 4, the other served models (``SERVED_MODELS``) at full width,
    bf16, random weights from seed 0, one at a time (each freed, with the
    allocator's cache, before the next): granite-3-8b and starcoder2-15b
    (K1 at head dim 128, GQA groups 4 and 12) after their kernel-vs-sdpa
    route check, mamba2-370m after the reference's prefill-then-decode
    check, dbrx-132b, llama4-scout-17b-a16e and jamba-1.5-large-398b
    (groups 6, 5 and 8; jamba's Mamba2 layers meet dense and MoE FFNs) cut
    in depth, each after ``moe_layer_check`` and its route check.  Returns
    each model's serving record (without its engine)."""
    import gc

    from repro_torch.configs import get_config
    from repro_torch.models import Model

    served = {}
    for name, layers in SERVED_MODELS:
        cfg = get_config(name)
        record = {"layers": layers, "published_layers": cfg.n_layers}
        if cfg.n_experts:
            log(f"phase 4: {cfg.name}'s MoE layer on the card")
            record["moe_layer_check"] = moe_layer_check(cfg)
        depth = (" and depth" if layers == cfg.n_layers
                 else f", {layers} of its {cfg.n_layers} layers")
        cfg = dataclasses.replace(cfg, n_layers=layers)
        if cfg.family == "ssm":
            widths = (f"d_model {cfg.d_model}, SSD {cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim}"
                      f" heads of {cfg.ssm_head_dim}, state {cfg.ssm_state}, chunk "
                      f"{cfg.ssm_chunk}, conv {cfg.ssm_conv_width}")
        else:
            widths = (f"d_model {cfg.d_model}, {cfg.n_heads} heads, {cfg.n_kv_heads} KV heads, "
                      f"head_dim {cfg.resolved_head_dim}, d_ff {cfg.d_ff} {cfg.mlp_type}")
            if cfg.n_experts:
                widths += (f", {cfg.n_experts} experts top-{cfg.experts_per_token}, "
                           f"{cfg.n_shared_experts} shared, qk_norm {cfg.qk_norm}")
            if cfg.family == "hybrid":
                plan = cfg.layer_plan()
                widths += (f"; plan {' '.join(f'{m}+{f}' for m, f in plan)}; Mamba2 "
                           f"{cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim} heads of "
                           f"{cfg.ssm_head_dim}, state {cfg.ssm_state}, chunk {cfg.ssm_chunk}")
        log(f"phase 4: serve {cfg.name} at full width{depth} ({cfg.n_layers} layers served, "
            f"{widths}, vocab {cfg.vocab_size}, {cfg.param_dtype}), random weights from "
            "seed 0, attn=kernel")
        model, params = init_full_width(cfg)
        record["peak_init_gib"] = torch.cuda.max_memory_allocated() / 2**30
        if cfg.family == "ssm":
            # the reference's check runs in f32 (its reduced configs): held
            # there at the reference's 5e-2, at full width on the served
            # weights widened to f32.  In bf16 the two paths round apart
            # over 48 layers, so the served model's decode steps are held
            # within bf16's own distance from f32: forward in bf16 against
            # forward in f32 at the decode steps' positions
            f32 = dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32")
            wide = _tree_map(lambda x: x.float(), params)
            checked = mamba2_consistency(Model(f32, attn="kernel", device="cuda"), wide,
                                         decode_tol=dict(atol=5e-2, rtol=5e-2))
            del wide
            torch.cuda.empty_cache()
            with torch.no_grad():
                toks = torch.from_numpy(np.random.default_rng(3).integers(
                    0, cfg.vocab_size, (1, 1024))).to(model.device)
                narrow = model.forward(params, {"tokens": toks})[0][0, 512:516].float()
            _, bf16_err = within(narrow, checked.pop("forward"), atol=0.0, rtol=0.0)
            log(f"  bfloat16 forward vs float32 forward on the same weights at positions "
                f"512-515: max_abs_err={bf16_err:.3e} (bf16's own rounding at "
                f"{cfg.n_layers} layers: the bf16 decode steps' band)")
            held = mamba2_consistency(model, params, decode_tol=dict(atol=bf16_err, rtol=0.0))
            held.pop("forward")
            record.update(check_float32=checked, check_bfloat16=held,
                          bf16_vs_f32_forward_max_abs_err=bf16_err)
        else:
            route_check(model, Model(cfg, attn=None, device="cuda"), params)
        record.update(serve_requests(model, params))
        del record["engine"], model, params
        gc.collect()
        torch.cuda.empty_cache()
        served[name] = record
    return served


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
    """(name, grid, cfg, slot_us, replace): S2 against its plain version,
    ``replace`` the fields of the batch's ``AdaptiveParams`` a case sets.
    16 points, every (m, n_queues) in 1..4 x 1..4 (and one queue
    throughout: the other build), quiet, noisy (sleep tails, interference,
    stall windows) and scheduled (per-point schedules, windows of 130 us,
    deep C-states); a grid whose budget is short (slots of 10 us cap it at
    157 steps) so that the last eighth paces every point (forced steps); the
    main path's grid, sweep_frontier's 2016 points in its quiet and noisy
    config, cut in duration only; 1, 5 and 33 points (a lone lane, a partial
    warp, a warp and one more); the edges of the kernel's ring (budgets of
    C - 1, C, C + 1 and 4 C + 13 steps, C = kernel.STAGE_STEPS, and runs
    cut by ``run_steps`` inside a stage, both builds); and the early stop
    (``early_stop_grid``: warps whose every point finishes more than three
    stages before the budget ends, and one lane paced by the budget's tail
    beside 31 that finish early)."""
    from repro_torch.kernels.adaptive_sweep.kernel import STAGE_STEPS
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
                   0.5, {}),
                  (f"m 1-4 x n_queues 1-4, noisy{tag}", multi(2, one_queue=one_queue),
                   noisy_cfg, 0.5, {}),
                  (f"m 1-4 x n_queues 1-4, scheduled{tag}",
                   multi(3, scheds, one_queue=one_queue), sched_cfg, 0.5, {}),
                  (f"tail pacing (slots of 10 us){tag}",
                   multi(5, t_s=(20.0, 60.0), one_queue=one_queue), noisy_cfg, 10.0, {})]
    cut_us = 2_000.0
    cases += [(f"sweep_frontier full grid, quiet, first {cut_us:g} us", frontier_grid(),
               SimRunConfig(duration_us=cut_us), 0.5, {}),
              (f"sweep_frontier full grid, noisy, first {cut_us:g} us", frontier_grid(),
               SimRunConfig(duration_us=cut_us, **FRONTIER_NOISY), 0.5, {})]
    pool = multi(2)
    for n in (1, 5, 33):
        pts = [pool.point(i % len(pool)) for i in range(n)]
        cases.append((f"{n} points, noisy", SweepGrid.of_points(pts), noisy_cfg, 0.5, {}))
        cases.append((f"{n} points, noisy, tail pacing", SweepGrid.of_points(pts), noisy_cfg,
                      10.0, {}))
    c = STAGE_STEPS
    for one_queue in (False, True):
        tag = ", one queue a point" if one_queue else ""
        for budget in (c - 1, c, c + 1, 4 * c + 13):
            cases.append((f"ring edge: a budget of {budget} steps, noisy{tag}",
                          multi(2, one_queue=one_queue), noisy_cfg, 0.5,
                          {"max_steps": budget}))
        for run in (2 * c + 7, 3 * c - 1):
            cases.append((f"ring edge: run_steps {run}, scheduled{tag}",
                          multi(3, scheds, one_queue=one_queue), sched_cfg, 0.5,
                          {"run_steps": run}))
        for cfg, kind in ((quiet, "quiet"), (noisy_cfg, "noisy")):
            grid, budget = early_stop_grid(one_queue)
            cases.append((f"early stop, {kind}{tag}", grid, cfg, 0.5, {"max_steps": budget}))
    return cases


def early_stop_grid(one_queue: bool):
    """(grid, budget): 96 points in three warps over 1,500 us, each point
    but one with T_S of 100-200 us and one thread (well under 100 steps in
    the configs of ``adaptive_compare_cases``), and point 7 (warp 0) with
    T_S 1 us and four threads, which would take 230-900; the budget, 192
    steps (6 stages of the kernel's ring), paces point 7 in its last eighth
    (its forced steps) while every other point stops more than three stages
    before the budget ends (warps 1 and 2 as a whole)."""
    from repro_torch.runtime import SweepGrid
    rng = np.random.default_rng(11)
    pts = []
    for i in range(96):
        busy = i == 7
        q = 1 if one_queue else int(rng.integers(1, 5))
        pts.append(dict(t_s_us=1.0 if busy else float(rng.uniform(100.0, 200.0)),
                        t_l_us=float(rng.uniform(200.0, 600.0)), m=4 if busy else 1,
                        n_queues=q,
                        rate_mpps=float((0.8 if busy else rng.uniform(0.05, 0.3)) * MU_MPPS
                                        * q / 2.0),
                        seed=int(rng.integers(0, 5))))
    return SweepGrid.of_points(pts), 192


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
    reported with the step where it diverges.  Every point reaches its
    duration, but where ``run_steps`` cuts the run; the early-stop cases
    must stop where ``early_stop_grid`` says.  Returns the max abs error
    and the builds compared."""
    from repro_torch.kernels.adaptive_sweep.kernel import STAGE_STEPS
    from repro_torch.kernels.adaptive_sweep.ops import adaptive_sweep, reference_adaptive_sweep
    from repro_torch.runtime.batched_adaptive import adaptive_sweep_inputs
    t0 = time.perf_counter()
    log("phase 2: adaptive_sweep (S2) vs plain version: m 1-4 x n_queues 1-4 quiet, noisy and "
        "scheduled, a budget short enough for tail pacing, the main path's grid "
        "(sweep_frontier, 2016 points) cut in duration only, 1, 5, 33 points, the ring's edges "
        "and the early stop; every output bit-equal")
    adaptive_sweep.launches = 0
    adaptive_sweep.launches_by_build = {}
    cases = adaptive_compare_cases()
    max_abs, failed, forced_seen = 0.0, [], False
    for name, grid, cfg, slot_us, replace in cases:
        args, params = adaptive_sweep_inputs(grid, cfg, slot_us, "cuda")
        params = dataclasses.replace(params, **replace)
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
        done = "run_steps" in replace or bool(
            (out["sim_time"] == np.float32(cfg.duration_us)).all())
        if name.startswith("early stop"):
            # point 7 paced in the budget's last eighth; every other point
            # stopped more than three stages before the budget's end
            n = out["n_steps"].cpu()
            rest = torch.cat([n[:7], n[8:]])
            done &= (float(n[7]) > params.max_steps - max(params.max_steps // 8, 2)
                     and float(out["forced_steps"][7]) > 0
                     and float(rest.max()) < params.max_steps - 3 * STAGE_STEPS)
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
            f"{'every point where it should stop' if replace else 'every point at its duration'}"
            f": {done}; plain {plain_s:.2f} s "
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
    bound (``sweep_bound``) and S1's plain version over its first 400
    slots.  One launch a sweep, every build among those phase 2 compared;
    the exact identities at every point.  Also the kernel launched alone
    (``launch_adaptive``), and from that time the us a step of the longest
    point (the chain the design shortens)."""
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
        # the kernel launched alone (no host sync between the events, as
        # the wrapper's choice of build makes)
        kernel_ms = time_ms(launch_adaptive, args, params, int(args[2].max()),
                            int(args[3].max()), iters=5, warmup=1)
        us_step = 1e3 * kernel_ms / sp["steps_max"]
        rows.append({
            "name": name, "ms": ms, "plain_ms": plain_ms, "plain_steps": ADAPTIVE_PLAIN_STEPS,
            "library_ms": None, "launches": 1, "bound_ms": b["bound_ms"],
            "bound_by": b["bound_by"], "bound_resource": b["bound_resource"],
            "point_steps_per_s": rate, "build": f"<{build[0]}, {build[1]}>",
            "kernel_ms": kernel_ms, "us_per_step": us_step, "s1_ms": s1_ms,
            "s1_slots": n_slots, **s1_extra, "budget": params.max_steps, **sp,
            "forced_steps": float(out["forced_steps"].sum()),
            "shape": f"{len(grid)} points, budget {params.max_steps} steps, live steps max "
                     f"{sp['steps_max']:.0f} mean {sp['steps_mean']:.1f} (S1: {n_slots} "
                     f"slots), m <= {int(grid.m.max())}, n_queues <= "
                     f"{int(grid.n_queues.max())}, flags {params.flags}; plain_ms over the "
                     f"first {ADAPTIVE_PLAIN_STEPS} steps"})
        log(f"  {name}: {len(grid)} points, build <{build[0]}, {build[1]}>, "
            f"budget {params.max_steps} steps: kernel "
            f"{ms:.3f} ms through the wrapper ({rate:.4e} point-steps/s), {kernel_ms:.3f} ms "
            f"launched alone ({us_step:.4f} us a step of the longest point); live "
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


def launch_adaptive(args, params, m_max: int, q_max: int, lib=None):
    """One launch of the event-jump sweep kernel past its wrapper (so that no
    launch counter moves), for phase 3's time of the kernel alone and
    ``--adaptive-ab``'s A/B of two sources (``lib``, default this
    checkout's): its build, then its outputs sums (14, P), win and ends
    (2, P)."""
    from repro_torch.kernels.adaptive_sweep.kernel import launch_adaptive_sweep
    from repro_torch.kernels.adaptive_sweep.ops import SUM_NAMES
    cols = dict(zip(("t_s", "t_l", "m", "nq", "lam", "seed_lo", "seed_hi"), args[:7]))
    n = args[0].shape[0]
    sums = torch.empty((len(SUM_NAMES), n), dtype=torch.float32, device="cuda")
    win = torch.empty((n, params.n_windows, 5), dtype=torch.float32, device="cuda")
    ends = torch.empty((2, n), dtype=torch.float32, device="cuda")
    build = launch_adaptive_sweep(cols, args[7], args[8], params, sums, win, ends, m_max=m_max,
                                  q_max=q_max, lib=lib)
    return build, sums, win, ends


def phase_adaptive_source_ab(sources: list[str]) -> list[dict]:
    """``--adaptive-ab SRC...``: this checkout's event-jump sweep kernel
    against other sources with the C interface ``adaptive_sweep_fwd`` of
    ``csrc/adaptive_sweep.cu`` (a parent commit's, a variant), each built
    with the same flags, at phase 3's five sweeps (``adaptive_settings``),
    uncut.  Each is timed as the median of 5 CUDA-event timings after 1
    warm-up, in the order this, SRC1 .. SRCn, SRCn .. SRC1, this (A B B A
    for one source), all launched the same way (``launch_adaptive``); a
    source's us a step is its mean time over the longest point's live steps
    in its own run; every output of each source is compared bit for bit
    with this checkout's (reported, not required: a variant may compute
    something else)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.adaptive_sweep import kernel as as_kernel
    from repro_torch.kernels.adaptive_sweep.ops import SUM_NAMES
    from repro_torch.runtime.batched_adaptive import adaptive_sweep_inputs
    named = {"this": as_kernel._SOURCE, **{s: str(Path(s).resolve()) for s in sources}}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(named)) as pool:
        libs = dict(zip(named, pool.map(as_kernel.build, named.values())))
    log(f"adaptive A/B: built {len(named)} sources in parallel in "
        f"{time.perf_counter() - t0:.2f} s")
    for name, source in named.items():
        info = _build.BUILD_INFO[source]
        log(f"  {name}: nvcc {info['seconds']:.2f} s; ptxas {ptxas_kernels(info['log'])}")
    order = [*named, *reversed(named)]
    steps = SUM_NAMES.index("n_steps")
    rows = []
    for name, grid, cfg, slot_us in adaptive_settings():
        args, params = adaptive_sweep_inputs(grid, cfg, slot_us, "cuda")
        m_max, q_max = int(args[2].max()), int(args[3].max())
        outs = {k: launch_adaptive(args, params, m_max, q_max, lib=lib)
                for k, lib in libs.items()}
        equal = {k: all(torch.equal(a, b) for a, b in zip(outs["this"][1:], o[1:]))
                 for k, o in outs.items() if k != "this"}
        longest = {k: float(o[1][steps].max()) for k, o in outs.items()}
        times = {k: [] for k in named}
        for k in order:
            times[k].append(time_ms(launch_adaptive, args, params, m_max, q_max, libs[k],
                                    iters=5, warmup=1))
        us_step = {k: 1e3 * statistics.mean(ts) / longest[k] for k, ts in times.items()}
        log(f"  {name} ({len(grid)} points, budget {params.max_steps} steps, build "
            f"<{outs['this'][0][0]}, {outs['this'][0][1]}>), order {' '.join(order)}: "
            + "; ".join(f"{k} " + ", ".join(f"{t:.3f}" for t in ts) + f" ms (longest point "
                        f"{longest[k]:.0f} steps, {us_step[k]:.4f} us a step)"
                        for k, ts in times.items()) + f"; bit-equal to this: {equal}")
        rows.append({"name": name, "points": len(grid), "budget": params.max_steps,
                     "steps_max": longest, "times_ms": times, "us_per_step": us_step,
                     "bit_equal": equal})
    log(f"adaptive A/B took {time.perf_counter() - t0:.1f} s")
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
    flash_attention.launches_by_route = {"wgmma": 0, "mma": 0}
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
            "wgmma": n_layers * len(reqs), "mma": 0}:
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
    over 2,000 slots (1,000 at 33 hosts); beyond a block's 256 lanes the
    cluster route (a cluster of 8 blocks a point, K hosts a lane) at 1,000
    hosts (the scale row's, uniform, one queue), 1,500 (six hosts a lane)
    and its largest H (K_max hosts a lane), and one host past it, both
    builds (the scratch route), over 200-300 slots; m x n_queues 1-4 (<4,
    4>) or one queue a point (<4, 1>, the build of benchmarks/fleet.py's
    grids)."""
    from repro_torch.kernels.fleet_sweep import kernel as fleet_kernel
    from repro_torch.runtime import FleetConfig, FleetGrid, SimRunConfig, SleepModel
    tail = SleepModel(base_us=2.8, slope=0.027, sigma_us=0.5, tail_prob=0.01,
                      tail_mean_us=40.0)
    noisy = dict(BAND_NOISY, stall_rate_per_us=1.0 / 400.0)
    link = dict(near_cost_us=1.0, far_cost_us=5.0)
    big = dict(lb="least-loaded", lb_stale_us=2.0, far_fraction=0.5, link_rate_mpps=10_000.0,
               **link)
    top = 256 * fleet_kernel.MAX_HOSTS_PER_LANE
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
            (1_000, {}, 300, True),
            (1_500, big, 300, False),
            (top, big, 200, False),
            (top + 1, big, 200, True),
            (top + 1, big, 200, False)):
        cfg = SimRunConfig(duration_us=0.5 * slots, sleep_model=tail, queue_capacity=64,
                           **noisy)
        fleet = FleetConfig(n_hosts=hosts, **kw)
        name = (f"{hosts} host{'s' if hosts > 1 else ''}, {fleet.lb}"
                f"{', link' if fleet.link_rate_mpps else ''}, "
                f"{'one queue' if one_queue else 'm x n_queues 1-4'}, {slots} slots")
        cases.append((name, FleetGrid.of_points(
            fleet_points(hosts, (0.0, 20.0, 80.0), True, one_queue), fleet=fleet), cfg, 0.5))
    return cases


def fleet_edge_cases():
    """(name, fgrid, cfg, slot_us): S3's ring at its edges, the cases of
    tests/test_torch_fleet.py's ``_edge_case``: least-loaded with the link
    and hedging on, every noise family, queues of 24 packets, four points
    (m = n_queues = 1..4, deadlines 0, 0.2, 1 and 5 us, a step schedule
    changing inside a stage, a ramp), at 1, 5 and 33 hosts, over 4 C - 1,
    4 C and 4 C + 1 slots (C slots a stage: the ring wraps at 2 C), the
    snapshot refreshed every 1, 3 and 7 slots."""
    from repro_torch.kernels.fleet_sweep import kernel as fleet_kernel
    from repro_torch.runtime import (
        FleetConfig,
        FleetGrid,
        RampSchedule,
        SimRunConfig,
        SleepModel,
        StepSchedule,
    )
    c = fleet_kernel.STAGE_SLOTS
    sleep = SleepModel(base_us=2.8, slope=0.027, sigma_us=0.5, tail_prob=0.2, tail_mean_us=6.0)
    scheds = (None, StepSchedule(times_us=(0.0, 3.2), scales=(0.5, 1.6)),
              RampSchedule(t_start_us=1.1, t_end_us=14.3, scale_from=0.3, scale_to=1.4),
              StepSchedule(times_us=(0.0, 9.7), scales=(1.3, 0.6)))
    cases = []
    for hosts in (1, 5, 33):
        for live in (4 * c - 1, 4 * c, 4 * c + 1):
            for stale in (1, 3, 7):
                rng = np.random.default_rng(hosts)
                pts = []
                for i, deadline in enumerate((0.0, 0.2, 1.0, 5.0)):
                    p = dict(t_s_us=float(rng.uniform(1.5, 4.0)),
                             t_l_us=float(rng.uniform(6.0, 20.0)), m=i + 1, n_queues=i + 1,
                             seed=int(rng.integers(0, 5)),
                             rate_mpps=float(rng.uniform(0.5, 1.0) * MU_MPPS * (i + 1) / 2.0
                                             * hosts),
                             hedge_deadline_us=deadline)
                    if scheds[i] is not None:
                        p["schedule"] = scheds[i]
                    pts.append(p)
                fleet = FleetConfig(n_hosts=hosts, lb="least-loaded", lb_stale_us=0.5 * stale,
                                    far_fraction=0.6, near_cost_us=1.0, far_cost_us=5.0,
                                    link_rate_mpps=8.0 * hosts)
                cfg = SimRunConfig(duration_us=0.5 * live, queue_capacity=24, sleep_model=sleep,
                                   interference_prob=0.25, interference_mean_us=4.0,
                                   stall_rate_per_us=1.0 / 10.0, stall_mean_us=3.0)
                cases.append((f"{hosts} hosts, {live} slots, refresh every {stale}",
                              FleetGrid.of_points(pts, fleet=fleet), cfg, 0.5))
    return cases


def phase_compare_fleet() -> dict:
    """S3 against its plain version on the card (``fleet_compare_cases``):
    every output bit-equal (the same float32 operations in the same order,
    the host sums in the kernel's tree, no fma contraction, the same math
    library), and at the ring's edges (``fleet_edge_cases``).  Then the
    per-host rule on the card: with uniform shares and topology and hedging
    off, host h of a point seeded s equals S1's kernel at seed s + h and
    rate float32(rate) x float32(1/H), every output bit for bit, at 4 and
    33 hosts.  Returns the max abs error and the builds compared."""
    from repro_torch.kernels.fleet_sweep import fleet_sweep, reference_fleet_sweep
    from repro_torch.kernels.fleet_sweep.ops import STAT_NAMES as FLEET_STATS
    from repro_torch.kernels.slot_sweep import slot_sweep
    from repro_torch.kernels.slot_sweep.ops import STAT_NAMES
    from repro_torch.runtime import FleetConfig, FleetGrid, SimRunConfig, SweepGrid
    from repro_torch.runtime.batched import sweep_inputs
    from repro_torch.runtime.fleet import fleet_inputs
    t0 = time.perf_counter()
    log("phase 2: fleet_sweep (S3) vs plain version: 1, 3, 4, 33, 64 hosts over 1,000-2,000 "
        "slots (the ring route), 1,000, 1,500 and the cluster route's largest H over 200-300 "
        "(the cluster route) and one host more (the scratch route), each balancer, topology, "
        "hedge deadlines 0/20/80, every noise family, schedules, m x n_queues 1-4 and one "
        "queue; the ring's edges; every output bit-equal; then the per-host rule against S1's "
        "kernel")
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
            f"{build[1]}> {build[2]}, flags {params.flags}, {params.live_slots()} slots: "
            "max_abs_err="
            f"{abs_err:.3e}; bit-equal: {len(exact)} of {len(FLEET_STATS)} outputs"
            f"{'' if len(exact) == len(FLEET_STATS) else ' ' + str(sorted(set(FLEET_STATS) - set(exact)))}"
            f"; hedge_dup {hedged:.1f}, topo_area {float(out['topo_area'].sum()):.1f}; plain "
            f"{plain_s:.2f} s {'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(name)
        max_abs = max(max_abs, abs_err)
    builds = set(fleet_sweep.launches_by_build)
    want = {(4, q, r) for q in (1, 4) for r in ("ring", "cluster", "scratch")}
    if fleet_sweep.launches != len(cases) or builds != want:
        fail(f"fleet_sweep counted {fleet_sweep.launches} launches "
             f"({fleet_sweep.launches_by_build}) for {len(cases)} calls; want the six builds "
             f"{sorted(want)}")
    # the ring's edges: every output bit-equal
    edges = fleet_edge_cases()
    edge_failed = []
    for name, fgrid, cfg, slot_us in edges:
        args, params, fparams = fleet_inputs(fgrid, cfg, slot_us, "cuda")
        out = fleet_sweep(*args, params=params, fleet=fparams)
        ref = reference_fleet_sweep(*args, params, fparams)
        differ = [k for k in FLEET_STATS if not torch.equal(out[k], ref[k])]
        if differ or float(out["hedge_dup"].sum()) <= 0:
            edge_failed.append(f"{name}: {differ}")
    log(f"  ring edges ({len(edges)} cases: 1, 5, 33 hosts x 4C-1, 4C, 4C+1 slots x refresh "
        f"every 1, 3, 7; least-loaded, link, hedging, every noise family, schedules): "
        f"{len(edges) - len(edge_failed)} of {len(edges)} bit-equal in every output"
        + (f"; FAIL {edge_failed}" if edge_failed else ""))
    failed += [f"ring edge {e}" for e in edge_failed]
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
    reductions' tree (2) and the snapshot's queue sum, all once every
    stale_every slots, when the snapshot refreshes (the shares hold between
    refreshes; ``bound_ms_softmax_every_slot`` is the bound with all but the
    queue sum counted every slot);
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
    # least-loaded: float32 and special-function operations a host-refresh
    lb_f32 = 4 + 1 + 4 + 1 + 2 + float(q.double().mean())
    refreshes = host_slots / fparams.stale_every_slots
    if fparams.lb_code == 2:
        f32 += refreshes * lb_f32
        sfu += refreshes * 2
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

    def least_time(ops):
        return {"f32": ops["f32"] / PEAK_F32_OPS * 1e3,
                "int32": ops["int32"] / PEAK_INT32_OPS * 1e3,
                "cvt": ops["cvt"] / PEAK_SFU_OPS * 1e3,
                "sfu": ops["sfu"] / PEAK_SFU_OPS * 1e3,
                "bytes": nbytes / PEAK_BYTES_PER_S * 1e3}
    times = least_time(ops)
    worst = max(times, key=times.get)
    every_slot = dict(ops)
    if fparams.lb_code == 2:
        every_slot["f32"] += (host_slots - refreshes) * (lb_f32 - float(q.double().mean()))
        every_slot["sfu"] += (host_slots - refreshes) * 2
    per = {k: v / host_slots for k, v in (*ops.items(), ("bytes", nbytes))}
    return {"bound_ms": times[worst], "bound_by": "bytes" if worst == "bytes" else "operations",
            "bound_resource": worst, "bound_times_ms": times, "host_slots": host_slots,
            "per_host_slot": per,
            "bound_ms_softmax_every_slot": max(least_time(every_slot).values())}


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
            "host_slots_per_s": rate, "build": f"<{build[0]}, {build[1]}> {build[2]}",
            "route": build[2], "s1_ms": s1_ms,
            "shape": f"{len(fgrid)} points x {fparams.n_hosts} hosts x {n_live} slots of "
                     f"{slot_us} us, lb {fgrid.fleet.lb}, hedge {list(FLEET_HEDGES)}, stalls; "
                     f"plain_ms over the first {cut.live_slots()} slots",
            "out": out})
        log(f"  {name}: {len(fgrid)} points x {fparams.n_hosts} hosts x {n_live} slots, build "
            f"<{build[0]}, {build[1]}> {build[2]}: kernel {ms:.3f} ms ({rate:.4e} host-slots/s, "
            f"{1e3 * ms / n_live:.3f} us a slot); bit-equal to the plain version over "
            f"{cut.live_slots()} slots on {len(FLEET_STATS)} of {len(FLEET_STATS)} outputs, "
            f"hedge_dup {float(kern['hedge_dup'].sum()):.1f}; plain {plain_ms:.1f} ms measured for "
            f"{cut.live_slots()} slots ({plain_ms * n_live / cut.live_slots() / 1e3:.0f} s "
            f"scaled to {n_live} slots, not measured); "
            + (f"S1 on the {len(fgrid) * fparams.n_hosts} host rows {s1_ms:.3f} ms "
               f"(S3 {ms / s1_ms:.2f}x); " if s1_ms else "")
            + f"library none; bound {b['bound_ms'] * 1e3:.2f} us ({b['bound_resource']}; "
            + ", ".join(f"{k} {v * 1e3:.2f} us" for k, v in b["bound_times_ms"].items())
            + f"), {100 * b['bound_ms'] / ms:.4f}% of it"
            + (f" (with the softmax every slot: {b['bound_ms_softmax_every_slot'] * 1e3:.2f} us)"
               if fparams.lb_code == 2 else "")
            + "; per host-slot " + ", ".join(
                f"{k} {v:.3g}" for k, v in b["per_host_slot"].items()))
    log(f"  phase 3 (fleet_sweep) took {time.perf_counter() - t0:.1f} s")
    return rows


def launch_fleet(args, params, fparams, lib=None):
    """One launch of the fleet sweep kernel past its wrapper (so that no
    launch counter moves), for ``--fleet-ab``'s comparison of two sources
    (``lib``, default this checkout's): its stats (14, P, H)."""
    from repro_torch.kernels.fleet_sweep.kernel import launch_fleet_sweep
    from repro_torch.kernels.fleet_sweep.ops import STAT_NAMES as FLEET_STATS
    cols = dict(zip(("t_s", "t_l", "m", "nq", "lam", "seed_lo", "seed_hi", "hedge_d"),
                    args[:8]))
    stats = torch.empty((len(FLEET_STATS), args[0].shape[0], fparams.n_hosts),
                        dtype=torch.float32, device="cuda")
    launch_fleet_sweep(cols, args[8], args[9], params, fparams, stats,
                       m_max=int(args[2].max()), q_max=int(args[3].max()), lib=lib)
    return stats


def phase_fleet_source_ab(sources: list[str]) -> list[dict]:
    """``--fleet-ab SRC...``: this checkout's fleet sweep kernel against
    other sources with the same C interface and scratch layout as
    ``csrc/fleet_sweep.cu`` (a parent commit's, a variant), each built with
    the same flags, at phase 3's ten shapes (``fleet_settings``), uncut.
    Each is timed as the median of 3 CUDA-event timings after 1 warm-up, in
    the order this, SRC1 .. SRCn, SRCn .. SRC1, this (A B B A for one
    source), all launched the same way (``launch_fleet``); every output of
    each source is compared bit for bit with this checkout's (reported, not
    required: a variant may compute something else)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.fleet_sweep import kernel as fleet_kernel
    from repro_torch.runtime.fleet import fleet_inputs
    named = {"this": fleet_kernel._SOURCE, **{s: str(Path(s).resolve()) for s in sources}}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(named)) as pool:
        libs = dict(zip(named, pool.map(fleet_kernel.build, named.values())))
    log(f"fleet A/B: built {len(named)} sources in parallel in {time.perf_counter() - t0:.2f} s")
    for name, source in named.items():
        info = _build.BUILD_INFO[source]
        log(f"  {name}: nvcc {info['seconds']:.2f} s; ptxas {ptxas_kernels(info['log'])}")
    order = [*named, *reversed(named)]
    rows = []
    for name, fgrid, cfg, slot_us in fleet_settings():
        args, params, fparams = fleet_inputs(fgrid, cfg, slot_us, "cuda")
        outs = {k: launch_fleet(args, params, fparams, lib) for k, lib in libs.items()}
        equal = {k: torch.equal(outs["this"], o) for k, o in outs.items() if k != "this"}
        times = {k: [] for k in named}
        for k in order:
            times[k].append(time_ms(launch_fleet, args, params, fparams, libs[k], iters=3,
                                    warmup=1))
        n_live = params.live_slots()
        log(f"  {name} ({len(fgrid)} points x {fparams.n_hosts} hosts x {n_live} slots), order "
            f"{' '.join(order)}: " + "; ".join(
                f"{k} " + ", ".join(f"{t:.3f}" for t in ts) + " ms ("
                f"{1e3 * statistics.mean(ts) / n_live:.4f} us a slot)" for k, ts in times.items())
            + f"; bit-equal to this: {equal}")
        rows.append({"name": name, "points": len(fgrid), "hosts": fparams.n_hosts,
                     "slots": n_live, "times_ms": times, "bit_equal": equal})
    log(f"fleet A/B took {time.perf_counter() - t0:.1f} s")
    return rows


def phase_cluster_exchange() -> list[dict]:
    """The cluster route's exchange alone (``fleet_cluster_exchange_probe``
    in csrc/fleet_sweep.cu): one cluster of 8 blocks runs ``n`` exchanges in
    turn, each feeding the next, timed as the median of 5 CUDA-event
    timings over n: mode 0 the bare push of a 16-byte record from every
    block into every block's shared memory (st.async, whose bytes complete
    that block's mbarrier) and the wait for it (one warp a block); modes 1
    and 2 the
    route's whole reduction (the in-turn fold of K warps' records, the
    32-lane butterfly, the exchange, the 8-group tree) of a sum and of the
    hedge record, at K = 2, 4 (the scale row) and 7 hosts a lane.  Returns
    the rows."""
    from repro_torch.kernels.fleet_sweep import kernel as fleet_kernel
    n = 20_000
    t0 = time.perf_counter()
    log(f"cluster exchange probe: one cluster of 8 blocks, {n} exchanges in turn; us an exchange")
    rows = []
    for mode, name in ((0, "bare 16-byte push and wait"), (1, "reduction of a sum"),
                       (2, "reduction of the hedge record")):
        for k in ((1,) if mode == 0 else (2, 4, 7)):
            out = torch.empty(8 * 32 * k, dtype=torch.float32, device="cuda")
            ms = time_ms(fleet_kernel.exchange_probe, mode, k, n, out, iters=5, warmup=1)
            if not bool(torch.isfinite(out).all()):
                fail(f"cluster exchange probe mode {mode} at K={k}: non-finite output")
            rows.append({"name": name, "mode": mode, "hosts_per_lane": k, "exchanges": n,
                         "ms": ms, "us_per_exchange": 1e3 * ms / n})
            log(f"  {name}{'' if mode == 0 else f', K={k} ({32 * k} threads a block)'}: "
                f"{ms:.3f} ms for {n} = {1e3 * ms / n:.4f} us an exchange")
    log(f"  cluster exchange probe took {time.perf_counter() - t0:.1f} s")
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
    by_route = {r: sum(n for b, n in fleet_sweep.launches_by_build.items() if b[2] == r)
                for r in ("ring", "cluster", "scratch")}
    if by_route != {"ring": len(settings) - 1, "cluster": 1, "scratch": 0}:
        fail(f"fleet_bench launched the routes {by_route}; want the ring route for each size x "
             "balancer and the cluster route for the scale row")
    log(f"  main path (S3) took {time.perf_counter() - t0:.1f} s")
    return {"launches": launches["fleet_sweep"], "by_route": by_route, "host_s": host_s,
            "busy_mean": busy_mean,
            "points": {name: fleet_point_rows(fs) for name, fs, _ in results},
            "verdict": {"n_hosts": hosts, "hedge_deadline_us": best_d, "cpu_cores": best_cpu,
                        "p999_us": best_p999, "busy_poll_p999_us": busy_p999}}


def fleet_point_rows(fs) -> list[dict]:
    """Each point's hedge deadline, fleet cores, mean latency, p99.9 (the
    hedged-tail closed form) and loss."""
    return [{"hedge_us": float(fs.fgrid.hedge_deadline_us[i]),
             "cores": float(fs.total_cpu_cores[i]), "mean_us": float(fs.mean_latency_us[i]),
             "p999_us": fs.quantile(i, 0.999), "loss": float(fs.loss_fraction[i])}
            for i in range(len(fs))]


# -- S3b: the fleet sweep by event jumps (runtime/fleet.py's fleet_step_a) -----

# the plain version runs, and the kernel is held to it, over this prefix of
# every phase-3 shape's steps
FLEET_ADAPTIVE_PLAIN_STEPS = 300
# tests/test_stepping.py::test_fleet_adaptive_parity_and_steps's grid (:165)
STEPPING_FLEET_US = 30_000.0


def fleet_adaptive_compare_cases():
    """(name, fgrid, cfg, slot_us, AdaptiveParams fields replaced, what the
    case must show): S3b against its plain version.  Every noise family,
    queues of 64 packets, hedge deadlines 0, 20 and 80 cycling over the
    points, every other point on a step schedule, m x n_queues 1-4 or one
    queue a point: 1 host (a lone lane; its duplicates come back to it), 3
    (weighted, link), 4 (least-loaded), 33 (least-loaded, link: two warps),
    64 (uniform, link), 256 (least-loaded, eight warps) and 257 (the
    cluster route: a cluster of 8 blocks a point, two hosts a lane) over
    1,000-2,000 steps of 0.5 us, 1,000 (the scale row's, uniform, one
    queue), 1,500 and the cluster route's largest H over 300, and one host
    past it, both builds (the scratch route), over 200 (up to 4 hosts the runs stop
    more than three stages before their budget's end); slots of 10 us, whose
    budget's tail paces; budgets on the ring's stage edges; 33, 48, 63 and 64
    hosts (two consumer warps, every reduction across the named barrier) over
    500 steps: least-loaded refreshing every 2 us with every point hedged (a
    refresh step right after a hedged one), the link without hedging, and at
    5 and 40 hosts a load of 5% with every point hedged (most steps every
    backlog equal: b1 and b2 the lowest indices); and benchmarks/fleet.py's
    H=64 least-loaded shape cut to 1,000 steps."""
    from repro_torch.kernels.fleet_adaptive_sweep import kernel as fas_kernel
    from repro_torch.runtime import FleetConfig, FleetGrid, SimRunConfig, SleepModel
    tail = SleepModel(base_us=2.8, slope=0.027, sigma_us=0.5, tail_prob=0.01,
                      tail_mean_us=40.0)
    noisy = dict(BAND_NOISY, stall_rate_per_us=1.0 / 400.0)
    link = dict(near_cost_us=1.0, far_cost_us=5.0)
    big = dict(lb="least-loaded", lb_stale_us=2.0, far_fraction=0.5, link_rate_mpps=10_000.0,
               **link)
    top = 256 * fas_kernel.MAX_HOSTS_PER_LANE
    cases = []
    for hosts, kw, steps, one_queue in (
            (1, dict(near_cost_us=2.0), 2_000, True),
            (3, dict(lb="weighted", host_weights=(1.0, 2.0, 3.0), far_fraction=0.34,
                     link_rate_mpps=10.0, **link), 2_000, False),
            (4, dict(lb="least-loaded", lb_stale_us=5.0), 2_000, True),
            (4, dict(lb="least-loaded", lb_stale_us=5.0), 2_000, False),
            (33, dict(lb="least-loaded", lb_stale_us=5.0, far_fraction=0.5,
                      link_rate_mpps=300.0, **link), 1_000, False),
            (64, dict(far_fraction=0.25, link_rate_mpps=400.0, **link), 1_000, True),
            (256, dict(lb="least-loaded", lb_stale_us=5.0), 1_000, False),
            (257, big, 1_000, False),
            (1_000, {}, 300, True),
            (1_500, big, 300, False),
            (top, big, 300, False),
            (top + 1, big, 200, True),
            (top + 1, big, 200, False)):
        fleet = FleetConfig(n_hosts=hosts, **kw)
        pts = fleet_points(hosts, (0.0, 20.0, 80.0), True, one_queue)
        label = (f"{hosts} host{'s' if hosts > 1 else ''}, {fleet.lb}"
                 f"{', link' if fleet.link_rate_mpps else ''}, "
                 f"{'one queue' if one_queue else 'm x n_queues 1-4'}")
        cfg = SimRunConfig(duration_us=0.5 * steps, sleep_model=tail, queue_capacity=64,
                           **noisy)
        # up to 4 hosts the run stops far inside its budget (the early stop)
        cases.append((f"{label}, {steps} slots of 0.5 us", FleetGrid.of_points(pts, fleet=fleet),
                      cfg, 0.5, {}, "early" if hosts <= 4 else None))
        if hosts in (3, 257):   # at 257 hosts with one queue a point: <4, 1> cluster
            paced = [dict(p, n_queues=1) for p in pts] if hosts == 257 else pts
            cases.append((f"{label}{', one queue' if hosts == 257 else ''}, 200 slots of 10 us "
                          "(tail pacing)", FleetGrid.of_points(paced, fleet=fleet),
                          dataclasses.replace(cfg, duration_us=2_000.0), 10.0, {}, "paced"))
    # budgets on a stage's edges: every point paced
    c = fas_kernel.STAGE_STEPS
    for budget in (4 * c - 1, 4 * c, 4 * c + 1):
        for hosts in (5, 33):
            fgrid, cfg, _ = [x for x in fleet_edge_cases()
                             if x[0].startswith(f"{hosts} hosts, {4 * c + 1} slots, "
                                                "refresh every 3")][0][1:]
            cases.append((f"{hosts} hosts ring edge, 150 us, budget {budget}", fgrid,
                          dataclasses.replace(cfg, duration_us=150.0), 0.5,
                          {"max_steps": budget}, "paced"))
    hedged_all = (20.0, 40.0, 80.0)
    for hosts, kw, hedges, load, label in (
            (33, dict(lb="least-loaded", lb_stale_us=2.0), hedged_all, 1.0,
             "least-loaded every 2 us, every point hedged"),
            (48, dict(far_fraction=0.5, link_rate_mpps=200.0, **link), (0.0,), 1.0,
             "the link without hedging"),
            (63, dict(lb="weighted", host_weights=tuple(1.0 + (h % 3) for h in range(63))),
             (0.0, 20.0, 80.0), 1.0, "weighted"),
            (64, dict(lb="least-loaded", lb_stale_us=2.0, far_fraction=0.25,
                      link_rate_mpps=400.0, **link), hedged_all, 1.0,
             "least-loaded every 2 us, link, every point hedged"),
            (5, {}, hedged_all, 0.05, "5% load, every point hedged (equal backlogs)"),
            (40, dict(lb="least-loaded", lb_stale_us=2.0), hedged_all, 0.05,
             "least-loaded, 5% load, every point hedged (equal backlogs)")):
        pts = [dict(p, rate_mpps=p["rate_mpps"] * load)
               for p in fleet_points(hosts, hedges, True, False)]
        cfg = SimRunConfig(duration_us=250.0, sleep_model=tail, queue_capacity=64, **noisy)
        cases.append((f"{hosts} hosts, {label}, 500 slots of 0.5 us",
                      FleetGrid.of_points(pts, fleet=FleetConfig(n_hosts=hosts, **kw)), cfg, 0.5,
                      {}, None))
    name, fgrid, cfg, _ = [x for x in fleet_settings() if x[0] == "H64/least-loaded"][0]
    cases.append((f"{name} (benchmarks/fleet.py), 1,000 steps", fgrid, cfg, 0.5,
                  {"run_steps": 1_000}, None))
    return cases


def phase_compare_fleet_adaptive() -> dict:
    """S3b against its plain version on the card
    (``fleet_adaptive_compare_cases``): every output bit-equal, both routes
    and both builds; the paced cases with forced steps, the early stop more
    than three stages before its budget's end.  Returns the max abs error
    and the builds compared."""
    from repro_torch.kernels.fleet_adaptive_sweep import (
        fleet_adaptive_sweep,
        reference_fleet_adaptive_sweep,
    )
    from repro_torch.kernels.fleet_adaptive_sweep import kernel as fas_kernel
    from repro_torch.kernels.fleet_adaptive_sweep.ops import POINT_NAMES, STAT_NAMES
    from repro_torch.runtime.fleet import fleet_adaptive_inputs
    t0 = time.perf_counter()
    log("phase 2: fleet_adaptive_sweep (S3b) vs plain version: 1, 3, 4, 33, 64, 256 (the ring "
        "route) and 257 hosts over 1,000-2,000 steps of 0.5 us, 1,000, 1,500 and the cluster "
        "route's largest H over 300 (the cluster route), one host more (the scratch route) over "
        "200, each balancer, the link, hedge deadlines "
        "0/20/80, every noise family, schedules, m x n_queues 1-4 and one queue; tail pacing; "
        "an early stop; budgets on the ring's stage edges; 33, 48, 63 and 64 hosts; equal "
        "backlogs; a refresh after a hedged step; the link without hedging; every output "
        "bit-equal")
    fleet_adaptive_sweep.launches = 0
    fleet_adaptive_sweep.launches_by_build = {}
    names = (*STAT_NAMES, *POINT_NAMES)
    cases = fleet_adaptive_compare_cases()
    max_abs, failed, edge_stops = 0.0, [], 0
    for name, fgrid, cfg, slot_us, replace, must in cases:
        args, params, fparams = fleet_adaptive_inputs(fgrid, cfg, slot_us, "cuda")
        params = dataclasses.replace(params, **replace)
        before = dict(fleet_adaptive_sweep.launches_by_build)
        out = fleet_adaptive_sweep(*args, params=params, fleet=fparams)
        (build,) = [b for b, n in fleet_adaptive_sweep.launches_by_build.items()
                    if n != before.get(b, 0)]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        ref = reference_fleet_adaptive_sweep(*args, params, fparams)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t1
        exact = [k for k in names if torch.equal(out[k], ref[k])]
        finite = all(bool(torch.isfinite(out[k]).all()) for k in names)
        abs_err = max(float((out[k].double() - ref[k].double()).abs().max()) for k in names)
        steps = ref["n_steps"].cpu()
        forced = float(ref["forced_steps"].sum())
        shows = {"paced": forced > 0,
                 "early": float(steps.max()) < params.max_steps - 3 * fas_kernel.STAGE_STEPS,
                 None: True}[must]
        if must == "early":   # points whose block stopped on a stage's first step
            edge_stops += int((steps.long() % fas_kernel.STAGE_STEPS == 0).sum())
        ok = len(exact) == len(names) and finite and float(out["wakeups"].sum()) > 0 and shows
        log(f"  {name}: {len(fgrid)} points x {fparams.n_hosts} hosts, build <{build[0]}, "
            f"{build[1]}> {build[2]}, budget {params.max_steps}{', run ' + str(params.steps) if params.run_steps else ''}: "
            f"live steps {int(steps.min())}-{int(steps.max())}, forced {forced:.0f}; "
            f"max_abs_err={abs_err:.3e}; bit-equal: {len(exact)} of {len(names)} outputs"
            f"{'' if len(exact) == len(names) else ' ' + str(sorted(set(names) - set(exact)))}"
            f"; hedge_dup {float(out['hedge_dup'].sum()):.1f}, topo_area "
            f"{float(out['topo_area'].sum()):.1f}; plain {plain_s:.2f} s {'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(name)
        max_abs = max(max_abs, abs_err)
    builds = set(fleet_adaptive_sweep.launches_by_build)
    want = {(4, q, r) for q in (1, 4) for r in ("ring", "cluster", "scratch")}
    if fleet_adaptive_sweep.launches != len(cases) or builds != want:
        fail(f"fleet_adaptive_sweep counted {fleet_adaptive_sweep.launches} launches "
             f"({fleet_adaptive_sweep.launches_by_build}) for {len(cases)} calls; want the six "
             f"builds {sorted(want)}")
    if failed:
        fail(f"fleet_adaptive_sweep disagrees with its plain version ({'; '.join(failed)})")
    log(f"  {edge_stops} points of the early-stop cases stopped on a stage's first step")
    if edge_stops == 0:
        fail("no point of the early-stop cases stopped on a stage's first step")
    log(f"  phase 2 (fleet_adaptive_sweep) took {time.perf_counter() - t0:.1f} s")
    return {"max_abs_err": max_abs, "builds": builds}


def fleet_adaptive_bound(args, params, fparams, out) -> dict:
    """Least time for an S3b sweep's work on the card, counted from the code
    (csrc/fleet_adaptive_sweep.cu) for this run's points, hosts and live
    steps: each (point, host) as a point of S2's count (``adaptive_bound``:
    its draws, its jump bounds and its macro-slot, over its point's live
    steps), plus the cross-host stages a host-step as ``fleet_bound`` counts
    them: the jump's two minima (2 float32 operations and their tree, 2);
    the hosts' queue rates (2); least-loaded's softmax at each refresh (the
    lattice's points the run crosses); topology, the link (its division on
    the special-function unit) and hedging as ``fleet_bound``'s.  Bytes:
    each input read once (8 words a point, its schedule rows, H shares), each
    output written once (14 words a host, 3 a point)."""
    n_pts, n_h = out["offered"].shape
    rows = {"n_steps": out["n_steps"].repeat_interleave(n_h),
            "ts_arms": out["ts_arms"].flatten(), "busy_tries": out["busy_tries"].flatten(),
            "win": torch.empty(0)}
    m = args[2].repeat_interleave(n_h)
    q = args[3].repeat_interleave(n_h)
    s2 = adaptive_bound([None, None, m, q, None, None, None, None, None], params, rows)
    ops = {k: s2["per_point_step"][k] * s2["point_steps"] for k in ("f32", "int32", "cvt", "sfu")}
    steps = out["n_steps"].double().cpu().numpy()
    host_steps = float(steps.sum()) * n_h
    hedged_steps = float(steps[(args[7] > 0).cpu().numpy()].sum()) * n_h
    f32 = host_steps * (2 + 2 + 2)
    sfu = 0.0
    if fparams.lb_code == 2:
        stale = fparams.stale_every_slots * params.slot_us
        refreshes = float(np.ceil(out["sim_time"].double().cpu().numpy() / stale).sum()) * n_h
        f32 += refreshes * (4 + 1 + 4 + 1 + 2 + float(q.double().mean()))
        sfu += refreshes * 2
    if fparams.topo_on or hedged_steps:
        f32 += host_steps * 2
    if fparams.topo_on:
        f32 += host_steps * 2
        if fparams.link_on:
            f32 += float(steps.sum()) * 7
            sfu += float(steps.sum())
    f32 += hedged_steps * (6 + 5 + 4 + 2) + hedged_steps / n_h * 8 * float(
        args[3].double().mean()) * 2
    sfu += hedged_steps * 3
    ops["f32"] += f32
    ops["sfu"] += sfu
    nbytes = 4.0 * (8 * n_pts + 14 * n_pts * n_h + 3 * n_pts + n_h)
    if args[8] is not None:
        nbytes += 4.0 * (args[8].numel() + args[9].numel())
    times = {"f32": ops["f32"] / PEAK_F32_OPS * 1e3,
             "int32": ops["int32"] / PEAK_INT32_OPS * 1e3,
             "cvt": ops["cvt"] / PEAK_SFU_OPS * 1e3,
             "sfu": ops["sfu"] / PEAK_SFU_OPS * 1e3,
             "bytes": nbytes / PEAK_BYTES_PER_S * 1e3}
    worst = max(times, key=times.get)
    per = {k: v / host_steps for k, v in (*ops.items(), ("bytes", nbytes))}
    return {"bound_ms": times[worst], "bound_by": "bytes" if worst == "bytes" else "operations",
            "bound_resource": worst, "bound_times_ms": times, "host_steps": host_steps,
            "per_host_step": per}


def phase_time_fleet_adaptive(compared: set, s3_rows: list[dict]) -> list[dict]:
    """S3b at benchmarks/fleet.py's ten shapes, uncut (``fleet_settings``):
    the median of 3 CUDA-event timings after 1 warm-up, each behind the
    device-side spin; live steps (the longest point's, which set the block's
    chain, and the mean) against S3a's slots and S3a's time on the same
    shape (phase 3 of S3, this call); us a step of the longest point;
    host-steps/s; the bound (``fleet_adaptive_bound``); the kernel against
    its plain version over the first ``FLEET_ADAPTIVE_PLAIN_STEPS`` steps,
    every output bit-equal, the plain version's time from that one call.
    There is no PyTorch call that computes a sweep.  Returns the rows, each
    with its outputs for the main path's cross-check."""
    from repro_torch.kernels.fleet_adaptive_sweep import (
        fleet_adaptive_sweep,
        reference_fleet_adaptive_sweep,
    )
    from repro_torch.kernels.fleet_adaptive_sweep.ops import POINT_NAMES, STAT_NAMES
    from repro_torch.runtime.fleet import fleet_adaptive_inputs
    t0 = time.perf_counter()
    log("phase 3: fleet_adaptive_sweep (S3b) at benchmarks/fleet.py's shapes, uncut: kernel "
        "median of 3 CUDA-event timings after 1 warm-up; S3a on the same shape (its phase 3, "
        f"this call); the kernel bit-equal to its plain version over the first "
        f"{FLEET_ADAPTIVE_PLAIN_STEPS} steps, the plain version timed there; bound from the "
        "code's operations (fleet_adaptive_bound)")
    s3 = {r["name"]: r for r in s3_rows}
    names = (*STAT_NAMES, *POINT_NAMES)
    rows = []
    for name, fgrid, cfg, slot_us in fleet_settings():
        args, params, fparams = fleet_adaptive_inputs(fgrid, cfg, slot_us, "cuda")
        fleet_adaptive_sweep.launches = 0
        fleet_adaptive_sweep.launches_by_build = {}
        ms, out = time_ms(fleet_adaptive_sweep, *args, iters=3, warmup=1, return_out=True,
                          params=params, fleet=fparams)
        cut = dataclasses.replace(params, run_steps=FLEET_ADAPTIVE_PLAIN_STEPS)
        kern = fleet_adaptive_sweep(*args, params=cut, fleet=fparams)
        if fleet_adaptive_sweep.launches != 5:
            fail(f"{name}: fleet_adaptive_sweep counted {fleet_adaptive_sweep.launches} "
                 "launches for 5 calls")
        (build,) = fleet_adaptive_sweep.launches_by_build
        check_builds_compared(name, compared, fleet_adaptive_sweep)
        plain_ms, plain = time_ms(reference_fleet_adaptive_sweep, *args, cut, fparams, iters=1,
                                  warmup=0, return_out=True)
        differ = [k for k in names if not torch.equal(kern[k], plain[k])]
        if differ or float(kern["wakeups"].sum()) <= 0:
            fail(f"{name}: fleet_adaptive_sweep differs from its plain version over "
                 f"{FLEET_ADAPTIVE_PLAIN_STEPS} steps on {differ}")
        b = fleet_adaptive_bound(args, params, fparams, out)
        steps = out["n_steps"].double().cpu().numpy()
        longest, forced = float(steps.max()), float(out["forced_steps"].sum())
        rate = b["host_steps"] / (ms / 1e3)
        a = s3[name]
        slots = params.duration_us / slot_us
        rows.append({
            "name": name, "ms": ms, "plain_ms": plain_ms,
            "plain_steps": FLEET_ADAPTIVE_PLAIN_STEPS, "library_ms": None, "launches": 1,
            "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
            "bound_resource": b["bound_resource"], "host_steps_per_s": rate,
            "us_per_step": 1e3 * ms / longest, "steps_max": longest,
            "steps_mean": float(steps.mean()), "budget": params.max_steps,
            "forced_steps": forced, "s3a_ms": a["ms"], "s3a_slots": slots,
            "build": f"<{build[0]}, {build[1]}> {build[2]}",
            "shape": f"{len(fgrid)} points x {fparams.n_hosts} hosts, budget {params.max_steps} "
                     f"steps over {params.duration_us:g} us (S3a: {slots:.0f} slots of {slot_us} "
                     f"us), lb {fgrid.fleet.lb}, hedge {list(FLEET_HEDGES)}, stalls; plain_ms "
                     f"over the first {FLEET_ADAPTIVE_PLAIN_STEPS} steps",
            "out": out})
        log(f"  {name}: {len(fgrid)} points x {fparams.n_hosts} hosts, build <{build[0]}, "
            f"{build[1]}> {build[2]}: kernel {ms:.3f} ms (S3a {a['ms']:.3f} ms; S3b / S3a "
            f"{ms / a['ms']:.3f}); live steps {longest:.0f} longest, {steps.mean():.0f} "
            f"mean, of a {params.max_steps}-step budget (S3a {slots:.0f} slots), forced "
            f"{forced:.0f}; {1e3 * ms / longest:.4f} us a step of the longest point; "
            f"{rate:.4e} host-steps/s; bit-equal to the plain version over "
            f"{FLEET_ADAPTIVE_PLAIN_STEPS} steps; plain {plain_ms:.1f} ms measured for "
            f"{FLEET_ADAPTIVE_PLAIN_STEPS} steps; library none; bound "
            f"{b['bound_ms'] * 1e3:.2f} us ({b['bound_resource']}; "
            + ", ".join(f"{k} {v * 1e3:.2f} us" for k, v in b["bound_times_ms"].items())
            + f"), {100 * b['bound_ms'] / ms:.4f}% of it; per host-step " + ", ".join(
                f"{k} {v:.3g}" for k, v in b["per_host_step"].items()))
    log(f"  phase 3 (fleet_adaptive_sweep) took {time.perf_counter() - t0:.1f} s")
    return rows


def launch_fleet_adaptive(args, params, fparams, m_max: int, q_max: int, lib=None):
    """One launch of the fleet sweep by event jumps past its wrapper (so that
    no launch counter moves), for ``--fleet-adaptive-ab``'s comparison of
    two sources (``lib``, default this checkout's): its stats (14, P, H) and
    ends (3, P)."""
    from repro_torch.kernels.fleet_adaptive_sweep.kernel import launch_fleet_adaptive_sweep
    from repro_torch.kernels.fleet_adaptive_sweep.ops import POINT_NAMES, STAT_NAMES
    cols = dict(zip(("t_s", "t_l", "m", "nq", "lam", "seed_lo", "seed_hi", "hedge_d"),
                    args[:8]))
    n = args[0].shape[0]
    stats = torch.empty((len(STAT_NAMES), n, fparams.n_hosts), dtype=torch.float32,
                        device="cuda")
    ends = torch.empty((len(POINT_NAMES), n), dtype=torch.float32, device="cuda")
    launch_fleet_adaptive_sweep(cols, args[8], args[9], params, fparams, stats, ends,
                                m_max=m_max, q_max=q_max, lib=lib)
    return stats, ends


def phase_fleet_adaptive_source_ab(sources: list[str]) -> list[dict]:
    """``--fleet-adaptive-ab SRC...``: this checkout's fleet sweep by event
    jumps against other sources with the C interface and scratch layout of
    ``csrc/fleet_adaptive_sweep.cu`` (a parent commit's, a variant), each
    built with the same flags, at phase 3's ten shapes (``fleet_settings``),
    uncut.  Each is timed as the median of 3 CUDA-event timings after 1
    warm-up, in the order this, SRC1 .. SRCn, SRCn .. SRC1, this (A B B A
    for one source), all launched the same way (``launch_fleet_adaptive``);
    a source's us a step is its mean time over the longest point's live
    steps in its own run; every output of each source is compared bit for
    bit with this checkout's (reported, not required: a variant may compute
    something else)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.fleet_adaptive_sweep import kernel as fas_kernel
    from repro_torch.runtime.fleet import fleet_adaptive_inputs
    named = {"this": fas_kernel._SOURCE, **{s: str(Path(s).resolve()) for s in sources}}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(named)) as pool:
        libs = dict(zip(named, pool.map(fas_kernel.build, named.values())))
    log(f"fleet adaptive A/B: built {len(named)} sources in parallel in "
        f"{time.perf_counter() - t0:.2f} s")
    for name, source in named.items():
        info = _build.BUILD_INFO[source]
        log(f"  {name}: nvcc {info['seconds']:.2f} s; ptxas {ptxas_kernels(info['log'])}")
    order = [*named, *reversed(named)]
    rows = []
    for name, fgrid, cfg, slot_us in fleet_settings():
        args, params, fparams = fleet_adaptive_inputs(fgrid, cfg, slot_us, "cuda")
        m_max, q_max = int(args[2].max()), int(args[3].max())
        outs = {k: launch_fleet_adaptive(args, params, fparams, m_max, q_max, lib)
                for k, lib in libs.items()}
        equal = {k: all(torch.equal(a, b) for a, b in zip(outs["this"], o))
                 for k, o in outs.items() if k != "this"}
        live = {k: float(o[1][0].max()) for k, o in outs.items()}
        forced = {k: float(o[1][1].sum()) for k, o in outs.items()}
        times = {k: [] for k in named}
        for k in order:
            times[k].append(time_ms(launch_fleet_adaptive, args, params, fparams, m_max, q_max,
                                    libs[k], iters=3, warmup=1))
        us_step = {k: 1e3 * statistics.mean(ts) / live[k] for k, ts in times.items()}
        log(f"  {name} ({len(fgrid)} points x {fparams.n_hosts} hosts, budget "
            f"{params.max_steps} steps), order {' '.join(order)}: " + "; ".join(
                f"{k} " + ", ".join(f"{t:.3f}" for t in ts) + f" ms ({us_step[k]:.4f} us a "
                f"step; longest point {live[k]:.0f} live steps, {forced[k]:.0f} forced over "
                "the points)" for k, ts in times.items()) + f"; bit-equal to this: {equal}")
        rows.append({"name": name, "points": len(fgrid), "hosts": fparams.n_hosts,
                     "budget": params.max_steps, "steps_max": live, "forced_steps": forced,
                     "times_ms": times, "us_per_step": us_step, "bit_equal": equal})
    log(f"fleet adaptive A/B took {time.perf_counter() - t0:.1f} s")
    return rows


def _stepping_band(fs_f, fs_a) -> list[str]:
    """tests/test_stepping.py::test_fleet_adaptive_parity_and_steps's bands
    (:188-202) of S3b against S3a, point by point: the failures."""
    bad = []
    for i in range(len(fs_f)):
        lat_f, lat_a = float(fs_f.mean_latency_us[i]), float(fs_a.mean_latency_us[i])
        cores_f, cores_a = float(fs_f.total_cpu_cores[i]), float(fs_a.total_cpu_cores[i])
        loss_f, loss_a = float(fs_f.loss_fraction[i]), float(fs_a.loss_fraction[i])
        if abs(lat_a - lat_f) > max(1.5, 0.12 * lat_f):
            bad.append(f"point {i} latency {lat_a:.3f} vs {lat_f:.3f}")
        if abs(cores_a - cores_f) > 4 * 0.02 + 0.05 * cores_f:
            bad.append(f"point {i} cores {cores_a:.4f} vs {cores_f:.4f}")
        if abs(loss_a - loss_f) > 0.03:
            bad.append(f"point {i} loss {loss_a:.4f} vs {loss_f:.4f}")
    return bad


def phase_fleet_adaptive_main(compared: set, timed: list[dict], s3_main: dict) -> dict:
    """S3b's main path, in two parts, with every launch counter set to 0
    just before each and read just after.  (1) benchmarks/fleet.py's
    ``fleet_bench`` (full mode) through ``simulate_fleet(stepping=
    "adaptive")``: one call a size x balancer over the hedge ladder and the
    scale row, exactly one fleet_adaptive_sweep launch a call and no other
    kernel; each result equal to phase 3's launch of its shape bit for bit,
    the exact identities at every (point, host), each point's cores, mean
    latency and p99.9 beside S3a's (its main path, this call), and the
    verdict at 64 hosts.  (2) tests/test_stepping.py's fleet parity grid at
    its full 30 ms (4 hosts, least-loaded at 50 us stale, rho 0.2 and 0.6)
    against S3a: the reference's bands, n_steps <= 0.5 x S3a's, the
    simulated time float32(30 ms); where seed 0 leaves a band, the bands on
    the means of 8 seeds."""
    from repro_torch.kernels import (
        adaptive_sweep,
        decode_attention,
        flash_attention,
        fleet_adaptive_sweep,
        fleet_sweep,
        slot_sweep,
        ssd_scan,
    )
    from repro_torch.runtime import (
        FleetConfig,
        FleetGrid,
        HR_SLEEP_MODEL,
        SimRunConfig,
        hedged_latency_quantile,
        simulate_fleet,
    )
    t0 = time.perf_counter()
    log("main path (S3b): benchmarks/fleet.py's fleet_bench, full mode, through "
        "repro_torch.runtime.simulate_fleet(stepping=\"adaptive\")")
    settings = fleet_settings()
    tail_prob = min(FLEET_STALLS["stall_rate_per_us"] * FLEET_STALLS["stall_mean_us"], 0.5)
    counters = (flash_attention, decode_attention, ssd_scan, slot_sweep, adaptive_sweep,
                fleet_sweep, fleet_adaptive_sweep)
    for k in counters:
        k.launches = 0
    fleet_adaptive_sweep.launches_by_build = {}
    results = []
    t1 = time.perf_counter()
    for name, fgrid, cfg, slot_us in settings:
        t2 = time.perf_counter()
        fs = simulate_fleet(fgrid, cfg, slot_us=slot_us, stepping="adaptive")
        results.append((name, fs, time.perf_counter() - t2))
    host_s = time.perf_counter() - t1
    launches = {k.__name__: k.launches for k in counters}
    want = {k.__name__: 0 for k in counters} | {"fleet_adaptive_sweep": len(settings)}
    if launches != want:
        fail(f"fleet_bench (adaptive) launched {launches}; want one fleet_adaptive_sweep launch "
             f"for each of its {len(settings)} simulate_fleet calls")
    check_builds_compared("the fleet's adaptive main path", compared, fleet_adaptive_sweep)
    by_route = {r: sum(n for b, n in fleet_adaptive_sweep.launches_by_build.items() if b[2] == r)
                for r in ("ring", "cluster", "scratch")}
    if by_route != {"ring": len(settings) - 1, "cluster": 1, "scratch": 0}:
        fail(f"fleet_bench (adaptive) launched the routes {by_route}; want the ring route for "
             "each size x balancer and the cluster route for the scale row")
    verdicts = []
    busy_mean = s3_main["busy_mean"]
    for (name, fs, wall), row in zip(results, timed, strict=True):
        check_fleet_identities(name, fs, fs.cfg.energy_model)
        if fs.backend != "fleet_adaptive_sweep" or fs.scan_len != row["budget"] or not all(
                np.array_equal(getattr(fs, k), row["out"][k].double().cpu().numpy())
                for k in ("serviced", "lat_area", "awake_us", "hedge_dup", "energy_uj",
                          "n_steps")):
            fail(f"{name}: simulate_fleet ({fs.backend}) differs from phase 3's launch")
        if not np.all(fs.sim_time_us == np.float64(np.float32(fs.cfg.duration_us))):
            fail(f"{name}: simulated time {fs.sim_time_us} is not the duration")
        if name.startswith("scale"):
            log(f"    {name}: {wall:.3f} s host clock, live steps {fs.n_steps.max():.0f} of a "
                f"{fs.scan_len}-step budget")
            continue
        n_h = fs.n_hosts
        busy_p999 = hedged_latency_quantile(0.999, np.full(n_h, busy_mean),
                                            hedge_deadline_us=0.0, tail_prob=tail_prob,
                                            tail_scale_us=FLEET_STALLS["stall_mean_us"])
        for p_a, p_f in zip(fleet_point_rows(fs), s3_main["points"][name], strict=True):
            log(f"    fleet/{name}/D{p_a['hedge_us']:g}: S3b cores {p_a['cores']:.3f}, mean "
                f"{p_a['mean_us']:.2f} us, p999 {p_a['p999_us']:.1f} us, loss {p_a['loss']:.4f} | "
                f"S3a cores {p_f['cores']:.3f}, mean {p_f['mean_us']:.2f} us, p999 "
                f"{p_f['p999_us']:.1f} us, loss {p_f['loss']:.4f}")
            if "/uniform" in name and p_a["hedge_us"] > 0.0:
                verdicts.append((n_h, p_a["hedge_us"], p_a["cores"], p_a["p999_us"], busy_p999))
    hosts = FLEET_SIZES[-1]
    _, best_d, best_cpu, best_p999, busy_p999 = min(
        (v for v in verdicts if v[0] == hosts), key=lambda v: v[3])
    ok = bool(best_cpu < hosts and best_p999 <= busy_p999)
    v3 = s3_main["verdict"]
    log(f"  {len(settings)} simulate_fleet(stepping=\"adaptive\") calls in {host_s:.2f} s host "
        f"clock; launches {launches}, builds {fleet_adaptive_sweep.launches_by_build}")
    log(f"  verdict at {hosts} hosts (S3b): best hedged uniform point D={best_d:g} us burns "
        f"{best_cpu:.2f} cores (busy-poll {hosts}) at p99.9 {best_p999:.1f} us (busy-poll "
        f"{busy_p999:.1f} us): {'ok' if ok else 'FAIL'}; S3a's: D={v3['hedge_deadline_us']:g} "
        f"us, {v3['cpu_cores']:.2f} cores, p99.9 {v3['p999_us']:.1f} us")
    if not ok:
        fail("the hedged Metronome fleet (S3b) does not beat the busy-poll fleet on cores and "
             "p99.9")

    # (2) the reference's parity grid, S3b against S3a
    for k in counters:
        k.launches = 0

    def grid(seed):
        return FleetGrid.product(
            fleet=FleetConfig(n_hosts=4, lb="least-loaded", lb_stale_us=50.0),
            t_s_us=(30.0,), t_l_us=(400.0,), rate_mpps=(0.2 * MU_MPPS * 4, 0.6 * MU_MPPS * 4),
            m=(3,), n_queues=(2,), seeds=(seed,))

    cfg = SimRunConfig(duration_us=STEPPING_FLEET_US, sleep_model=HR_SLEEP_MODEL)
    f = simulate_fleet(grid(0), cfg, slot_us=0.5, shard=False)
    a = simulate_fleet(grid(0), cfg, slot_us=0.5, shard=False, stepping="adaptive")
    if (fleet_adaptive_sweep.launches, fleet_sweep.launches) != (1, 1):
        fail(f"the parity grid launched S3b {fleet_adaptive_sweep.launches} and S3a "
             f"{fleet_sweep.launches} times; want once each")
    check_fleet_identities("the parity grid (S3b)", a, cfg.energy_model)
    exact = {"sim_time": bool(np.all(a.sim_time_us == np.float64(np.float32(cfg.duration_us)))),
             "n_steps <= 0.5 x S3a's": bool(np.all(a.n_steps <= 0.5 * f.n_steps)),
             "scan_len < S3a's": a.scan_len < f.scan_len}
    bad = _stepping_band(f, a)
    for i in range(len(a)):
        log(f"    parity grid rho {0.2 if i == 0 else 0.6}: S3b mean {a.mean_latency_us[i]:.3f} "
            f"us, cores {a.total_cpu_cores[i]:.4f}, loss {a.loss_fraction[i]:.4f}, "
            f"{a.n_steps[i]:.0f} live steps of a {a.scan_len}-step budget | S3a mean "
            f"{f.mean_latency_us[i]:.3f} us, cores {f.total_cpu_cores[i]:.4f}, loss "
            f"{f.loss_fraction[i]:.4f}, {f.n_steps[i]:.0f} slots")
    eight = None
    if bad:
        log(f"  seed 0 leaves a band ({bad}): the bands on the means of {BAND_SEEDS} seeds")

        class Means:
            def __init__(self, runs):
                self.runs = runs

            def __len__(self):
                return len(self.runs[0])

            def __getattr__(self, k):
                return np.mean([getattr(r, k) for r in self.runs], axis=0)

        fs_f = [simulate_fleet(grid(s), cfg, slot_us=0.5) for s in range(BAND_SEEDS)]
        fs_a = [simulate_fleet(grid(s), cfg, slot_us=0.5, stepping="adaptive")
                for s in range(BAND_SEEDS)]
        bad = _stepping_band(Means(fs_f), Means(fs_a))
        eight = {"bands": "8-seed means", "failures": bad}
        log(f"  {BAND_SEEDS}-seed means: {'ok' if not bad else 'FAIL ' + str(bad)}")
    log(f"  parity grid (S3b vs S3a, 30 ms): bands {'ok' if not bad else 'FAIL ' + str(bad)}; "
        f"{exact}; S3b {a.n_steps.tolist()} live steps vs S3a {f.n_steps.tolist()} slots")
    if bad or not all(exact.values()):
        fail("S3b leaves the reference's parity bands against S3a on its parity grid")
    log(f"  main path (S3b) took {time.perf_counter() - t0:.1f} s")
    return {"launches": launches["fleet_adaptive_sweep"], "by_route": by_route, "host_s": host_s,
            "verdict": {"n_hosts": hosts, "hedge_deadline_us": best_d, "cpu_cores": best_cpu,
                        "p999_us": best_p999, "busy_poll_p999_us": busy_p999},
            "parity_grid": {"s3b_steps": a.n_steps.tolist(), "s3a_slots": f.n_steps.tolist(),
                            "eight_seeds": eight}}


def profiled_runs(fn, *args, calls: int = 1, **kwargs) -> tuple[float, dict[str, list[float]]]:
    """``calls`` calls of ``fn(*args, **kwargs)`` under torch.profiler: the
    wall ms a call (host clock around the synchronised calls) and each
    CUDA kernel's times in ms by name, in time order."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn(*args, **kwargs)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / calls
    runs: dict[str, list[float]] = {}
    for e in sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                    key=lambda e: e.time_range.start):
        runs.setdefault(e.name, []).append(e.time_range.elapsed_us() / 1e3)
    return wall_ms, runs


def profile(name: str, fn, *args, kernel: tuple[str, str] = ("flash_attention", "flash_fwd"),
            calls: int = 1, **kwargs) -> dict[str, float]:
    """Device busy share of a call of ``fn(*args, **kwargs)``: the sum of
    its CUDA kernels' times (torch.profiler) over its wall time (host clock
    around synchronised calls), the time of the kernels whose names
    contain ``kernel[1]`` (reported as ``kernel[0]``), and the kernels that
    take the most of it, after one warm-up call.  Returns ms a call by
    kernel name, the median over ``calls`` calls (empty where the profiler
    recorded no CUDA kernel)."""
    fn(*args, **kwargs)
    wall_ms, runs = profiled_runs(fn, *args, calls=calls, **kwargs)
    # each call launches the same kernels, so a name's runs, in time order,
    # split evenly into the calls
    by_name = {n: statistics.median(sum(ts[i * len(ts) // calls:(i + 1) * len(ts) // calls])
                                    for i in range(calls)) for n, ts in runs.items()}
    if not by_name:
        log(f"  profile {name}: wall {wall_ms:.2f} ms; device time not measured "
            "(the profiler recorded no CUDA kernels)")
        return by_name
    busy = sum(by_name.values())
    focus = sum(ms for n, ms in by_name.items() if kernel[1] in n)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
    log(f"  profile {name}: wall {wall_ms:.2f} ms, device busy {busy:.2f} ms "
        f"({100 * busy / wall_ms:.1f}%), {kernel[0]} {focus:.3f} ms, "
        f"{sum(map(len, runs.values())) // calls} kernels; top: "
        + "; ".join(f"{n[:60]} {ms:.4f} ms" for n, ms in top))
    return by_name


def _tree_map(fn, tree):
    return {k: _tree_map(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


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
    ab = {"--sweep-ab": phase_sweep_source_ab, "--fleet-ab": phase_fleet_source_ab,
          "--adaptive-ab": phase_adaptive_source_ab,
          "--fleet-adaptive-ab": phase_fleet_adaptive_source_ab,
          "--ssd-ab": phase_ssd_source_ab, "--attention-ab": phase_attention_source_ab,
          "--decode-ab": phase_decode_source_ab, "--decode-phases": phase_decode_phases,
          "--train-loop": train_loop_child, "--mesh": lambda _: phase_mesh()}
    if sys.argv[1:2] and sys.argv[1] in ab:
        log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True,
                           check=True).stdout.strip().splitlines()[0])
        key = sys.argv[1][2:].replace("-", "_")
        print(json.dumps({key: ab[sys.argv[1]](sys.argv[2:])}), flush=True)
        return 0
    t_start = time.perf_counter()
    phase_card()
    route_err = phase_compare()
    decode_err = phase_compare_decode()
    ssd_err = phase_compare_ssd()
    phase_grad_guard()
    rows = phase_time()
    decode_rows = phase_time_decode()
    ssd_rows = phase_time_ssd()
    served = phase_serve()
    served_models = phase_serve_models()
    whisper = phase_whisper()
    internvl2 = phase_internvl2()
    log(f"phase 4 done at {time.perf_counter() - t_start:.1f} s")
    training = phase_train()
    training_loop = phase_train_loop()
    phase_train_entry()
    mesh = phase_mesh()
    sweep_cmp = phase_compare_sweep()
    s2_cmp = phase_compare_adaptive()
    sweep_rows = phase_time_sweep(sweep_cmp["builds"])
    s2_rows = phase_time_adaptive(s2_cmp["builds"], sweep_cmp["builds"])
    phase_sweep_bands(sweep_cmp["builds"], s2_cmp["builds"])
    sweep_main = phase_sweep_main(sweep_cmp["builds"])
    calibration = phase_calibration_main(served["engine"], s2_cmp["builds"])
    s3_cmp = phase_compare_fleet()
    s3_rows = phase_time_fleet(s3_cmp["builds"], sweep_cmp["builds"])
    exchange = phase_cluster_exchange()
    phase_fleet_band(s3_cmp["builds"])
    fleet_main = phase_fleet_main(s3_cmp["builds"], s3_rows)
    s3b_cmp = phase_compare_fleet_adaptive()
    s3b_rows = phase_time_fleet_adaptive(s3b_cmp["builds"], s3_rows)
    s3b_main = phase_fleet_adaptive_main(s3b_cmp["builds"], s3b_rows, fleet_main)
    # K1 has one kernel per type: bf16 ("wgmma", the serving path of
    # gemma-2b, granite-3-8b, starcoder2-15b, dbrx-132b,
    # llama4-scout-17b-a16e and jamba-1.5-large-398b, and the model paths of
    # whisper-small and internvl2-76b; launches are the nine runs' sum
    # (mamba2-370m makes none), by model beside it; its numbers at
    # gemma-2b's largest prefill bucket, every row beside them) and f32
    # ("mma", split TF32, on one model path: whisper-small's f32
    # prefill-then-decode check, whose launches it reports, the timing
    # phase's and the serving runs' (0) beside them; its numbers at gemma-2b
    # heads, whisper's row beside them; its bound is its route's, as K3's
    # is, with the f32 CUDA-core one left to phase 3's log)
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    main_row, f32_row = rows["wgmma"][len(SERVE_BUCKETS) - 1], rows["mma"][0]
    served_runs = {"gemma-2b": served, **served_models, "whisper-small": whisper,
                   "internvl2-76b": internvl2}
    row_keys = ("name", "shape", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                "tflops", "bound_share")
    k1 = {"route": "cuda", "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
          "replaces": "src/repro/kernels/flash_attention/kernel.py:81"}
    kernels = [
        {"name": "flash_attention (wgmma, bf16)", **k1,
         "launches": sum(r["by_route"]["wgmma"] for r in served_runs.values()),
         "launches_by_model": {n: r["by_route"]["wgmma"] for n, r in served_runs.items()},
         "max_abs_err": route_err["wgmma"], **{k: main_row[k] for k in keys},
         "shape": main_row["shape"],
         "rows": [{k: r[k] for k in row_keys} for r in rows["wgmma"]]},
        {"name": "flash_attention (mma, f32)", **k1,
         "launches": whisper["f32_by_route"]["mma"], "timing_launches": f32_row["launches"],
         "max_abs_err": route_err["mma"], **{k: f32_row[k] for k in keys},
         "shape": "B=1 S=T=1024 H=8 KV=1 hd=256 f32 causal",
         "serving_launches": sum(r["by_route"]["mma"] for r in served_runs.values()),
         "rows": [{k: r[k] for k in row_keys} for r in rows["mma"][1:]]},
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
    ssd_keys = ("per_launch_ms", "state_pass_bound_ms")
    for name, source, replaces, row, err, serving, extra in (
            (f"{da} (mma, bf16)", da, "src/repro/kernels/decode_attention/kernel.py:73",
             decode_rows[0], decode_err["mma"],
             sum(r["decode_by_route"]["mma"] for r in served_runs.values()), {}),
            (f"{da} (simt, f32)", da, "src/repro/kernels/decode_attention/kernel.py:73",
             decode_rows[2], decode_err["simt"],
             sum(r["decode_by_route"]["simt"] for r in served_runs.values()),
             {"warm_ms": decode_rows[2]["warm_ms"],
              "rows": [{k: r[k] for k in ("name", "shape", "warm_ms", *keys)}
                       for r in decode_rows[3:5]]}),
            ("ssd_scan", "ssd_scan", "src/repro/kernels/ssd_scan/kernel.py:78", ssd_rows[0],
             ssd_err, sum(r["ssd_scan"] for r in served_runs.values()),
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
    extra = ("build", "bound_resource", "point_steps_per_s", "kernel_ms", "us_per_step",
             "plain_steps", "budget", "steps_max",
             "steps_mean", "warp_longest_over_mean", "lane_busy_share", "s1_ms", "s1_slots",
             "forced_steps")
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
    # The ring route (fleet_sweep_kernel, up to 256 hosts) and the cluster
    # route (fleet_cluster_kernel, the scale row's 1,000 hosts) are two
    # kernels: each with its launches on the main path, by route
    row = next(r for r in s3_rows if r["name"] == f"H{FLEET_SIZES[-1]}/uniform")
    extra = ("build", "bound_resource", "host_slots_per_s", "plain_slots", "s1_ms")
    kernels.append({
        "name": "fleet_sweep", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fleet_sweep.cu",
        "replaces": "src/repro/runtime/fleet.py:234",
        "launches": fleet_main["by_route"]["ring"],
        "max_abs_err": s3_cmp["max_abs_err"], **{k: row[k] for k in keys},
        "shape": f"{row['name']}: {row['shape']}", **{k: row[k] for k in extra},
        "verdict": fleet_main["verdict"],
        "rows": [{k: r[k] for k in ("name", "shape", *keys, *extra)} for r in s3_rows
                 if r is not row and r["route"] == "ring"]})
    row = next(r for r in s3_rows if r["route"] == "cluster")
    kernels.append({
        "name": "fleet_sweep (cluster)", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fleet_sweep.cu",
        "replaces": "src/repro/runtime/fleet.py:234",
        "launches": fleet_main["by_route"]["cluster"],
        "max_abs_err": s3_cmp["max_abs_err"], **{k: row[k] for k in keys},
        "shape": f"{row['name']}: {row['shape']}", **{k: row[k] for k in extra},
        "exchange": exchange})
    # S3b, the fleet sweep by event jumps: launches are its main path's
    # (fleet_bench through simulate_fleet(stepping="adaptive")); its numbers
    # at the verdict's shape (64 hosts, uniform), the other rows in "rows",
    # S3a's time on each shape beside
    row = next(r for r in s3b_rows if r["name"] == f"H{FLEET_SIZES[-1]}/uniform")
    extra = ("build", "bound_resource", "host_steps_per_s", "us_per_step", "steps_max",
             "steps_mean", "budget", "forced_steps", "plain_steps", "s3a_ms", "s3a_slots")
    kernels.append({
        "name": "fleet_adaptive_sweep", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fleet_adaptive_sweep.cu",
        "replaces": "src/repro/runtime/fleet.py:497",
        "launches": s3b_main["by_route"]["ring"],
        "max_abs_err": s3b_cmp["max_abs_err"], **{k: row[k] for k in keys},
        "shape": f"{row['name']}: {row['shape']}", **{k: row[k] for k in extra},
        "verdict": s3b_main["verdict"], "parity_grid": s3b_main["parity_grid"],
        "rows": [{k: r[k] for k in ("name", "shape", *keys, *extra)} for r in s3b_rows
                 if r is not row and r["build"].endswith("ring")]})
    row = next(r for r in s3b_rows if r["build"].endswith("cluster"))
    kernels.append({
        "name": "fleet_adaptive_sweep (cluster)", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fleet_adaptive_sweep.cu",
        "replaces": "src/repro/runtime/fleet.py:497",
        "launches": s3b_main["by_route"]["cluster"],
        "max_abs_err": s3b_cmp["max_abs_err"], **{k: row[k] for k in keys},
        "shape": f"{row['name']}: {row['shape']}", **{k: row[k] for k in extra}})
    # the training path (phase_train's steps, counters set to 0 just
    # before) launches none of K1-K3: the reference trains on its plain
    # attention route and no Pallas kernel of the repo has a backward
    trained = training["launches"]
    training_launches = {
        "flash_attention (wgmma, bf16)": trained["flash_attention"]["wgmma"],
        "flash_attention (mma, f32)": trained["flash_attention"]["mma"],
        f"{da} (mma, bf16)": trained["decode_attention"]["mma"],
        f"{da} (simt, f32)": trained["decode_attention"]["simt"],
        "ssd_scan": trained["ssd_scan"]}
    for k in kernels:
        if k["name"] in training_launches:
            k["training_launches"] = training_launches[k["name"]]
    # nor does the mesh phase (the dry run's cells run the plain attention
    # route, as the reference's)
    meshed = mesh["launches"]
    mesh_launches = {
        "flash_attention (wgmma, bf16)": meshed["flash_attention"]["wgmma"],
        "flash_attention (mma, f32)": meshed["flash_attention"]["mma"],
        f"{da} (mma, bf16)": meshed["decode_attention"]["mma"],
        f"{da} (simt, f32)": meshed["decode_attention"]["simt"],
        "ssd_scan": meshed["ssd_scan"]}
    for k in kernels:
        if k["name"] in mesh_launches:
            k["mesh_launches"] = mesh_launches[k["name"]]
    print(json.dumps({"training": training, "training_loop": training_loop, "mesh": mesh}),
          flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
