"""Run one cell of ``BENCHMARK.json`` on the card and print its result.

    python3 gpu_bench/run.py --workload <config>.<mix> --seed <n> \\
        --seconds <s> --trace <0|1>

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared beside its limit,
which also end standard error.  The run exits non-zero and prints no
result without CUDA or without the cards the cell asks for, outside a
checkout that holds the port, when a JAX module or the JAX package was
loaded, or when a traced run's profiler lost the kernels of its slice.  Build products stay inside the checkout (``build/``).
"""

from __future__ import annotations

import time

T_START = time.monotonic()          # set-up is timed from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _fail(code: int, msg: str) -> None:
    print(f"gpu_bench: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(code)


def _metrics(run, entries, reader) -> dict:
    out = {}
    for entry in entries:
        value = reader(entry["name"])(run)
        if value is not None:
            out[entry["name"]] = {"value": float(value), "unit": entry["unit"]}
    return out


def result(cell, run, trace: bool, device: dict) -> dict:
    """The result line of ``run``, a finished ``drivers.serve.Run``."""
    from gpu_bench.bench import spec

    metrics = _metrics(run, cell.per_layer if trace else cell.end_to_end, spec.metric_reader)
    w = run.window
    out = {"correct": run.correct, "attempted": w.attempted, "failed": w.failed,
           "metrics": metrics, "device": device}
    if trace and w.device_slice is not None and w.device_slice.recorded:
        from gpu_bench.bench.trace import breakdown, busy_and_gaps
        sl = w.device_slice
        busy_ns, _ = busy_and_gaps(sl.ops, sl.start_ns, sl.end_ns)
        out["device"] = {**device, "busy_s": busy_ns / 1e9, "window_s": sl.seconds}
        out["breakdown"] = breakdown(sl.ops, w.calls, sl.start_ns, sl.end_ns)
    out["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in run.checks}
    return out


def trace_fault(cell, run, out: dict) -> str | None:
    """Why a traced run's numbers cannot stand, or None: the profiler lost
    kernels of the model calls inside its slice, or a per-layer metric of
    the cell found nothing to read."""
    w = run.window
    sl = w.device_slice
    if sl is None or not sl.recorded:
        return "the traced run profiled no slice"
    from gpu_bench.bench.trace import unseen_calls
    unseen = unseen_calls(sl.ops, w.calls, sl.start_ns, sl.end_ns)
    if unseen:
        inside = sum(1 for c in w.calls if sl.start_ns <= c.start_ns and c.end_ns <= sl.end_ns)
        return (f"the profiler lost kernels: {len(unseen)} of the {inside} model calls inside "
                f"the slice show none ({len(sl.ops)} device operations recorded)")
    missing = [m["name"] for m in cell.per_layer if m["name"] not in out["metrics"]]
    if missing:
        return f"nothing to read for {missing} in the slice"
    return None


def report(cell, seed: int, run) -> str:
    """The run's account for standard error, the checks on its last lines."""
    w = run.window
    lines = [f"gpu_bench: {cell.name} seed {seed}: {w.attempted} attempted, {w.failed} failed, "
             f"{len(w.records)} requests, {w.tokens} output tokens in {w.seconds:.3f} s, setup "
             f"{run.setup_s:.3f} s, feeder late at most {w.late_ns / 1e6:.3f} ms, awaited "
             f"{(w.gave_up_ns - w.end_ns) / 1e9:.3f} s after, server stopped "
             f"{(w.stats.stopped_ns - w.end_ns) / 1e9:.3f} s after, check {run.check_s:.3f} s"]
    if w.device_slice is not None and w.device_slice.recorded:
        lines.append("gpu_bench: " + "; ".join(
            f"{tag}: {len(sl.ops)} device operations in {sl.seconds:.3f} s, profiler stop "
            f"{sl.stop_s:.3f} s, read {sl.read_s:.3f} s"
            for tag, sl in [*(("an earlier window's slice, which lost kernels", x.device_slice)
                              for x in run.earlier), ("the slice read", w.device_slice)]))
    if w.due:
        from gpu_bench.bench.stats import MISSING, nearest_rank
        waits = [(r.first_token_ns - r.due_ns) / 1e6 if r.first_token_ns and r.due_ns >= 0
                 else MISSING for r in w.due]
        lines.append(f"gpu_bench: ttft ms p50 {nearest_rank(waits, 0.5):.1f} p90 "
                     f"{nearest_rank(waits, 0.9):.1f} max {max(waits):.1f}")
    lines += [f"check {c.name} {c.value!r} limit {c.limit!r} {'ok' if c.ok else 'FAILED'}"
              for c in run.checks]
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # every build cache at a fixed path inside the checkout, set before torch loads
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(ROOT / "build" / sub)
    os.environ["USE_FLAX"] = "0"

    if not (ROOT / "src" / "repro_torch").is_dir():
        _fail(2, f"no src/repro_torch beside {Path(__file__).parent.name}/: "
                 "not a checkout of the port")
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from gpu_bench.bench import guard, spec

    cell = spec.resolve(args.workload)
    import torch
    if not torch.cuda.is_available():
        _fail(3, "torch.cuda.is_available() is False")
    if torch.cuda.device_count() < cell.chips:
        _fail(3, f"{cell.name} needs {cell.chips} cards, {torch.cuda.device_count()} present")
    driver = spec.load_module(spec.BENCH_DIR / "drivers" / f"{cell.mix['driver']}.py",
                              f"gpu_bench_driver_{cell.mix['driver']}")
    run = driver.run(cell, args.seed, args.seconds, bool(args.trace), device="cuda",
                     t_start=T_START)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips,
              "memory_peak_bytes": run.memory_peak_bytes}
    out = result(cell, run, bool(args.trace), device)
    print(report(cell, args.seed, run), file=sys.stderr)
    fault = trace_fault(cell, run, out) if args.trace else None
    if fault:
        _fail(5, fault)
    loaded = guard.forbidden_loaded()
    if loaded:
        _fail(4, f"forbidden modules loaded in the benchmark's process: {loaded}")
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
