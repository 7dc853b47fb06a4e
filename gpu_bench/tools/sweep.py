"""Find an open-loop cell's knee: one set-up, then a window at each rate.

    python3 gpu_bench/tools/sweep.py --workload granite-3-8b.rag_8k \\
        --seed 7 --seconds 30 --rates 1.5,2,2.5,3

For each rate it prints one JSON line: the requests due, TTFT's median and
90th percentile (ms), how many due requests had no first token when the
window closed (the backlog it left), and the median TTFT of the window's
last third over its first third (above 1: the queue grew).  The knee is the
highest rate whose backlog does not grow over the window.
"""

from __future__ import annotations

import argparse
import copy
import json
import statistics
import sys
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parents[2]),
                str(Path(__file__).resolve().parents[2] / "src")]

from gpu_bench.bench import spec  # noqa: E402
from gpu_bench.bench.stats import MISSING, nearest_rank  # noqa: E402


def summary(w, rate: float) -> dict:
    due = [r for r in w.due if r.due_ns >= 0]
    ttft = [(r.first_token_ns - r.due_ns) / 1e6 if r.first_token_ns else MISSING for r in due]
    third = max(len(due) // 3, 1)
    first = [t for t in ttft[:third] if t != MISSING]
    last = [t for t in ttft[-third:] if t != MISSING]
    return {"rate_per_s": rate, "due": len(due),
            "ttft_p50_ms": nearest_rank(ttft, 0.5), "ttft_p90_ms": nearest_rank(ttft, 0.9),
            "backlog_at_close": sum(1 for r in due if not r.first_token_ns
                                    or r.first_token_ns > w.end_ns),
            "last_over_first_third": (statistics.median(last) / statistics.median(first)
                                      if first and last else None),
            "failed": w.failed, "feeder_late_ms": w.late_ns / 1e6}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", required=True)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("sweep: no CUDA device")
    cell = spec.resolve(args.workload)
    driver = spec.load_module(spec.BENCH_DIR / "drivers" / f"{cell.mix['driver']}.py",
                              f"gpu_bench_driver_{cell.mix['driver']}")
    session = driver.Session(cell, args.seed, device="cuda")
    for rate in (float(r) for r in args.rates.split(",")):
        mix = copy.deepcopy(cell.mix)
        mix["arrivals"]["rate_per_s"] = rate
        print(json.dumps(summary(session.window(args.seconds, mix=mix), rate)), flush=True)
    session.free()
    return 0


if __name__ == "__main__":
    sys.exit(main())
