"""The check's two readings of a cell: the program's widest gap and the
float8 control's, over several seeds, in one process.

    python3 gpu_bench/tools/readings.py --workload granite-3-8b.rag_8k \\
        --seeds 101,102,103 --seconds 15

For each seed: the cell's set-up, one window of ``seconds`` at the cell's
own load, the program freed, then the reference over the same sample as a
run's check, with the control beside it.  One JSON line a seed: the widest
normalised gap of the program's served tokens and of the control's first
choice, the tokens compared, and the program's gaps at the 50th and 99th
percentiles.  The limit of ``limits/<cell>.json`` is set from these
(PERF.md gives the readings).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parents[2]),
                str(Path(__file__).resolve().parents[2] / "src")]

import numpy as np  # noqa: E402

from gpu_bench.bench import spec  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--no-control", action="store_true")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("readings: no CUDA device")
    cell = spec.resolve(args.workload)
    driver = spec.load_module(spec.BENCH_DIR / "drivers" / f"{cell.mix['driver']}.py",
                              f"gpu_bench_driver_{cell.mix['driver']}")
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.monotonic()
        session = driver.Session(cell, seed, device="cuda")
        w = session.window(args.seconds)
        session.free()
        t1 = time.monotonic()
        g = session.gaps(w.finished, control=not args.no_control)
        row = {"seed": seed, "finished": len(w.finished), "tokens": int(g["program"].size),
               "window_s": args.seconds, "run_s": t1 - t0, "check_s": time.monotonic() - t1}
        for side in ("program", "control"):
            if side in g:
                x = g[side]
                row[side] = {"max": float(x.max()), "mean": float(x.mean()),
                             "p90": float(np.percentile(x, 90)),
                             "p99": float(np.percentile(x, 99)),
                             "share_off_best": float((x > 0).mean())}
        # the look behind a widest gap: the routing margin where the gaps are
        order = np.argsort(-g["program"])[:8]
        row["widest"] = [[float(g["program"][i]), float(g["margin"][i])] for i in order]
        if np.isfinite(g["margin"]).any():
            row["margin_p"] = [float(np.percentile(g["margin"], q)) for q in (1, 5, 25, 50)]
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
