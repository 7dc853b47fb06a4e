"""ttft_p90_ms: the 90th percentile (nearest rank) over every request due in
the window of its first token's stamp minus the time it was due.  A request
that never produced a first token ranks above all; if the percentile falls
on one, the value is its wait until the run gave up awaiting it.  Host
clock."""

from gpu_bench.bench.stats import MISSING, nearest_rank


def read(run):
    if not run.window.due:
        return None
    waits = [(r.first_token_ns - r.due_ns) / 1e6 if r.first_token_ns and r.due_ns >= 0 else MISSING
             for r in run.window.due]
    p90 = nearest_rank(waits, 0.9)
    if p90 == MISSING:
        w = run.window
        return max((w.gave_up_ns - r.due_ns) / 1e6 for r in w.due if r.due_ns >= 0)
    return p90
