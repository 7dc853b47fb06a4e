"""retrieval_p90_ms.*: the 90th percentile (nearest rank) of
``RunStats.latency_us``, enqueue to retrieval by a poller, over all
samples.  Program counter."""

from gpu_bench.bench.stats import nearest_rank


def read(run):
    samples = list(run.window.stats.latency_us)
    return nearest_rank(samples, 0.9) / 1e3 if samples else None
