"""poller_cores.*: cores the pollers kept awake over the server's life:
``RunStats.cpu_fraction`` (per-thread CPU time over wall time), the paper's
metric.  Program counter."""


def read(run):
    return run.window.stats.cpu_fraction
