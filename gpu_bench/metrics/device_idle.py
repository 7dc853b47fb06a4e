"""device_idle.*: the share of the profiled slice, in percent, in which no
operation ran on the card.  Device trace."""

from gpu_bench.bench.trace import busy_and_gaps


def read(run):
    sl = run.window.device_slice
    if sl is None or not sl.recorded or not sl.ops:
        return None
    busy_ns, _ = busy_and_gaps(sl.ops, sl.start_ns, sl.end_ns)
    return 100.0 * (1.0 - busy_ns / (sl.end_ns - sl.start_ns))
