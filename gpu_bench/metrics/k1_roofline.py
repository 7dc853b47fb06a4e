"""k1_roofline.*: kernel K1's least time over its device time, in percent,
over the K1 launches in the profiled slice: each launch's least time is the
larger of its FLOPs over the bf16 peak and its bytes over 3.35 TB/s, from
its prefill's shape (B=1, the bucket's S, causal); the device time is the
sum of the kernels named ``flash_fwd_*``.  Device trace."""

from gpu_bench.bench.trace import k1_share


def read(run):
    sl = run.window.device_slice
    if sl is None or not sl.recorded:
        return None
    share = k1_share(sl.ops, run.window.calls, run.model, sl.start_ns, sl.end_ns)
    if share is None:
        return None
    least, device, _ = share
    return 100.0 * least / device
