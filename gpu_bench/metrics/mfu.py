"""mfu.*: the useful FLOPs of every token prefilled and decoded in the
profiled slice over the slice's seconds and the bf16 peak, in percent.
Useful: 2·N_active a token (MoE experts at k/E), causal attention over the
positions the inputs hold, the output head where its logits are read
(``bench/roofline.py``).  Device trace (the slice) and the proxy's calls."""

from gpu_bench.bench.roofline import PEAK_BF16_FLOPS
from gpu_bench.bench.trace import useful_flops


def read(run):
    sl = run.window.device_slice
    if sl is None or not sl.recorded or not sl.ops:
        return None
    flops = useful_flops(run.window.calls, run.model, sl.start_ns, sl.end_ns)
    return 100.0 * flops / (sl.seconds * PEAK_BF16_FLOPS) if flops else None
