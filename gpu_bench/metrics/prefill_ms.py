"""prefill_ms.*: mean wall time of a ``Model.prefill`` call in the window,
from the benchmark's proxy around ``engine.model`` (synchronised on exit).
Program span, read in the traced run."""


def read(run):
    ms = [(c.end_ns - c.start_ns) / 1e6 for c in run.window.calls if c.kind == "prefill"]
    return sum(ms) / len(ms) if ms else None
