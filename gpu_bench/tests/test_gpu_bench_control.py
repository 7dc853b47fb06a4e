"""The check's control at a test's size: the reference computed in float8
(weights and activations of every projection) in the program's place fails
each cell's limit, where the program in bfloat16 passes it.  The same
readings at the cells' own sizes on the card are in PERF.md (§2)."""

import pytest

from gpu_bench_toy import CELLS, toy_cell

from gpu_bench.bench import check
from gpu_bench.drivers import serve


@pytest.mark.parametrize("name", CELLS)
def test_float8_control_fails_the_limit(name):
    cell = toy_cell(name, d=128, layers=6, vocab=4096)
    if "chat" in name:
        # outputs long enough that the sample compares some hundreds of tokens, as a run does
        cell.mix["prompt_tokens"] = {"kind": "log_uniform", "min": 8, "max": 16}
        cell.mix["output_tokens"] = {"kind": "log_uniform", "min": 32, "max": 60}
    session = serve.Session(cell, 2**31 + 101, device="cpu")
    w = session.window(1.0)
    session.free()
    g = session.gaps(w.finished, control=True)
    for stat, limit in cell.limits.items():
        program = float(check.STATISTICS[stat](g["program"]))
        control = float(check.STATISTICS[stat](g["control"]))
        assert program <= limit < control, (stat, program, limit, control)
