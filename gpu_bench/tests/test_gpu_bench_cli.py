"""The command refuses to print a result where it cannot measure: outside a
checkout that holds the port, and without CUDA (this sandbox)."""

import shutil
import subprocess
import sys

import pytest

from gpu_bench_toy import ROOT

ARGS = ["--workload", "granite-3-8b.rag_8k", "--seed", "1", "--seconds", "1", "--trace", "0"]


def test_no_result_beside_only_the_benchmark(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "gpu_bench", tmp_path / "gpu_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "gpu_bench/run.py", *ARGS], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout == ""
    assert "not a checkout of the port" in out.stderr


def test_no_result_without_cuda():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the refusal without one")
    out = subprocess.run([sys.executable, "gpu_bench/run.py", *ARGS], cwd=ROOT,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode != 0 and out.stdout == ""
    assert "torch.cuda.is_available() is False" in out.stderr


def test_result_line_and_report_of_a_toy_run():
    """What the command prints, from a run at a test's size: the result's
    keys, ``checks`` last, and the checks on the report's last lines."""
    import json

    from gpu_bench_toy import toy_cell

    from gpu_bench.drivers import serve
    from gpu_bench.run import report, result

    cell = toy_cell("granite-3-8b.rag_8k")
    run = serve.run(cell, 9, 0.5, True, device="cpu", t_start=0.0)
    out = json.loads(json.dumps(result(cell, run, True, {"platform": "gpu"})))
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device", "breakdown",
                         "checks"]
    assert out["correct"] is True and out["failed"] == 0
    assert set(out["metrics"]) <= {m["name"] for m in cell.per_layer}
    assert {"busy_s", "window_s"} <= set(out["device"])
    lines = report(cell, 9, run).splitlines()
    assert lines[-1].startswith("check logit_gap ") and lines[-1].endswith(" ok")


@pytest.mark.parametrize("name,op,fault", [
    # what the profiler keeps when it drops a slice's kernels: copies and fills
    ("granite-3-8b.chat_batch", "Memcpy HtoD (Pageable -> Device)", "the profiler lost kernels"),
    # kernels, but none of K1's, in a cell that reads K1's roofline
    ("granite-3-8b.rag_8k", "nvjet_tst_64x32", "k1_roofline.prompt"),
    ("granite-3-8b.rag_8k", "flash_fwd_pingpong_bf16", None),
])
def test_traced_run_that_lost_its_kernels_prints_no_result(monkeypatch, capsys, name, op, fault):
    """The command, past its look for a card, given a toy run whose slice
    holds one operation named ``op`` in each model call."""
    import json
    import os
    from types import SimpleNamespace

    import torch

    from gpu_bench_toy import toy_cell

    from gpu_bench import run as cmd
    from gpu_bench.bench import guard, spec
    from gpu_bench.bench.trace import DeviceOp
    from gpu_bench.drivers import serve

    cell = toy_cell(name)
    run = serve.run(cell, 9, 0.5, True, device="cpu", t_start=0.0)
    sl, calls = run.window.device_slice, run.window.calls
    sl.start_ns, sl.end_ns = calls[0].start_ns, calls[-1].end_ns
    sl.ops = [DeviceOp(op, c.start_ns + 1, c.end_ns - 1) for c in calls]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "toy")
    monkeypatch.setattr(spec, "resolve", lambda n: cell)
    load = spec.load_module
    monkeypatch.setattr(spec, "load_module", lambda path, mod: SimpleNamespace(
        run=lambda *a, **k: run) if path.parent.name == "drivers" else load(path, mod))
    monkeypatch.setattr(guard, "forbidden_loaded", lambda: [])
    monkeypatch.setattr(os, "environ", dict(os.environ))
    monkeypatch.setattr(sys, "path", list(sys.path))
    args = ["--workload", name, "--seed", "9", "--seconds", "0.5", "--trace", "1"]
    if fault is None:
        assert cmd.main(args) == 0
        out = json.loads(capsys.readouterr().out.splitlines()[-1])
        assert {m["name"] for m in cell.per_layer} == set(out["metrics"])
        return
    with pytest.raises(SystemExit) as e:
        cmd.main(args)
    printed = capsys.readouterr()
    assert e.value.code == 5 and printed.out == "" and fault in printed.err
