"""Nothing the benchmark runs imports the JAX stack, the JAX package or its
CPU harness, by top-level name compared whole; the reference imports
nothing of the port either.  Checked on the sources and in a fresh process
that runs a cell at a test's size."""

import ast
import os
import subprocess
import sys

from gpu_bench_toy import ROOT

from gpu_bench.bench import spec
from gpu_bench.bench.guard import FORBIDDEN, forbidden_loaded


def _imports(path):
    """Top-level names and the ``gpu_bench`` modules ``path`` imports."""
    names, local = set(), set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            mods = [node.module] + [f"{node.module}.{a.name}" for a in node.names]
        else:
            continue
        for mod in mods:
            names.add(mod.split(".", 1)[0])
            if mod.startswith("gpu_bench."):
                local.add(mod)
    return names, local


def _closure(path):
    """Top-level names imported by ``path`` and the gpu_bench modules it pulls in."""
    seen, todo, names = set(), [path], set()
    while todo:
        p = todo.pop()
        if p in seen:
            continue
        seen.add(p)
        top, local = _imports(p)
        names |= top
        for mod in local:
            parts = mod.split(".")
            for cut in (len(parts), len(parts) - 1):
                cand = ROOT.joinpath(*parts[:cut]).with_suffix(".py")
                pkg = ROOT.joinpath(*parts[:cut], "__init__.py")
                for c in (cand, pkg):
                    if c.is_file():
                        todo.append(c)
    return names


def test_whole_names_are_compared():
    assert forbidden_loaded(["repro_torch.models", "torch", "benchmarks_x"]) == []
    assert forbidden_loaded(["repro.models", "jax.numpy", "benchmarks.run"]) == [
        "benchmarks", "jax", "repro"]


def test_no_source_under_gpu_bench_imports_a_forbidden_module():
    files = sorted(spec.BENCH_DIR.rglob("*.py"))
    assert len(files) > 20
    for path in files:
        bad = _imports(path)[0] & FORBIDDEN
        assert not bad, (path, bad)


def test_the_reference_imports_nothing_of_the_port():
    for path in sorted((spec.BENCH_DIR / "reference").glob("*.py")):
        bad = _closure(path) & (FORBIDDEN | {"repro_torch"})
        assert not bad, (path, bad)


def test_a_run_loads_no_forbidden_module():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from gpu_bench_toy import toy_cell\n"
            "from gpu_bench.drivers import serve\n"
            "from gpu_bench.bench.guard import forbidden_loaded\n"
            "run = serve.run(toy_cell('dbrx-132b.rag_4k'), 1, 0.5, True, device='cpu',\n"
            "                t_start=0.0)\n"
            "print(run.correct, forbidden_loaded())\n") % str(ROOT / "gpu_bench" / "tests")
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=240,
                         cwd=ROOT, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "True []"
