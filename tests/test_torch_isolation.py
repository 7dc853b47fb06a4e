"""The PyTorch port stands alone: importing it loads neither jax nor any
module of the JAX package, no source file of it imports them, and its
verbatim copies of the JAX-free host modules equal the reference's."""

import os
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
REF = ROOT / "src" / "repro"
PORT = ROOT / "src" / "repro_torch"

COPIES = [
    "core/analytics.py", "core/controller.py", "core/hr_sleep.py", "core/trylock.py",
    "runtime/stats.py", "runtime/dispatch.py", "runtime/assignment.py",
    "runtime/queues.py", "runtime/policy.py", "runtime/simcore.py",
    "runtime/workload.py", "runtime/runtime.py",
    "configs/base.py", "configs/gemma_2b.py", "configs/gemma2_2b.py",
]

# an import statement naming jax or the reference package (not repro_torch)
_BAD_IMPORT = re.compile(r"^\s*(?:from|import)\s+(?:jax|jaxlib|repro)\b(?!_)", re.M)
_REF_IMPORT = re.compile(r"^(\s*(?:from|import)\s+)repro\b(?!_)", re.M)


def test_import_loads_no_jax_and_no_reference_module():
    import repro_torch
    names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch.")]
    assert "repro_torch.serving.server" in names and "repro_torch.launch.serve" in names
    code = (
        "import importlib, sys\n"
        f"for name in {names!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120,
                          env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_sources_import_no_jax_and_no_reference_module():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    offenders = [f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
                 for f in files for m in _BAD_IMPORT.finditer(f.read_text())]
    assert not offenders, offenders


@pytest.mark.parametrize("rel", COPIES)
def test_copied_module_equals_reference(rel):
    ref = _REF_IMPORT.sub(r"\1repro_torch", (REF / rel).read_text())
    assert (PORT / rel).read_text() == ref
