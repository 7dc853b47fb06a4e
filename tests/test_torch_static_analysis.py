"""The reference's static analysis (``python -m repro.analysis``: units,
engine parity, scan purity, lock discipline, races; stdlib only) run over
the port's package, as it is, from a subprocess: no finding, new or
grandfathered, against the repo's empty baseline."""

import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def test_reference_analysis_finds_nothing_in_the_port():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run([sys.executable, "-m", "repro.analysis", "--paths", "src/repro_torch",
                           "--format", "json"], capture_output=True, text=True, env=env,
                          cwd=ROOT, timeout=120)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    report = json.loads(proc.stdout)
    assert report["ok"] and report["new"] == [] and report["grandfathered"] == [], report
    assert report["files_scanned"] > 90
