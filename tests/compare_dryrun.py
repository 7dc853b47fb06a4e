"""One dry-run cell in both packages, side by side (CPU only):

    PYTHONPATH=src python tests/compare_dryrun.py --arch mamba2-370m --shape long_500k

The reference's ``repro.launch.dryrun.run_cell`` runs in this process on
512 placeholder host devices.  Its mesh is built with ``AxisType.Auto``
axes: ``jax.make_mesh`` makes explicit axes by default in newer jax, and
the reference's dry run, written for the older default, fails on them.
The port's CLI (``python -m repro_torch.launch.dryrun``) runs in a
subprocess.  Both print FLOPs, bytes and collective bytes a device and
argument and peak bytes; the reference's roofline seconds are under its
TPU v5e constants and are not compared.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def reference(arch: str, shape: str, multi_pod: bool) -> dict:
    import jax
    from jax.sharding import AxisType

    import repro.launch.dryrun as dryrun   # sets the 512 placeholder devices

    def auto_mesh(*, multi_pod: bool = False):
        dims = (2, 16, 16) if multi_pod else (16, 16)
        axes = ("pod", "data", "model") if multi_pod else ("data", "model")
        return jax.make_mesh(dims, axes, axis_types=(AxisType.Auto,) * len(dims))

    dryrun.make_production_mesh = auto_mesh
    rep = dryrun.run_cell(arch, shape, multi_pod=multi_pod, verbose=False)
    return {"flops_per_dev": rep.flops_per_dev, "bytes_per_dev": rep.bytes_per_dev,
            "coll_bytes_per_dev": rep.coll_bytes_per_dev, "arg_bytes": rep.arg_bytes,
            "peak_bytes": rep.peak_bytes, "coll_counts": rep.coll_detail["counts"]}


def port(arch: str, shape: str, multi_pod: bool) -> dict:
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "row.jsonl")
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
               "--shape", shape, "--json", out] + (["--multi-pod"] if multi_pod else [])
        subprocess.run(cmd, check=True, capture_output=True, cwd=ROOT,
                       env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
        row = json.loads(open(out).read().splitlines()[-1])
    return {k: row[k] for k in ("flops_per_dev", "bytes_per_dev", "coll_bytes_per_dev",
                                "arg_bytes", "peak_bytes")} | {
        "coll_counts": row["coll_detail"]["counts"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="mamba2-370m")
    ap.add_argument("--shape", default="long_500k")
    ap.add_argument("--multi-pod", action="store_true")
    args = ap.parse_args(argv)
    rows = {"port": port(args.arch, args.shape, args.multi_pod),
            "reference": reference(args.arch, args.shape, args.multi_pod)}
    for name, row in rows.items():
        print(f"{name:9s} " + " ".join(f"{k}={v:.4e}" if isinstance(v, float) else f"{k}={v}"
                                       for k, v in row.items()))
    print(json.dumps(rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
