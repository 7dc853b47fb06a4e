"""The PyTorch port stands alone: importing it loads neither jax nor any
module of the JAX package and builds no kernel, no source file of it
imports them, its verbatim copies of the JAX-free host modules equal the
reference's, and the definitions its own ``runtime/apps.py``,
``runtime/batched.py``, ``runtime/batched_adaptive.py``,
``runtime/calibrate.py`` and ``runtime/fleet.py`` keep from the reference
are the reference's text (imports of the reference package read as the
port's).

The multi-device layer (``launch/{mesh,inputs,dryrun}``,
``sharding/{logical,policy,pipeline}``, ``roofline/``) keeps the
reference's ``roofline_terms``, ``CellReport`` and
``WHISPER_DECODE_ENC_LEN`` word for word, and ``count_params`` with its
jax tree walk swapped for the port's; ``repro_torch.configs`` exports
``cells`` as the reference's package does."""

import ast
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
    "configs/mamba2_370m.py",
    "runtime/schedule.py", "runtime/sim.py", "core/simulator.py",
    "configs/metronome_l3fwd.py", "configs/granite_3_8b.py", "configs/starcoder2_15b.py",
    "configs/dbrx_132b.py", "configs/llama4_scout_17b_a16e.py",
    "configs/jamba_1_5_large_398b.py", "configs/whisper_small.py", "configs/internvl2_76b.py",
    "train/data.py",
]

# module -> top-level definitions the port's own module keeps from the
# reference word for word
PINNED = {
    "runtime/apps.py": ("AppLoad", "DutyCycleBurner", "_combine_bernoulli_exp",
                        "_combine_stalls", "co_run_config"),
    "runtime/batched.py": ("_DIMS", "_MAX_SCHED_SEGMENTS", "SweepGrid", "BatchStats",
                           "_EVENT_ENGINE_ONLY_FIELDS", "_GRID_SUPPLIED_FIELDS",
                           "_NO_SAMPLE_PATH_FIELDS", "unsupported_config_fields",
                           "validate_batched_config", "_schedule_rows"),
    "runtime/batched_adaptive.py": ("_GRID_SUPPLIED_FIELDS", "_EVENT_ENGINE_ONLY_FIELDS",
                                    "_NO_SAMPLE_PATH_FIELDS", "_WAKE_EPS_US", "_RATE_EPS",
                                    "_FILL_SLACK_PKTS", "estimate_adaptive_steps"),
    "runtime/calibrate.py": ("__all__", "CalibrationMismatch", "OperatingPoint",
                             "OperatingTable", "analytic_guard_mask", "_event_sim_point",
                             "schedule_spot_check"),
    "runtime/fleet.py": ("__all__", "_LB_CODE", "FleetGrid", "FleetStats"),
    "train/optimizer.py": ("OptConfig",),
    "train/checkpoint.py": ("latest_step", "save_checkpoint"),
    "roofline/analysis.py": ("roofline_terms", "CellReport"),
    "launch/inputs.py": ("WHISPER_DECODE_ENC_LEN",),
}

# an import statement naming jax or the reference package (not repro_torch)
_BAD_IMPORT = re.compile(r"^\s*(?:from|import)\s+(?:jax|jaxlib|repro)\b(?!_)", re.M)
_REF_IMPORT = re.compile(r"^(\s*(?:from|import)\s+)repro\b(?!_)", re.M)


def test_import_loads_no_jax_and_no_reference_module():
    import repro_torch
    names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch.")]
    assert "repro_torch.serving.server" in names and "repro_torch.launch.serve" in names
    assert {"repro_torch.kernels.decode_attention.ops", "repro_torch.kernels.ssd_scan.ops",
            "repro_torch.kernels.slot_sweep.ops", "repro_torch.runtime.batched",
            "repro_torch.runtime.sim", "repro_torch.core.simulator",
            "repro_torch.kernels.adaptive_sweep.ops", "repro_torch.runtime.batched_adaptive",
            "repro_torch.runtime.calibrate", "repro_torch.kernels.fleet_sweep.ops",
            "repro_torch.runtime.fleet", "repro_torch.train", "repro_torch.train.loop",
            "repro_torch.launch.train", "repro_torch.launch.mesh", "repro_torch.launch.inputs",
            "repro_torch.launch.dryrun", "repro_torch.sharding", "repro_torch.sharding.logical",
            "repro_torch.sharding.policy", "repro_torch.sharding.pipeline",
            "repro_torch.sharding.local",
            "repro_torch.roofline", "repro_torch.roofline.analysis"} <= set(names)
    code = (
        "import importlib, sys\n"
        f"for name in {names!r}:\n"
        "    importlib.import_module(name)\n"
        "from repro_torch.kernels import _build\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "print(bad, _build.BUILD_INFO)\n"
        "sys.exit(1 if bad or _build.BUILD_INFO else 0)\n")
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


def test_runtime_import_builds_no_kernel():
    """Importing ``repro_torch.runtime`` and reaching its batched engine
    loads the sweep kernel's binding but builds and loads no library."""
    code = (
        "import sys\n"
        "import repro_torch.runtime as rt\n"
        "lazy = 'repro_torch.runtime.batched' in sys.modules\n"
        "assert rt.simulate_batch and rt.SweepGrid and rt.BatchStats\n"
        "from repro_torch.kernels import _build\n"
        "print(lazy, _build.BUILD_INFO, _build._libs)\n"
        "sys.exit(1 if lazy or _build.BUILD_INFO or _build._libs else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120,
                          env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_fleet_import_loads_no_jax_and_builds_no_kernel():
    """``from repro_torch.runtime import FleetGrid, FleetStats,
    simulate_fleet`` loads neither jax nor a module of the reference, and
    builds and loads no kernel library."""
    code = (
        "import sys\n"
        "from repro_torch.runtime import FleetGrid, FleetStats, simulate_fleet\n"
        "from repro_torch.kernels import _build\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "print(bad, _build.BUILD_INFO, _build._libs)\n"
        "sys.exit(1 if bad or _build.BUILD_INFO or _build._libs else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120,
                          env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_train_import_loads_no_jax_and_builds_no_kernel():
    """``repro_torch.train`` and ``repro_torch.launch.train`` load neither
    jax nor a module of the reference, and build and load no kernel."""
    code = (
        "import sys\n"
        "import repro_torch.train, repro_torch.launch.train\n"
        "from repro_torch.train import train_loop, make_train_step, AsyncCheckpointer\n"
        "from repro_torch.kernels import _build\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "print(bad, _build.BUILD_INFO, _build._libs)\n"
        "sys.exit(1 if bad or _build.BUILD_INFO or _build._libs else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120,
                          env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _definitions(path: Path) -> dict[str, str]:
    """Top-level class, function and assignment sources of a module, by name."""
    text = path.read_text()
    out = {}
    for node in ast.parse(text).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names = [node.name]
        elif isinstance(node, ast.Assign):
            names = [t.id for t in node.targets if isinstance(t, ast.Name)]
        else:
            continue
        start = node.decorator_list[0].lineno if getattr(node, "decorator_list", None) \
            else node.lineno
        seg = "\n".join(text.splitlines()[start - 1:node.end_lineno])
        out.update((name, seg) for name in names)
    return out


@pytest.mark.parametrize("rel,name", [(rel, name) for rel, names in PINNED.items()
                                      for name in names])
def test_pinned_definition_equals_reference(rel, name):
    ref, port = _definitions(REF / rel), _definitions(PORT / rel)
    assert name in ref and name in port
    assert port[name] == _REF_IMPORT.sub(r"\1repro_torch", ref[name])


def test_build_operating_table_is_the_references_plus_device():
    """The port's ``build_operating_table`` is the reference's text with one
    keyword added: ``device``, in the signature, its docstring paragraph and
    the ``simulate_batch`` call."""
    ref = _definitions(REF / "runtime/calibrate.py")["build_operating_table"]
    port = _definitions(PORT / "runtime/calibrate.py")["build_operating_table"]
    added = ('    device="cuda",\n',
             "    ``device`` (the port's one addition) is where the lattice sweep runs,\n"
             "    passed to ``simulate_batch``: a CUDA device launches the sweep kernel,\n"
             "    ``\"cpu\"`` runs its plain version; the event-engine spot checks run on\n"
             "    the host either way.\n\n",
             ", device=device")
    for text in added:
        assert port.count(text) == 1, text
        port = port.replace(text, "")
    assert port == ref



def test_count_params_is_the_references_on_the_ports_tree_walk():
    """``roofline.count_params`` is the reference's text with its jax tree
    walk (an import and ``tree_flatten_with_path``) swapped for the port's
    ``tree_items``."""
    ref = _definitions(REF / "roofline/analysis.py")["count_params"]
    port = _definitions(PORT / "roofline/analysis.py")["count_params"]
    ref = ref.replace("    import jax\n\n", "").replace(
        "jax.tree_util.tree_flatten_with_path(params_tree)[0]", "tree_items(params_tree)")
    assert port == ref


def test_configs_export_cells_as_the_reference():
    import repro_torch.configs as port_configs
    from repro_torch.configs import base

    assert "cells" in port_configs.__all__ and port_configs.cells is base.cells
    ref_init = (REF / "configs/__init__.py").read_text()
    assert "cells" in ref_init.split("__all__")[1]


def test_multi_device_layer_imports_touch_no_process_group():
    """Importing the multi-device modules (the dry run's too) loads neither
    jax nor a module of the reference and sets up no process group: the
    dry run's fake ranks exist only once its ``main`` runs."""
    code = (
        "import sys\n"
        "import torch.distributed as dist\n"
        "import repro_torch.launch.dryrun, repro_torch.launch.inputs, repro_torch.launch.mesh\n"
        "import repro_torch.sharding.pipeline, repro_torch.sharding.local, repro_torch.roofline\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "print(bad, dist.is_initialized())\n"
        "sys.exit(1 if bad or dist.is_initialized() else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120,
                          env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert proc.returncode == 0, proc.stdout + proc.stderr
