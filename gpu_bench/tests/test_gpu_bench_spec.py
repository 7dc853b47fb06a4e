"""BENCHMARK.json against the contract's shape, and every cell, mix,
configuration and metric found by name; a new mix, cell and metric added as
files and entries alone."""

import json
import re
import shutil

import pytest

from gpu_bench_toy import CELLS, ROOT

from gpu_bench.bench import spec

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
TEXT = re.compile(r"^[^\t\n]{1,200}$")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["gpu_bench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert all(TEXT.match(w) and not w.startswith("/") and ".." not in w for w in BENCH["command"])
    assert (ROOT / BENCH["command"][1]).is_file()
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves_to_its_files(name):
    cell = spec.resolve(name)
    entry = next(w for w in BENCH["workloads"] if w["name"] == name)
    assert set(entry) == {"name", "config", "traffic", "chips", "why"} and entry["chips"] == 1
    assert name == f"{entry['config']}.{entry['traffic']}"
    assert cell.config["name"] == entry["config"]
    assert (spec.BENCH_DIR / "drivers" / f"{cell.mix['driver']}.py").is_file()
    assert (spec.BENCH_DIR / "reference" / f"{cell.config['reference']}.py").is_file()
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in names
        assert callable(spec.metric_reader(m["name"]))
    for m in cell.end_to_end:
        assert callable(spec.metric_reader(m["name"]))


def test_names_units_and_texts():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[group]:
            assert NAME.match(entry["name"]), entry["name"]
            for key in ("why", "layer", "source"):
                if key in entry:
                    assert TEXT.match(entry[key]), (entry["name"], key)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        if m["unit"] == "%" and ("_roofline" in m["name"] or "mfu" in m["name"]):
            assert m["better"] == "higher"
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("gpu_bench/") and (ROOT / c["file"]).is_file()
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        model = json.loads((ROOT / c["file"]).read_text())["model"]
        assert all(k in model for k in c["reduced"])


def test_a_mix_a_cell_and_a_metric_added_as_files(tmp_path):
    """A later change adds a cell by new files and entries only."""
    bench_dir = tmp_path / "gpu_bench"
    for sub in ("configs", "traffic", "limits", "metrics"):
        shutil.copytree(spec.BENCH_DIR / sub, bench_dir / sub)
    mix = json.loads((spec.BENCH_DIR / "traffic" / "rag_8k.json").read_text())
    mix["prompt_tokens"] = {"kind": "fixed", "value": 512}
    (bench_dir / "traffic" / "rag_short.json").write_text(json.dumps(mix))
    (bench_dir / "limits" / "granite-3-8b.rag_short.json").write_text('{"logit_gap": 0.5}')
    (bench_dir / "metrics" / "requests_due.py").write_text(
        "def read(run):\n    return len(run.window.due)\n")
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "granite-3-8b.rag_short", "config": "granite-3-8b",
                               "traffic": "rag_short", "chips": 1, "why": "short prompts"})
    bench["per_layer"].append({"name": "requests_due.short", "unit": "requests",
                               "better": "higher", "source": "program_counter", "layer": "engine",
                               "moves": "ttft_p90_ms", "workloads": ["granite-3-8b.rag_short"]})
    for m in bench["end_to_end"]:
        if m["name"] == "ttft_p90_ms":
            m["workloads"].append("granite-3-8b.rag_short")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.resolve("granite-3-8b.rag_short", bench_dir=bench_dir)
    assert cell.mix["prompt_tokens"]["value"] == 512
    assert [m["name"] for m in cell.end_to_end] == ["ttft_p90_ms", "setup_s"]
    assert "requests_due.short" in [m["name"] for m in cell.per_layer]
    read = spec.metric_reader("requests_due.short", bench_dir)

    class Window:
        due = [1, 2, 3]

    class Run:
        window = Window()
    assert read(Run()) == 3


def test_a_per_layer_metric_has_to_list_its_cells():
    bench = json.loads(json.dumps(BENCH))
    del bench["per_layer"][0]["workloads"]
    with pytest.raises(KeyError, match="lists no workloads"):
        spec.resolve(CELLS[0], bench=bench)
    # an end-to-end metric without the key is every cell's
    assert "setup_s" in [m["name"] for m in spec.resolve(CELLS[0]).end_to_end]
