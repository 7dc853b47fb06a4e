"""Toy-sized cells for the CPU tests: a real cell's files, its widths cut
to a test's size and its traffic to a few short requests."""

from __future__ import annotations

import copy
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from gpu_bench.bench import spec  # noqa: E402

CELLS = ("granite-3-8b.rag_8k", "dbrx-132b.rag_4k", "granite-3-8b.chat_batch",
         "dbrx-132b.chat_batch")


def toy_cell(name: str, *, dtype: str = "bfloat16", d: int = 64, layers: int = 2,
             vocab: int = 503) -> spec.Cell:
    cell = spec.resolve(name)
    m = dict(cell.config["model"])
    m.update(n_layers=layers, d_model=d, n_heads=4, n_kv_heads=2, head_dim=d // 4, d_ff=2 * d,
             vocab_size=vocab, param_dtype=dtype, compute_dtype=dtype)
    if m.get("n_experts"):
        # dropless, as the cell: capacity factor = experts / top-k
        m.update(n_experts=4, experts_per_token=2, capacity_factor=2.0)
    mix = copy.deepcopy(cell.mix)
    mix["engine"].update(max_slots=4, max_len=80, prefill_buckets=[16, 32, 64])
    mix["prompt_tokens"] = {"kind": "log_uniform", "min": 8, "max": 64}
    if mix["arrivals"]["kind"] == "stratified_poisson":
        # enough at once that every slot serves
        mix["arrivals"]["rate_per_s"] = 40.0
    else:
        mix["arrivals"]["depth"] = 8
        mix["block"] = 4
        mix["output_tokens"] = {"kind": "log_uniform", "min": 4, "max": 12}
    return spec.Cell(name=cell.name, chips=1, config={**cell.config, "model": m}, mix=mix,
                     limits=dict(cell.limits), end_to_end=cell.end_to_end,
                     per_layer=cell.per_layer)
