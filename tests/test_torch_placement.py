"""Each rank of a sharded step does its share of the work: the dry run's
trace of a reduced dense config on a fake 2x4 ("data", "model") mesh
against the same step on 1x1 (CPU; ``meta`` storage; a subprocess, whose
fake process group is its own).

The config is gemma-2b's family cut to 2 query heads of 32 over one KV
head: 4 "model" ranks do not divide its heads, as 16 do not divide
gemma-2b's 8, so DTensor cannot split a head over them (the case where the
port's attention splits the queries' sequence instead,
``sharding.logical.query_split``).  Its vocabulary is 512, so that the
tied output head splits over "model" too, and d_ff 192, so that no
weight's whole shape is another's local one.  Every product of the prefill
and train steps then divides over the 8 ranks: none of the 1x1 count is
work that cannot be split.

- Rank 0's matmul FLOPs are within 5% of the 1x1 count over 8.
- No local matmul takes a weight whose "model"-split dim is whole: a
  row-parallel projection's ``Partial`` output is reduced before the next
  projection (``models/transformer._residual``), so that projection's
  weight is not gathered, in the forward or the backward.

Both under the baseline rules and under ``seq="model"`` with the chunked
attention route (two of the dry run's Optimized levers).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
RULES = {"baseline": {}, "chunked+seq": {"attn": "chunked", "seq": "model"}}
CELLS = ("prefill_32k", "train_4k")

TRACE = r"""
import dataclasses, json, sys
import torch
torch.set_num_threads(1)
from repro_torch.configs import get_config
from repro_torch.launch.dryrun import fake_world
from repro_torch.launch.inputs import build_cell
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.roofline.analysis import CostTrace
from repro_torch.sharding.policy import param_pspecs
from repro_torch.train.loop import meta_params
from repro_torch.train.tree import tree_items

MM = ("mm", "bmm", "addmm")


class ShapeTrace(CostTrace):
    # CostTrace that also keeps each local matmul's operand shapes
    def __init__(self):
        super().__init__(device="meta")
        self.mm = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = super().__torch_dispatch__(func, types, args, kwargs)
        ins = [a for a in args if isinstance(a, torch.Tensor)]
        if (out is not NotImplemented and func._overloadpacket.__name__ in MM
                and all(t.device.type == "meta" and not isinstance(t, (self._dtensor, self._fake))
                        for t in ins)):
            self.mm.append([list(t.shape[-2:]) for t in ins])
        return out


cfg = get_config("gemma-2b")
# every weight's whole (in, out) differs from every weight's local one
red = dataclasses.replace(cfg.reduced(), n_heads=2, n_kv_heads=1, head_dim=32, d_ff=192,
                          vocab_size=512)
ov = {f.name: getattr(red, f.name) for f in dataclasses.fields(cfg)
      if getattr(red, f.name) != getattr(cfg, f.name)}
out = {}
for name, rules in json.loads(sys.argv[1]).items():
    for shape in json.loads(sys.argv[2]):
        for d, m in ((2, 4), (1, 1)):
            fake_world(d * m)
            mesh = make_host_mesh(d, m, device_type="cpu")
            cell = build_cell("gemma-2b", shape, mesh, cfg_overrides=ov, rule_overrides=rules)
            trace = ShapeTrace()
            with trace:
                cell.run()
            mode = "train" if shape == "train_4k" else "serve"
            params = meta_params(red, max_seq=4096)
            specs = dict(tree_items(param_pspecs(red, params, mesh, mode)))
            whole = []   # each weight's (in, out) shape where a dim of it is split on "model"
            for path, leaf in tree_items(params):
                spec = specs[path][-2:]
                if leaf.ndim >= 2 and "model" in spec:
                    whole.append(list(leaf.shape[-2:]))
            out[f"{name}|{shape}|{d}x{m}"] = {"flops": trace.flops, "mm": trace.mm,
                                               "whole": whole, "heads": red.n_heads,
                                               "kv_heads": red.n_kv_heads}
print("PLACEMENT " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def traces():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    proc = subprocess.run([sys.executable, "-c", TRACE, json.dumps(RULES), json.dumps(CELLS)],
                          capture_output=True, text=True, env=env, cwd=ROOT, timeout=560)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    line = next(ln for ln in proc.stdout.splitlines() if ln.startswith("PLACEMENT "))
    return json.loads(line[len("PLACEMENT "):])


@pytest.mark.parametrize("shape", CELLS)
@pytest.mark.parametrize("rules", list(RULES))
def test_rank_zero_does_an_eighth_of_the_matmul_flops(traces, rules, shape):
    eight, one = traces[f"{rules}|{shape}|2x4"], traces[f"{rules}|{shape}|1x1"]
    assert eight["heads"] % 4 and eight["kv_heads"] % 4       # heads do not divide "model"
    assert one["flops"] > 0
    assert abs(eight["flops"] - one["flops"] / 8) <= 0.05 * one["flops"] / 8, (
        eight["flops"], one["flops"] / 8)


@pytest.mark.parametrize("shape", CELLS)
@pytest.mark.parametrize("rules", list(RULES))
def test_no_matmul_takes_a_model_split_weight_whole(traces, rules, shape):
    eight, one = traces[f"{rules}|{shape}|2x4"], traces[f"{rules}|{shape}|1x1"]
    whole = {tuple(s) for s in eight["whole"]} | {tuple(s[::-1]) for s in eight["whole"]}
    assert len(eight["whole"]) >= 6                 # wq, wk, wv, wo, w_up, w_gate, w_down, embed
    seen = {tuple(s) for op in one["mm"] for s in op}
    assert seen & whole                             # on one rank the weights are whole
    taken = [op for op in eight["mm"] if any(tuple(s) in whole for s in op)]
    assert not taken, taken[:5]
