"""The model ops rewritten so that DTensor places them on every torch
release (2.11 on the card fails on the old forms): Mamba2's left padding
(``_causal_conv``, ``_conv_tail``), the SSD scan on DTensors
(``ssd_chunked`` runs each rank's batch rows and heads), and the embedding
lookup (``sharding.logical.take_rows``, an ``autograd.Function``).

- On plain tensors each is bit for bit the expression it replaced (kept
  inline here), values and gradients.
- On DTensors over a 2x2 ("data", "model") mesh of four gloo ranks:
  ``take_rows`` with the table's columns gathered, kept sharded, or its
  rows sharded, against ``table[ids]`` and its gradient on the whole
  tensors (the gradient of the old form was not the whole one: each rank
  kept its own ids' share under a replicated placement); ``ssd_chunked``
  and ``_causal_conv`` at the model's placements against the plain ops, with
  the gradients of every operand; a reduced gemma-2b (its one KV head does
  not divide the 2 "model" ranks: attention splits the queries' sequence)
  through ``build_cell``'s prefill step and the train step's loss and
  gradients, against the plain steps, under the baseline rules and under
  ``seq="model"`` with the chunked route.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.models import mamba2
from repro_torch.sharding.logical import take_rows

ROOT = Path(__file__).resolve().parents[1]


def _old_causal_conv(x, w, b):
    width = w.shape[0]
    pad = F.pad(x, (0, 0, width - 1, 0))
    out = sum(pad[:, i:i + x.shape[1], :] * w[i][None, None, :] for i in range(width))
    return F.silu(out + b[None, None, :])


def _old_conv_tail(x, width):
    pad = F.pad(x, (0, 0, max(width - 1 - x.shape[1], 0), 0))
    return pad[:, -(width - 1):, :]


def _old_ssd_chunked(x, dt, a, bmat, cmat, chunk, h0=None):
    bsz, length, nh, hd = x.shape
    n = bmat.shape[-1]
    nc = length // chunk
    xc = x.reshape(bsz, nc, chunk, nh, hd).float()
    dtc = dt.reshape(bsz, nc, chunk, nh).float()
    bc = bmat.reshape(bsz, nc, chunk, n).float()
    cc = cmat.reshape(bsz, nc, chunk, n).float()
    da = dtc * a[None, None, None, :]
    cum = torch.cumsum(da, dim=2)
    decay = mamba2._segsum_exp(cum.movedim(-1, 2))
    scores = torch.einsum("bcin,bcjn->bcij", cc, bc)
    att = scores[:, :, None] * decay * dtc.permute(0, 1, 3, 2)[:, :, :, None, :]
    y_intra = torch.einsum("bchij,bcjhd->bcihd", att, xc)
    decay_out = torch.exp(cum[:, :, -1:, :] - cum)
    s_chunk = torch.einsum("bcqh,bcqn,bcqhd->bchdn", decay_out * dtc, bc, xc)
    total = torch.exp(cum[:, :, -1, :])
    h = (torch.zeros((bsz, nh, hd, n), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h)
        h = total[:, c, :, None, None] * h + s_chunk[:, c]
    h_prevs = torch.stack(h_prevs, dim=1)
    y_inter = torch.einsum("bcqn,bchdn->bcqhd", cc, h_prevs) * torch.exp(cum)[..., None]
    y = (y_intra + y_inter).reshape(bsz, length, nh, hd)
    return y.to(x.dtype), h


def _grads(fn, *args):
    args = [a.clone().requires_grad_(a.is_floating_point()) for a in args]
    out = fn(*args)
    outs = out if isinstance(out, tuple) else (out,)
    loss = sum((o.float() * torch.linspace(-1, 1, o.numel()).reshape(o.shape)).sum()
               for o in outs)
    grads = torch.autograd.grad(loss, [a for a in args if a.requires_grad])
    return [o.detach() for o in outs], grads


def _bit_equal(new, old, *args):
    (o1, g1), (o2, g2) = _grads(new, *args), _grads(old, *args)
    for a, b in zip(o1 + list(g1), o2 + list(g2)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b), (a - b).abs().max()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_causal_conv_is_the_pad_form_bit_for_bit(dtype):
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 11, 6, generator=g).to(dtype)
    w = torch.randn(4, 6, generator=g).to(dtype)
    b = torch.randn(6, generator=g).to(dtype)
    _bit_equal(mamba2._causal_conv, _old_causal_conv, x, w, b)


@pytest.mark.parametrize("length", [1, 2, 3, 7])
def test_conv_tail_is_the_pad_form_bit_for_bit(length):
    x = torch.randn(2, length, 5, generator=torch.Generator().manual_seed(length))
    _bit_equal(lambda t: mamba2._conv_tail(t, 4), lambda t: _old_conv_tail(t, 4), x)


@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_chunked_on_plain_tensors_is_the_einsum_form_bit_for_bit(with_h0):
    g = torch.Generator().manual_seed(1)
    b, length, nh, hd, n = 2, 24, 3, 4, 5
    args = [torch.randn(b, length, nh, hd, generator=g),
            F.softplus(torch.randn(b, length, nh, generator=g)),
            -torch.rand(nh, generator=g) - 0.1,
            torch.randn(b, length, n, generator=g), torch.randn(b, length, n, generator=g)]
    if with_h0:
        h0 = torch.randn(b, nh, hd, n, generator=g)
        _bit_equal(lambda *a: mamba2.ssd_chunked(*a[:5], 8, a[5]),
                   lambda *a: _old_ssd_chunked(*a[:5], 8, a[5]), *args, h0)
    else:
        _bit_equal(lambda *a: mamba2.ssd_chunked(*a, 8), lambda *a: _old_ssd_chunked(*a, 8),
                   *args)


def test_take_rows_on_plain_tensors_is_indexing_bit_for_bit():
    g = torch.Generator().manual_seed(2)
    table = torch.randn(13, 6, generator=g)
    ids = torch.randint(0, 13, (3, 5), generator=g)
    assert take_rows(table, ids) is not None
    _bit_equal(lambda t: take_rows(t, ids), lambda t: t[ids], table)


MODEL_RULES = {"baseline": {}, "chunked+seq": {"attn": "chunked", "seq": "model"}}

WORKER = r'''
import json, os, sys
import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def rank_fn(rank, world, port, out, model_rules):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world)
    try:
        from torch.distributed.tensor import Replicate, Shard, distribute_tensor
        from repro_torch.launch.mesh import make_host_mesh
        from repro_torch.models import mamba2
        from repro_torch.sharding.logical import take_rows

        mesh = make_host_mesh(2, 2, device_type="cpu")
        R, S = Replicate(), Shard
        res = {}

        def dt(t, placements):
            return distribute_tensor(t.clone(), mesh, placements,
                                     src_data_rank=None).requires_grad_(t.is_floating_point())

        def whole(fn, *args):
            """values and gradients of every float operand, on the whole tensors"""
            args = [a.clone().requires_grad_(a.is_floating_point()) for a in args]
            outs = fn(*args)
            outs = outs if isinstance(outs, tuple) else (outs,)
            loss = sum((o.float() * w).sum() for o, w in zip(outs, weights(outs)))
            loss.backward()
            return [o.detach() for o in outs], [a.grad for a in args if a.is_floating_point()]

        def weights(outs):
            return [torch.linspace(-1, 1, o.numel()).reshape(o.shape) for o in outs]

        def sharded(fn, args, placements):
            ds = [dt(a, p) for a, p in zip(args, placements)]
            outs = fn(*ds)
            outs = outs if isinstance(outs, tuple) else (outs,)
            ws = [distribute_tensor(w, mesh, o.placements if not any(
                      p.is_partial() for p in o.placements) else [R, R], src_data_rank=None)
                  for w, o in zip(weights(outs), outs)]
            loss = sum((o.float() * w).sum() for o, w in zip(outs, ws))
            loss.backward()
            return ([o.full_tensor().detach() for o in outs],
                    [d.grad.full_tensor() for d in ds if d.is_floating_point()],
                    [str(tuple(o.placements)) for o in outs])

        def compare(name, fn, args, placements):
            (wo, wg), (so, sg, sp) = whole(fn, *args), sharded(fn, args, placements)
            res[name] = {"out": max(float((a - b).abs().max()) for a, b in zip(so, wo)),
                         "grad": max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
                                     for a, b in zip(sg, wg)),
                         "n_grads": len(sg), "placements": sp}

        g = torch.Generator().manual_seed(0)
        table = torch.randn(12, 8, generator=g)
        ids = torch.randint(0, 12, (4, 6), generator=g)
        id_place = (S(0), R)
        compare("take_rows columns gathered", take_rows, [table, ids], [(S(1), R), id_place])
        compare("take_rows columns kept", take_rows, [table, ids], [(R, S(1)), id_place])
        compare("take_rows rows", take_rows, [table, ids], [(R, S(0)), id_place])
        compare("take_rows both", take_rows, [table, ids], [(S(1), S(0)), id_place])

        b, length, nh, hd, n = 4, 16, 4, 3, 5
        x = torch.randn(b, length, nh, hd, generator=g)
        dtv = torch.nn.functional.softplus(torch.randn(b, length, nh, generator=g))
        a = -torch.rand(nh, generator=g) - 0.1
        bm, cm = torch.randn(b, length, n, generator=g), torch.randn(b, length, n, generator=g)
        ssd = lambda *t: mamba2.ssd_chunked(*t, 8)
        # the dry run's: x whole on "model", dt split on its heads
        compare("ssd_chunked model placements", ssd, [x, dtv, a, bm, cm],
                [(S(0), R), (S(0), S(2)), (R, R), (S(0), R), (S(0), R)])
        compare("ssd_chunked heads on data", ssd, [x, dtv, a, bm, cm],
                [(S(2), S(0)), (R, R), (R, R), (R, S(0)), (R, R)])
        xc = torch.randn(b, length, 6, generator=g)
        w, bias = torch.randn(4, 6, generator=g), torch.randn(6, generator=g)
        compare("_causal_conv", mamba2._causal_conv, [xc, w, bias],
                [(S(0), S(2)), (R, S(1)), (R, S(0))])

        # a reduced gemma-2b (4 query heads over one KV head: 2 "model"
        # ranks do not divide it) through build_cell's prefill step and the
        # train step's loss and gradients, against the plain steps
        import dataclasses
        from torch.distributed.tensor.experimental import implicit_replication
        from repro_torch.configs import get_config
        from repro_torch.launch.inputs import build_cell, place_like
        from repro_torch.models import Model, attention
        from repro_torch.sharding.logical import logical_axis_rules
        from repro_torch.train.steps import _value_and_grad, make_loss_fn, make_prefill_step
        from repro_torch.train.tree import tree_items

        cfg = get_config("gemma-2b")
        red = cfg.reduced()
        ov = {f.name: getattr(red, f.name) for f in dataclasses.fields(cfg)
              if getattr(red, f.name) != getattr(cfg, f.name)}
        split = attention._attend_split
        calls = []
        attention._attend_split = lambda *a, **k: calls.append(1) or split(*a, **k)
        for name, rules in model_rules.items():
            model = Model(red, attn=rules.get("attn"), device="cpu")
            params = model.init(torch.Generator().manual_seed(0))
            toks = torch.randint(0, red.vocab_size, (4, 17), generator=g)
            batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
            calls.clear()
            _, plain, _ = make_prefill_step(model)(params, {"tokens": batch["tokens"]})
            cell = build_cell("gemma-2b", "prefill_32k", mesh, cfg_overrides=ov,
                              rule_overrides=rules)
            _, logits, _ = cell.run(place_like(params, cell.args[0]),
                                    place_like({"tokens": batch["tokens"]}, cell.args[1]))
            loss_fn = make_loss_fn(model, remat=True)
            (l1, _), g1 = _value_and_grad(loss_fn, params, batch)
            cell = build_cell("gemma-2b", "train_4k", mesh, cfg_overrides=ov,
                              rule_overrides=rules)
            with logical_axis_rules(cell.mesh, cell.rules), implicit_replication():
                (l2, _), g2 = _value_and_grad(loss_fn, place_like(params, cell.args[0]),
                                              place_like(batch, cell.args[2]))
            res["model " + name] = {
                "logits": float((logits.full_tensor() - plain).abs().max() / plain.abs().max()),
                "loss": abs(float(l2.full_tensor()) - float(l1)) / abs(float(l1)),
                "grads": {"/".join(p): float((b.full_tensor() - a).abs().max()
                                             / a.abs().max().clamp_min(1e-30))
                          for (p, a), (_, b) in zip(tree_items(g1), tree_items(g2))},
                "split_calls": len(calls)}
        if rank == 0:
            with open(os.path.join(out, "res.json"), "w") as f:
                json.dump(res, f)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    mp.start_processes(rank_fn, args=(4, int(sys.argv[1]), sys.argv[2], json.loads(sys.argv[3])),
                       nprocs=4, start_method="spawn")
'''


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def on_ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("dtensor_ops")
    script = out / "worker.py"
    script.write_text(WORKER)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    proc = subprocess.run([sys.executable, str(script), str(_free_port()), str(out),
                           json.dumps(MODEL_RULES)],
                          capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return json.loads((out / "res.json").read_text())


@pytest.mark.parametrize("case", ["take_rows columns gathered", "take_rows columns kept",
                                  "take_rows rows", "take_rows both"])
def test_take_rows_on_four_ranks_equals_indexing_the_whole_table(on_ranks, case):
    r = on_ranks[case]
    assert r["out"] == 0.0, r
    assert r["n_grads"] == 1 and r["grad"] < 1e-6, r


@pytest.mark.parametrize("case", ["ssd_chunked model placements", "ssd_chunked heads on data",
                                  "_causal_conv"])
def test_mamba2_ops_on_four_ranks_equal_the_plain_ops(on_ranks, case):
    r = on_ranks[case]
    assert r["out"] < 1e-5, r
    assert r["n_grads"] == (5 if case.startswith("ssd") else 3) and r["grad"] < 1e-5, r


def test_ssd_on_shards_keeps_the_heads_split(on_ranks):
    """The scan's outputs come back split as it ran: batch on "data" and
    heads on "model" (dt's), y (B, L, nh, hd) and h (B, nh, hd, N)."""
    assert on_ranks["ssd_chunked model placements"]["placements"] == [
        "(Shard(dim=0), Shard(dim=2))", "(Shard(dim=0), Shard(dim=1))"]
    assert np.isfinite(on_ranks["ssd_chunked heads on data"]["out"])


@pytest.mark.parametrize("rules", list(MODEL_RULES))
def test_reduced_dense_model_on_four_ranks_equals_the_plain_steps(on_ranks, rules):
    """Reduced gemma-2b on the 2x2 mesh (attention's queries split over
    "model", every row-parallel output reduced before it joins the residual
    stream): the prefill step's logits and the train step's loss and every
    parameter's gradient against the plain steps, at the model tolerances
    (f32 2e-4 of the largest magnitude)."""
    r = on_ranks["model " + rules]
    assert r["split_calls"] > 0, r                 # the query split ran
    assert r["logits"] < 2e-4 and r["loss"] < 2e-4, r
    assert len(r["grads"]) > 8 and max(r["grads"].values()) < 2e-4, r["grads"]
