"""The plain float32 reference against the port's plain CPU path on reduced
dense and MoE configurations, on weights the benchmark draws from a seed;
the check's sample."""

import numpy as np
import pytest
import torch

from gpu_bench_toy import toy_cell

from gpu_bench.bench import check, spec
from gpu_bench.bench.weights import Redraw, build_params, draw

REFERENCE = spec.load_module(spec.BENCH_DIR / "reference" / "decoder.py",
                             "gpu_bench_reference_decoder")


def _model(name, attn):
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models import Model
    m = toy_cell(name, dtype="float32").config["model"]
    return m, Model(ModelConfig(**m), attn=attn, device="cpu")


@pytest.mark.parametrize("name", ["granite-3-8b.rag_8k", "dbrx-132b.rag_4k"])
@pytest.mark.parametrize("attn", [None, "kernel"])
def test_reference_matches_the_port_forward(name, attn):
    m, model = _model(name, attn)
    specs = REFERENCE.leaf_specs(m)
    params = build_params(specs, 11, m["n_layers"], "cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(1, m["vocab_size"], 32))
    with torch.no_grad():
        port = model.forward(params, {"tokens": toks[None]})[0][0]
    ref = REFERENCE.logits(m, Redraw(specs, 11, "cpu"), toks)
    assert ref.shape == port.shape
    torch.testing.assert_close(port, ref, rtol=1e-4, atol=1e-4 * ref.abs().max().item())


@pytest.mark.parametrize("name", ["granite-3-8b.rag_8k", "dbrx-132b.rag_4k"])
def test_reference_matches_prefill_then_decode(name):
    """The served path: a prefill at a padded bucket, then decode steps
    through the cache, against one reference pass."""
    m, model = _model(name, "kernel")
    specs = REFERENCE.leaf_specs(m)
    params = build_params(specs, 5, m["n_layers"], "cpu")
    seq = torch.from_numpy(np.random.default_rng(1).integers(1, m["vocab_size"], 24))
    n_pre = 20
    with torch.no_grad():
        toks = torch.zeros((1, 32), dtype=torch.long)
        toks[0, :n_pre] = seq[:n_pre]
        logits, pre = model.prefill(params, {"tokens": toks})
        rows = [logits[0, n_pre - 1]]
        cache = model.init_cache(1, 40)
        for leaf, c in cache["layer0"].items():
            c[:, :, :32] = pre["layer0"][leaf]
        for p in range(n_pre, seq.numel()):
            step, cache = model.decode_step(params, seq[p:p + 1], cache, torch.tensor([p]))
            rows.append(step[0])
    ref = REFERENCE.logits(m, Redraw(specs, 5, "cpu"), seq)[n_pre - 1:]
    torch.testing.assert_close(torch.stack(rows), ref, rtol=1e-4,
                               atol=1e-4 * ref.abs().max().item())


def test_redraw_gives_the_program_its_weights():
    m = toy_cell("dbrx-132b.rag_4k").config["model"]
    specs = REFERENCE.leaf_specs(m)
    params = build_params(specs, 2**31 + 3, m["n_layers"], "cpu")
    redraw = Redraw(specs, 2**31 + 3, "cpu")
    leaf = params["blocks"]["layer0"]["ffn"]["w_up"]
    assert leaf.dtype == torch.bfloat16
    assert params["blocks"]["layer0"]["ffn"]["router"].dtype == torch.float32
    assert torch.equal(redraw(("blocks", "layer0", "ffn", "w_up"), 1), leaf[1].float())
    assert not torch.equal(leaf[0], leaf[1])
    other = draw(specs[0], 2**31 + 4, 0, "cpu")
    assert not torch.equal(other, params["embed"])


def test_sample_holds_the_longest_and_follows_the_seed():
    served = [check.Served(np.arange(1, n + 1), tuple(range(4))) for n in (5, 50, 7, 9, 11, 3)]
    a = check.sample(served, 3, 1)
    assert len(a) == 3 and len(a[0].prompt) == 50
    assert [len(s.prompt) for s in a] == [len(s.prompt) for s in check.sample(served, 3, 1)]
    assert len({tuple(len(s.prompt) for s in check.sample(served, 3, k)) for k in range(8)}) > 1
    assert check.sample(served[:2], 3, 1) == served[:2]
