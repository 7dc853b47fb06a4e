"""The port's serving stack on the CPU: its engine gives the JAX engine's
greedy tokens for the same requests and parameters (gemma-2b,
mamba2-370m, whose slots hold SSM state, dbrx-132b, whose FFNs are MoE,
and jamba-1.5-large-398b, the hybrid of both with attention), its
``Server`` + ``MetronomePolicy`` completes every request while sleeping,
the launcher CLI runs end to end, and the reference's int8-KV serving
and cache tests (tests/test_serving_quant.py,
tests/test_kv_optimizations.py's granite cases) hold on the port with
the reference's parameters carried across."""

import dataclasses
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import Model as JaxModel
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import InferenceEngine as JaxEngine
from repro.serving import Request as JaxRequest
from repro.sharding.logical import logical_axis_rules
from repro_torch.configs import get_config
from repro_torch.core import MetronomeConfig
from repro_torch.models import Model
from repro_torch.models.convert import params_from_numpy
from repro_torch.runtime import BusyPollPolicy, MetronomePolicy
from repro_torch.serving import EngineConfig, InferenceEngine, Request, Server

ROOT = Path(__file__).resolve().parents[1]
# a vocabulary of its own keeps this file's jitted JAX engine apart from
# other files' traces of an equal model in the same worker
OVERRIDES = dict(vocab_size=257)
ENGINE = dict(max_slots=2, max_len=48, prefill_buckets=(8, 16))
PROMPT_LENS = (3, 7, 9, 14, 5, 12)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Reduced models gain nothing from intra-op threads; one keeps a
    parallel test run from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_engine(params=None, attn="kernel", arch="gemma-2b"):
    cfg = dataclasses.replace(get_config(arch).reduced(), **OVERRIDES)
    model = Model(cfg, attn=attn, device="cpu")
    if params is None:
        params = model.init(torch.Generator().manual_seed(0))
    return InferenceEngine(model, params, EngineConfig(**ENGINE))


@pytest.mark.parametrize("arch", ["gemma-2b", "mamba2-370m", "dbrx-132b",
                                  "jamba-1.5-large-398b"])
def test_engine_greedy_tokens_match_jax_engine(arch):
    """More requests than slots, prompts in both buckets, the kernel route
    on both sides (the reference's pallas rule, live while its engine
    traces in this thread).  A Mamba2 slot's state is copied whole into
    its row, and, as in the reference, has also consumed the prompt's
    padding up to its bucket.  A MoE decode step routes every slot, idle
    ones too, as the reference's does.  jamba's slots hold KV leaves and
    SSM state side by side."""
    cfg = dataclasses.replace(jax_get_config(arch).reduced(), **OVERRIDES)
    jm = JaxModel(cfg)
    jp = jm.init(jax.random.PRNGKey(0), max_seq=64)
    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(1, cfg.vocab_size, n)] for n in PROMPT_LENS]

    jeng = JaxEngine(jm, jp, JaxEngineConfig(**ENGINE))
    jreqs = [JaxRequest(prompt=list(p), max_new_tokens=6) for p in prompts]
    with logical_axis_rules(None, {"attn": "pallas"}):
        jeng.submit(jreqs)
        jeng.pump()

    port_cfg = dataclasses.replace(get_config(arch).reduced(), **OVERRIDES)
    teng = _port_engine(params_from_numpy(jax.tree.map(np.asarray, jp), port_cfg,
                                          device="cpu"), arch=arch)
    treqs = [Request(prompt=list(p), max_new_tokens=6) for p in prompts]
    teng.submit(treqs)
    teng.pump()

    assert len(treqs) > ENGINE["max_slots"] and not teng.has_work
    assert {teng._bucket(n) for n in PROMPT_LENS} == set(ENGINE["prefill_buckets"])
    assert [r.tokens for r in treqs] == [r.tokens for r in jreqs]
    assert teng.prefill_tokens == jeng.prefill_tokens == sum(PROMPT_LENS)
    assert teng.decoded_tokens == jeng.decoded_tokens


def _drive(policy, n_req=10, rate_hz=40.0):
    eng = _port_engine()
    eng.submit([Request(prompt=[1, 2], max_new_tokens=2)])
    eng.pump()
    srv = Server(eng, policy)
    srv.start()
    reqs = []
    for i in range(n_req):
        r = Request(prompt=[(i % 200) + 1, 2, 3], max_new_tokens=4)
        assert srv.submit(r)
        reqs.append(r)
        time.sleep(1.0 / rate_hz)
    assert all(r.wait(timeout=30.0) for r in reqs), "request not completed"
    return reqs, srv.stop()


def test_metronome_server_completes_everything_and_sleeps():
    policy = MetronomePolicy(MetronomeConfig(m=3, v_target_us=3_000.0,
                                             t_long_us=60_000.0))
    reqs, stats = _drive(policy)
    assert sum(len(r.tokens) == 4 for r in reqs) == len(reqs)
    assert stats.busy_periods > 0
    assert 0 < stats.cpu_fraction < 1.0
    assert policy.controller.cycles > 0


def test_busy_poll_server_spins_one_core():
    reqs, stats = _drive(BusyPollPolicy(), n_req=6)
    assert sum(len(r.tokens) == 4 for r in reqs) == len(reqs)
    assert 0.9 <= stats.cpu_fraction <= 1.1


def test_server_loads_operating_table_path(tmp_path):
    """A path to an operating table is loaded with ``OperatingTable.load``
    (the reference's ``Server``): a path that names no file is refused, a
    saved table loads and feeds the controller."""
    from repro_torch.runtime import OperatingPoint, OperatingTable

    with pytest.raises(FileNotFoundError):
        Server(_port_engine(), MetronomePolicy(MetronomeConfig()),
               operating_table=str(tmp_path / "missing.json"))
    table = OperatingTable(target_mean_latency_us=15.0, service_rate_mpps=29.76, points=(
        OperatingPoint(rho=0.1, t_s_us=60.0, t_l_us=800.0, m=2, mean_latency_us=12.0,
                       cpu_fraction=0.1, loss_fraction=0.0),
        OperatingPoint(rho=0.9, t_s_us=10.0, t_l_us=400.0, m=3, mean_latency_us=9.0,
                       cpu_fraction=0.9, loss_fraction=0.0)))
    path = tmp_path / "table.json"
    table.save(path)
    policy = MetronomePolicy(MetronomeConfig())
    srv = Server(_port_engine(), policy, operating_table=path)
    assert srv.operating_table == table and policy.controller.feedforward == table


@pytest.mark.parametrize("arch", ["gemma-2b", "granite-3-8b", "mamba2-370m",
                                  "llama4-scout-17b-a16e"])
def test_launcher_smoke_on_cpu(arch):
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch,
         "--smoke", "--device", "cpu", "--requests", "6", "--rate", "40"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "completed=6/6" in proc.stdout
    cpu = float(re.search(r"cpu=([0-9.]+)", proc.stdout).group(1))
    assert 0 < cpu < 1.0
    assert re.search(r"^controller: rho=", proc.stdout, re.M)


# ---------------------------------------------------------------------------
# int8 KV on reduced granite-3-8b: ports of tests/test_serving_quant.py and of
# tests/test_kv_optimizations.py's two granite tests, on the reference's
# parameters (PRNGKey(0)) and token draws
# ---------------------------------------------------------------------------

def _granite(cfg_overrides):
    """The port's model on reduced granite-3-8b with ``cfg_overrides``, and
    the reference's parameters for it, carried across."""
    jcfg = dataclasses.replace(jax_get_config("granite-3-8b").reduced(), **cfg_overrides)
    jp = JaxModel(jcfg).init(jax.random.PRNGKey(0), max_seq=64)
    cfg = dataclasses.replace(get_config("granite-3-8b").reduced(), **cfg_overrides)
    return Model(cfg, device="cpu"), params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                                                       device="cpu")


TINY = dict(n_layers=2, d_model=32, n_heads=2, n_kv_heads=2, head_dim=16, d_ff=64,
            vocab_size=101)


def _quant_engine(**kv):
    model, params = _granite({**TINY, **kv})
    return InferenceEngine(model, params, EngineConfig(max_slots=3, max_len=64,
                                                       prefill_buckets=(8,)))


def test_engine_runs_with_int8_kv_and_mostly_agrees():
    outs = {}
    for name, eng in (("fp", _quant_engine()), ("q8", _quant_engine(kv_quant=True))):
        reqs = [Request(prompt=[i + 1, i + 2, i + 3], max_new_tokens=6) for i in range(5)]
        eng.submit(reqs)
        eng.pump()
        assert all(len(r.tokens) == 6 for r in reqs)
        outs[name] = [r.tokens for r in reqs]
    # greedy decode sequences agree for most requests on this tiny model
    flat_agree = np.mean([t1 == t2 for a, b in zip(outs["fp"], outs["q8"])
                          for t1, t2 in zip(a, b)])
    assert flat_agree > 0.8, (flat_agree, outs)


def _cache_leaves(cache):
    return [leaf for layer in cache.values() for leaf in layer.values()]


def test_engine_int8_cache_dtype():
    eng = _quant_engine(kv_quant=True)
    dtypes = {leaf.dtype for leaf in _cache_leaves(eng.cache)}
    assert torch.int8 in dtypes and torch.float32 in dtypes
    # int8 codes are half the bytes of the full-precision cache
    q_bytes = sum(x.numel() * x.element_size() for x in _cache_leaves(eng.cache))
    f_bytes = sum(x.numel() * x.element_size() for x in _cache_leaves(_quant_engine().cache))
    assert q_bytes < 0.8 * f_bytes


def _teacher_force(cfg_overrides, s=24, b=2, max_len=40, seed=3):
    model, params = _granite(cfg_overrides)
    toks = np.array(jax.random.randint(jax.random.PRNGKey(seed), (b, s), 0,
                                         model.cfg.vocab_size))
    cache = model.init_cache(b, max_len)
    outs = []
    with torch.no_grad():
        for i in range(s - 1):
            logits, cache = model.decode_step(params, torch.from_numpy(toks[:, i]), cache,
                                              torch.full((b,), i))
            outs.append(logits)
    return torch.stack(outs, 1).numpy()


def test_int8_kv_decode_close_to_fp():
    ref = _teacher_force({})
    got = _teacher_force({"kv_quant": True})
    # int8 KV: small logit perturbation, same argmax nearly everywhere
    rel = np.abs(ref - got).max() / max(np.abs(ref).max(), 1e-9)
    assert rel < 0.08, rel
    agree = (ref.argmax(-1) == got.argmax(-1)).mean()
    assert agree > 0.95, agree


def test_int8_kv_prefill_then_decode():
    model, params = _granite({"kv_quant": True})
    b, s, split, max_len = 2, 16, 12, 20
    toks = torch.from_numpy(np.array(jax.random.randint(
        jax.random.PRNGKey(1), (b, s), 0, model.cfg.vocab_size)))
    with torch.no_grad():
        logits_full, _ = model.forward(params, {"tokens": toks})
        _, pre = model.prefill(params, {"tokens": toks[:, :split]})
        cache = model.init_cache(b, max_len)
        for name, leaves in pre.items():
            for leaf, x in leaves.items():
                assert cache[name][leaf].dtype == x.dtype
                cache[name][leaf][:, :, :split] = x
        for i in range(split, s):
            lg, cache = model.decode_step(params, toks[:, i], cache, torch.full((b,), i))
            np.testing.assert_allclose(lg.numpy(), logits_full[:, i].numpy(),
                                       rtol=0.15, atol=0.15)
