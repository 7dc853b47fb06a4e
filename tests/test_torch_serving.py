"""The port's serving stack on the CPU: its engine gives the JAX engine's
greedy tokens for the same requests and parameters, its ``Server`` +
``MetronomePolicy`` completes every request while sleeping, and the
launcher CLI runs end to end."""

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


def _port_engine(params=None, attn="kernel"):
    cfg = dataclasses.replace(get_config("gemma-2b").reduced(), **OVERRIDES)
    model = Model(cfg, attn=attn, device="cpu")
    if params is None:
        params = model.init(torch.Generator().manual_seed(0))
    return InferenceEngine(model, params, EngineConfig(**ENGINE))


def test_engine_greedy_tokens_match_jax_engine():
    """More requests than slots, prompts in both buckets, the kernel route
    on both sides (the reference's pallas rule, live while its engine
    traces in this thread)."""
    cfg = dataclasses.replace(jax_get_config("gemma-2b").reduced(), **OVERRIDES)
    jm = JaxModel(cfg)
    jp = jm.init(jax.random.PRNGKey(0), max_seq=64)
    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(1, cfg.vocab_size, n)] for n in PROMPT_LENS]

    jeng = JaxEngine(jm, jp, JaxEngineConfig(**ENGINE))
    jreqs = [JaxRequest(prompt=list(p), max_new_tokens=6) for p in prompts]
    with logical_axis_rules(None, {"attn": "pallas"}):
        jeng.submit(jreqs)
        jeng.pump()

    port_cfg = dataclasses.replace(get_config("gemma-2b").reduced(), **OVERRIDES)
    teng = _port_engine(params_from_numpy(jax.tree.map(np.asarray, jp), port_cfg,
                                          device="cpu"))
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


def test_server_rejects_operating_table_path(tmp_path):
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


def test_launcher_smoke_on_cpu():
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "gemma-2b",
         "--smoke", "--device", "cpu", "--requests", "6", "--rate", "40"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "completed=6/6" in proc.stdout
    cpu = float(re.search(r"cpu=([0-9.]+)", proc.stdout).group(1))
    assert 0 < cpu < 1.0
    assert re.search(r"^controller: rho=", proc.stdout, re.M)
