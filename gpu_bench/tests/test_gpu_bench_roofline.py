"""Operation and byte counts against sums worked by hand."""

import json

import pytest

from gpu_bench_toy import ROOT

from gpu_bench.bench import roofline

GRANITE = json.loads((ROOT / "gpu_bench/configs/granite-3-8b.json").read_text())["model"]
DBRX = json.loads((ROOT / "gpu_bench/configs/dbrx-132b.json").read_text())["model"]


def test_attention_counts():
    flops, nbytes = roofline.attn_flops_bytes(1, 4, 2, 1, 8, causal=True)
    assert flops == 4 * 1 * 2 * 8 * (4 + 3 + 2 + 1)          # 10 visible pairs
    assert nbytes == 2 * 8 * 1 * 4 * (2 * 2 + 2 * 1)           # q, out: 2 heads; k, v: 1
    full, _ = roofline.attn_flops_bytes(1, 4, 2, 1, 8, causal=False)
    assert full == 4 * 2 * 8 * 16


def test_bound_takes_the_larger():
    assert roofline.bound_s(989e12, 0.0) == pytest.approx(1.0)
    assert roofline.bound_s(0.0, 3.35e12) == pytest.approx(1.0)
    # K1 at granite S=1024 is bound by operations: 8.69 us (PERF.md, PR 37)
    assert roofline.attn_bound_s(1, 1024, 32, 8, 128) == pytest.approx(8.69e-6, rel=2e-3)


def test_granite_parameters():
    per_layer = 4096 * 128 * (32 + 32 + 8 + 8) + 3 * 4096 * 12800
    assert roofline.body_params(GRANITE) == 40 * per_layer
    assert roofline.head_params(GRANITE) == 4096 * 49155
    # with the tied embedding counted once: granite's 8.17 B
    assert roofline.body_params(GRANITE) + roofline.head_params(GRANITE) == pytest.approx(
        8.17e9, rel=1e-3)


def test_dbrx_active_parameters():
    attn = 6144 * 128 * (48 + 48 + 8 + 8)
    experts = 4 * 3 * 6144 * 10752 + 6144 * 16                # top-4 of 16, and the router
    assert roofline.body_params(DBRX) == 10 * (attn + experts)


def test_prefill_and_decode_flops():
    m = GRANITE
    n = 1000
    attn = 40 * 4 * 32 * 128 * (n * (n + 1) // 2)
    assert roofline.prefill_flops(m, n) == pytest.approx(
        2 * roofline.body_params(m) * n + attn + 2 * roofline.head_params(m))
    pos = 2047
    assert roofline.decode_flops(m, pos) == pytest.approx(
        2 * (roofline.body_params(m) + roofline.head_params(m)) + 40 * 4 * 32 * 128 * 2048)
