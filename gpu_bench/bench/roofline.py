"""The card's peaks and the operation and byte counts the metrics divide by.

Frozen here so that a change to the program cannot move the yardstick:
``bound`` and ``attn_bound`` are ``chip_smoke.py``'s (PR 30's), the
per-token count is ``repro_torch/roofline/analysis.py:model_flops``'s
2·N_active (MoE expert weights at k/E of their size, the embedding gather
not counted), with the output head counted only where its logits are read.
"""

from __future__ import annotations

__all__ = ["PEAK_BF16_FLOPS", "PEAK_BYTES_PER_S", "bound_s", "attn_flops_bytes",
           "attn_bound_s", "body_params", "head_params", "prefill_flops", "decode_flops"]

# NVIDIA H100 SXM data sheet, dense: bf16 tensor cores and HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12


def bound_s(flops: float, nbytes: float) -> float:
    """Least seconds for ``flops`` at the bf16 peak and ``nbytes`` at the
    memory rate: the larger of the two."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S)


def attn_flops_bytes(b: int, s: int, h: int, kv: int, hd: int, *, causal: bool = True,
                     itemsize: int = 2) -> tuple[float, float]:
    """One attention call's work on these inputs: 4*hd FLOPs a visible
    (q, k) pair, each of q, k, v read once and the output written once."""
    pairs = s * (s + 1) // 2 if causal else s * s
    return 4.0 * b * h * hd * pairs, float(itemsize * hd * b * s * (2 * h + 2 * kv))


def attn_bound_s(b: int, s: int, h: int, kv: int, hd: int, *, causal: bool = True) -> float:
    return bound_s(*attn_flops_bytes(b, s, h, kv, hd, causal=causal))


def _head_dim(m: dict) -> int:
    return m.get("head_dim") or m["d_model"] // m["n_heads"]


def body_params(m: dict) -> float:
    """Matmul parameters a token passes through below the output head: the
    attention projections, the dense MLP or the router and k of E experts,
    in every layer (a ``ModelConfig``'s fields as a dict)."""
    d, hd = m["d_model"], _head_dim(m)
    attn = d * hd * (2 * m["n_heads"] + 2 * m["n_kv_heads"])
    glu = 3 if m.get("mlp_type", "swiglu") in ("swiglu", "geglu") else 2
    mlp = glu * d * m["d_ff"]
    if m.get("n_experts"):
        mlp = mlp * m["experts_per_token"] + d * m["n_experts"]
    return float(m["n_layers"] * (attn + mlp))


def head_params(m: dict) -> float:
    return float(m["d_model"] * m["vocab_size"])


def _attn_layer_flops(m: dict, visible: float) -> float:
    """Causal attention of one layer for ``visible`` (q, k) pairs."""
    return 4.0 * m["n_heads"] * _head_dim(m) * visible


def prefill_flops(m: dict, n: int) -> float:
    """Useful FLOPs of a prompt of ``n`` tokens: 2·N_body a token, causal
    attention over the n positions it holds (not its padded bucket), and
    the output head at the last position, the only one read."""
    return (2.0 * body_params(m) * n + m["n_layers"] * _attn_layer_flops(m, n * (n + 1) / 2)
            + 2.0 * head_params(m))


def decode_flops(m: dict, pos: int) -> float:
    """Useful FLOPs of one decoded token at position ``pos`` (it attends
    ``pos + 1`` keys)."""
    return (2.0 * (body_params(m) + head_params(m))
            + m["n_layers"] * _attn_layer_flops(m, pos + 1))
