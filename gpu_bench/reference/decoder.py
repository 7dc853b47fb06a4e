"""Plain float32 reference of a decoder-only transformer, dense or MoE, with
the semantics the port serves (``repro_torch.models.transformer``):

  x = embed[tokens]
  per layer:  x += attn(rmsnorm(x) * s1);  x += ffn(rmsnorm(x) * s2)
  logits = rmsnorm(x) * s_f @ head      (head = embed^T when tied)

rmsnorm(x) = x / sqrt(mean(x^2) + eps); attention is causal GQA with
half-split RoPE at ``rope_theta`` and scale hd^-1/2; the FFN is a SwiGLU
(silu(x Wg) * (x Wu)) Wd, or a router (float32 softmax over E experts, the
top k by a stable sort, gates renormalised over the k) and the k experts'
SwiGLUs, with no capacity limit.  Every product and sum is float32 with
TF32 off; the work runs layer by layer over all sequences, attention in
blocks of queries, the FFN in blocks of rows, so it fits beside nothing
else on the card.

``leaf_specs`` is the benchmark's weight layout for such a model: the
program's parameter tree (``Model.init``'s paths and shapes) and the draw
of each leaf.  ``score`` reads the reference at the positions that
produced served tokens; with ``control`` it also runs the same model with
every weight and activation entering a projection rounded to float8
(e4m3, a scale a row or an output column), the precision a later change
might be tempted to serve in.
"""

from __future__ import annotations

import math

import torch

from gpu_bench.bench.weights import LeafSpec, Redraw

__all__ = ["leaf_specs", "score", "logits", "check_supported"]

FP8_MAX = 448.0          # the largest float8_e4m3fn
_UNSUPPORTED = ("qk_norm", "logit_softcap", "attn_softcap", "local_window", "scale_embeddings",
                "n_shared_experts", "frontend", "frontend_len", "n_encoder_layers", "kv_quant",
                "kv_ring", "attn_period", "local_global_period")


def check_supported(m: dict) -> None:
    """Refuse a configuration with a mechanism this reference does not model."""
    bad = [k for k in _UNSUPPORTED if m.get(k)]
    if m.get("family") not in ("dense", "moe") or bad or not m.get("use_rope", True) \
            or m.get("moe_period", 1) != 1 or m.get("mlp_type", "swiglu") != "swiglu":
        raise ValueError(f"reference 'decoder' does not model {m.get('family')!r} with {bad}")


def _hd(m: dict) -> int:
    return m.get("head_dim") or m["d_model"] // m["n_heads"]


def leaf_specs(m: dict) -> list[LeafSpec]:
    check_supported(m)
    d, h, kv, hd, f, v = m["d_model"], m["n_heads"], m["n_kv_heads"], _hd(m), m["d_ff"], \
        m["vocab_size"]
    wdt = m.get("param_dtype", "bfloat16")
    blk = ("blocks", "layer0")

    def w(path, shape, fan_in, stacked=True, dtype=wdt):
        return LeafSpec(path, tuple(shape), stacked, dtype, 0.0, 1.0 / math.sqrt(fan_in))

    def norm(path, stacked=True):
        return LeafSpec(path, (d,), stacked, wdt, 1.0, 0.1)

    specs = [LeafSpec(("embed",), (v, d), False, wdt, 0.0, 0.02),
             norm((*blk, "mixer_norm")),
             w((*blk, "mixer", "wq"), (d, h * hd), d), w((*blk, "mixer", "wk"), (d, kv * hd), d),
             w((*blk, "mixer", "wv"), (d, kv * hd), d),
             w((*blk, "mixer", "wo"), (h * hd, d), h * hd),
             norm((*blk, "ffn_norm"))]
    if m.get("n_experts"):
        e = m["n_experts"]
        specs += [w((*blk, "ffn", "router"), (d, e), d, dtype="float32"),
                  w((*blk, "ffn", "w_gate"), (e, d, f), d), w((*blk, "ffn", "w_up"), (e, d, f), d),
                  w((*blk, "ffn", "w_down"), (e, f, d), f)]
    else:
        specs += [w((*blk, "ffn", "w_gate"), (d, f), d), w((*blk, "ffn", "w_up"), (d, f), d),
                  w((*blk, "ffn", "w_down"), (f, d), f)]
    specs.append(norm(("final_norm",), stacked=False))
    if not m.get("tie_embeddings", True):
        specs.append(LeafSpec(("lm_head",), (d, v), False, wdt, 0.0, 0.02))
    return specs


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale per slice along ``dim``."""
    scale = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class _Linear:
    """``x @ w`` in float32, or with both operands in float8 (``fp8``)."""

    def __init__(self, w: torch.Tensor, fp8: bool):
        self.fp8 = fp8
        self.w = _fp8(w, -2) if fp8 else w          # a scale an output column

    def __call__(self, x):
        return (_fp8(x, -1) if self.fp8 else x) @ self.w


def _rmsnorm(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def _rope(x, pos, theta):
    """Half-split RoPE; x (T, heads, hd), angles in float64."""
    hd = x.shape[-1]
    inv = theta ** (-torch.arange(0, hd, 2, dtype=torch.float64, device=x.device) / hd)
    ang = pos.double()[:, None] * inv
    cos, sin = ang.cos().float()[:, None, :], ang.sin().float()[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attention(m, lw, x, q_block):
    t = x.shape[0]
    h, kv, hd = m["n_heads"], m["n_kv_heads"], _hd(m)
    pos = torch.arange(t, device=x.device)
    q = _rope(lw["wq"](x).view(t, h, hd), pos, m["rope_theta"])
    k = _rope(lw["wk"](x).view(t, kv, hd), pos, m["rope_theta"])
    v = lw["wv"](x).view(t, kv, hd)
    qg = q.view(t, kv, h // kv, hd).permute(1, 2, 0, 3)              # (kv, g, t, hd)
    kk, vv = k.permute(1, 0, 2), v.permute(1, 0, 2)                    # (kv, t, hd)
    out = torch.empty(kv, h // kv, t, hd, device=x.device)
    for s0 in range(0, t, q_block):
        s1 = min(s0 + q_block, t)
        logits = torch.einsum("kgsd,ktd->kgst", qg[:, :, s0:s1], kk[:, :s1]) * hd ** -0.5
        causal = (torch.arange(s1, device=x.device)[None, :]
                  <= torch.arange(s0, s1, device=x.device)[:, None])
        logits = logits.masked_fill(~causal, float("-inf"))
        out[:, :, s0:s1] = torch.einsum("kgst,ktd->kgsd", logits.softmax(-1), vv[:, :s1])
    return lw["wo"](out.permute(2, 0, 1, 3).reshape(t, h * hd))


def _swiglu(gate, up, down, x):
    return down(torch.nn.functional.silu(gate(x)) * up(x))


def _moe(m, router, experts, x):
    """Every token through its top-k experts, the gates renormalised; and
    each token's routing margin: its k-th probability less its (k+1)-th."""
    probs = torch.softmax(x @ router, dim=-1)
    top, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = m["experts_per_token"]
    margin = top[:, k - 1] - top[:, k]
    gate, idx = top[:, :k], idx[:, :k]
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
    out = torch.zeros_like(x)
    for e, (wg, wu, wd) in enumerate(experts):
        rows, slot = (idx == e).nonzero(as_tuple=True)
        if rows.numel():
            out.index_add_(0, rows, gate[rows, slot, None] * _swiglu(wg, wu, wd, x[rows]))
    return out, margin


def _raw_layer(m, redraw: Redraw, layer: int) -> dict:
    blk = ("blocks", "layer0")
    raw = {name: redraw((*blk, "mixer", name), layer) for name in ("wq", "wk", "wv", "wo")}
    for name in ("w_gate", "w_up", "w_down", *(("router",) if m.get("n_experts") else ())):
        raw[name] = redraw((*blk, "ffn", name), layer)
    return raw


def _layer_weights(m, raw: dict, fp8: bool) -> dict:
    lw = {name: _Linear(raw[name], fp8) for name in ("wq", "wk", "wv", "wo")}
    mlp = [raw[n] for n in ("w_gate", "w_up", "w_down")]
    if m.get("n_experts"):
        lw["router"] = raw["router"]
        lw["experts"] = [tuple(_Linear(w[e], fp8) for w in mlp) for e in range(m["n_experts"])]
    else:
        lw["mlp"] = tuple(_Linear(w, fp8) for w in mlp)
    return lw


def _ffn(m, lw, x, row_block):
    """(the FFN of x, each row's routing margin or +inf for a dense FFN)."""
    out = torch.empty_like(x)
    margin = torch.full((x.shape[0],), float("inf"), device=x.device)
    for r0 in range(0, x.shape[0], row_block):
        xs = x[r0:r0 + row_block]
        if "experts" in lw:
            out[r0:r0 + row_block], margin[r0:r0 + row_block] = _moe(m, lw["router"],
                                                                     lw["experts"], xs)
        else:
            out[r0:r0 + row_block] = _swiglu(*lw["mlp"], xs)
    return out, margin


def _final_logits(m, redraw: Redraw, seqs, last: list[int], control: bool, q_block: int,
                  row_block: int):
    """(for each sequence, {"ref": logits, "ctrl": logits} at its ``last``
    positions, for each sequence its least routing margin at each position)."""
    eps = m["norm_eps"]
    embed = redraw(("embed",))
    streams = {"ref": [embed[s] for s in seqs]}
    margins = [torch.full((s.numel(),), float("inf"), device=embed.device) for s in seqs]
    if control:
        streams["ctrl"] = [x.clone() for x in streams["ref"]]
    del embed
    for layer in range(m["n_layers"]):
        norm1 = redraw(("blocks", "layer0", "mixer_norm"), layer)
        norm2 = redraw(("blocks", "layer0", "ffn_norm"), layer)
        raw = _raw_layer(m, redraw, layer)
        for name, hs in streams.items():
            lw = _layer_weights(m, raw, fp8=(name == "ctrl"))
            for i, x in enumerate(hs):
                x = x + _attention(m, lw, _rmsnorm(x, norm1, eps), q_block)
                f, margin = _ffn(m, lw, _rmsnorm(x, norm2, eps), row_block)
                hs[i] = x + f
                if name == "ref":
                    margins[i] = torch.minimum(margins[i], margin)
            del lw
        del raw
    final = redraw(("final_norm",))
    head = redraw(("lm_head",)) if ("lm_head",) in redraw.specs else redraw(("embed",)).T
    heads = {"ref": _Linear(head, False)}
    if control:
        heads["ctrl"] = _Linear(head, True)
    logits = [{name: heads[name](_rmsnorm(hs[i][-n:], final, eps)) for name, hs in streams.items()}
              for i, n in enumerate(last)]
    return logits, margins


class _NoTF32:
    def __enter__(self):
        self.prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.prev


@torch.no_grad()
def logits(m: dict, redraw: Redraw, seq: torch.Tensor, *, q_block: int = 1024,
           row_block: int = 4096) -> torch.Tensor:
    """The reference's float32 logits at every position of ``seq``."""
    with _NoTF32():
        return _final_logits(m, redraw, [seq], [seq.numel()], False, q_block,
                             row_block)[0][0]["ref"]


@torch.no_grad()
def score(m: dict, redraw: Redraw, seqs: list[torch.Tensor], reads: list[torch.Tensor], *,
          control: bool = False, q_block: int = 1024, row_block: int = 4096) -> list[dict]:
    """For each sequence (token ids, int64, on the reference's device) and
    the tokens ``reads[i]`` that the positions ``len(seq) - len(reads[i])``
    onwards were followed by: the reference's best logit (``best``), the
    logit of the token read (``read``) and the standard deviation of the
    logits (``std``) at each of those positions; with ``control``, also
    ``control_gap``: how far the reference's logit of the token that the
    float8 model puts first lies below the reference's best.  ``margin``:
    the least routing margin over the layers at each of those positions
    (+inf without experts), where a token's routing is closest to a tie."""
    with _NoTF32():
        all_logits, margins = _final_logits(m, redraw, seqs, [t.numel() for t in reads], control,
                                            q_block, row_block)
    out = []
    for toks, lg, margin in zip(reads, all_logits, margins):
        ref = lg["ref"]
        best = ref.max(-1).values
        row = {"best": best, "read": ref.gather(1, toks[:, None])[:, 0], "std": ref.std(-1),
               "margin": margin[-toks.numel():]}
        if control:
            pick = lg["ctrl"].argmax(-1)
            row["control_gap"] = best - ref.gather(1, pick[:, None])[:, 0]
        out.append(row)
    return out
