"""Model/shape configuration system for the assigned architecture pool.

Every architecture is a ``ModelConfig``; the four assigned input shapes are
``ShapeConfig``s.  ``reduced()`` produces the family-preserving small config
used by CPU smoke tests (full configs are only ever lowered via the dry-run,
never allocated).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

__all__ = ["ModelConfig", "ShapeConfig", "SHAPES", "register", "get_config", "list_configs"]


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | encdec
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // n_heads

    # --- MoE ---
    n_experts: int = 0
    experts_per_token: int = 0
    moe_period: int = 1            # MoE FFN every `moe_period` layers
    n_shared_experts: int = 0      # llama4-style always-on shared expert
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv_width: int = 4
    ssm_chunk: int = 256

    # --- hybrid (jamba): attention layer every `attn_period` layers ---
    attn_period: int = 0           # 0 -> all attention (or all ssm if family=ssm)

    # --- attention / block features ---
    rope_theta: float = 10_000.0
    use_rope: bool = True
    mlp_type: str = "swiglu"       # swiglu | geglu | gelu
    logit_softcap: float = 0.0     # gemma2 final-logit softcap
    attn_softcap: float = 0.0      # gemma2 attention-logit softcap
    local_window: int = 0          # sliding-window size for local layers
    local_global_period: int = 0   # gemma2: local,global alternating (=2)
    scale_embeddings: bool = False # gemma family: embeds *= sqrt(d_model)
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    qk_norm: bool = False

    # --- encoder-decoder (whisper) ---
    n_encoder_layers: int = 0      # >0 => enc-dec; n_layers = decoder layers

    # --- modality frontend stub ---
    frontend: str = ""             # "" | "vision_stub" | "audio_stub"
    frontend_len: int = 0          # prefix embedding positions (vlm)

    # --- numerics ---
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    # int8 KV cache (per-token-per-head symmetric scales): halves decode
    # cache residency + reads; scales factor out of both attention einsums
    # (beyond-paper serving optimization, EXPERIMENTS.md §Perf B2)
    kv_quant: bool = False
    # ring-buffer KV for local-window layers: cache length = window instead
    # of seq_len (gemma2's 13 local layers keep 4096 slots, not 32768)
    kv_ring: bool = False
    # Optimizer moment dtype; jamba/dbrx-scale models use bf16 moments so a
    # 16 GB/chip pod fits params+grads+moments (documented in EXPERIMENTS.md).
    moment_dtype: str = "float32"

    # --- source provenance (public literature tag from the assignment) ---
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def is_encdec(self) -> bool:
        return self.n_encoder_layers > 0

    def layer_plan(self) -> tuple[tuple[str, str], ...]:
        """Per-layer (mixer, ffn) plan for the decoder stack.

        mixer: 'attn' | 'attn_local' | 'ssm';  ffn: 'dense' | 'moe'.
        """
        plan = []
        for i in range(self.n_layers):
            if self.family == "ssm":
                mixer = "ssm"
            elif self.attn_period:
                mixer = "attn" if i % self.attn_period == 0 else "ssm"
            elif self.local_global_period:
                # gemma2 order: local first, then global (arXiv:2408.00118)
                mixer = "attn_local" if i % self.local_global_period == 0 else "attn"
            else:
                mixer = "attn"
            ffn = "moe" if (self.n_experts and i % self.moe_period == 0) else "dense"
            if self.family == "ssm":
                ffn = "none"  # mamba2 blocks have no separate FFN
            plan.append((mixer, ffn))
        return tuple(plan)

    def scan_unit(self) -> int:
        """Smallest repeating unit of the layer plan (scan over repeats)."""
        plan = self.layer_plan()
        n = len(plan)
        for p in range(1, n + 1):
            if n % p == 0 and all(plan[i] == plan[i % p] for i in range(n)):
                return p
        return n

    def reduced(self) -> "ModelConfig":
        """Family-preserving tiny config for CPU smoke tests."""
        unit = self.scan_unit()
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=max(unit * 2, 2) if unit * 2 <= self.n_layers else unit,
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads else 2,
            head_dim=16,
            d_ff=128,
            vocab_size=503,
            n_experts=min(self.n_experts, 4),
            experts_per_token=min(self.experts_per_token, 2),
            # no-drop capacity so forward == prefill+decode exactly in tests
            # (capacity-based dropping is sequence-length dependent)
            capacity_factor=float(max(self.n_experts, 1)),
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=16,
            ssm_chunk=16,
            local_window=min(self.local_window, 8) if self.local_window else 0,
            n_encoder_layers=min(self.n_encoder_layers, 2),
            frontend_len=min(self.frontend_len, 8) if self.frontend_len else 0,
            param_dtype="float32",
            compute_dtype="float32",
        )


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}

# long_500k only runs on sub-quadratic archs (DESIGN.md §Arch-applicability).
SUBQUADRATIC_FAMILIES = ("ssm", "hybrid")

_REGISTRY: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        # import side-effect registration
        from repro_torch import configs as _c  # noqa: F401
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs() -> list[str]:
    from repro_torch import configs as _c  # noqa: F401
    return sorted(_REGISTRY)


def cells(include_skips: bool = False):
    """All (arch, shape) cells; skips per DESIGN.md unless include_skips."""
    out = []
    for name in list_configs():
        cfg = _REGISTRY[name]
        for sname, shape in SHAPES.items():
            skip = (sname == "long_500k"
                    and cfg.family not in SUBQUADRATIC_FAMILIES)
            if skip and not include_skips:
                continue
            out.append((name, sname, skip))
    return out
