"""Model configurations of the port.

``ModelConfig`` is a copy of the reference's dataclass (every field), so a
config moves between the two packages as ``dataclasses.asdict``. Each
architecture the port runs has a module here defining ``CONFIG`` (the
full-scale config) and ``smoke_config()`` (a reduced variant of the same
family for CPU tests). ``get_config`` and ``get_smoke_config`` return them
for every id of the reference (``ARCH_IDS``: the dense, MoE, hybrid, xLSTM,
vision-language and audio models) and the paper's ``mule-cnn`` and
``mule-lstm-cnn``.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# ModelConfig
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture description consumed by repro_torch.models.

    A single config class covers all six assigned families (dense / moe /
    ssm / hybrid / vlm / audio); family-specific fields default to "off".
    """

    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    source: str = ""                 # citation, e.g. "[arXiv:2405.04517]"

    # -- attention details ---------------------------------------------------
    head_dim: Optional[int] = None   # default: d_model // n_heads
    qkv_bias: bool = False           # Qwen2-style QKV bias
    rope_theta: float = 10_000.0
    sliding_window: Optional[int] = None      # window size for local layers
    global_layer_interval: int = 0   # gemma3: every k-th layer is global
    mrope_sections: Optional[Tuple[int, int, int]] = None  # qwen2-vl M-RoPE

    # -- MoE -----------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25

    # -- SSM (Mamba2) ----------------------------------------------------------
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    attn_layer_interval: int = 0     # zamba2: shared attn block every k layers

    # -- xLSTM ---------------------------------------------------------------
    xlstm_slstm_every: int = 0       # alternate sLSTM blocks every k blocks
    xlstm_proj_factor: float = 2.0   # internal up-projection factor

    # -- enc-dec (whisper) -----------------------------------------------------
    encoder_layers: int = 0
    encoder_seq: int = 0             # fixed encoder length (stub frontend)

    # -- vlm stub --------------------------------------------------------------
    vision_tokens: int = 0           # patch-embedding stub prefix length

    # -- misc ------------------------------------------------------------------
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    act: str = "silu"                # silu | gelu
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"          # activation/compute dtype
    param_dtype: str = "float32"

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def is_encoder_decoder(self) -> bool:
        return self.encoder_layers > 0

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic decode: SSM/hybrid/xLSTM, or sliding-window dense."""
        if self.family in ("ssm", "hybrid", "xlstm"):
            return True
        return self.sliding_window is not None

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + blocks), for rooflines."""
        d, v = self.d_model, self.vocab
        n = v * d  # embedding
        if not self.tie_embeddings:
            n += v * d
        hd = self.resolved_head_dim
        for layer in range(self.n_layers):
            if self.family in ("ssm", "hybrid") and not self._is_attn_layer(layer):
                d_in = self.ssm_expand * d
                n_heads_ssm = d_in // self.ssm_head_dim
                # in_proj (z,x,B,C,dt) + conv + out_proj, Mamba2 layout
                n += d * (2 * d_in + 2 * self.ssm_state + n_heads_ssm)
                n += self.ssm_conv * (d_in + 2 * self.ssm_state)
                n += d_in * d + 2 * n_heads_ssm  # out_proj + A,D
            elif self.family == "xlstm":
                pass  # handled below
            else:
                q = d * self.n_heads * hd
                kv = 2 * d * self.n_kv_heads * hd
                o = self.n_heads * hd * d
                n += q + kv + o
                if self.n_experts:
                    n += d * self.n_experts  # router
                    n += self.n_experts * 3 * d * self.d_ff
                elif self.d_ff:
                    n += 3 * d * self.d_ff
        if self.family == "xlstm":
            # mLSTM/sLSTM blocks with proj factor
            dp = int(self.xlstm_proj_factor * d)
            per_block = d * dp * 2 + dp * d + 4 * dp * (dp // max(self.n_heads, 1))
            n += self.n_layers * per_block
        if self.encoder_layers:
            n += self.encoder_layers * (4 * d * d + 2 * d * self.d_ff)
        return n

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k of n_experts)."""
        if not self.n_experts:
            return self.param_count()
        total = self.param_count()
        expert_params = self.n_layers * self.n_experts * 3 * self.d_model * self.d_ff
        active = self.n_layers * self.top_k * 3 * self.d_model * self.d_ff
        return total - expert_params + active

    def _is_attn_layer(self, layer: int) -> bool:
        if self.family == "hybrid" and self.attn_layer_interval:
            return (layer + 1) % self.attn_layer_interval == 0
        return self.family not in ("ssm", "hybrid")


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

ARCH_IDS = (
    "xlstm-350m",
    "zamba2-2.7b",
    "stablelm-1.6b",
    "qwen3-moe-235b-a22b",
    "granite-34b",
    "qwen2-vl-72b",
    "granite-moe-1b-a400m",
    "qwen2.5-32b",
    "gemma3-4b",
    "whisper-base",
)

_MODULE_FOR: dict[str, str] = {
    "stablelm-1.6b": "stablelm_1p6b",
    "gemma3-4b": "gemma3_4b",
    "granite-34b": "granite_34b",
    "qwen2.5-32b": "qwen2p5_32b",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "zamba2-2.7b": "zamba2_2p7b",
    "xlstm-350m": "xlstm_350m",
    "qwen2-vl-72b": "qwen2_vl_72b",
    "whisper-base": "whisper_base",
    # the paper's own models
    "mule-cnn": "mule_cnn",
    "mule-lstm-cnn": "mule_lstm_cnn",
}

def _module(arch_id: str):
    if arch_id not in _MODULE_FOR:
        raise KeyError(f"unknown arch {arch_id!r}; known: "
                       f"{sorted(_MODULE_FOR)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULE_FOR[arch_id]}")


def get_config(arch_id: str):
    """Full-scale config for an architecture id."""
    return _module(arch_id).CONFIG


def get_smoke_config(arch_id: str):
    """Reduced same-family config for CPU tests."""
    return _module(arch_id).smoke_config()


# ---------------------------------------------------------------------------
# Input shapes (assigned)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}
