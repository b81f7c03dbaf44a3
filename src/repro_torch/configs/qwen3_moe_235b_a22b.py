"""qwen3-moe-235b-a22b — 128-expert top-8 MoE [hf:Qwen/Qwen3-30B-A3B].

94L d_model=4096 64H (GQA kv=4) d_ff=1536(per expert) vocab=151936,
MoE 128e top-8.
"""
from repro_torch.configs import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    d_ff=1536,
    vocab=151936,
    source="[hf:Qwen/Qwen3-30B-A3B]",
    head_dim=128,
    n_experts=128,
    top_k=8,
    rope_theta=1_000_000.0,
    norm="rmsnorm",
    act="silu",
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-smoke",
        family="moe",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=2,
        d_ff=64,
        vocab=256,
        head_dim=32,
        n_experts=4,
        top_k=2,
        norm="rmsnorm",
        act="silu",
    )
