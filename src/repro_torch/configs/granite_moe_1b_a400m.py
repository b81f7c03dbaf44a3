"""granite-moe-1b-a400m — 32-expert top-8 MoE
[hf:ibm-granite/granite-3.0-1b-a400m-base].

24L d_model=1024 16H (GQA kv=8) d_ff=512(per expert) vocab=49155,
MoE 32e top-8.
"""
from repro_torch.configs import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=512,
    vocab=49155,
    source="[hf:ibm-granite/granite-3.0-1b-a400m-base]",
    n_experts=32,
    top_k=8,
    norm="rmsnorm",
    act="silu",
    tie_embeddings=True,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-smoke",
        family="moe",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=2,
        d_ff=64,
        vocab=256,
        n_experts=4,
        top_k=2,
        norm="rmsnorm",
        act="silu",
        tie_embeddings=True,
    )
