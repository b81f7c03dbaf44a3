"""qwen2.5-32b — dense, GQA + QKV bias [hf:Qwen/Qwen2.5-0.5B family].

64L d_model=5120 40H (GQA kv=8) d_ff=27648 vocab=152064.
"""
from repro_torch.configs import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=27648,
    vocab=152064,
    source="[hf:Qwen/Qwen2.5-0.5B]",
    qkv_bias=True,
    rope_theta=1_000_000.0,
    norm="rmsnorm",
    act="silu",
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-smoke",
        family="dense",
        n_layers=2,
        d_model=160,
        n_heads=5,
        n_kv_heads=1,
        d_ff=432,
        vocab=256,
        qkv_bias=True,
        norm="rmsnorm",
        act="silu",
    )
