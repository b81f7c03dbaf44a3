"""stablelm-1.6b — dense decoder [hf:stabilityai/stablelm-2-1_6b].

24L d_model=2048 32H (GQA kv=32) d_ff=5632 vocab=100352.
"""
from repro_torch.configs import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-1.6b",
    family="dense",
    n_layers=24,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=5632,
    vocab=100352,
    source="[hf:stabilityai/stablelm-2-1_6b]",
    rope_theta=10_000.0,
    norm="layernorm",
    act="silu",
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="stablelm-smoke",
        family="dense",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=4,
        d_ff=352,
        vocab=256,
        norm="layernorm",
        act="silu",
    )
