"""zamba2-2.7b — Mamba2 backbone + shared attention blocks [arXiv:2411.15242].

54L d_model=2560 32H (GQA kv=32) d_ff=10240 vocab=32000, ssm_state=64.
Every 6th layer applies the *shared* attention block (single weight set reused
at every application, Zamba's signature trick).
"""
from repro_torch.configs import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,
    vocab=32000,
    source="[arXiv:2411.15242]",
    ssm_state=64,
    ssm_conv=4,
    ssm_expand=2,
    ssm_head_dim=64,
    attn_layer_interval=6,
    norm="rmsnorm",
    act="gelu",
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-smoke",
        family="hybrid",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=4,
        d_ff=256,
        vocab=256,
        ssm_state=16,
        ssm_conv=4,
        ssm_expand=2,
        ssm_head_dim=32,
        attn_layer_interval=2,
        norm="rmsnorm",
        act="gelu",
    )
