"""gemma3-4b — 5:1 local:global attention, 128k context [hf:google/gemma-3-1b-pt].

34L d_model=2560 8H (GQA kv=4) d_ff=10240 vocab=262144. Local layers use a
1024-token sliding window; every 6th layer is global — which makes long_500k
decode tractable (only 6 global KV caches at full length).
"""
from repro_torch.configs import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-4b",
    family="dense",
    n_layers=34,
    d_model=2560,
    n_heads=8,
    n_kv_heads=4,
    d_ff=10240,
    vocab=262144,
    source="[hf:google/gemma-3-1b-pt]",
    head_dim=256,
    sliding_window=1024,
    global_layer_interval=6,   # 5 local : 1 global
    rope_theta=1_000_000.0,
    norm="rmsnorm",
    act="gelu",
    tie_embeddings=True,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-smoke",
        family="dense",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=2,
        d_ff=256,
        vocab=256,
        head_dim=32,
        sliding_window=64,
        global_layer_interval=2,
        norm="rmsnorm",
        act="gelu",
        tie_embeddings=True,
    )
