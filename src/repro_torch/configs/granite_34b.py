"""granite-34b — llama-arch code model, MQA [arXiv:2405.04324].

88L d_model=6144 48H (GQA kv=1) d_ff=24576 vocab=49152.
"""
from repro_torch.configs import ModelConfig

CONFIG = ModelConfig(
    name="granite-34b",
    family="dense",
    n_layers=88,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    d_ff=24576,
    vocab=49152,
    source="[arXiv:2405.04324]",
    norm="layernorm",
    act="gelu",
    tie_embeddings=True,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="granite-34b-smoke",
        family="dense",
        n_layers=2,
        d_model=192,
        n_heads=6,
        n_kv_heads=1,
        d_ff=768,
        vocab=256,
        norm="layernorm",
        act="gelu",
        tie_embeddings=True,
    )
