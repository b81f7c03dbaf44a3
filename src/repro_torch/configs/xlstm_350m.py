"""xlstm-350m — sLSTM + mLSTM blocks [arXiv:2405.04517].

24L d_model=1024 4H (GQA kv=4) d_ff=0 vocab=50304. d_ff=0: xLSTM blocks carry
their own internal up-projection (proj factor 2) instead of a separate MLP.
"""
from repro_torch.configs import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="xlstm",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=50304,
    source="[arXiv:2405.04517]",
    xlstm_slstm_every=2,      # alternate mLSTM / sLSTM
    xlstm_proj_factor=2.0,
    norm="layernorm",
    act="gelu",
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-350m-smoke",
        family="xlstm",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=4,
        d_ff=0,
        vocab=256,
        xlstm_slstm_every=2,
        xlstm_proj_factor=2.0,
        norm="layernorm",
        act="gelu",
    )
