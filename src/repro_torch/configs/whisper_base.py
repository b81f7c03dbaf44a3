"""whisper-base — enc-dec ASR backbone, conv frontend STUB [arXiv:2212.04356].

6L(dec)+6L(enc) d_model=512 8H (kv=8) d_ff=2048 vocab=51865. The
mel-spectrogram + conv feature extractor is a STUB per the assignment
carve-out: the batch carries precomputed frame embeddings ``audio_embed``
of shape (batch, encoder_seq=1500, d_model).
"""
from repro_torch.configs import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="audio",
    n_layers=6,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_ff=2048,
    vocab=51865,
    source="[arXiv:2212.04356]",
    encoder_layers=6,
    encoder_seq=1500,
    norm="layernorm",
    act="gelu",
    tie_embeddings=True,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="whisper-smoke",
        family="audio",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=4,
        d_ff=256,
        vocab=256,
        encoder_layers=2,
        encoder_seq=64,
        norm="layernorm",
        act="gelu",
        tie_embeddings=True,
    )
