"""qwen2-vl-72b — VLM backbone with M-RoPE [arXiv:2409.12191].

80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064. The ViT vision
encoder + projector is a STUB per the assignment carve-out: the batch
carries precomputed patch embeddings ``vision_embed`` (the `vision_tokens`
prefix) of shape (batch, vision_tokens, d_model) for the language backbone.
"""
from repro_torch.configs import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=29568,
    vocab=152064,
    source="[arXiv:2409.12191]",
    qkv_bias=True,
    mrope_sections=(16, 24, 24),   # t/h/w sections of head_dim//2 = 64 (HF value)
    rope_theta=1_000_000.0,
    vision_tokens=256,
    norm="rmsnorm",
    act="silu",
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-smoke",
        family="vlm",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=2,
        d_ff=256,
        vocab=256,
        qkv_bias=True,
        mrope_sections=(4, 6, 6),   # head_dim//2 = 16
        vision_tokens=16,
        norm="rmsnorm",
        act="silu",
    )
