"""GQA attention layer: full-sequence (prefill) and KV-cache decode.

Port of ``repro.models.attention`` for self-attention: QKV bias (qwen),
sliding windows (gemma3's local layers, with a rolling KV cache at decode)
and RoPE. The full-sequence path goes through ``flash_attention``, which
launches the hand-written kernel for CUDA tensors and differentiates
through the reference's blockwise backward. The reference's
``_constrain_heads`` and ``_constrain_seq`` are GSPMD sharding hints with no
meaning on one card, so the port leaves them out. Cross-attention
(``cross_attn_forward``, ``cross_kv``), the bidirectional encoder and the
``d_model``/``rope`` arguments that Whisper uses wait for it (ROADMAP §1
item 14.4), M-RoPE for qwen2-vl (item 14.5).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs import ModelConfig
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.layers import apply_rope, dense_init, rope_angles

NEG_INF = -1e30


def compute_dtype_of(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def init_attention(gen: torch.Generator, cfg: ModelConfig):
    d = cfg.d_model
    hd = cfg.resolved_head_dim
    p = {
        "wq": dense_init(gen, (d, cfg.n_heads * hd)),
        "wk": dense_init(gen, (d, cfg.n_kv_heads * hd)),
        "wv": dense_init(gen, (d, cfg.n_kv_heads * hd)),
        "wo": dense_init(gen, (cfg.n_heads * hd, d)),
    }
    if cfg.qkv_bias:
        for name, n in (("bq", cfg.n_heads), ("bk", cfg.n_kv_heads),
                        ("bv", cfg.n_kv_heads)):
            p[name] = torch.zeros((n * hd,), device=gen.device)
    return p


def _qkv(params, x: torch.Tensor, cfg: ModelConfig, compute_dtype):
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    xc = x.to(compute_dtype)
    q = xc @ params["wq"].to(compute_dtype)
    k = xc @ params["wk"].to(compute_dtype)
    v = xc @ params["wv"].to(compute_dtype)
    if cfg.qkv_bias:
        q = q + params["bq"].to(compute_dtype)
        k = k + params["bk"].to(compute_dtype)
        v = v + params["bv"].to(compute_dtype)
    return (q.reshape(b, s, cfg.n_heads, hd),
            k.reshape(b, s, cfg.n_kv_heads, hd),
            v.reshape(b, s, cfg.n_kv_heads, hd))


def _roped_qkv(params, x: torch.Tensor, positions: torch.Tensor,
               cfg: ModelConfig):
    """q, k, v of x with RoPE applied to q and k (at ``positions`` [B, S])."""
    q, k, v = _qkv(params, x, cfg, compute_dtype_of(cfg))
    ang = rope_angles(positions, cfg.resolved_head_dim, cfg.rope_theta,
                      cfg.mrope_sections)
    return apply_rope(q, ang), apply_rope(k, ang), v


def attn_forward(params, x: torch.Tensor, positions: torch.Tensor,
                 cfg: ModelConfig, *, window: Optional[int] = None,
                 backend: str = "auto") -> torch.Tensor:
    """Full-sequence causal self-attention. positions: [B, S]."""
    compute_dtype = compute_dtype_of(cfg)
    q, k, v = _roped_qkv(params, x, positions, cfg)
    out = flash_attention(q, k, v, causal=True, window=window,
                          backend=backend)
    b, s, _, _ = out.shape
    out = out.reshape(b, s, cfg.n_heads * cfg.resolved_head_dim) \
        .to(compute_dtype)
    return (out @ params["wo"].to(compute_dtype)).to(x.dtype)


# ---------------------------------------------------------------------------
# decode with KV cache
# ---------------------------------------------------------------------------


def init_kv_cache(cfg: ModelConfig, batch: int, max_seq: int,
                  window: Optional[int] = None, dtype=torch.bfloat16, *,
                  device):
    """Cache for ONE attention layer. Rolling buffer when windowed."""
    hd = cfg.resolved_head_dim
    slots = min(window, max_seq) if window is not None else max_seq
    shape = (batch, slots, cfg.n_kv_heads, hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def attn_decode(params, x: torch.Tensor, cache, pos: int, cfg: ModelConfig,
                *, window: Optional[int] = None):
    """One-token decode. x: [B, 1, D]; pos: the current position (int).

    Cached K/V are stored post-RoPE. For windowed layers the cache is a
    rolling buffer of ``window`` slots written at ``pos % window``. Where
    the reference returns an updated copy, the port writes the new K/V into
    ``cache`` in place (no copy of the cache per token) and returns it.
    """
    compute_dtype = compute_dtype_of(cfg)
    b = x.shape[0]
    hd = cfg.resolved_head_dim
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q, k, v = _roped_qkv(params, x, positions, cfg)   # [B,1,H|KV,hd]

    ck, cv = cache["k"], cache["v"]
    slots = ck.shape[1]
    slot = pos % slots if window is not None else pos
    ck[:, slot] = k[:, 0].to(ck.dtype)
    cv[:, slot] = v[:, 0].to(cv.dtype)

    # attention over the cache (linear in cache length)
    g = cfg.n_heads // cfg.n_kv_heads
    qg = q.reshape(b, 1, cfg.n_kv_heads, g, hd).float()
    scale = 1.0 / torch.sqrt(torch.tensor(float(hd), device=x.device))
    sc = torch.einsum("bikgd,bjkd->bkgj", qg * scale, ck.float())
    slot_idx = torch.arange(slots, device=x.device)
    if window is not None:
        # slot s holds position p = s (mod slots), the largest such p <= pos
        slot_pos = pos - torch.remainder(pos - slot_idx, slots)
        valid = (slot_pos >= 0) & (slot_pos <= pos) & (slot_pos > pos - window)
    else:
        valid = slot_idx <= pos
    sc = torch.where(valid, sc, NEG_INF)
    p = torch.softmax(sc, dim=-1)
    out = torch.einsum("bkgj,bjkd->bkgd", p, cv.float())
    out = out.reshape(b, 1, cfg.n_heads * hd).to(compute_dtype)
    out = (out @ params["wo"].to(compute_dtype)).to(x.dtype)
    return out, cache
