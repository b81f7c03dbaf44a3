"""GQA attention layer: full-sequence (prefill), KV-cache decode, and
cross-attention.

Port of ``repro.models.attention``: QKV bias (qwen), sliding windows
(gemma3's local layers, with a rolling KV cache at decode), RoPE and M-RoPE
(qwen2-vl: positions [3, B, S]), bidirectional and RoPE-free layers
(``causal=False``, ``rope=False``: Whisper's encoder and decoder) and
Whisper's cross-attention (``cross_kv``, ``cross_attn_forward``). The
self-attention of the full-sequence path goes through ``flash_attention``,
which launches the hand-written kernel for CUDA tensors and differentiates
through the reference's blockwise backward. Cross-attention takes the
plain chunked version (``backend="ref"``) on every device, as the
reference's does, so it launches no kernel. The reference's
``_constrain_heads`` and ``_constrain_seq`` are GSPMD sharding hints with no
meaning on one card, and its ``d_model`` argument of ``init_attention`` is
used by no model, so the port leaves them out.
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


def _rope(q: torch.Tensor, k: torch.Tensor, positions: torch.Tensor,
          cfg: ModelConfig):
    """q and k rotated at ``positions`` ([B, S], or [3, B, S] under
    M-RoPE)."""
    ang = rope_angles(positions, cfg.resolved_head_dim, cfg.rope_theta,
                      cfg.mrope_sections)
    return apply_rope(q, ang), apply_rope(k, ang)


def attn_forward(params, x: torch.Tensor, positions: Optional[torch.Tensor],
                 cfg: ModelConfig, *, window: Optional[int] = None,
                 causal: bool = True, backend: str = "auto",
                 rope: bool = True) -> torch.Tensor:
    """Full-sequence self-attention. positions: [B, S] or [3, B, S]
    (M-RoPE); unused with ``rope=False``."""
    compute_dtype = compute_dtype_of(cfg)
    q, k, v = _qkv(params, x, cfg, compute_dtype)
    if rope:
        q, k = _rope(q, k, positions, cfg)
    out = flash_attention(q, k, v, causal=causal, window=window,
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
                *, window: Optional[int] = None, rope: bool = True):
    """One-token decode. x: [B, 1, D]; pos: the current position (int),
    the same in all three streams under M-RoPE.

    Cached K/V are stored post-RoPE. For windowed layers the cache is a
    rolling buffer of ``window`` slots written at ``pos % window``. Where
    the reference returns an updated copy, the port writes the new K/V into
    ``cache`` in place (no copy of the cache per token) and returns it.
    """
    compute_dtype = compute_dtype_of(cfg)
    b = x.shape[0]
    hd = cfg.resolved_head_dim
    q, k, v = _qkv(params, x, cfg, compute_dtype)     # [B,1,H|KV,hd]
    if rope:
        positions = torch.full((b, 1), pos, dtype=torch.int32,
                               device=x.device)
        if cfg.mrope_sections is not None:
            positions = positions.expand(3, b, 1)
        q, k = _rope(q, k, positions, cfg)

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


# ---------------------------------------------------------------------------
# cross-attention (whisper decoder)
# ---------------------------------------------------------------------------


def cross_attn_forward(params, x: torch.Tensor, enc_k: torch.Tensor,
                       enc_v: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """x: [B, S, D] queries; enc_k, enc_v: [B, Se, KV, hd] from ``cross_kv``
    (or a cache of another dtype). Bidirectional, through the plain chunked
    version on every device, as in the reference. The plain version
    computes in float32 whatever its inputs' dtype, so q, k and v are
    widened to the wider of their dtypes (exactly) rather than k and v
    rounded to q's."""
    compute_dtype = compute_dtype_of(cfg)
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    xc = x.to(compute_dtype)
    q = (xc @ params["wq"].to(compute_dtype)).reshape(b, s, cfg.n_heads, hd)
    wide = torch.promote_types(q.dtype, enc_k.dtype)
    out = flash_attention(q.to(wide), enc_k.to(wide), enc_v.to(wide),
                          causal=False, backend="ref")
    out = out.reshape(b, s, cfg.n_heads * hd).to(compute_dtype)
    return (out @ params["wo"].to(compute_dtype)).to(x.dtype)


def cross_kv(params, enc_out: torch.Tensor, cfg: ModelConfig):
    """Cross-attention K/V [B, Se, KV, hd] of the encoder's output."""
    compute_dtype = compute_dtype_of(cfg)
    b, se, _ = enc_out.shape
    hd = cfg.resolved_head_dim
    e = enc_out.to(compute_dtype)
    k = (e @ params["wk"].to(compute_dtype)).reshape(b, se, cfg.n_kv_heads, hd)
    v = (e @ params["wv"].to(compute_dtype)).reshape(b, se, cfg.n_kv_heads, hd)
    return k, v
