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

On a mesh of ranks (``mesh``: ``launch.sharding.rank_specs``' blocks, the
``"model"`` axis) a layer runs on the heads its weights hold, read from
their widths, not from ``cfg.n_heads``:

- ``wq`` (and ``bq``) whole: every peer runs the whole attention, with no
  collective (qwen2.5-32b's smoke config: 5 heads);
- ``wq`` split by heads: the input enters through ``replicated``, the
  rank's rows of ``wo`` give a partial output, summed by
  ``reduce_from_peers`` (Megatron's f and g). With ``wk`` and ``wv`` split
  too, the rank's kv heads are the ones its query heads read (global q
  head h reads kv head h // G). With them whole (``n_kv_heads`` does not
  divide: granite-34b's single kv head, gemma3-4b at 8 ranks), every peer
  computes every kv head from the input as it is, passes k and v through
  ``replicated`` (each peer uses its own heads of them, so their weights'
  gradients are the sum of the peers' partial ones) and keeps the kv heads
  its query heads read before the kernel (``kv_take``).

Cross-attention is not split: the ``audio`` family holds every leaf whole.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs import ModelConfig
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.launch import collectives as coll
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


def kv_take(cfg: ModelConfig, q0: int, hq: int):
    """The kv heads that query heads ``q0 .. q0 + hq - 1`` read (global q
    head h reads kv head h // G): a slice where they read whole groups or
    lie inside one group, else one kv head a query head (a list)."""
    g = cfg.n_heads // cfg.n_kv_heads
    first, last = q0 // g, (q0 + hq - 1) // g
    if q0 % g == 0 and hq % g == 0:
        return slice(first, first + hq // g)
    if first == last:
        return slice(first, first + 1)
    return [(q0 + i) // g for i in range(hq)]


def _taken(take) -> int:
    return take.stop - take.start if isinstance(take, slice) else len(take)


def rank_kv_heads(params, cfg: ModelConfig, mesh) -> int:
    """How many kv heads the rank holding ``params`` (its ``wq`` and ``wk``
    blocks, or their shapes) reads, as its decode cache holds them: its
    own where kv is split, the ones its query heads read (``kv_take``)
    where only q is, all where q is whole."""
    hd = cfg.resolved_head_dim
    hq, hkv = params["wq"].shape[-1] // hd, params["wk"].shape[-1] // hd
    if mesh is None or hq == cfg.n_heads or hkv != cfg.n_kv_heads:
        return hkv
    return _taken(kv_take(cfg, mesh.axis_index("model") * hq, hq))


def _qkv(params, x: torch.Tensor, cfg: ModelConfig, compute_dtype,
         mesh=None):
    """q [B, S, hq, hd], k and v [B, S, kv, hd] of the heads this rank's
    weights hold (module docstring), and whether q is split over the
    mesh's ``"model"`` axis."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    hq, hkv = params["wq"].shape[-1] // hd, params["wk"].shape[-1] // hd
    q_split = mesh is not None and hq != cfg.n_heads
    kv_split = hkv != cfg.n_kv_heads      # only under a split q
    xc = (coll.replicated(x, mesh, "model") if q_split else x) \
        .to(compute_dtype)
    # kv from the input as it is where their weights are whole under a
    # split q: their cotangent is summed over the peers after the heads
    # (``replicated`` below), not through the input's
    xk = xc if kv_split or not q_split else x.to(compute_dtype)
    q = xc @ params["wq"].to(compute_dtype)
    k = xk @ params["wk"].to(compute_dtype)
    v = xk @ params["wv"].to(compute_dtype)
    if cfg.qkv_bias:
        q = q + params["bq"].to(compute_dtype)
        k = k + params["bk"].to(compute_dtype)
        v = v + params["bv"].to(compute_dtype)
    q = q.reshape(b, s, hq, hd)
    k = k.reshape(b, s, hkv, hd)
    v = v.reshape(b, s, hkv, hd)
    if q_split and not kv_split:
        take = kv_take(cfg, mesh.axis_index("model") * hq, hq)
        k = coll.replicated(k, mesh, "model")[:, :, take]
        v = coll.replicated(v, mesh, "model")[:, :, take]
    return q, k, v, q_split


def _out_proj(params, out: torch.Tensor, compute_dtype, mesh,
              q_split: bool) -> torch.Tensor:
    """out [B, S, hq * hd] @ the rank's rows of ``wo``, summed over the
    peers where q is split."""
    out = out.to(compute_dtype) @ params["wo"].to(compute_dtype)
    if q_split:
        out = coll.reduce_from_peers(out, mesh, "model")
    return out


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
                 rope: bool = True, mesh=None) -> torch.Tensor:
    """Full-sequence self-attention. positions: [B, S] or [3, B, S]
    (M-RoPE); unused with ``rope=False``. On a ``mesh``, the rank's heads
    (module docstring)."""
    compute_dtype = compute_dtype_of(cfg)
    q, k, v, q_split = _qkv(params, x, cfg, compute_dtype, mesh)
    if rope:
        q, k = _rope(q, k, positions, cfg)
    out = flash_attention(q, k, v, causal=causal, window=window,
                          backend=backend)
    b, s, h, hd = out.shape
    out = _out_proj(params, out.reshape(b, s, h * hd), compute_dtype, mesh,
                    q_split)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# decode with KV cache
# ---------------------------------------------------------------------------


def init_kv_cache(cfg: ModelConfig, batch: int, max_seq: int,
                  window: Optional[int] = None, dtype=torch.bfloat16, *,
                  device, kv_heads: Optional[int] = None):
    """Cache for ONE attention layer. Rolling buffer when windowed.
    ``kv_heads``: a rank's count (``rank_kv_heads``), by default all."""
    hd = cfg.resolved_head_dim
    slots = min(window, max_seq) if window is not None else max_seq
    shape = (batch, slots, kv_heads or cfg.n_kv_heads, hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def attn_decode(params, x: torch.Tensor, cache, pos: int, cfg: ModelConfig,
                *, window: Optional[int] = None, rope: bool = True,
                mesh=None):
    """One-token decode. x: [B, 1, D]; pos: the current position (int),
    the same in all three streams under M-RoPE.

    Cached K/V are stored post-RoPE. For windowed layers the cache is a
    rolling buffer of ``window`` slots written at ``pos % window``. Where
    the reference returns an updated copy, the port writes the new K/V into
    ``cache`` in place (no copy of the cache per token) and returns it. On
    a ``mesh``, the rank's heads and the kv heads they read
    (``rank_kv_heads``).
    """
    compute_dtype = compute_dtype_of(cfg)
    b = x.shape[0]
    hd = cfg.resolved_head_dim
    q, k, v, q_split = _qkv(params, x, cfg, compute_dtype,
                            mesh)                     # [B,1,H|KV,hd]
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
    hq, kv = q.shape[2], k.shape[2]
    qg = q.reshape(b, 1, kv, hq // kv, hd).float()
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
    out = _out_proj(params, out.reshape(b, 1, hq * hd), compute_dtype, mesh,
                    q_split)
    return out.to(x.dtype), cache


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
