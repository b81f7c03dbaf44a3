"""Plain PyTorch versions of blockwise GQA attention.

Port of ``repro.kernels.flash_attention.ref`` (forward only):

- ``mha_reference``: softmax(QK^T)V with the full score matrix. The oracle
  the kernel is held to; only safe at small S.
- ``flash_reference``: the reference's chunked running-softmax forward
  (``_fwd_impl``), the CPU path the model runs. It never builds [S, S]
  scores or repeated KV heads. With ``window`` set each query block visits
  only the contiguous KV range covering its band, and, as in the
  reference, that band path applies the causal mask whatever ``causal``
  says (the kernel and ``mha_reference`` honour ``causal=False``).

Shapes: q [B, S, H, D]; k, v [B, Sk, KV, D] with H % KV == 0. Queries are
right-aligned: query i sits at position ``i + Sk - S``. Masked scores are
``NEG_INF = -1e30`` (not -inf), so a row whose first block is fully masked
carries finite garbage that the next block's correction factor wipes out.
The custom VJP of the reference waits for the training slice.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def _group(q: torch.Tensor, n_kv: int) -> torch.Tensor:
    """[B,S,H,D] -> [B,S,KV,G,D]."""
    b, s, h, d = q.shape
    return q.reshape(b, s, n_kv, h // n_kv, d)


def _scale(d: int, scale: Optional[float]) -> float:
    return scale if scale is not None else 1.0 / math.sqrt(d)


def mha_reference(q, k, v, *, causal: bool = True,
                  window: Optional[int] = None,
                  scale: Optional[float] = None) -> torch.Tensor:
    b, sq, h, d = q.shape
    _, sk, n_kv, _ = k.shape
    scale = _scale(d, scale)
    qg = _group(q, n_kv).float()
    scores = torch.einsum("bikgd,bjkd->bkgij", qg * scale, k.float())
    qpos = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    scores = torch.where(mask, scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgij,bjkd->bikgd", p, v.float())
    return out.reshape(b, sq, h, d).to(q.dtype)


def _band_range(qi: int, block_q: int, block_k: int, window: int, sk: int,
                q_off: int):
    """Static-length contiguous KV range covering the sliding-window band."""
    span = ((window + block_k - 1) // block_k) * block_k + block_q
    span = min(span, ((sk + block_k - 1) // block_k) * block_k)
    start = min(max(qi * block_q + q_off + block_q - span, 0),
                max(sk - span, 0))
    return start, span


def _pad_seq(t: torch.Tensor, n: int) -> torch.Tensor:
    """Zero-pad dim 1 of [B, S, ...] by n rows."""
    return F.pad(t, (0, 0) * (t.dim() - 2) + (0, n)) if n else t


def _fwd_impl(q, k, v, causal, window, block_q, block_k, scale):
    """The reference's forward: out [B,S,H,D] in q's dtype."""
    b, s, h, d = q.shape
    _, sk, n_kv, _ = k.shape
    g = h // n_kv
    nq = -(-s // block_q)
    qg = _group(_pad_seq(q, nq * block_q - s), n_kv) \
        .reshape(b, nq, block_q, n_kv, g, d)
    q_off = sk - s
    nk = -(-sk // block_k)
    k_pad = _pad_seq(k, nk * block_k - sk)
    v_pad = _pad_seq(v, nk * block_k - sk)
    dev = q.device

    def one_q_block(qi, q_blk):
        q32 = q_blk.float() * scale
        qpos = qi * block_q + torch.arange(block_q, device=dev) + q_off

        if window is not None:
            start, span = _band_range(qi, block_q, block_k, window, sk, q_off)
            k_rng = k_pad[:, start:start + span]
            v_rng = v_pad[:, start:start + span]
            kpos = start + torch.arange(span, device=dev)
            valid = (kpos[None, :] <= qpos[:, None]) \
                & (kpos[None, :] > qpos[:, None] - window) \
                & (kpos < sk)[None, :]
            sc = torch.einsum("bikgd,bjkd->bkgij", q32, k_rng.float())
            sc = torch.where(valid, sc, NEG_INF)
            m = torch.amax(sc, dim=-1, keepdim=True)
            p = torch.exp(sc - m)
            l = torch.sum(p, dim=-1, keepdim=True)
            return torch.einsum("bkgij,bjkd->bikgd",
                                p / torch.clamp(l, min=1e-30), v_rng.float())

        m = torch.full((b, n_kv, g, block_q, 1), NEG_INF, device=dev)
        l = torch.zeros((b, n_kv, g, block_q, 1), device=dev)
        acc = torch.zeros((b, block_q, n_kv, g, d), device=dev)
        for kj in range(nk):
            k_blk = k_pad[:, kj * block_k:(kj + 1) * block_k]
            v_blk = v_pad[:, kj * block_k:(kj + 1) * block_k]
            kpos = kj * block_k + torch.arange(block_k, device=dev)
            valid = (kpos < sk)[None, :].expand(block_q, block_k)
            if causal:
                valid = valid & (kpos[None, :] <= qpos[:, None])
            sc = torch.einsum("bikgd,bjkd->bkgij", q32, k_blk.float())
            sc = torch.where(valid, sc, NEG_INF)
            m_new = torch.maximum(m, torch.amax(sc, dim=-1, keepdim=True))
            p = torch.exp(sc - m_new)
            corr = torch.exp(m - m_new)
            l = l * corr + torch.sum(p, dim=-1, keepdim=True)
            corr_b = torch.movedim(corr[..., 0], -1, 1)[..., None]
            acc = acc * corr_b + torch.movedim(
                torch.einsum("bkgij,bjkd->bkgid", p, v_blk.float()), 3, 1)
            m = m_new
        l_b = torch.movedim(l[..., 0], -1, 1)[..., None]
        return acc / torch.clamp(l_b, min=1e-30)

    out = torch.stack([one_q_block(qi, qg[:, qi]) for qi in range(nq)], dim=1)
    out = out.reshape(b, nq * block_q, h, d)
    return out[:, :s].to(q.dtype)


def flash_reference(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None, block_q: int = 512,
                    block_k: int = 512,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Chunked attention with a running softmax; O(S·block) live memory."""
    b, s, h, d = q.shape
    _, sk, _, _ = k.shape
    scale = _scale(d, scale)
    return _fwd_impl(q, k, v, causal, window, min(block_q, s),
                     min(block_k, sk), scale)
