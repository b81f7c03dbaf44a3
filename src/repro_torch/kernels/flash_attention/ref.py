"""Plain PyTorch versions of blockwise GQA attention.

Port of ``repro.kernels.flash_attention.ref``:

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

- ``flash_backward``: the reference's custom VJP (``_flash_core_bwd`` over
  ``_bwd_impl``): the per-row softmax statistics of the plain forward
  (``_fwd_impl``'s ``ms``, ``ls``), then two blockwise passes that
  recompute the scores, dQ per query block and dK, dV per key block, all in
  float32. ``ops.flash_attention_op`` takes it as the backward of both
  routes: the kernel keeps no statistics, so they are recomputed here.
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
    """The reference's forward: (out [B,S,H,D] in q's dtype, and the per-row
    running max ``ms`` and sum ``ls`` [B,S,KV,G] in float32)."""
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
            o = torch.einsum("bkgij,bjkd->bikgd",
                             p / torch.clamp(l, min=1e-30), v_rng.float())
            return (o, torch.movedim(m[..., 0], -1, 1),
                    torch.movedim(l[..., 0], -1, 1))

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
        return (acc / torch.clamp(l_b, min=1e-30),
                torch.movedim(m[..., 0], -1, 1), l_b[..., 0])

    blocks = [one_q_block(qi, qg[:, qi]) for qi in range(nq)]
    out, ms, ls = (torch.stack(x, dim=1) for x in zip(*blocks))
    out = out.reshape(b, nq * block_q, h, d)
    ms = ms.reshape(b, nq * block_q, n_kv, g)
    ls = ls.reshape(b, nq * block_q, n_kv, g)
    return out[:, :s].to(q.dtype), ms[:, :s], ls[:, :s]


def _bwd_impl(q, k, v, out, ms, ls, dout, causal, window, block_q, block_k,
              scale):
    """The reference's two-pass backward: (dq, dk, dv) in the inputs'
    dtypes; O(S·D) live memory, the scores recomputed per block pair."""
    b, s, h, d = q.shape
    _, sk, n_kv, _ = k.shape
    g = h // n_kv
    nq = -(-s // block_q)
    pad_q = nq * block_q - s
    q_off = sk - s
    nk = -(-sk // block_k)
    pad_k = nk * block_k - sk
    dev = q.device

    def grouped(t):
        return _group(_pad_seq(t.float(), pad_q), n_kv) \
            .reshape(b, nq, block_q, n_kv, g, d)

    qg, dog, og = grouped(q), grouped(dout), grouped(out)
    msr = _pad_seq(ms, pad_q).reshape(b, nq, block_q, n_kv, g)
    lsr = _pad_seq(ls, pad_q).reshape(b, nq, block_q, n_kv, g)
    delta = torch.sum(dog * og, dim=-1)                       # [B,nq,Bq,KV,G]
    kr = _pad_seq(k, pad_k).float()
    vr = _pad_seq(v, pad_k).float()

    def scores(qi, kj_start, span_k):
        """The normalised p of query block qi against a key range ->
        ([B,KV,G,Bq,span], the key range)."""
        q_blk = qg[:, qi] * scale
        k_rng = kr[:, kj_start:kj_start + span_k]
        qpos = qi * block_q + torch.arange(block_q, device=dev) + q_off
        kpos = kj_start + torch.arange(span_k, device=dev)
        valid = (kpos[None, :] <= qpos[:, None] if causal else
                 torch.ones((block_q, span_k), dtype=torch.bool, device=dev))
        if window is not None:
            valid = valid & (kpos[None, :] > qpos[:, None] - window)
        valid = valid & (kpos < sk)[None, :]
        sc = torch.einsum("bikgd,bjkd->bkgij", q_blk, k_rng)
        sc = torch.where(valid, sc, NEG_INF)
        m_i = torch.movedim(msr[:, qi], 1, -1)[..., None]    # [B,KV,G,Bq,1]
        l_i = torch.movedim(lsr[:, qi], 1, -1)[..., None]
        return torch.exp(sc - m_i) / torch.clamp(l_i, min=1e-30), k_rng

    def ds_of(qi, p, v_rng):
        dp = torch.einsum("bikgd,bjkd->bkgij", dog[:, qi], v_rng)
        dl = torch.movedim(delta[:, qi], 1, -1)[..., None]   # [B,KV,G,Bq,1]
        return p * (dp - dl)

    # -- pass 1: dQ per query block --------------------------------------
    def dq_block(qi):
        if window is not None:
            start, span = _band_range(qi, block_q, block_k, window, sk, q_off)
            p, k_rng = scores(qi, start, span)
            ds = ds_of(qi, p, vr[:, start:start + span])
            return torch.einsum("bkgij,bjkd->bikgd", ds, k_rng) * scale
        hi = min(qi + 1, nk) if causal and q_off == 0 else nk
        dq = torch.zeros((b, block_q, n_kv, g, d), device=dev)
        for kj in range(hi):
            p, k_rng = scores(qi, kj * block_k, block_k)
            ds = ds_of(qi, p, vr[:, kj * block_k:(kj + 1) * block_k])
            dq = dq + torch.einsum("bkgij,bjkd->bikgd", ds, k_rng) * scale
        return dq

    dq = torch.stack([dq_block(qi) for qi in range(nq)], dim=1)
    dq = dq.reshape(b, nq * block_q, h, d)[:, :s].to(q.dtype)

    # -- pass 2: dK, dV per key block ------------------------------------
    def dkv_block(kj):
        lo = kj if (causal and q_off == 0 and block_q == block_k) else 0
        hi = nq
        if window is not None:       # the query blocks whose band has kj
            lo = max(0, (kj * block_k - block_q - q_off) // block_q)
            hi = min(nq, (kj * block_k + block_k + window) // block_q + 1)
        dk = torch.zeros((b, block_k, n_kv, d), device=dev)
        dv = torch.zeros((b, block_k, n_kv, d), device=dev)
        v_rng = vr[:, kj * block_k:(kj + 1) * block_k]
        for qi in range(lo, hi):
            p, _ = scores(qi, kj * block_k, block_k)
            ds = ds_of(qi, p, v_rng)
            dv = dv + torch.einsum("bkgij,bikgd->bjkd", p, dog[:, qi])
            dk = dk + torch.einsum("bkgij,bikgd->bjkd", ds, qg[:, qi]) * scale
        return dk, dv

    dks, dvs = zip(*[dkv_block(kj) for kj in range(nk)])
    dk = torch.cat(dks, dim=1)[:, :sk].to(k.dtype)
    dv = torch.cat(dvs, dim=1)[:, :sk].to(v.dtype)
    return dq, dk, dv


def flash_reference(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None, block_q: int = 512,
                    block_k: int = 512,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Chunked attention with a running softmax; O(S·block) live memory."""
    b, s, h, d = q.shape
    _, sk, _, _ = k.shape
    scale = _scale(d, scale)
    return _fwd_impl(q, k, v, causal, window, min(block_q, s),
                     min(block_k, sk), scale)[0]


def flash_backward(q, k, v, dout, *, causal: bool = True,
                   window: Optional[int] = None, block_q: int = 512,
                   block_k: int = 512, scale: Optional[float] = None):
    """(dq, dk, dv) of ``flash_reference`` at (q, k, v) for the cotangent
    ``dout``: the reference's ``_flash_core_bwd``, with ``out``, ``ms`` and
    ``ls`` from the plain forward."""
    s, sk, d = q.shape[1], k.shape[1], q.shape[3]
    cfg = (causal, window, min(block_q, s), min(block_k, sk),
           _scale(d, scale))
    out, ms, ls = _fwd_impl(q, k, v, *cfg)
    return _bwd_impl(q, k, v, out, ms, ls, dout, *cfg)
