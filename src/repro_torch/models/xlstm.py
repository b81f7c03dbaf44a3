"""xLSTM blocks (arXiv:2405.04517): mLSTM (matrix memory, parallelizable)
and sLSTM (scalar memory, truly recurrent), alternating per config.

Port of ``repro.models.xlstm``, under the reference's parameter names, so
weights carry across leaf for leaf. The mLSTM's full-sequence path is the
reference's chunked parallel form (a running rescale, so [S, S] is never
built), plain PyTorch as in the reference:

    d_ij = cumF_i - cumF_j + i_j   (j <= i),  separable as cumF_i + b_j
    h_i  = sum_j (q_i . k_j / sqrt(P)) e^{d_ij - m_i} v_j / max(|den_i|, e^{-m_i})

The sLSTM's full-sequence path goes through ``slstm_scan_op``, which
launches the hand-written kernel for CUDA tensors (``backend="auto"``) and
runs its plain version on the CPU or under ``backend="ref"``; its gradient
is the plain version's. Decode is the plain
recurrent step of both cells, as in the reference; where the reference
returns an updated copy of the cache, ``mlstm_decode`` and ``slstm_decode``
write the new state into ``cache`` in place.

Where the reference mixes dtypes, the port casts to what JAX computes: in
bf16 the mLSTM's q . k scores are a bf16 product, promoted to f32 by the
f32 scale, and the score-weighted sum of v is an f32 product.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs import ModelConfig
from repro_torch.kernels.slstm_fused import slstm_scan_op
from repro_torch.kernels.slstm_fused.ref import cell_step
from repro_torch.models.attention import compute_dtype_of
from repro_torch.models.layers import apply_norm, dense_init, init_norm


def _dims(cfg: ModelConfig):
    d = cfg.d_model
    dp = int(cfg.xlstm_proj_factor * d)
    h = cfg.n_heads
    p = dp // h
    return d, dp, h, p


def _group_norm(hg: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Per-head norm of hg [..., H, P] (population variance), flattened to
    [..., H * P] and scaled."""
    mu = torch.mean(hg, dim=-1, keepdim=True)
    var = torch.var(hg, dim=-1, keepdim=True, unbiased=False)
    hg = (hg - mu) * torch.rsqrt(var + 1e-6)
    return hg.reshape(*hg.shape[:-2], -1) * scale


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def init_mlstm(gen: torch.Generator, cfg: ModelConfig):
    """Random f32 parameters from ``gen``, on ``gen``'s device."""
    d, dp, h, p = _dims(cfg)
    return {
        "norm": init_norm(cfg.norm, d, device=gen.device),
        "w_up": dense_init(gen, (d, dp)),
        "w_gate": dense_init(gen, (d, dp)),
        "wq": dense_init(gen, (dp, dp)),
        "wk": dense_init(gen, (dp, dp)),
        "wv": dense_init(gen, (dp, dp)),
        "w_if": dense_init(gen, (dp, 2 * h)),  # i and f gate pre-activations
        "gn_scale": torch.ones((dp,), device=gen.device),
        "w_down": dense_init(gen, (dp, d)),
    }


def _pad_time(t: torch.Tensor, pad: int, fill: float = 0.0) -> torch.Tensor:
    if not pad:
        return t
    return torch.cat([t, t.new_full((t.shape[0], pad) + t.shape[2:], fill)],
                     dim=1)


def _mlstm_parallel(q, k, v, i_pre, f_pre, *, block: int = 256):
    """q,k,v: [B,S,H,P]; i_pre,f_pre: [B,S,H] -> h [B,S,H,P] (fp32).

    Chunked two-level scan with running (m, num, den) rescaling.
    """
    b, s, h, p = q.shape
    scale = float(np.float32(1.0) / np.sqrt(np.float32(p)))
    logf = F.logsigmoid(f_pre.float())
    cumf = torch.cumsum(logf, dim=1)                       # [B,S,H]
    bj = i_pre.float() - cumf                              # [B,S,H]

    block = min(block, s)
    nb = -(-s // block)
    pad = nb * block - s

    # block operands stay bf16 in a bf16 model; accumulation is fp32
    blk_dtype = q.dtype if q.dtype == torch.bfloat16 else torch.float32
    qc, kc, vc = (_pad_time(t, pad).reshape(b, nb, block, h, p).to(blk_dtype)
                  for t in (q, k, v))
    bjc = _pad_time(bj, pad, -1e30).reshape(b, nb, block, h)
    cumfc = _pad_time(cumf, pad).reshape(b, nb, block, h)
    idx = torch.arange(block, device=q.device)
    maskij = idx[None, :] <= idx[:, None]                  # j <= i

    def scores(q_blk, k_blk):
        return torch.einsum("bihp,bjhp->bhij", q_blk, k_blk).float() * scale

    def weighted_v(sw, v_blk):
        return torch.einsum("bhij,bjhp->bihp", sw, v_blk.float())

    def one_q_block(qi):
        q_blk = qc[:, qi]                                  # [B,Q,H,P]
        cf_i = cumfc[:, qi]                                # [B,Q,H]
        m_prev = torch.full((b, block, h), -1e30, device=q.device)
        num = torch.zeros((b, block, h, p), device=q.device)
        den = torch.zeros((b, block, h), device=q.device)
        # d_ij = cf_i + b_j is separable: a running column max (mb) keeps
        # exp(b_j - mb) bounded
        for kj in range(qi):
            k_blk, v_blk, b_blk = kc[:, kj], vc[:, kj], bjc[:, kj]
            mb = torch.amax(b_blk, dim=1)                  # [B,H]
            m_new = torch.maximum(m_prev, cf_i + mb[:, None, :])
            corr = torch.exp(m_prev - m_new)               # [B,Q,H]
            sc = scores(q_blk, k_blk)
            row = torch.exp(cf_i - m_new + mb[:, None, :])  # [B,Q,H]
            col = torch.exp(b_blk - mb[:, None, :])        # [B,K,H]
            sw = sc * row.permute(0, 2, 1)[..., None] \
                * col.permute(0, 2, 1)[:, :, None, :]      # [B,H,Q,K]
            num = num * corr[..., None] + weighted_v(sw, v_blk)
            den = den * corr + torch.sum(sw, dim=-1).permute(0, 2, 1)
            m_prev = m_new

        # diagonal block: prefix-max over j <= i
        k_blk, v_blk, b_blk = kc[:, qi], vc[:, qi], bjc[:, qi]
        cmax = torch.cummax(b_blk, dim=1).values           # [B,K,H]
        m_new = torch.maximum(m_prev, cf_i + cmax)         # row i: cmax[i]
        corr = torch.exp(m_prev - m_new)
        sc = scores(q_blk, k_blk)
        # w_ij = exp(cf_i + b_j - m_new_i) <= 1 for j <= i
        w = torch.exp(torch.clamp(
            cf_i[:, :, None, :] + b_blk[:, None, :, :] - m_new[:, :, None, :],
            max=0.0))
        w = torch.where(maskij[None, :, :, None], w, 0.0)
        sw = sc * w.permute(0, 3, 1, 2)
        num = num * corr[..., None] + weighted_v(sw, v_blk)
        den = den * corr + torch.sum(sw, dim=-1).permute(0, 2, 1)
        return num / torch.maximum(torch.abs(den),
                                   torch.exp(-m_new))[..., None]

    return torch.cat([one_q_block(qi) for qi in range(nb)], dim=1)[:, :s]


def mlstm_forward(params, x: torch.Tensor, cfg: ModelConfig, *,
                  block: int = 256) -> torch.Tensor:
    """x: [B,S,D] -> x + mLSTM block(x)."""
    d, dp, h, p = _dims(cfg)
    cd = compute_dtype_of(cfg)
    bsz, s, _ = x.shape
    xn = apply_norm(params["norm"], x, cfg.norm, cfg.norm_eps).to(cd)
    u = xn @ params["w_up"].to(cd)
    gate = xn @ params["w_gate"].to(cd)
    q = (u @ params["wq"].to(cd)).reshape(bsz, s, h, p)
    k = (u @ params["wk"].to(cd)).reshape(bsz, s, h, p)
    v = (u @ params["wv"].to(cd)).reshape(bsz, s, h, p)
    if_pre = (u @ params["w_if"].to(cd)).float()
    i_pre, f_pre = torch.chunk(if_pre, 2, dim=-1)
    hv = _mlstm_parallel(q, k, v, i_pre, f_pre, block=block)  # fp32
    hv = _group_norm(hv, params["gn_scale"])
    out = hv.to(cd) * F.silu(gate)
    return x + (out @ params["w_down"].to(cd)).to(x.dtype)


def init_mlstm_cache(cfg: ModelConfig, batch: int, *, device):
    """C, n and m of ONE mLSTM layer, f32 (as the reference's
    ``Model.init_cache``, whatever the model's dtype)."""
    _, dp, h, p = _dims(cfg)
    return {
        "C": torch.zeros((batch, h, p, p), device=device),
        "n": torch.zeros((batch, h, p), device=device),
        "m": torch.full((batch, h), -1e30, device=device),
    }


def mlstm_decode(params, x: torch.Tensor, cache, cfg: ModelConfig):
    """x: [B,1,D] -> (x + mLSTM block(x), cache); the new C, n and m are
    written into ``cache`` in place."""
    d, dp, h, p = _dims(cfg)
    cd = compute_dtype_of(cfg)
    bsz = x.shape[0]
    xn = apply_norm(params["norm"], x[:, 0], cfg.norm, cfg.norm_eps).to(cd)
    u = xn @ params["w_up"].to(cd)
    gate = xn @ params["w_gate"].to(cd)
    q = (u @ params["wq"].to(cd)).reshape(bsz, h, p).float()
    k = (u @ params["wk"].to(cd)).reshape(bsz, h, p).float()
    v = (u @ params["wv"].to(cd)).reshape(bsz, h, p).float()
    if_pre = (u @ params["w_if"].to(cd)).float()
    i_pre, f_pre = torch.chunk(if_pre, 2, dim=-1)          # [B,H]
    logf = F.logsigmoid(f_pre)
    m_prev, C, n = (cache[key].float() for key in ("m", "C", "n"))
    m_new = torch.maximum(logf + m_prev, i_pre)
    f_act = torch.exp(logf + m_prev - m_new)
    i_act = torch.exp(i_pre - m_new)
    scale = float(np.float32(1.0) / np.sqrt(np.float32(p)))
    C = C * f_act[..., None, None] \
        + i_act[..., None, None] * torch.einsum("bhp,bhq->bhpq", v, k)
    n = n * f_act[..., None] + i_act[..., None] * k
    num = torch.einsum("bhpq,bhq->bhp", C, q * scale)
    den = torch.maximum(
        torch.abs(torch.einsum("bhp,bhp->bh", n, q * scale)),
        torch.exp(-m_new))
    hv = _group_norm(num / den[..., None], params["gn_scale"])  # [B,dp]
    out = hv.to(cd) * F.silu(gate)
    out = (out @ params["w_down"].to(cd)).to(x.dtype)
    for key, new in (("C", C), ("n", n), ("m", m_new)):
        cache[key].copy_(new)
    return x + out[:, None, :], cache


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


def init_slstm(gen: torch.Generator, cfg: ModelConfig):
    """Random f32 parameters from ``gen``, on ``gen``'s device. The head
    is d_model // n_heads wide (not ``_dims``' mLSTM head)."""
    d = cfg.d_model
    h = cfg.n_heads
    up = int(cfg.xlstm_proj_factor * d)
    dev = gen.device
    return {
        "norm": init_norm(cfg.norm, d, device=dev),
        "w_in": dense_init(gen, (d, 4 * d)),               # z,i,f,o inputs
        "r": dense_init(gen, (4, h, d // h, d // h), scale=0.02),
        "b": torch.zeros((4 * d,), device=dev),
        "gn_scale": torch.ones((d,), device=dev),
        "w_up_gate": dense_init(gen, (d, up)),
        "w_up": dense_init(gen, (d, up)),
        "w_down": dense_init(gen, (up, d)),
    }


def _slstm_cell(params, pre: torch.Tensor, state):
    """One time step. pre: [B, 4D] gate pre-activations (z, i, f, o);
    state: dict of [B, H, P] -> the new state."""
    b, hh, p = state["h"].shape
    rec = torch.einsum("bhp,ghpq->bghq", state["h"], params["r"].float())
    return cell_step(pre.reshape(b, 4, hh, p), rec, state)


def init_slstm_cache(cfg: ModelConfig, batch: int, *, device):
    """h, c, n and m of ONE sLSTM layer, f32."""
    h = cfg.n_heads
    p = cfg.d_model // h
    z = torch.zeros((batch, h, p), device=device)
    return {"h": z, "c": z.clone(), "n": z.clone(),
            "m": torch.full((batch, h, p), -1e30, device=device)}


def _slstm_out(params, hv: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Group norm of the cell output hv [..., H, P], then the gated
    up/down projection. The gate is always GELU (tanh form), whatever
    ``cfg.act`` says, as in the reference's sLSTM block."""
    cd = compute_dtype_of(cfg)
    hv = _group_norm(hv, params["gn_scale"]).to(cd)
    up = F.gelu(hv @ params["w_up_gate"].to(cd), approximate="tanh") \
        * (hv @ params["w_up"].to(cd))
    return up @ params["w_down"].to(cd)


def _slstm_pre(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    cd = compute_dtype_of(cfg)
    xn = apply_norm(params["norm"], x, cfg.norm, cfg.norm_eps).to(cd)
    return (xn @ params["w_in"].to(cd)).float() + params["b"]


def slstm_forward(params, x: torch.Tensor, cfg: ModelConfig, *,
                  backend: str = "auto") -> torch.Tensor:
    """x: [B,S,D] -> x + sLSTM block(x): the true sequential recurrence,
    through ``slstm_scan_op`` (the recurrent weights stay in registers
    across the sweep: see kernels/slstm_fused)."""
    h = cfg.n_heads
    bsz, s, d = x.shape
    pre = _slstm_pre(params, x, cfg).reshape(bsz, s, 4, h, d // h)
    hs = slstm_scan_op(pre, params["r"], backend)        # [B,S,H,P]
    return x + _slstm_out(params, hs, cfg).to(x.dtype)


def slstm_decode(params, x: torch.Tensor, cache, cfg: ModelConfig):
    """x: [B,1,D] -> (x + sLSTM block(x), cache); the new h, c, n and m
    are written into ``cache`` in place."""
    st = _slstm_cell(params, _slstm_pre(params, x[:, 0], cfg),
                     {k: v.float() for k, v in cache.items()})
    out = _slstm_out(params, st["h"], cfg).to(x.dtype)
    for key, new in st.items():
        cache[key].copy_(new)
    return x + out[:, None, :], cache
