"""Mamba2 (SSD) block, the mixer of zamba2.

Port of ``repro.models.mamba2``: input projections -> [z | x | B | C | dt];
causal depthwise conv over (x, B, C); silu; SSD scan; gated RMSNorm;
out_proj. B/C are shared across heads; A is a negative scalar per head; dt
via softplus(dt + bias). The projections stay separate (``w_z``, ``w_x``,
``w_B``, ``w_C``, ``w_dt``) under the reference's leaf names, so weights
carry across leaf for leaf.

The full-sequence path goes through ``ssd_scan_op``, which launches the
hand-written kernel for CUDA tensors (``backend="auto"``) and runs its
plain chunked version on the CPU or under ``backend="ref"``; its gradient
is the plain version's. Decode is the
plain O(1) recurrent step; where the reference returns an updated copy of
the cache, ``mamba2_decode`` writes the new conv history and state into
``cache`` in place.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs import ModelConfig
from repro_torch.kernels.ssm_scan import ssd_scan_op
from repro_torch.models.attention import compute_dtype_of
from repro_torch.models.layers import dense_init


def _dims(cfg: ModelConfig, d_model=None):
    d = d_model or cfg.d_model
    d_in = cfg.ssm_expand * d
    n_heads = d_in // cfg.ssm_head_dim
    return d, d_in, n_heads


def init_mamba2(gen: torch.Generator, cfg: ModelConfig):
    """Random f32 parameters from ``gen``, on ``gen``'s device."""
    d, d_in, h = _dims(cfg)
    n = cfg.ssm_state
    dev = gen.device
    return {
        "w_z": dense_init(gen, (d, d_in)),
        "w_x": dense_init(gen, (d, d_in)),
        "w_B": dense_init(gen, (d, n)),
        "w_C": dense_init(gen, (d, n)),
        "w_dt": dense_init(gen, (d, h)),
        "conv_x_w": dense_init(gen, (cfg.ssm_conv, d_in), scale=0.1),
        "conv_x_b": torch.zeros((d_in,), device=dev),
        "conv_B_w": dense_init(gen, (cfg.ssm_conv, n), scale=0.1),
        "conv_B_b": torch.zeros((n,), device=dev),
        "conv_C_w": dense_init(gen, (cfg.ssm_conv, n), scale=0.1),
        "conv_C_b": torch.zeros((n,), device=dev),
        "A_log": torch.log(torch.arange(1, h + 1, dtype=torch.float32,
                                        device=dev)),
        "D": torch.ones((h,), device=dev),
        "dt_bias": torch.zeros((h,), device=dev),
        "norm_scale": torch.ones((d_in,), device=dev),
        "out_proj": dense_init(gen, (d_in, d)),
    }


def _causal_depthwise_conv(x, w, b):
    """x: [B,S,C]; w: [K,C] -> causal depthwise conv (the reference's
    shifted sum, in its order)."""
    k = w.shape[0]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = sum(xp[:, i:i + x.shape[1], :] * w[i][None, None, :]
              for i in range(k))
    return out + b[None, None, :]


def _gated_norm(y, z, scale, eps=1e-6):
    g = y * F.silu(z)
    gf = g.float()
    var = torch.mean(gf * gf, dim=-1, keepdim=True)
    return (gf * torch.rsqrt(var + eps) * scale).to(y.dtype)


def mamba2_forward(params, x: torch.Tensor, cfg: ModelConfig, *,
                   backend: str = "auto", chunk: int = 64) -> torch.Tensor:
    """x: [B,S,D] -> [B,S,D]."""
    compute_dtype = compute_dtype_of(cfg)
    bsz, s, d = x.shape
    _, d_in, h = _dims(cfg, d)
    xc = x.to(compute_dtype)
    z = xc @ params["w_z"].to(compute_dtype)
    xs = xc @ params["w_x"].to(compute_dtype)
    Bm = xc @ params["w_B"].to(compute_dtype)
    Cm = xc @ params["w_C"].to(compute_dtype)
    dt_raw = xc @ params["w_dt"].to(compute_dtype)

    xs = F.silu(_causal_depthwise_conv(
        xs.float(), params["conv_x_w"], params["conv_x_b"]))
    Bm = F.silu(_causal_depthwise_conv(
        Bm.float(), params["conv_B_w"], params["conv_B_b"]))
    Cm = F.silu(_causal_depthwise_conv(
        Cm.float(), params["conv_C_w"], params["conv_C_b"]))
    dt = F.softplus(dt_raw.float() + params["dt_bias"])             # [B,S,H]
    A = -torch.exp(params["A_log"])                                  # [H]
    xh = xs.reshape(bsz, s, h, cfg.ssm_head_dim)
    y = ssd_scan_op(xh, dt, A, Bm, Cm, chunk, backend)
    y = y + params["D"][None, None, :, None] * xh
    y = y.reshape(bsz, s, d_in)
    y = _gated_norm(y, z.float(), params["norm_scale"])
    return (y.to(compute_dtype)
            @ params["out_proj"].to(compute_dtype)).to(x.dtype)


# ---------------------------------------------------------------------------
# decode (single token, recurrent state)
# ---------------------------------------------------------------------------


def init_mamba2_cache(cfg: ModelConfig, batch: int, *, device):
    """Conv histories and SSM state of ONE Mamba2 layer, in f32 whatever
    the model's dtype (as the reference's ``Model.init_cache``)."""
    _, d_in, h = _dims(cfg)
    n, k = cfg.ssm_state, cfg.ssm_conv
    return {
        "conv_x": torch.zeros((batch, k - 1, d_in), device=device),
        "conv_B": torch.zeros((batch, k - 1, n), device=device),
        "conv_C": torch.zeros((batch, k - 1, n), device=device),
        "ssm": torch.zeros((batch, h, cfg.ssm_head_dim, n), device=device),
    }


def _conv_step(hist, new, w, b):
    """hist: [B,K-1,C]; new: [B,C] -> (conv output [B,C], new hist)."""
    full = torch.cat([hist, new[:, None, :].to(hist.dtype)], dim=1)
    out = torch.einsum("bkc,kc->bc", full.float(), w) + b
    return out, full[:, 1:]


def mamba2_decode(params, x: torch.Tensor, cache, cfg: ModelConfig):
    """x: [B,1,D] -> (y [B,1,D], cache). O(1) in context length; the new
    conv histories and state are written into ``cache`` in place."""
    compute_dtype = compute_dtype_of(cfg)
    bsz, _, d = x.shape
    _, d_in, h = _dims(cfg, d)
    xc = x[:, 0].to(compute_dtype)
    z = xc @ params["w_z"].to(compute_dtype)
    xs_new = xc @ params["w_x"].to(compute_dtype)
    B_new = xc @ params["w_B"].to(compute_dtype)
    C_new = xc @ params["w_C"].to(compute_dtype)
    dt_raw = xc @ params["w_dt"].to(compute_dtype)

    xs, conv_x = _conv_step(cache["conv_x"], xs_new, params["conv_x_w"],
                            params["conv_x_b"])
    Bm, conv_B = _conv_step(cache["conv_B"], B_new, params["conv_B_w"],
                            params["conv_B_b"])
    Cm, conv_C = _conv_step(cache["conv_C"], C_new, params["conv_C_w"],
                            params["conv_C_b"])
    xs, Bm, Cm = F.silu(xs), F.silu(Bm), F.silu(Cm)

    dt = F.softplus(dt_raw.float() + params["dt_bias"])             # [B,H]
    A = -torch.exp(params["A_log"])
    dA = torch.exp(dt * A[None, :])                                  # [B,H]
    xh = xs.reshape(bsz, h, cfg.ssm_head_dim)
    state = cache["ssm"].float()
    state = state * dA[..., None, None] + torch.einsum(
        "bhp,bn->bhpn", dt[..., None] * xh, Bm)
    y = torch.einsum("bhpn,bn->bhp", state, Cm) \
        + params["D"][None, :, None] * xh
    y = y.reshape(bsz, d_in)
    y = _gated_norm(y, z.float(), params["norm_scale"])
    y = y.to(compute_dtype) @ params["out_proj"].to(compute_dtype)
    for key, new in (("conv_x", conv_x), ("conv_B", conv_B),
                     ("conv_C", conv_C), ("ssm", state)):
        cache[key].copy_(new)
    return y[:, None, :].to(x.dtype), cache
