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

On a mesh of ranks (``mesh``: ``launch.sharding.rank_specs``' head-parallel
layout over ``"model"``) a rank whose ``w_x`` holds fewer than ``d_in``
columns runs its block of heads: ``w_z``, ``w_x``, ``w_dt``, ``conv_x_*``,
``A_log``, ``D``, ``dt_bias`` and ``norm_scale`` are its heads' (their
input enters through ``replicated``), ``out_proj`` its rows (the partial
output summed by ``reduce_from_peers``). ``w_B``, ``w_C`` and their
convolutions are whole: every peer computes B and C from the input as it
is and passes them, after the convolution and SiLU, through
``replicated``, since each peer uses them on its own heads. The gated
norm's mean over the whole ``d_in`` is the f32 sum of squares ``psum``-ed
over the peers (whose cotangent is partial too) over ``d_in``. A layout
that splits the channels but not the heads (``d_in`` divides, the head
count does not) is not run: it raises.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs import ModelConfig
from repro_torch.kernels.ssm_scan import ssd_scan_op
from repro_torch.launch import collectives as coll
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


def _gated_norm(y, z, scale, eps=1e-6, mesh=None, width=None):
    """RMSNorm of ``y * silu(z)``; on a ``mesh``, of this rank's channels
    of ``width`` in all."""
    g = y * F.silu(z)
    gf = g.float()
    if mesh is None:
        var = torch.mean(gf * gf, dim=-1, keepdim=True)
    else:
        var = coll.psum(torch.sum(gf * gf, dim=-1, keepdim=True), mesh,
                        "model") / width
    return (gf * torch.rsqrt(var + eps) * scale).to(y.dtype)


def _split(params, cfg: ModelConfig, d_in: int, mesh):
    """(mesh or None, the rank's heads): the mesh where this rank holds a
    block of the heads (module docstring)."""
    dl, hl = params["w_x"].shape[-1], params["w_dt"].shape[-1]
    if mesh is None or dl == d_in:
        return None, hl
    if hl * cfg.ssm_head_dim != dl:
        raise ValueError(f"{cfg.name}: {dl} of {d_in} mixer channels with "
                         f"{hl} whole heads: a split inside heads is not "
                         f"run")
    return mesh, hl


def _replicated(t, mesh):
    if mesh is None:
        return t
    return coll.replicated(t, mesh, "model")


def _out(params, y: torch.Tensor, compute_dtype, mesh) -> torch.Tensor:
    out = y.to(compute_dtype) @ params["out_proj"].to(compute_dtype)
    if mesh is not None:
        out = coll.reduce_from_peers(out, mesh, "model")
    return out


def mamba2_forward(params, x: torch.Tensor, cfg: ModelConfig, *,
                   backend: str = "auto", chunk: int = 64,
                   mesh=None) -> torch.Tensor:
    """x: [B,S,D] -> [B,S,D]. On a ``mesh``, the rank's heads (module
    docstring)."""
    compute_dtype = compute_dtype_of(cfg)
    bsz, s, d = x.shape
    _, d_in, _ = _dims(cfg, d)
    mesh, h = _split(params, cfg, d_in, mesh)
    xr = x.to(compute_dtype)
    xc = _replicated(x, mesh).to(compute_dtype)
    z = xc @ params["w_z"].to(compute_dtype)
    xs = xc @ params["w_x"].to(compute_dtype)
    Bm = xr @ params["w_B"].to(compute_dtype)
    Cm = xr @ params["w_C"].to(compute_dtype)
    dt_raw = xc @ params["w_dt"].to(compute_dtype)

    xs = F.silu(_causal_depthwise_conv(
        xs.float(), params["conv_x_w"], params["conv_x_b"]))
    Bm = _replicated(F.silu(_causal_depthwise_conv(
        Bm.float(), params["conv_B_w"], params["conv_B_b"])), mesh)
    Cm = _replicated(F.silu(_causal_depthwise_conv(
        Cm.float(), params["conv_C_w"], params["conv_C_b"])), mesh)
    dt = F.softplus(dt_raw.float() + params["dt_bias"])             # [B,S,H]
    A = -torch.exp(params["A_log"])                                  # [H]
    xh = xs.reshape(bsz, s, h, cfg.ssm_head_dim)
    y = ssd_scan_op(xh, dt, A, Bm, Cm, chunk, backend)
    y = y + params["D"][None, None, :, None] * xh
    y = y.reshape(bsz, s, h * cfg.ssm_head_dim)
    y = _gated_norm(y, z.float(), params["norm_scale"], mesh=mesh,
                    width=d_in)
    return _out(params, y, compute_dtype, mesh).to(x.dtype)


# ---------------------------------------------------------------------------
# decode (single token, recurrent state)
# ---------------------------------------------------------------------------


def init_mamba2_cache(cfg: ModelConfig, batch: int, *, device,
                      params=None):
    """Conv histories and SSM state of ONE Mamba2 layer, in f32 whatever
    the model's dtype (as the reference's ``Model.init_cache``); with
    ``params`` (a rank's block of the mixer, or its shapes), of the heads
    and ``conv_x`` channels it holds."""
    _, d_in, h = _dims(cfg)
    if params is not None:
        d_in, h = params["w_x"].shape[-1], params["w_dt"].shape[-1]
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


def mamba2_decode(params, x: torch.Tensor, cache, cfg: ModelConfig, *,
                  mesh=None):
    """x: [B,1,D] -> (y [B,1,D], cache). O(1) in context length; the new
    conv histories and state are written into ``cache`` in place. On a
    ``mesh``, the rank's heads (``init_mamba2_cache(params=)``)."""
    compute_dtype = compute_dtype_of(cfg)
    bsz, _, d = x.shape
    _, d_in, _ = _dims(cfg, d)
    mesh, h = _split(params, cfg, d_in, mesh)
    xr = x[:, 0].to(compute_dtype)
    xc = _replicated(x[:, 0], mesh).to(compute_dtype)
    z = xc @ params["w_z"].to(compute_dtype)
    xs_new = xc @ params["w_x"].to(compute_dtype)
    B_new = xr @ params["w_B"].to(compute_dtype)
    C_new = xr @ params["w_C"].to(compute_dtype)
    dt_raw = xc @ params["w_dt"].to(compute_dtype)

    xs, conv_x = _conv_step(cache["conv_x"], xs_new, params["conv_x_w"],
                            params["conv_x_b"])
    Bm, conv_B = _conv_step(cache["conv_B"], B_new, params["conv_B_w"],
                            params["conv_B_b"])
    Cm, conv_C = _conv_step(cache["conv_C"], C_new, params["conv_C_w"],
                            params["conv_C_b"])
    xs = F.silu(xs)
    Bm, Cm = _replicated(F.silu(Bm), mesh), _replicated(F.silu(Cm), mesh)

    dt = F.softplus(dt_raw.float() + params["dt_bias"])             # [B,H]
    A = -torch.exp(params["A_log"])
    dA = torch.exp(dt * A[None, :])                                  # [B,H]
    xh = xs.reshape(bsz, h, cfg.ssm_head_dim)
    state = cache["ssm"].float()
    state = state * dA[..., None, None] + torch.einsum(
        "bhp,bn->bhpn", dt[..., None] * xh, Bm)
    y = torch.einsum("bhpn,bn->bhp", state, Cm) \
        + params["D"][None, :, None] * xh
    y = y.reshape(bsz, h * cfg.ssm_head_dim)
    y = _gated_norm(y, z.float(), params["norm_scale"], mesh=mesh,
                    width=d_in)
    y = _out(params, y, compute_dtype, mesh)
    for key, new in (("conv_x", conv_x), ("conv_B", conv_B),
                     ("conv_C", conv_C), ("ssm", state)):
        cache[key].copy_(new)
    return y[:, None, :].to(x.dtype), cache
