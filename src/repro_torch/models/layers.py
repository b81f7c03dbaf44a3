"""Shared building blocks of the LM stack: init, norms, activations, RoPE, MLP.

Port of ``repro.models.layers``. Parameters are plain tensors in the
reference's layouts (dense ``[in, out]``), held in nested dicts. Norms and
RoPE compute in float32 and cast back to the input's dtype, as the
reference does. M-RoPE and ``sinusoidal_positions`` wait for the
architectures that use them (ROADMAP §1 items 14.5 and 14.4).
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------


def dense_init(gen: torch.Generator, shape, scale: float = 0.02
               ) -> torch.Tensor:
    """Normal(0, scale) f32 weights drawn from ``gen``, on ``gen``'s device."""
    return scale * torch.randn(tuple(shape), generator=gen, device=gen.device)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def init_norm(kind: str, dim: int, *, device):
    if kind == "rmsnorm":
        return {"scale": torch.ones((dim,), device=device)}
    return {"scale": torch.ones((dim,), device=device),
            "bias": torch.zeros((dim,), device=device)}


def apply_norm(params, x: torch.Tensor, kind: str, eps: float = 1e-6):
    xf = x.float()
    if kind == "rmsnorm":
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + eps) * params["scale"]
    else:
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
        y = (xf - mu) * torch.rsqrt(var + eps) * params["scale"] \
            + params["bias"]
    return y.to(x.dtype)


def activation(name: str):
    # jax.nn.gelu defaults to the tanh approximation; torch's gelu does not
    return {"silu": F.silu,
            "gelu": functools.partial(F.gelu, approximate="tanh"),
            "relu": F.relu}[name]


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, *, device) -> torch.Tensor:
    """Inverse frequencies, shape [head_dim // 2], float32."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float,
                mrope_sections: Optional[Tuple[int, int, int]] = None
                ) -> torch.Tensor:
    """Rotation angles [B, S, head_dim // 2] for positions [B, S]."""
    if mrope_sections is not None:
        raise NotImplementedError(
            "M-RoPE is not ported yet; it arrives with ROADMAP §1 item 14.5 "
            "(qwen2-vl)")
    inv = rope_freqs(head_dim, theta, device=positions.device)
    return positions[..., None].float() * inv


def apply_rope(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """x: [B, S, H, hd]; angles: [B, S, hd // 2] -> x rotated (split halves)."""
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# gated MLP (SwiGLU / GeGLU)
# ---------------------------------------------------------------------------


def init_mlp(gen: torch.Generator, d_model: int, d_ff: int):
    return {
        "wi_gate": dense_init(gen, (d_model, d_ff)),
        "wi_up": dense_init(gen, (d_model, d_ff)),
        "wo": dense_init(gen, (d_ff, d_model)),
    }


def apply_mlp(params, x: torch.Tensor, act: str,
              compute_dtype=torch.bfloat16) -> torch.Tensor:
    xc = x.to(compute_dtype)
    g = activation(act)(xc @ params["wi_gate"].to(compute_dtype))
    u = xc @ params["wi_up"].to(compute_dtype)
    return ((g * u) @ params["wo"].to(compute_dtype)).to(x.dtype)


# ---------------------------------------------------------------------------
# misc
# ---------------------------------------------------------------------------


def sinusoidal_positions(seq: int, dim: int) -> torch.Tensor:
    raise NotImplementedError(
        "sinusoidal positions are not ported yet; they arrive with ROADMAP "
        "§1 item 14.4 (whisper)")
