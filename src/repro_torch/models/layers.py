"""Shared building blocks of the LM stack: init, norms, activations, RoPE
and M-RoPE, MLP, sinusoidal positions.

Port of ``repro.models.layers``. Parameters are plain tensors in the
reference's layouts (dense ``[in, out]``), held in nested dicts. Norms and
RoPE compute in float32 and cast back to the input's dtype, as the
reference does. ``rope_angles`` takes M-RoPE's three position streams
(qwen2-vl), ``sinusoidal_positions`` gives Whisper's fixed positional
embeddings. The reference's asserts on M-RoPE's inputs are ``ValueError``s.
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
# RoPE / M-RoPE
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, *, device) -> torch.Tensor:
    """Inverse frequencies, shape [head_dim // 2], float32."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float,
                mrope_sections: Optional[Tuple[int, int, int]] = None
                ) -> torch.Tensor:
    """Rotation angles [B, S, head_dim // 2].

    positions: [B, S] for plain RoPE, or [3, B, S] (t/h/w streams) for
    M-RoPE, whose frequency slots are split into ``mrope_sections``, each
    fed by one stream (Qwen2-VL Sec 3.2); the sections must sum to
    ``head_dim // 2``.
    """
    inv = rope_freqs(head_dim, theta, device=positions.device)
    if mrope_sections is None:
        return positions[..., None].float() * inv
    if positions.dim() != 3 or positions.shape[0] != 3:
        raise ValueError(f"M-RoPE wants [3, B, S] positions, got "
                         f"{tuple(positions.shape)}")
    if sum(mrope_sections) != head_dim // 2:
        raise ValueError(f"M-RoPE sections {tuple(mrope_sections)} do not "
                         f"sum to head_dim // 2 = {head_dim // 2}")
    # which stream feeds each frequency slot [hd/2]: 0 below the first
    # section's end, 1 below the second's, else 2; built on the device from
    # Python ints, so no host tensor is copied (and no stream synchronised)
    s0, s1, _ = mrope_sections
    slot = torch.arange(head_dim // 2, device=positions.device)
    sec_id = (slot >= s0).long() + (slot >= s0 + s1).long()
    ang = positions[sec_id].float() * inv[:, None, None]   # [hd/2, B, S]
    return torch.movedim(ang, 0, -1)


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


def sinusoids(positions: torch.Tensor, dim: int) -> torch.Tensor:
    """[len(positions), dim] f32: sin of position x frequency in the even
    columns, cos in the odd ones, frequencies 10000^(-i / dim) for even
    i. ``sinusoidal_positions`` is its rows 0..seq-1; Whisper's decode
    takes the row of its one position."""
    dev = positions.device
    # -log(10000) / dim in float32, as the reference computes it
    rate = -torch.log(torch.tensor(10000.0, device=dev)) / dim
    div = torch.exp(torch.arange(0, dim, 2, dtype=torch.float32,
                                 device=dev) * rate)
    ang = positions.float()[:, None] * div
    pe = torch.zeros((positions.shape[0], dim), device=dev)
    pe[:, 0::2] = torch.sin(ang)
    pe[:, 1::2] = torch.cos(ang)
    return pe


def sinusoidal_positions(seq: int, dim: int, *, device="cpu"
                         ) -> torch.Tensor:
    """Whisper's fixed positional embeddings [seq, dim] f32."""
    return sinusoids(torch.arange(seq, dtype=torch.float32, device=device),
                     dim)
