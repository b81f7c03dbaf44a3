"""Wrapper of the ``mule_agg`` kernel: checks, device dispatch, launch count.

``mule_agg(assign, weights)`` computes ``assign [F, M] @ weights [M, D]``
with fp32 accumulation and returns ``[F, D]`` in ``weights``' dtype. On a
CUDA tensor it launches the hand-written kernel (``csrc/mule_agg.cu``) or
raises; on a CPU tensor it takes the plain version (``ref.py``), which is
what the CPU tests run. ``mule_agg.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.mule_agg.ref import mule_agg_plain

MAX_F = 16          # the kernel's compile-time bound on F (rows of assign)

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
_ENTRY = {torch.float32: "mule_agg_f32", torch.bfloat16: "mule_agg_bf16"}


def _check(assign: torch.Tensor, weights: torch.Tensor) -> None:
    if assign.dim() != 2 or weights.dim() != 2:
        raise ValueError(f"mule_agg wants assign [F, M] and weights [M, D], "
                         f"got {tuple(assign.shape)} and "
                         f"{tuple(weights.shape)}")
    if assign.shape[1] != weights.shape[0]:
        raise ValueError(f"mule_agg: assign has M={assign.shape[1]} columns "
                         f"but weights has {weights.shape[0]} rows")
    if assign.dtype != torch.float32:
        raise TypeError(f"mule_agg: assign must be float32, got {assign.dtype}")
    if weights.dtype not in _ENTRY:
        raise TypeError(f"mule_agg: weights must be float32 or bfloat16, "
                        f"got {weights.dtype}")
    if assign.device != weights.device:
        raise ValueError(f"mule_agg: assign on {assign.device}, weights on "
                         f"{weights.device}")


def mule_agg(assign: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """assign [F, M] f32 x weights [M, D] f32|bf16 -> [F, D] in weights' dtype."""
    _check(assign, weights)
    if weights.device.type == "cpu":
        return mule_agg_plain(assign, weights)
    if weights.device.type != "cuda":
        raise ValueError(f"mule_agg runs on cuda or cpu, not {weights.device}")
    f, m = assign.shape
    d = weights.shape[1]
    if f > MAX_F:
        raise ValueError(f"mule_agg: F={f} rows of assign exceed the "
                         f"kernel's bound of {MAX_F}")
    if not (assign.is_contiguous() and weights.is_contiguous()):
        raise ValueError("mule_agg: assign and weights must be contiguous")
    out = torch.empty((f, d), dtype=weights.dtype, device=weights.device)
    if f == 0 or d == 0:
        return out
    if m == 0:
        return out.zero_()
    fn = getattr(_build.load("mule_agg"), _ENTRY[weights.dtype])
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    with torch.cuda.device(weights.device):
        stream = torch.cuda.current_stream(weights.device).cuda_stream
        err = fn(assign.data_ptr(), weights.data_ptr(), out.data_ptr(),
                 f, m, d, stream)
    if err != 0:
        raise RuntimeError(f"mule_agg kernel launch failed: CUDA error {err} "
                           f"(F={f}, M={m}, D={d}, {weights.dtype})")
    mule_agg.launches += 1
    return out


mule_agg.launches = 0
