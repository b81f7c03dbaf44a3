"""Wrapper of the ``encounter_mix`` kernel: checks, dispatch, launch count.

``encounter_mix(pos, area, active, weights, radius=...)`` returns
``(mix [M, D], mass [M])``: each row the mean of the weights of the peers
it met (same area, within ``radius``, both active, not itself), zero where
it met none, in ``weights``' dtype; ``mass`` the number of peers, float32.
On a CUDA tensor it launches the hand-written kernel
(``csrc/encounter_mix.cu``) or raises; on a CPU tensor it takes the plain
version (``ref.encounter_mix_reference``), which is what the CPU tests run.
``encounter_mix.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.encounter_mix.ref import encounter_mix_reference

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_longlong,
                                     ctypes.c_float, ctypes.c_void_p]
_ENTRY = {torch.float32: "encounter_mix_f32",
          torch.bfloat16: "encounter_mix_bf16"}


def _check(pos: torch.Tensor, area: torch.Tensor,
           active: Optional[torch.Tensor], weights: torch.Tensor) -> None:
    if weights.dim() != 2:
        raise ValueError(f"encounter_mix wants weights [M, D], got "
                         f"{tuple(weights.shape)}")
    m = weights.shape[0]
    if tuple(pos.shape) != (m, 2):
        raise ValueError(f"encounter_mix wants pos [M, 2] with M={m}, got "
                         f"{tuple(pos.shape)}")
    if tuple(area.shape) != (m,):
        raise ValueError(f"encounter_mix wants area [M] with M={m}, got "
                         f"{tuple(area.shape)}")
    if active is not None and tuple(active.shape) != (m,):
        raise ValueError(f"encounter_mix wants active [M] with M={m}, got "
                         f"{tuple(active.shape)}")
    if pos.dtype != torch.float32:
        raise TypeError(f"encounter_mix: pos must be float32, got {pos.dtype}")
    if area.dtype.is_floating_point or area.dtype.is_complex \
            or area.dtype == torch.bool:
        raise TypeError(f"encounter_mix: area must be integer, got "
                        f"{area.dtype}")
    if active is not None and active.dtype != torch.bool:
        raise TypeError(f"encounter_mix: active must be bool, got "
                        f"{active.dtype}")
    if weights.dtype not in _ENTRY:
        raise TypeError(f"encounter_mix: weights must be float32 or bfloat16, "
                        f"got {weights.dtype}")
    others = [pos, area] + ([] if active is None else [active])
    if any(t.device != weights.device for t in others):
        raise ValueError(f"encounter_mix: inputs on "
                         f"{sorted({str(t.device) for t in others})}, "
                         f"weights on {weights.device}")


def encounter_mix(pos: torch.Tensor, area: torch.Tensor,
                  active: Optional[torch.Tensor], weights: torch.Tensor, *,
                  radius: float = 0.15) -> Tuple[torch.Tensor, torch.Tensor]:
    """pos [M, 2] f32, area [M] int, active [M] bool (None == all active),
    weights [M, D] f32|bf16 -> (mix [M, D] in weights' dtype, mass [M] f32)."""
    _check(pos, area, active, weights)
    if weights.device.type == "cpu":
        mix, mass = encounter_mix_reference(pos, area, active, weights,
                                            radius=radius)
        return mix.to(weights.dtype), mass
    if weights.device.type != "cuda":
        raise ValueError(f"encounter_mix runs on cuda or cpu, not "
                         f"{weights.device}")
    if not (pos.is_contiguous() and weights.is_contiguous()):
        raise ValueError("encounter_mix: pos and weights must be contiguous")
    m, d = weights.shape
    dev = weights.device
    out = torch.empty((m, d), dtype=weights.dtype, device=dev)
    mass = torch.empty((m,), dtype=torch.float32, device=dev)
    if m == 0:
        return out, mass
    area64 = area.to(torch.int64).contiguous()
    on = (torch.ones((m,), dtype=torch.bool, device=dev) if active is None
          else active.contiguous())
    fn = getattr(_build.load("encounter_mix"), _ENTRY[weights.dtype])
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(pos.data_ptr(), area64.data_ptr(), on.data_ptr(),
                 weights.data_ptr(), out.data_ptr(), mass.data_ptr(), m, d,
                 ctypes.c_float(radius ** 2), stream)
    if err != 0:
        raise RuntimeError(f"encounter_mix kernel launch failed: CUDA error "
                           f"{err} (M={m}, D={d}, {weights.dtype})")
    encounter_mix.launches += 1
    return out, mass


encounter_mix.launches = 0
