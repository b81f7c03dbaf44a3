"""Wrappers of the ``encounter_mix`` kernels: checks, dispatch, launch counts.

``encounter_mix(pos, area, active, weights, radius=...)`` returns
``(mix [M, D], mass [M])``: each row the mean of the weights of the peers
it met (same area, within ``radius``, both active, not itself), zero where
it met none, in ``weights``' dtype; ``mass`` the number of peers, float32.
On a CUDA tensor it launches the hand-written kernel
(``csrc/encounter_mix.cu``) or raises; on a CPU tensor it takes the plain
version (``ref.encounter_mix_reference``), which is what the CPU tests run.
``encounter_mix.launches`` counts kernel launches.

``encounter_block_hop(pos_r, area_r, act_r, row0, pos_v, area_v, act_v,
col0, weights_v, radius)`` is one hop of the ring (``baselines.gossip:
ring_encounter_mix``): local rows against a visiting block, global ids
``row0 + i`` and ``col0 + j``, returning the unnormalized ``(acc [R, D],
mass [R])`` of ``ref.encounter_block``, float32 only. ``backend="auto"``
launches the hop kernel (``encounter_hop_f32`` in the same source) on a
CUDA tensor and takes ``encounter_block`` on a CPU tensor; ``"ref"`` is
``encounter_block`` everywhere. ``encounter_block_hop.launches`` counts its
launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.encounter_mix.ref import (encounter_block,
                                                  encounter_mix_reference)

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_longlong,
                                     ctypes.c_float, ctypes.c_void_p]
_ENTRY = {torch.float32: "encounter_mix_f32",
          torch.bfloat16: "encounter_mix_bf16"}
# pos_r, area_r, act_r, R, row0, pos_v, area_v, act_v, V, col0, W_v, acc,
# mass, D, r2, stream
_HOP_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_longlong]
                 + [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_longlong]
                 + [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_float,
                                            ctypes.c_void_p])


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
    if not weights.is_contiguous():
        raise ValueError("encounter_mix: weights must be contiguous")
    pos = pos.contiguous()                      # [M, 2]: a small copy at most
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


def _check_block(name: str, pos: torch.Tensor, area: torch.Tensor,
                 act: Optional[torch.Tensor], n: int, dev) -> None:
    """One side of a hop: pos [n, 2] f32, area [n] int, act [n] bool."""
    if tuple(pos.shape) != (n, 2) or tuple(area.shape) != (n,) or (
            act is not None and tuple(act.shape) != (n,)):
        raise ValueError(
            f"encounter_block_hop wants pos_{name} [{n}, 2], area_{name} and "
            f"act_{name} [{n}], got {tuple(pos.shape)}, {tuple(area.shape)}, "
            f"{None if act is None else tuple(act.shape)}")
    if pos.dtype != torch.float32:
        raise TypeError(f"encounter_block_hop: pos_{name} must be float32, "
                        f"got {pos.dtype}")
    if area.dtype.is_floating_point or area.dtype.is_complex \
            or area.dtype == torch.bool:
        raise TypeError(f"encounter_block_hop: area_{name} must be integer, "
                        f"got {area.dtype}")
    if act is not None and act.dtype != torch.bool:
        raise TypeError(f"encounter_block_hop: act_{name} must be bool, got "
                        f"{act.dtype}")
    if any(t.device != dev for t in (pos, area) + (() if act is None
                                                    else (act,))):
        raise ValueError(f"encounter_block_hop: the {name} block's geometry "
                         f"is not on the weights' device {dev}")


def encounter_block_hop(pos_r: torch.Tensor, area_r: torch.Tensor,
                        act_r: Optional[torch.Tensor], row0: int,
                        pos_v: torch.Tensor, area_v: torch.Tensor,
                        act_v: Optional[torch.Tensor], col0: int,
                        weights_v: torch.Tensor, radius: float = 0.15, *,
                        backend: str = "auto"
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Local rows pos_r [R, 2] f32, area_r [R] int, act_r [R] bool (None ==
    all active) with global ids ``row0 + i``, against a visiting block
    (``*_v`` [V], global ids ``col0 + j``, weights_v [V, D] f32) ->
    (acc [R, D] f32, mass [R] f32), unnormalized."""
    if backend not in ("auto", "ref"):
        raise ValueError(f"unknown encounter_block_hop backend {backend!r}; "
                         "expected 'auto' or 'ref'")
    if weights_v.dim() != 2:
        raise ValueError(f"encounter_block_hop wants weights_v [V, D], got "
                         f"{tuple(weights_v.shape)}")
    if weights_v.dtype != torch.float32:
        raise TypeError(f"encounter_block_hop: weights_v must be float32, "
                        f"got {weights_v.dtype}")
    r = pos_r.shape[0]
    v, d = weights_v.shape
    dev = weights_v.device
    _check_block("r", pos_r, area_r, act_r, r, dev)
    _check_block("v", pos_v, area_v, act_v, v, dev)
    if backend == "ref" or dev.type == "cpu":
        return encounter_block(pos_r, area_r, act_r, row0, pos_v, area_v,
                               act_v, col0, weights_v, radius)
    if dev.type != "cuda":
        raise ValueError(f"encounter_block_hop runs on cuda or cpu, not "
                         f"{dev}")
    if not weights_v.is_contiguous():
        raise ValueError("encounter_block_hop: weights_v must be contiguous")
    pos_r, pos_v = pos_r.contiguous(), pos_v.contiguous()   # [n, 2]: small
    acc = torch.empty((r, d), dtype=torch.float32, device=dev)
    mass = torch.empty((r,), dtype=torch.float32, device=dev)
    if r == 0:
        return acc, mass

    def side(area, act, n):
        on = (torch.ones((n,), dtype=torch.bool, device=dev) if act is None
              else act.contiguous())
        return area.to(torch.int64).contiguous(), on

    area_r64, on_r = side(area_r, act_r, r)
    area_v64, on_v = side(area_v, act_v, v)
    fn = _build.load("encounter_mix").encounter_hop_f32
    fn.argtypes = _HOP_ARGTYPES
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(pos_r.data_ptr(), area_r64.data_ptr(), on_r.data_ptr(), r,
                 int(row0), pos_v.data_ptr(), area_v64.data_ptr(),
                 on_v.data_ptr(), v, int(col0), weights_v.data_ptr(),
                 acc.data_ptr(), mass.data_ptr(), d,
                 ctypes.c_float(radius ** 2), stream)
    if err != 0:
        raise RuntimeError(f"encounter_hop kernel launch failed: CUDA error "
                           f"{err} (R={r}, V={v}, D={d})")
    encounter_block_hop.launches += 1
    return acc, mass


encounter_block_hop.launches = 0
