"""Wrapper of the ``mule_agg`` kernel: checks, device dispatch, launch count.

``mule_agg(assign, weights)`` computes ``assign [F, M] @ weights [M, D]``
with fp32 accumulation and returns ``[F, D]`` in ``weights``' dtype, for
any F: the kernel takes the rows in tiles of at most 16 within one launch.
On a CUDA tensor it launches the hand-written kernel (``csrc/mule_agg.cu``)
or raises; on a CPU tensor it takes the plain version (``ref.py``), which is
what the CPU tests run. ``mule_agg.launches`` counts kernel launches.

``mule_agg_lanes(assign [S, F, M], weights [S, M, D])`` is the lane-batched
entry of a seed sweep: ``[S, F, D]`` from one launch of the same kernel
for all S lanes (``gridDim.y``), each lane the bits of ``mule_agg`` on its
own inputs; on a CPU tensor ``ref.mule_agg_lanes_plain``. It adds one to
``mule_agg.launches`` a call; ``mule_agg`` on a CUDA tensor is its one-lane
call.

``mule_agg_op`` is ``mule_agg`` registered as the custom op
``repro_torch::mule_agg``, so that ``torch.func.vmap`` can see it: its
vmap rule hands the lanes to ``mule_agg_lanes`` (``scenarios/sweep.py``
vmaps the engine's step over seeds). ``core.aggregation`` calls it.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.mule_agg.ref import (mule_agg_lanes_plain,
                                              mule_agg_plain)

# A, W, out, S, F, M, D, stream
_LANES_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
    ctypes.c_longlong, ctypes.c_void_p]
_LANES_ENTRY = {torch.float32: "mule_agg_lanes_f32",
                torch.bfloat16: "mule_agg_lanes_bf16"}
MAX_LANES = 65535   # gridDim.y


def _check(assign: torch.Tensor, weights: torch.Tensor, lanes: int = 0
           ) -> None:
    """``lanes`` leading axes: 0 for ``mule_agg``, 1 for ``mule_agg_lanes``."""
    what = ("assign [F, M] and weights [M, D]" if not lanes else
            "assign [S, F, M] and weights [S, M, D]")
    if assign.dim() != 2 + lanes or weights.dim() != 2 + lanes:
        raise ValueError(f"mule_agg wants {what}, got "
                         f"{tuple(assign.shape)} and {tuple(weights.shape)}")
    if lanes and assign.shape[0] != weights.shape[0]:
        raise ValueError(f"mule_agg_lanes: assign has {assign.shape[0]} "
                         f"lanes but weights has {weights.shape[0]}")
    if assign.shape[-1] != weights.shape[-2]:
        raise ValueError(f"mule_agg: assign has M={assign.shape[-1]} columns "
                         f"but weights has {weights.shape[-2]} rows")
    if assign.dtype != torch.float32:
        raise TypeError(f"mule_agg: assign must be float32, got {assign.dtype}")
    if weights.dtype not in _LANES_ENTRY:
        raise TypeError(f"mule_agg: weights must be float32 or bfloat16, "
                        f"got {weights.dtype}")
    if assign.device != weights.device:
        raise ValueError(f"mule_agg: assign on {assign.device}, weights on "
                         f"{weights.device}")


def mule_agg(assign: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """assign [F, M] f32 x weights [M, D] f32|bf16 -> [F, D] in weights' dtype.

    On a CUDA tensor: ``mule_agg_lanes`` of one lane (the same kernel)."""
    _check(assign, weights)
    if weights.device.type == "cpu":
        return mule_agg_plain(assign, weights)
    return mule_agg_lanes(assign[None], weights[None])[0]


mule_agg.launches = 0


def mule_agg_lanes(assign: torch.Tensor, weights: torch.Tensor
                   ) -> torch.Tensor:
    """assign [S, F, M] f32 x weights [S, M, D] f32|bf16 -> [S, F, D] in
    weights' dtype: lane s is ``mule_agg(assign[s], weights[s])``, all S
    lanes in one launch."""
    _check(assign, weights, lanes=1)
    if weights.device.type == "cpu":
        return mule_agg_lanes_plain(assign, weights)
    if weights.device.type != "cuda":
        raise ValueError(f"mule_agg runs on cuda or cpu, not {weights.device}")
    s, f, m = assign.shape
    d = weights.shape[2]
    if s > MAX_LANES:
        raise ValueError(f"mule_agg_lanes: S={s} lanes exceed the grid's "
                         f"bound of {MAX_LANES}")
    if not (assign.is_contiguous() and weights.is_contiguous()):
        raise ValueError("mule_agg: assign and weights must be contiguous")
    out = torch.empty((s, f, d), dtype=weights.dtype, device=weights.device)
    if s == 0 or f == 0 or d == 0:
        return out
    if m == 0:
        return out.zero_()
    fn = getattr(_build.load("mule_agg"), _LANES_ENTRY[weights.dtype])
    fn.argtypes = _LANES_ARGTYPES
    fn.restype = ctypes.c_int
    with torch.cuda.device(weights.device):
        stream = torch.cuda.current_stream(weights.device).cuda_stream
        err = fn(assign.data_ptr(), weights.data_ptr(), out.data_ptr(),
                 s, f, m, d, stream)
    if err != 0:
        raise RuntimeError(f"mule_agg_lanes kernel launch failed: CUDA error "
                           f"{err} (S={s}, F={f}, M={m}, D={d}, "
                           f"{weights.dtype})")
    mule_agg.launches += 1
    return out


def lanes_first(x: torch.Tensor, dim, n: int) -> torch.Tensor:
    """A vmap rule's argument with its lane axis first and contiguous: the
    batched axis ``dim`` moved to 0, or ``n`` lanes of an unbatched one."""
    x = x.movedim(dim, 0) if dim is not None else x.expand((n,) + x.shape)
    return x.contiguous()


@torch.library.custom_op("repro_torch::mule_agg", mutates_args=())
def mule_agg_op(assign: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """``mule_agg`` as a custom op, visible to ``torch.func.vmap``."""
    return mule_agg(assign, weights)


@mule_agg_op.register_fake
def _(assign, weights):
    return weights.new_empty((assign.shape[0], weights.shape[1]))


@mule_agg_op.register_vmap
def _(info, in_dims, assign, weights):
    n = info.batch_size
    return mule_agg_lanes(lanes_first(assign, in_dims[0], n),
                          lanes_first(weights, in_dims[1], n)), 0
