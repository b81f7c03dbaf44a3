"""Wrapper of the ``slstm_scan`` kernel: checks, dispatch, launch count.

``slstm_scan(pre, r)`` runs the sequential sLSTM recurrence over
``pre [B, S, 4, H, P]`` (gate pre-activations z, i, f, o) with the
head-wise recurrent weights ``r [4, H, P, P]``, both float32, and returns
``h [B, S, H, P]``. With ``backend="auto"`` a CUDA tensor launches the
hand-written kernel (``csrc/slstm_scan.cu``), which starts from the zero
state as the TPU kernel does: it raises for a ``state``. A CPU tensor takes
the plain version (``ref.slstm_reference``), which also takes a ``state``
to continue from; ``backend="ref"`` asks for that plain version on any
device. ``slstm_scan.launches`` counts kernel launches.

The kernel keeps a cluster's slice of ``r`` in shared memory, so it takes
P up to 256 (xlstm-350m: P 256); larger P and other dtypes raise on every
route.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.slstm_fused.ref import slstm_reference

MAX_P = 256         # the largest head width the kernel's shared memory takes

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [
    ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p]
_FITS: Dict[tuple, int] = {}     # (device index, P) -> co-resident clusters


def _check(pre: torch.Tensor, r: torch.Tensor) -> None:
    if pre.dim() != 5 or pre.shape[2] != 4 or r.dim() != 4:
        raise ValueError(f"slstm_scan wants pre [B,S,4,H,P] and r [4,H,P,P], "
                         f"got {tuple(pre.shape)} and {tuple(r.shape)}")
    b, s, _, h, p = pre.shape
    if tuple(r.shape) != (4, h, p, p):
        raise ValueError(f"slstm_scan: r {tuple(r.shape)} does not match pre "
                         f"{tuple(pre.shape)}: want {(4, h, p, p)}")
    if min(b, s, h) < 1 or not 1 <= p <= MAX_P:
        raise ValueError(f"slstm_scan: B={b}, S={s} and H={h} must be at "
                         f"least 1 and P={p} must lie in [1, {MAX_P}]")
    if pre.dtype != torch.float32 or r.dtype != torch.float32:
        raise TypeError(f"slstm_scan: pre and r must be float32, got "
                        f"{pre.dtype} and {r.dtype}")
    if pre.device != r.device:
        raise ValueError(f"slstm_scan: pre on {pre.device}, r on {r.device}")


def _clusters_fit(lib, p: int, device: torch.device) -> int:
    """How many of the kernel's 8-CTA clusters the card holds at once."""
    key = (device.index, p)
    if key not in _FITS:
        n = ctypes.c_int(0)
        fn = lib.slstm_scan_max_clusters
        fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
        err = fn(p, ctypes.byref(n))
        if err != 0:
            raise RuntimeError(f"slstm_scan: the occupancy query failed: "
                               f"CUDA error {err}")
        _FITS[key] = n.value
    return _FITS[key]


def slstm_scan(pre: torch.Tensor, r: torch.Tensor, *,
               state: Optional[Dict[str, torch.Tensor]] = None,
               backend: str = "auto") -> torch.Tensor:
    """pre [B,S,4,H,P]; r [4,H,P,P] -> h [B,S,H,P] (float32)."""
    _check(pre, r)
    if backend not in ("auto", "ref"):
        raise ValueError(f"unknown backend {backend!r}")
    if backend == "ref" or pre.device.type == "cpu":
        return slstm_reference(pre, r, state)[0]
    if state is not None:
        raise ValueError("slstm_scan: the kernel starts from the zero state "
                         "and takes no state (the plain version does: "
                         "backend='ref')")
    if pre.device.type != "cuda":
        raise ValueError(f"slstm_scan runs on cuda or cpu, not {pre.device}")
    b, s, _, h, p = pre.shape
    lib = _build.load("slstm_scan")
    with torch.cuda.device(pre.device):
        if _clusters_fit(lib, p, pre.device) < 1:
            raise RuntimeError(f"slstm_scan: no cluster of 8 blocks at P={p} "
                               f"fits this card at once")
        out = torch.empty((b, s, h, p), dtype=torch.float32,
                          device=pre.device)
        strides = (ctypes.c_longlong * 9)(*pre.stride(), *r.stride())
        fn = lib.slstm_scan_f32
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        stream = torch.cuda.current_stream(pre.device).cuda_stream
        err = fn(pre.data_ptr(), r.data_ptr(), out.data_ptr(), b, s, h, p,
                 strides, stream)
    if err != 0:
        raise RuntimeError(f"slstm_scan kernel launch failed: CUDA error "
                           f"{err} (pre {tuple(pre.shape)})")
    slstm_scan.launches += 1
    return out


slstm_scan.launches = 0
