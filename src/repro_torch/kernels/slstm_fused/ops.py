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

The kernel keeps a cluster's slice of ``r`` in registers, so it takes P up
to 256 (xlstm-350m: P 256); larger P and other dtypes raise on every
route. One cluster of ``CLUSTER`` blocks runs each head for a group of up
to ``MAX_ROWS`` batch rows (``slstm_geometry``); a cluster that the card
cannot hold raises. ``slstm_step_floor`` times the kernel's h exchange
alone (no products, no cell) and launches nothing that ``launches`` counts.

``slstm_scan_op(pre, r, backend)`` is the scan from the zero state as a
``torch.autograd.Function``: its forward is ``slstm_scan``'s route (the
kernel on a CUDA tensor under ``"auto"``), its backward the
vector-Jacobian product of the plain version (``ref.slstm_reference``)
re-run on the saved inputs, the code the reference's training
differentiates (neither has a backward kernel); its ``torch.func.vmap``
rule folds the lanes into the heads (each head is its own recurrence with
its own r), so a vmapped population launches the kernel once, with each
lane's bits.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.mule_agg.ops import lanes_first
from repro_torch.kernels.slstm_fused.ref import slstm_reference

MAX_P = 256         # the largest head width the kernel's registers take
MAX_ROWS = 4        # batch rows one cluster takes
CLUSTER = 16        # blocks a cluster (the kernel's kC; PERF.md)
FLOOR_MODES = {"mbarrier": 1, "cluster": 2}

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [
    ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p]
_FITS: Dict[tuple, int] = {}     # (device index, rows, P) -> clusters


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def slstm_geometry(b: int, h: int, p: int) -> dict:
    """The kernel's grid, as ``csrc/slstm_scan.cu`` lays it out.

    The batch rows split into ``groups`` of at most ``MAX_ROWS``, each of
    ``rows`` rows but the last (``row_groups``); cluster ``k`` runs head
    ``k % h`` for row group ``k // h``. Block ``j`` of a cluster owns the
    head columns ``columns[j]`` (``per`` of them, a multiple of 4, or fewer
    at the edge; none past P).
    """
    groups = _ceil_div(b, MAX_ROWS)
    rows = _ceil_div(b, groups)
    per = _ceil_div(_ceil_div(p, CLUSTER), 4) * 4
    return {
        "rows": rows, "groups": groups,
        "clusters": h * groups,
        "row_groups": [(g * rows, min(b, (g + 1) * rows))
                       for g in range(groups)],
        "per": per,
        "columns": [(min(p, j * per), min(p, (j + 1) * per))
                    for j in range(CLUSTER)],
    }


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


def _require_fit(lib, b: int, p: int, device: torch.device) -> None:
    """Raises unless one of the kernel's clusters fits the card."""
    key = (device.index, slstm_geometry(b, 1, p)["rows"], p)
    if key not in _FITS:
        n = ctypes.c_int(0)
        fn = lib.slstm_scan_max_clusters
        fn.argtypes = [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
        err = fn(b, p, ctypes.byref(n))
        if err != 0:
            raise RuntimeError(f"slstm_scan: the occupancy query failed: "
                               f"CUDA error {err}")
        _FITS[key] = n.value
    if _FITS[key] < 1:
        raise RuntimeError(f"slstm_scan: no cluster of {CLUSTER} blocks at "
                           f"P={p} fits this card at once")


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
        _require_fit(lib, b, p, pre.device)
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


def slstm_step_floor(b: int, s: int, h: int, p: int, *, sync: str,
                     device="cuda") -> torch.Tensor:
    """S steps of the kernel's h exchange alone, at its grid for
    ``[b, s, 4, h, p]``: each owner sends h + 1 to every block of its
    cluster, through st.async and the mbarriers (``sync="mbarrier"``, the
    kernel's) or DSMEM stores and a cluster barrier a step
    (``sync="cluster"``, the previous design's). Returns the h buffer, whose
    step ``s - 1`` holds ``s`` everywhere; for timing the floor of a step."""
    if sync not in FLOOR_MODES:
        raise ValueError(f"slstm_step_floor: sync {sync!r} must be one of "
                         f"{sorted(FLOOR_MODES)}")
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"slstm_step_floor runs on cuda, not {device}")
    lib = _build.load("slstm_scan")
    with torch.cuda.device(device):
        _require_fit(lib, b, p, device)
        out = torch.zeros((b, s, h, p), dtype=torch.float32, device=device)
        fn = lib.slstm_step_floor_f32
        fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(out.data_ptr(), b, s, h, p, FLOOR_MODES[sync], stream)
    if err != 0:
        raise RuntimeError(f"slstm_step_floor failed: CUDA error {err}")
    return out


class _SLSTMScan(torch.autograd.Function):
    """``slstm_scan`` from the zero state, differentiable and vmappable
    (``slstm_scan_op``)."""

    @staticmethod
    def forward(pre, r, backend):
        return slstm_scan(pre, r, backend=backend)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[0], inputs[1])

    @staticmethod
    def backward(ctx, dh):
        _, vjp = torch.func.vjp(lambda pre, r: slstm_reference(pre, r)[0],
                                *ctx.saved_tensors)
        return vjp(dh) + (None,)

    @staticmethod
    def vmap(info, in_dims, pre, r, backend):
        n = info.batch_size
        pre = lanes_first(pre, in_dims[0], n)       # [L, B, S, 4, H, P]
        r = lanes_first(r, in_dims[1], n)           # [L, 4, H, P, P]
        _, b, s, g, h, p = pre.shape
        pre = pre.permute(1, 2, 3, 0, 4, 5).reshape(b, s, g, n * h, p)
        r = r.permute(1, 0, 2, 3, 4).reshape(g, n * h, p, p)
        out = _SLSTMScan.apply(pre, r, backend)     # [B, S, L * H, P]
        return out.reshape(b, s, n, h, p).permute(2, 0, 1, 3, 4), 0


def slstm_scan_op(pre: torch.Tensor, r: torch.Tensor,
                  backend: str = "auto") -> torch.Tensor:
    """h [B, S, H, P] of the scan from the zero state, with an autograd rule
    (the plain version's VJP) and a vmap rule (lanes folded into heads)."""
    return _SLSTMScan.apply(pre, r, backend)
