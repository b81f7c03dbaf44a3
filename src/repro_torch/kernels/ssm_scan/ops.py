"""Wrapper of the ``ssd_scan`` kernel: checks, dispatch, launch count.

``ssd_scan(x, dt, A, Bmat, Cmat, chunk=..., init_state=...)`` runs the
chunked Mamba2/SSD scan of x [B, S, H, P] with dt [B, S, H], A [H] (or
[B, H], one A per batch row) and B, C [B, S, N], all float32, and returns
``(y [B, S, H, P], final_state)``.
With ``backend="auto"`` a CUDA tensor launches the hand-written kernel
(``csrc/ssd_scan.cu``), which is prefill-only as the TPU kernel is: it
raises for an ``init_state`` and returns ``final_state`` None. A CPU tensor
takes the plain chunked version (``ref.ssd_chunked_reference``), which
takes an ``init_state`` and returns the final state [B, H, P, N];
``backend="ref"`` asks for that plain version on any device.
``ssd_scan.launches`` counts calls that reach the kernel: each launches two
CUDA kernels, a per-chunk preparation and the scan (``csrc/ssd_scan.cu``),
into scratch the wrapper allocates (``ssd_geometry``).

The kernel takes P and N up to 64 and a chunk of 1 to 64 steps (zamba2:
P 64, N 64, chunk 64); other sizes and other dtypes raise on every route.

``ssd_scan_op(x, dt, A, Bmat, Cmat, chunk, backend)`` is the scan from the
zero state as a ``torch.autograd.Function`` (``y`` only): its forward is
``ssd_scan``'s route (the kernel on a CUDA tensor under ``"auto"``), its
backward the vector-Jacobian product of the plain chunked version
(``ref.ssd_chunked_reference``) re-run on the saved inputs, the code the
reference's training differentiates (neither has a backward kernel); its
``torch.func.vmap`` rule folds the lanes into B, each lane's A a row of
A [L * B, H], so a vmapped population launches the kernel once.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.mule_agg.ops import lanes_first
from repro_torch.kernels.ssm_scan.ref import ssd_chunked_reference

MAX_DIM = 64        # the largest P, N and chunk the kernel takes
SLICE = 32          # state columns a scan block takes (the kernel's kPW)

# x, dt, A, A's row stride, B, C, y, tiles, vecs, B, S, H, P, N, chunk,
# strides, stream
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [
    ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
    ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p]


def ssd_geometry(b: int, s: int, h: int, p: int, chunk: int) -> dict:
    """The kernel's grids and scratch, as ``csrc/ssd_scan.cu`` lays them out.

    The preparation runs one block per (chunk, batch row) and writes
    ``tiles`` (G transposed, C transposed and B, 64 x 64 each, per row and
    chunk) and ``vecs`` (dt, cum, exp(cum) and exp(last - cum), 64 each,
    per row, chunk and head). The scan runs one block per (b, h, slice):
    block ``k`` takes row ``k // (h slices)``, head ``(k // slices) % h``
    and the state columns ``columns[k % slices]``.
    """
    n_chunks = -(-s // chunk)
    slices = -(-p // SLICE)
    return {
        "n_chunks": n_chunks, "slices": slices,
        "tiles": (b, n_chunks, 3, MAX_DIM, MAX_DIM),
        "vecs": (b, n_chunks, h, 4, MAX_DIM),
        "prep_grid": (n_chunks, b), "grid": b * h * slices,
        "threads": 4 * SLICE,
        "columns": [(k * SLICE, min(p, (k + 1) * SLICE))
                    for k in range(slices)],
    }


def _check(x, dt, A, Bmat, Cmat, chunk: int) -> None:
    if x.dim() != 4 or dt.dim() != 3 or A.dim() not in (1, 2) \
            or Bmat.dim() != 3 or Cmat.shape != Bmat.shape:
        raise ValueError(f"ssd_scan wants x [B,S,H,P], dt [B,S,H], A [H] "
                         f"(or [B,H]) and "
                         f"B, C [B,S,N], got {tuple(x.shape)}, "
                         f"{tuple(dt.shape)}, {tuple(A.shape)}, "
                         f"{tuple(Bmat.shape)}, {tuple(Cmat.shape)}")
    b, s, h, p = x.shape
    if tuple(dt.shape) != (b, s, h) or tuple(A.shape) not in ((h,), (b, h)) \
            or tuple(Bmat.shape[:2]) != (b, s):
        raise ValueError(f"ssd_scan: dt {tuple(dt.shape)}, A "
                         f"{tuple(A.shape)} or B {tuple(Bmat.shape)} do not "
                         f"match x {tuple(x.shape)}")
    n = Bmat.shape[2]
    if not (1 <= p <= MAX_DIM and 1 <= n <= MAX_DIM):
        raise ValueError(f"ssd_scan: P={p} and N={n} must lie in "
                         f"[1, {MAX_DIM}]")
    if not 1 <= chunk <= MAX_DIM:
        raise ValueError(f"ssd_scan: chunk {chunk} must lie in "
                         f"[1, {MAX_DIM}]")
    ts = (x, dt, A, Bmat, Cmat)
    if any(t.dtype != torch.float32 for t in ts):
        raise TypeError(f"ssd_scan: x, dt, A, B and C must be float32, got "
                        f"{[str(t.dtype) for t in ts]}")
    if any(t.device != x.device for t in ts):
        raise ValueError(f"ssd_scan: inputs on {[str(t.device) for t in ts]}")


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bmat: torch.Tensor, Cmat: torch.Tensor, *, chunk: int = 64,
             init_state: Optional[torch.Tensor] = None,
             backend: str = "auto"):
    """x [B,S,H,P]; dt [B,S,H]; A [H]; Bmat/Cmat [B,S,N] -> (y, final_state)."""
    _check(x, dt, A, Bmat, Cmat, chunk)
    if backend not in ("auto", "ref"):
        raise ValueError(f"unknown backend {backend!r}")
    if backend == "ref" or x.device.type == "cpu":
        return ssd_chunked_reference(x, dt, A, Bmat, Cmat, chunk=chunk,
                                     init_state=init_state)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan runs on cuda or cpu, not {x.device}")
    if init_state is not None:
        raise ValueError("ssd_scan: the kernel is prefill-from-scratch and "
                         "takes no init_state (the plain version does: "
                         "backend='ref')")
    b, s, h, p = x.shape
    geo = ssd_geometry(b, s, h, p, chunk)
    y = torch.empty((b, s, h, p), dtype=torch.float32, device=x.device)
    tiles = torch.empty(geo["tiles"], dtype=torch.float32, device=x.device)
    vecs = torch.empty(geo["vecs"], dtype=torch.float32, device=x.device)
    A = A.contiguous()
    strides = (ctypes.c_longlong * 13)(*x.stride(), *dt.stride(),
                                       *Bmat.stride(), *Cmat.stride())
    lib = _build.load("ssd_scan")
    fn = lib.ssd_scan_f32
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    a_rs = h if A.dim() == 2 else 0
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), a_rs,
                 Bmat.data_ptr(), Cmat.data_ptr(), y.data_ptr(),
                 tiles.data_ptr(), vecs.data_ptr(), b, s, h, p,
                 Bmat.shape[2], chunk, strides, stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: CUDA error {err} "
                           f"(x {tuple(x.shape)}, N {Bmat.shape[2]}, chunk "
                           f"{chunk})")
    ssd_scan.launches += 1
    return y, None


ssd_scan.launches = 0


class _SSDScan(torch.autograd.Function):
    """``ssd_scan``'s y from the zero state, differentiable and vmappable
    (``ssd_scan_op``)."""

    @staticmethod
    def forward(x, dt, A, Bmat, Cmat, chunk, backend):
        return ssd_scan(x, dt, A, Bmat, Cmat, chunk=chunk,
                        backend=backend)[0]

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs[:5])
        ctx.chunk = inputs[5]

    @staticmethod
    def backward(ctx, dy):
        def plain(*xs):
            return ssd_chunked_reference(*xs, chunk=ctx.chunk)[0]
        _, vjp = torch.func.vjp(plain, *ctx.saved_tensors)
        return vjp(dy) + (None, None)

    @staticmethod
    def vmap(info, in_dims, x, dt, A, Bmat, Cmat, chunk, backend):
        n = info.batch_size
        lanes = [lanes_first(t, d, n) for t, d in
                 zip((x, dt, A, Bmat, Cmat), in_dims[:5])]
        b = lanes[0].shape[1]
        # A [L, H] (or [L, B, H]) -> one row of A per folded batch row
        a = lanes[2]
        a = (a[:, None] if a.dim() == 2 else a).expand(
            (n, b) + a.shape[-1:])
        folded = [t.reshape((n * b,) + t.shape[2:])
                  for t in (lanes[0], lanes[1], a, lanes[3], lanes[4])]
        y = _SSDScan.apply(*folded, chunk, backend)
        return y.reshape((n, b) + y.shape[1:]), 0


def ssd_scan_op(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bmat: torch.Tensor, Cmat: torch.Tensor, chunk: int = 64,
                backend: str = "auto") -> torch.Tensor:
    """y [B, S, H, P] of the scan from the zero state, with an autograd
    rule (the plain version's VJP) and a vmap rule (lanes folded into B)."""
    return _SSDScan.apply(x, dt, A, Bmat, Cmat, chunk, backend)
