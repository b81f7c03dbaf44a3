"""Wrapper of the ``flash_attention`` kernels: checks, route, launch counts.

``flash_attention(q, k, v, causal=..., window=..., scale=...)`` computes
``softmax(scale * q kᵀ + mask) v`` for q [B, S, H, D] and k, v
[B, Sk, KV, D] and returns [B, S, H, D] in q's dtype (f32 or bf16). With
``backend="auto"`` a CUDA tensor goes to one of two hand-written kernels,
picked by ``tc_route`` from the dtype, the head dim and the layout, never by
failure:

- bf16 with D in ``TC_HEAD_DIMS`` (64, 80, 128, 256): the tensor-core kernel
  (``csrc/flash_attention_tc.cu``: TMA loads, wgmma, p split into bf16 hi +
  lo). Its loads need 16-byte-aligned bases and strides that are multiples
  of 16 bytes; a call that breaks this raises before the launch.
- float32 (every D) and bf16 at D = 8, 16, 32: the SIMT kernel
  (``csrc/flash_attention.cu``, fp32 FMAs on the CUDA cores).

On a CPU tensor it takes the plain chunked version (``ref.flash_reference``),
with blocks of 256 as the reference's ``"ref"`` backend uses.
``backend="ref"`` asks for that plain version on any device. A causal call
with S > Sk raises: its first S - Sk queries would see no key.
``flash_attention.launches`` counts kernel launches of both routes;
``flash_attention.tc_launches`` counts those of the tensor-core kernel.

``flash_attention`` is a ``torch.autograd.Function`` (``_FlashAttention``):
its forward is the route above (the kernel on a CUDA tensor), its backward
the reference's custom VJP (``ref.flash_backward``: the per-row statistics
recomputed by the plain forward, then the two blockwise float32 passes,
with the plain version's blocks of 256) on either route; the reference has
no backward kernel. Its ``torch.func.vmap`` rule folds the lanes into B, so
a vmapped population launches the kernel once.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import (flash_backward,
                                                     flash_reference)
from repro_torch.kernels.mule_agg.ops import lanes_first

HEAD_DIMS = (8, 16, 32, 64, 80, 128, 256)   # the head dims of both routes
TC_HEAD_DIMS = (64, 80, 128, 256)           # the tensor-core kernel's
TC_ALIGN = 16        # bytes: TMA's base and stride alignment
REF_BLOCK = 256      # the reference's "ref" backend raises blocks to >= 256

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
    ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, ctypes.c_int,
    ctypes.c_int, ctypes.c_void_p]
_ENTRY = {torch.float32: "flash_attention_f32",
          torch.bfloat16: "flash_attention_bf16"}
_TC_ENTRY = "flash_attention_bf16_tc"


def tc_route(dtype: torch.dtype, d: int, ptrs, strides) -> bool:
    """Whether a CUDA call takes the tensor-core kernel: bf16 with ``d`` in
    ``TC_HEAD_DIMS``. ``ptrs`` are the data pointers of q, k, v (bytes) and
    ``strides`` their (b, s, h) strides (elements). Raises ValueError where
    that kernel is due but a base or a stride is not a multiple of 16
    bytes: the call does not go quietly to the SIMT kernel instead."""
    if dtype != torch.bfloat16 or d not in TC_HEAD_DIMS:
        return False
    bad = [f"base {p} B" for p in ptrs if p % TC_ALIGN] + [
        f"stride {st} x 2 B" for st in strides if (st * 2) % TC_ALIGN]
    if bad:
        raise ValueError(
            f"flash_attention: the tensor-core kernel (bf16, head_dim {d}) "
            f"reads q, k, v with TMA, which needs {TC_ALIGN}-byte-aligned "
            f"bases and (b, s, h) strides that are multiples of {TC_ALIGN} "
            f"bytes; got {', '.join(bad)} (make the tensors contiguous)")
    return True


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           causal: bool, window: Optional[int]) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention wants q [B,S,H,D] and k, v "
                         f"[B,Sk,KV,D], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, _, h, d = q.shape
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} does not "
                         f"match q {tuple(q.shape)} in B or D")
    if k.shape[2] == 0 or h % k.shape[2]:
        raise ValueError(f"flash_attention: H={h} is not a multiple of "
                         f"KV={k.shape[2]}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {d} is not one of "
                         f"{HEAD_DIMS}")
    if q.dtype not in _ENTRY or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: q, k, v must all be float32 or "
                        f"all bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"flash_attention: q on {q.device}, k on "
                         f"{k.device}, v on {v.device}")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window must be >= 1, got "
                         f"{window}")
    if causal and q.shape[1] > k.shape[1]:
        # right-aligned, the first S - Sk queries would see no key at all
        raise ValueError(f"flash_attention: a causal call needs S <= Sk, "
                         f"got S={q.shape[1]}, Sk={k.shape[1]}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None,
                    backend: str = "auto") -> torch.Tensor:
    """q [B,S,H,D], k/v [B,Sk,KV,D] -> [B,S,H,D]; queries right-aligned.
    Differentiable (the reference's blockwise backward) and vmappable."""
    return _FlashAttention.apply(q, k, v, causal, window, scale, backend)


flash_attention.launches = 0
flash_attention.tc_launches = 0


def _flash_forward(q, k, v, causal: bool, window: Optional[int],
                   scale: Optional[float], backend: str) -> torch.Tensor:
    """The forward of ``flash_attention``: the plain version or a kernel."""
    _check(q, k, v, causal, window)
    if backend not in ("auto", "ref"):
        raise ValueError(f"unknown backend {backend!r}")
    if backend == "ref" or q.device.type == "cpu":
        return flash_reference(q, k, v, causal=causal, window=window,
                               block_q=REF_BLOCK, block_k=REF_BLOCK,
                               scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not "
                         f"{q.device}")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("flash_attention: the head_dim of q, k and v must "
                         "be contiguous")
    b, s, h, d = q.shape
    sk, n_kv = k.shape[1], k.shape[2]
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    if b == 0 or s == 0 or h == 0:
        return out
    if sk == 0:
        raise ValueError("flash_attention: no keys (Sk = 0)")
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    st = (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3])
    tc = tc_route(q.dtype, d, (q.data_ptr(), k.data_ptr(), v.data_ptr()), st)
    strides = (ctypes.c_longlong * 9)(*st)
    fn = (getattr(_build.load("flash_attention_tc"), _TC_ENTRY) if tc else
          getattr(_build.load("flash_attention"), _ENTRY[q.dtype]))
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 b, s, sk, h, n_kv, d, strides, ctypes.c_float(scale),
                 int(causal), -1 if window is None else int(window), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention {'tensor-core' if tc else 'SIMT'}"
                           f" kernel launch failed: error {err} (q "
                           f"{tuple(q.shape)}, k {tuple(k.shape)}, {q.dtype})")
    flash_attention.launches += 1
    if tc:
        flash_attention.tc_launches += 1
    return out


class _FlashAttention(torch.autograd.Function):
    """``flash_attention``: the kernel's forward, the reference's blockwise
    backward, lanes folded into B under vmap."""

    @staticmethod
    def forward(q, k, v, causal, window, scale, backend):
        return _flash_forward(q, k, v, causal, window, scale, backend)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs[:3])
        ctx.cfg = inputs[3:6]

    @staticmethod
    def backward(ctx, dout):
        causal, window, scale = ctx.cfg
        grads = flash_backward(*ctx.saved_tensors, dout, causal=causal,
                               window=window, block_q=REF_BLOCK,
                               block_k=REF_BLOCK, scale=scale)
        return grads + (None,) * 4

    @staticmethod
    def vmap(info, in_dims, q, k, v, causal, window, scale, backend):
        n = info.batch_size
        q, k, v = (lanes_first(t, d, n) for t, d in zip((q, k, v), in_dims))
        b = q.shape[1]
        out = _FlashAttention.apply(
            *(t.reshape((n * b,) + t.shape[2:]) for t in (q, k, v)),
            causal, window, scale, backend)
        return out.reshape((n, b) + out.shape[1:]), 0

