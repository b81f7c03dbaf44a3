"""Rematerialisation: a layer whose backward recomputes its forward.

The counterpart of ``jax.checkpoint`` around each layer of
``repro.models.api`` (``Model.remat``). ``torch.utils.checkpoint`` does not
run under ``torch.func.grad``, which the train step differentiates with
(``use_reentrant=False`` needs saved-tensor hooks, which ``torch.func``
does not support; ``use_reentrant=True`` is an ``autograd.Function``
without ``setup_context``), so the port has its own ``autograd.Function``:

- **forward** runs the layer and keeps only its inputs (the layer's input
  and its weights); the graph it builds is dropped with it. It runs with
  gradients on, as the train step's forward does, so every op takes the
  same route (``matmul`` folds a batched operand into ``mm`` only where
  it tracks a gradient);
- **backward** runs the layer again under ``torch.func.grad`` and pulls
  the cotangents through it. Its results are detached, so the recomputed
  graph is freed layer by layer (no double backward through a
  rematerialised layer).

``policy="dots"`` (``jax.checkpoint_policies.dots_with_no_batch_dims_
saveable``) also keeps the outputs of the products with no batch
dimension, ``aten.mm`` and ``aten.addmm`` (every ``x @ w``), and of the
ordered sums over ranks (``repro_torch::ordered_psum``: tensor
parallelism's ``reduce_from_peers``, the MoE aux loss's mean), and the
recomputation takes them in the order the forward made them in place of
computing them again, so it moves nothing between ranks (skipping the
tensor-parallel all-reduces is the reference's stated purpose for
"dots"); batched products (``bmm``: the experts, attention), the flash
kernel's output and the other transfers (the experts' ``all_to_all`` and
``all_gather``) are recomputed. Under ``policy="full"`` the recomputation
runs every collective of the layer again; every rank recomputes in the
same order, so they stay matched.

The recomputation runs the same ops on the same inputs, so a gradient with
``remat`` is bitwise the gradient without it.
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_unflatten

from repro_torch.core.distributed import ordered_psum_op

POLICIES = ("full", "dots")
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
         ordered_psum_op._opoverload)


class _Box:
    """The saved products of one layer (a plain object, so that
    ``torch.func`` passes it through as it is)."""

    def __init__(self):
        self.saved = []


class _SaveDots(TorchDispatchMode):
    def __init__(self, box: _Box):
        super().__init__()
        self.box = box

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func in _DOTS:
            self.box.saved.append(out.detach())
        return out


class _ReplayDots(TorchDispatchMode):
    def __init__(self, box: _Box):
        super().__init__()
        self.saved = iter(box.saved)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in _DOTS:
            return next(self.saved).detach()
        return func(*args, **(kwargs or {}))


class _Checkpoint(torch.autograd.Function):
    @staticmethod
    def forward(run, box, *args):
        with torch.enable_grad():
            inputs = [a.detach().requires_grad_() for a in args]
            with _SaveDots(box) if box is not None else \
                    contextlib.nullcontext():
                outs = run(*inputs)
        return tuple(o.detach() for o in outs)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.run, ctx.box = inputs[0], inputs[1]
        ctx.save_for_backward(*inputs[2:])

    @staticmethod
    def backward(ctx, *grads):
        # the cotangents pulled inside one torch.func.grad call (of the
        # outputs' dot product with them, whose gradient at each output is
        # its cotangent exactly), so that a backward inside the layer that
        # opens a transform of its own (the SSD scan's) runs while this
        # level is still open
        def dot(*args):
            with _ReplayDots(ctx.box) if ctx.box is not None else \
                    contextlib.nullcontext():
                outs = ctx.run(*args)
            return sum((o * g).sum() for o, g in zip(outs, grads))

        saved = ctx.saved_tensors
        back = torch.func.grad(dot, argnums=tuple(range(len(saved))))(*saved)
        return (None, None) + tuple(g.detach() for g in back)


def checkpoint(fn: Callable, x: torch.Tensor, *trees: Any,
               policy: str = "full"
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``fn(x, *trees) -> (y, aux or None)`` with its intermediates
    recomputed in the backward (``policy`` "full" or "dots"). ``trees``
    are the layer's weights (nested dicts and lists of tensors, or
    ``None``); ``fn`` closes over everything else."""
    if policy not in POLICIES:
        raise ValueError(f"unknown remat policy {policy!r}: one of "
                         f"{POLICIES}")
    leaves, spec = tree_flatten(trees)
    at = [i for i, leaf in enumerate(leaves)
          if isinstance(leaf, torch.Tensor)]

    def run(x, *tensors):
        full = list(leaves)
        for i, t in zip(at, tensors):
            full[i] = t
        y, aux = fn(x, *tree_unflatten(full, spec))
        return (y,) if aux is None else (y, aux)

    outs = _Checkpoint.apply(run, _Box() if policy == "dots" else None, x,
                             *(leaves[i] for i in at))
    return outs[0], (outs[1] if len(outs) > 1 else None)
