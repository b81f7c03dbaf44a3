"""Optimizers on dicts of tensors: SGD (momentum, Nesterov), Adam, AdamW,
and the schedules and clipping the training loop uses.

Port of ``repro.optim.optimizers``, with its ``(init, update)`` pair:

    opt = sgd(lr=0.1, momentum=0.9)
    state = opt.init(params)
    params, state = opt.update(params, grads, state)

``params`` and ``grads`` are nested dicts and lists of tensors (a model's
parameter tree); the state is an explicit dict holding the step count (an
int32 tensor, as the reference's) and the moment trees. ``lr`` is a float
or a schedule ``step -> float32 tensor``. The updates are the reference's
formulas, not ``torch.optim``'s: Adam keeps ``eps`` outside the square root
of the bias-corrected second moment, ``p - lr * m̂ / (sqrt(v̂) + eps)``,
with the bias corrections in float32 and weight decay added to the step
(``adamw``). Every update returns new tensors; nothing is changed in place.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Union

import torch

from repro_torch.interop import tree_leaves, tree_map

Schedule = Callable[[torch.Tensor], torch.Tensor]
LR = Union[float, Schedule]


def _lr_at(lr: LR, step: torch.Tensor) -> torch.Tensor:
    return lr(step) if callable(lr) else torch.tensor(
        lr, dtype=torch.float32, device=step.device)


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    """A float32 scalar tensor: a divisor kept as a tensor, so no kernel
    multiplies by its reciprocal instead of dividing."""
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def _zeros_like(params: Any) -> Any:
    return tree_map(torch.zeros_like, params)


def _first_leaf(params: Any) -> torch.Tensor:
    return tree_leaves(params)[0]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], tuple]


def _step0(params: Any) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32,
                       device=_first_leaf(params).device)


def sgd(lr: LR = 0.01, momentum: float = 0.0,
        nesterov: bool = False) -> Optimizer:
    def init(params):
        state = {"step": _step0(params)}
        if momentum:
            state["mu"] = _zeros_like(params)
        return state

    def update(params, grads, state):
        step = state["step"] + 1
        lr_t = _lr_at(lr, step)
        if momentum:
            mu = tree_map(lambda m, g: momentum * m + g, state["mu"], grads)
            upd = (tree_map(lambda m, g: momentum * m + g, mu, grads)
                   if nesterov else mu)
            new_state = {"step": step, "mu": mu}
        else:
            upd = grads
            new_state = {"step": step}
        params = tree_map(lambda p, u: p - lr_t * u.to(p.dtype), params, upd)
        return params, new_state

    return Optimizer(init, update)


def adam(lr: LR = 1e-3, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8, weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        return {"step": _step0(params), "m": _zeros_like(params),
                "v": _zeros_like(params)}

    def update(params, grads, state):
        step = state["step"] + 1
        lr_t = _lr_at(lr, step)
        m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g, state["m"], grads)
        v = tree_map(lambda v_, g: b2 * v_ + (1 - b2) * g * g, state["v"],
                     grads)
        stepf = step.to(torch.float32)
        bc1 = 1 - _f32(b1, stepf) ** stepf
        bc2 = 1 - _f32(b2, stepf) ** stepf

        def upd(p, m_, v_):
            u = (m_ / bc1) / (torch.sqrt(v_ / bc2) + eps)
            if weight_decay:
                u = u + weight_decay * p
            return p - lr_t * u.to(p.dtype)

        return tree_map(upd, params, m, v), {"step": step, "m": m, "v": v}

    return Optimizer(init, update)


def adamw(lr: LR = 1e-3, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 0.01) -> Optimizer:
    return adam(lr, b1, b2, eps, weight_decay)


# ---------------------------------------------------------------------------
# schedules / utilities
# ---------------------------------------------------------------------------


def _warm_and_progress(step, warmup: int, total_steps: int):
    step = step.to(torch.float32)
    warm = torch.clamp(step / _f32(max(warmup, 1), step), max=1.0)
    prog = torch.clamp((step - warmup) / _f32(max(total_steps - warmup, 1),
                                              step), 0.0, 1.0)
    return warm, prog


def cosine_schedule(base_lr: float, total_steps: int, warmup: int = 0,
                    final_frac: float = 0.0) -> Schedule:
    def fn(step):
        warm, prog = _warm_and_progress(step, warmup, total_steps)
        cos = 0.5 * (1 + torch.cos(math.pi * prog))
        return base_lr * warm * (final_frac + (1 - final_frac) * cos)

    return fn


def linear_schedule(base_lr: float, total_steps: int,
                    warmup: int = 0) -> Schedule:
    def fn(step):
        warm, prog = _warm_and_progress(step, warmup, total_steps)
        return base_lr * warm * (1 - prog)

    return fn


def clip_by_global_norm(grads: Any, max_norm: float):
    """(grads scaled to a global L2 norm of at most ``max_norm``, the norm);
    the squares summed leaf by leaf in the reference's leaf order."""
    leaves = tree_leaves(grads)
    total = torch.sum(torch.square(leaves[0].float()))
    for g in leaves[1:]:
        total = total + torch.sum(torch.square(g.float()))
    norm = torch.sqrt(total)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: (g * scale).to(g.dtype), grads), norm
