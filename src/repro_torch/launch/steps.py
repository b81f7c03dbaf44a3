"""Step builders: training, prefill and decode.

Port of ``repro.launch.steps``. The reference's jit targets are plain
functions here (PyTorch runs eagerly). The train step differentiates
``Model.loss`` with ``torch.func.grad_and_value``; the kernels' ops carry
their own backward (the plain version's, as the reference has no backward
kernel), so on the card the forward runs the hand-written kernels.
"""
from __future__ import annotations

from typing import Any, Callable, Dict

import torch

from repro_torch.interop import tree_map
from repro_torch.models.api import Model
from repro_torch.optim import Optimizer


def make_train_step(model: Model, optimizer: Optimizer,
                    microbatches: int = 1) -> Callable:
    """``(params, opt_state, batch) -> (params, opt_state, metrics)``.

    With ``microbatches > 1`` each leaf of ``batch`` is cut into that many
    equal slices along axis 0, and the float32 gradients are summed slice
    by slice in order (the reference's ``lax.scan``), then divided by the
    count; ``metrics`` is then ``{"loss": mean of the slices' losses}``.
    """
    grad_fn = torch.func.grad_and_value(model.loss, has_aux=True)

    if microbatches <= 1:
        def train_step(params, opt_state, batch):
            grads, (loss, metrics) = grad_fn(params, batch)
            params, opt_state = optimizer.update(params, grads, opt_state)
            return params, opt_state, {**metrics, "loss": loss}

        return train_step

    def train_step(params, opt_state, batch: Dict[str, Any]):
        def split(leaf):
            b = leaf.shape[0]
            if b % microbatches:
                raise ValueError(f"batch of {b} does not split into "
                                 f"{microbatches} microbatches")
            return leaf.reshape((microbatches, b // microbatches)
                                + leaf.shape[1:])

        micro = tree_map(split, batch)
        gsum = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                              device=p.device), params)
        lsum = None
        for i in range(microbatches):
            grads, (loss, _) = grad_fn(params, tree_map(lambda l: l[i],
                                                        micro))
            gsum = tree_map(lambda a, g: a + g, gsum, grads)
            lsum = loss if lsum is None else lsum + loss
        grads = tree_map(lambda g: (g / microbatches).float(), gsum)
        params, opt_state = optimizer.update(params, grads, opt_state)
        return params, opt_state, {"loss": lsum / microbatches}

    return train_step


def make_prefill_step(model: Model) -> Callable:
    """(params, batch) -> logits [B, S, V]: the full-sequence forward. The
    batch goes to ``forward`` whole (``vision_embed``, ``audio_embed``,
    ``positions`` beside ``tokens``)."""
    @torch.no_grad()
    def prefill(params, batch):
        logits, _ = model.forward(params, batch)
        return logits

    return prefill


def make_serve_step(model: Model) -> Callable:
    """(params, cache, token [B,1], pos) -> (logits [B, V], cache)."""
    @torch.no_grad()
    def serve(params, cache, token, pos):
        return model.decode_step(params, cache, token, pos)

    return serve
