"""The prefill and decode steps of serving.

Port of ``repro.launch.steps`` for serving. The reference's jit targets are
plain functions here (PyTorch runs eagerly). ``make_train_step`` waits for
the optimizer (ROADMAP §1 item 14.6).
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models.api import Model


def make_prefill_step(model: Model) -> Callable:
    """(params, batch) -> logits [B, S, V]: the full-sequence forward."""
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
