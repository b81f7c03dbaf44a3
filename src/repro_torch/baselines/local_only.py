"""Local-only: every device trains on its own data; no communication."""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.core.seeds import split


def local_step(models: Any, batches: Any, train_fn: Callable, key: int) -> Any:
    """models: stacked [P, ...]; batches: [P, B, ...]."""
    lead = next(iter(models.values()))
    keys = split(key, lead.shape[0], lead.device)
    return torch.func.vmap(train_fn)(models, batches, keys)
