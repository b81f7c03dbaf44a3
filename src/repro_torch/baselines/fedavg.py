"""FedAvg (McMahan et al. 2017): server round = broadcast, local train,
weighted average by client data size."""
from __future__ import annotations

from typing import Any, Callable, Dict

import torch

from repro_torch.core.aggregation import weighted_average
from repro_torch.core.seeds import fold_in, split

Params = Dict[str, torch.Tensor]


def broadcast(model: Params, n: int) -> Params:
    """One model -> ``n`` stacked copies [n, ...]."""
    return {k: v.unsqueeze(0).expand((n,) + v.shape).clone()
            for k, v in model.items()}


def local_train(models: Params, batches: Any, train_fn: Callable, key: int,
                local_steps: int) -> Params:
    """``local_steps`` vmapped ``train_fn`` calls on stacked [C, ...] models.

    Client ``c``'s step ``i`` trains with ``fold_in(seed_c, i)``, where
    ``seed_c`` is the ``c``-th seed of ``split(key, C)`` (the reference's
    ``fori_loop`` over ``fold_in(k_c, i)``).
    """
    lead = next(iter(models.values()))
    seeds = split(key, lead.shape[0], "cpu").tolist()
    for i in range(local_steps):
        keys = torch.tensor([fold_in(s, i) for s in seeds],
                            dtype=torch.int64, device=lead.device)
        models = torch.func.vmap(train_fn)(models, batches, keys)
    return models


def fedavg_round(global_model: Params, client_batches: Any,
                 client_sizes: torch.Tensor, train_fn: Callable, key: int,
                 local_steps: int = 1) -> Params:
    """client_batches: stacked [C, B, ...] consumed by train_fn.

    train_fn(params, batch, key) -> params; applied ``local_steps`` times.
    """
    n_clients = client_sizes.shape[0]
    locals_ = local_train(broadcast(global_model, n_clients), client_batches,
                          train_fn, key, local_steps)
    return weighted_average(locals_, client_sizes.float())
