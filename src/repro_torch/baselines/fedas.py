"""FedAS (Yang et al., CVPR 2024) — simplified faithful core.

FedAS bridges inconsistency in personalized FL with two mechanisms:
(1) **federated parameter alignment** — before local training, the client's
    *shared* parameters are re-aligned to the server state so stale personal
    models don't drag the aggregate; personal (classifier) parameters never
    leave the device;
(2) **client-synchronized aggregation weights** — aggregation weighted by
    how in-sync a client's shared update is (cosine similarity to the mean
    update as the sync score).

``shared_pred(name)`` decides which leaves are shared (default: everything
except leaves whose name contains "fc2"/"head" — the task classifier).
The port names a leaf by its dotted key (``bn1.scale``) where the reference
names it by its pytree path (``['bn1']/['scale']``); the default predicate
matches substrings, so both give the same masks.
"""
from __future__ import annotations

from typing import Any, Callable, Dict

import torch

from repro_torch.baselines.fedavg import local_train
from repro_torch.core.aggregation import weighted_average

Params = Dict[str, torch.Tensor]


def default_shared_predicate(path: str) -> bool:
    return not any(k in path for k in ("fc2", "head"))


def _split(tree: Params, pred: Callable[[str], bool]) -> Params:
    """Masks (1.0 shared / 0.0 personal) matching ``tree``."""
    return {k: torch.full_like(v, 1.0 if pred(k) else 0.0)
            for k, v in tree.items()}


def fedas_round(global_shared: Params, client_models: Params,
                client_batches: Any, client_sizes: torch.Tensor,
                train_fn: Callable, key: int,
                shared_pred: Callable[[str], bool] = default_shared_predicate,
                local_steps: int = 1):
    """Returns (new_global_shared, new_client_models).

    client_models: stacked [C, ...] personalized models (clients keep their
    personal parts across rounds).
    """
    n = client_sizes.shape[0]
    mask = _split(global_shared, shared_pred)

    # (1) alignment: overwrite each client's shared part with the server's
    aligned = {k: cm * (1 - mask[k][None])
               + global_shared[k][None].expand(cm.shape) * mask[k][None]
               for k, cm in client_models.items()}
    trained = local_train(aligned, client_batches, train_fn, key, local_steps)

    # (2) sync-scored aggregation of the shared part
    keys = sorted(trained)
    flat = torch.cat([(trained[k] - aligned[k]).reshape(n, -1)
                      for k in keys], 1)                       # [C, D]
    mean_u = flat.mean(0, keepdim=True)
    cos = (flat * mean_u).sum(1) / (
        torch.linalg.norm(flat, dim=1) * torch.linalg.norm(mean_u) + 1e-9)
    sync_w = torch.relu(cos) + 1e-3
    weights = client_sizes.float() * sync_w
    new_global = weighted_average(trained, weights)
    # personal parts stay local:
    new_global = {k: g * mask[k] + global_shared[k] * (1 - mask[k])
                  for k, g in new_global.items()}
    return new_global, trained
