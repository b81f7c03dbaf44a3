"""Clustered Federated Learning (Sattler et al. 2019).

Recursive bipartitioning: when the global objective stagnates (mean client
update norm below eps1) but some client still moves (max norm above eps2),
the cluster is split into two groups by the sign structure of pairwise
cosine similarities between client updates; each cluster then runs FedAvg
independently. The cluster bookkeeping runs on the host (numpy) between
rounds, as in practical CFL implementations; training and aggregation stay
on the models' device.

``np.linalg.eigh``'s leading eigenvector has no fixed sign, and a flip
swaps the two halves of a split: the clusters are the same sets in either
order.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List

import numpy as np
import torch

from repro_torch.baselines.fedavg import broadcast, local_train
from repro_torch.core.aggregation import weighted_average
from repro_torch.core.seeds import fold_in
from repro_torch.interop import tree_map

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass
class CFLState:
    clusters: List[np.ndarray]        # list of client-index arrays
    models: List[Params]              # one model per cluster
    eps1: float = 0.05                # stagnation norm
    eps2: float = 0.4                 # max-client norm to trigger split
    min_cluster: int = 2


def _flat(models: Params) -> torch.Tensor:
    """Stacked [n, ...] leaves -> [n, D] in sorted-key (leaf) order."""
    n = next(iter(models.values())).shape[0]
    return torch.cat([models[k].reshape(n, -1) for k in sorted(models)], 1)


def _bipartition(sim: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Split clients into two groups maximizing intra-group cosine sim
    (greedy spectral-sign heuristic on the similarity matrix)."""
    w, v = np.linalg.eigh(sim)
    lead = v[:, -1]
    g1 = np.where(lead >= np.median(lead))[0]
    g2 = np.where(lead < np.median(lead))[0]
    if len(g1) == 0 or len(g2) == 0:  # degenerate; split by half
        order = np.argsort(lead)
        g1, g2 = order[: len(order) // 2], order[len(order) // 2:]
    return g1, g2


def cfl_round(state: CFLState, client_batches: Any,
              client_sizes: torch.Tensor, train_fn: Callable, key: int,
              local_steps: int = 1) -> CFLState:
    """One communication round over all clusters, with split checks."""
    new_clusters: List[np.ndarray] = []
    new_models: List[Params] = []
    for ci, (idx, model) in enumerate(zip(state.clusters, state.models)):
        rows = torch.as_tensor(idx, device=client_sizes.device)
        batches_c = tree_map(lambda b: b[rows], client_batches)
        sizes_c = client_sizes[rows]
        n = len(idx)
        locals_ = local_train(broadcast(model, n), batches_c, train_fn,
                              fold_in(key, ci), local_steps)
        flat_upd = _flat({k: v - model[k][None] for k, v in locals_.items()})
        norms = torch.linalg.norm(flat_upd, dim=1).cpu().numpy()
        mean_norm = float(torch.linalg.norm(flat_upd.mean(0)))
        agg = weighted_average(locals_, sizes_c.float())

        do_split = (mean_norm < state.eps1 and norms.max() > state.eps2
                    and n >= 2 * state.min_cluster)
        if do_split:
            fu = flat_upd.cpu().numpy()
            nrm = np.linalg.norm(fu, axis=1, keepdims=True) + 1e-9
            sim = (fu / nrm) @ (fu / nrm).T
            g1, g2 = _bipartition(sim)
            if len(g1) >= state.min_cluster and len(g2) >= state.min_cluster:
                for g in (g1, g2):
                    sub = torch.as_tensor(g, device=client_sizes.device)
                    new_clusters.append(idx[g])
                    new_models.append(weighted_average(
                        {k: v[sub] for k, v in locals_.items()},
                        sizes_c[sub].float()))
                continue
        new_clusters.append(idx)
        new_models.append(agg)
    return dataclasses.replace(state, clusters=new_clusters, models=new_models)


def cfl_client_models(state: CFLState, n_clients: int) -> Params:
    """Stacked [C, ...] view: each client gets its cluster's model."""
    order = np.zeros(n_clients, np.int64)
    for ci, idx in enumerate(state.clusters):
        order[idx] = ci
    first = state.models[0]
    rows = torch.as_tensor(order, device=next(iter(first.values())).device)
    return {k: torch.stack([m[k] for m in state.models])[rows] for k in first}
