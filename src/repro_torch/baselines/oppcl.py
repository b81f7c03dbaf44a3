"""Opportunistic Collaborative Learning (Lee et al. 2021).

Egocentric cycle per encounter: exchange - train - exchange - aggregate.
Device i sends its model to an encountered peer j; j trains i's model on
j's local data and returns it; i aggregates the returned model with its own.
Vectorized simplification (documented): each device picks its nearest
neighbor as the peer for the step, the first one where distances tie (on
trace scenarios every position is 0, so every same-area peer ties).

The peer search does not depend on D, so this module has no kernel. The
reference's sharded search (``_ring_nearest_peer``) arrives with ROADMAP §1
item 13.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from repro_torch.core.aggregation import batched_mix
from repro_torch.core.seeds import split
from repro_torch.kernels.encounter_mix import encounter_gate
from repro_torch.kernels.encounter_mix.ref import radius_sq


def _block_d2(pos_r, area_r, act_r, row0, pos_v, area_v, act_v, col0):
    """Squared distances of rows vs a visiting block, inf where the pair
    fails the shared non-distance gates (``encounter_gate``)."""
    d2, gate = encounter_gate(pos_r, area_r, act_r, row0,
                              pos_v, area_v, act_v, col0)
    return torch.where(gate, d2, torch.inf)


def _take(tree: Any, idx: torch.Tensor) -> Any:
    """Rows ``idx`` of every tensor in a tuple/list/dict of tensors."""
    if isinstance(tree, dict):
        return {k: _take(v, idx) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_take(v, idx) for v in tree)
    return tree[idx]


def oppcl_step(models: Any, pos: torch.Tensor, area: torch.Tensor,
               batches: Any, train_fn: Callable, key: int, *,
               radius: float = 0.15, gamma: float = 0.5,
               active: Optional[torch.Tensor] = None,
               backend: str = "auto") -> Any:
    """One OppCL cycle over the population.

    ``backend`` is accepted for signature uniformity with ``gossip_step``
    and ignored: the peer search has no kernel. Rows that met no peer take
    row 0's batch and are gated out by ``gamma * met = 0``.
    """
    m = pos.shape[0]
    d2 = _block_d2(pos, area, active, 0, pos, area, active, 0)
    d2 = torch.where(d2 <= radius_sq(radius).to(d2.device), d2, torch.inf)
    peer = torch.argmin(d2, dim=1)             # first occurrence on ties
    met = torch.isfinite(d2.min(dim=1).values).float()
    peer_batches = _take(batches, peer)        # j's data

    # peer j trains i's model on j's data (exchange-train), then
    # (exchange back - aggregate)
    keys = split(key, m, pos.device)
    trained = torch.func.vmap(train_fn)(models, peer_batches, keys)
    return batched_mix(models, trained, gamma * met)
