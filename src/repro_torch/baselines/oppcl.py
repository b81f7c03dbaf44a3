"""Opportunistic Collaborative Learning (Lee et al. 2021).

Egocentric cycle per encounter: exchange - train - exchange - aggregate.
Device i sends its model to an encountered peer j; j trains i's model on
j's local data and returns it; i aggregates the returned model with its own.
Vectorized simplification (documented): each device picks its nearest
neighbor as the peer for the step, the first one where distances tie (on
trace scenarios every position is 0, so every same-area peer ties).

The peer search does not depend on D, so this module has no kernel.

Sharded populations: with a ``RingSpec`` the search runs over the ring of
ranks (``_ring_nearest_peer``): each rank's (pos, area, active, batches)
block arrives by a direct shift (``gossip.shift_perm``), and every local
row keeps a running lexicographic minimum over ``(d², global peer id)``
plus the winning peer's batch. The tie-break makes the result independent
of ring order, so it equals the single-host ``argmin`` (first occurrence)
exactly, and the per-row train and aggregate are rank-local. The search
shares gossip's area-bitmask hop pruning: a pruned hop has no same-area
active pair (all-``inf`` distances), so skipping it leaves ``met`` and
every met row's winner unchanged; rows that met no peer may carry other
placeholder batches, which ``gamma * met = 0`` gates out. Under
``torch.func.vmap`` (a seed sweep) every lane runs the hops any lane needs,
and a hop that one lane does not need changes nothing in that lane (its
own hop mask gates the update), so each lane is its sequential run.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from repro_torch.baselines.gossip import (RING_COUNTS, RingSpec, _ring_need,
                                          _ring_shifts)
from repro_torch.core.aggregation import batched_mix
from repro_torch.core.seeds import split
from repro_torch.interop import tree_map
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


def _ring_nearest_peer(pos: torch.Tensor, area: torch.Tensor,
                       active: Optional[torch.Tensor], batches: Any, *,
                       radius: float, ring: RingSpec):
    """Cross-rank nearest-encounter search over this rank's block; returns
    (peer_batches, met [m_loc] f32, peer [m_loc] int64 global ids, valid
    where met)."""
    m_loc = pos.shape[0]
    row0 = ring.rank() * m_loc
    dev = pos.device
    act = (torch.ones((m_loc,), dtype=torch.bool, device=dev)
           if active is None else active)
    r2 = radius_sq(radius).to(dev)
    orig = (pos, area, act, batches)

    def consume(carry, visiting, col0, lane_need=None):
        best_d2, best_g, best_b = carry
        pos_v, area_v, act_v, batch_v = visiting
        RING_COUNTS["hops"] += 1
        d2 = _block_d2(pos, area, act, row0, pos_v, area_v, act_v, col0)
        d2 = torch.where(d2 <= r2, d2, torch.inf)
        j = torch.argmin(d2, dim=1)            # first occurrence on ties
        cand = d2.gather(1, j[:, None])[:, 0]
        cand_g = col0 + j
        better = (cand < best_d2) | ((cand == best_d2) & (cand_g < best_g))
        if lane_need is not None:   # a hop this lane does not need: no-op
            better = better & lane_need
        best_b = tree_map(lambda nw, o: torch.where(
            better.reshape((-1,) + (1,) * (nw.dim() - 1)), nw, o),
            _take(batch_v, j), best_b)
        return (torch.where(better, cand, best_d2),
                torch.where(better, cand_g, best_g), best_b)

    carry = (torch.full((m_loc,), torch.inf, device=dev),
             torch.full((m_loc,), torch.iinfo(torch.int64).max,
                        dtype=torch.int64, device=dev),
             batches)                # placeholder rows; met gates them out
    carry = consume(carry, orig, row0)              # shift 0: local block
    if ring.axis_size > 1:
        lane, need = (_ring_need(area, act, ring) if ring.prune
                      else (None, None))
        for s, src, blk in _ring_shifts(orig, ring, need):
            carry = consume(carry, blk, src * m_loc,
                            None if lane is None else lane[s])
    best_d2, best_g, best_b = carry
    return best_b, torch.isfinite(best_d2).float(), best_g


def oppcl_step(models: Any, pos: torch.Tensor, area: torch.Tensor,
               batches: Any, train_fn: Callable, key: int, *,
               radius: float = 0.15, gamma: float = 0.5,
               active: Optional[torch.Tensor] = None,
               backend: str = "auto", ring: Optional[RingSpec] = None,
               keys: Optional[torch.Tensor] = None) -> Any:
    """One OppCL cycle over the population.

    ``backend`` is accepted for signature uniformity with ``gossip_step``
    and ignored: the peer search has no kernel. Rows that met no peer take
    row 0's batch (single host) or a placeholder (ring) and are gated out
    by ``gamma * met = 0``. ``ring`` and ``keys`` follow ``gossip_step``:
    every argument is this rank's block, the search streams around the
    ring, and ``keys`` replaces ``split(key, M)``.
    """
    m = pos.shape[0]
    if ring is None:
        d2 = _block_d2(pos, area, active, 0, pos, area, active, 0)
        d2 = torch.where(d2 <= radius_sq(radius).to(d2.device), d2,
                         torch.inf)
        peer = torch.argmin(d2, dim=1)         # first occurrence on ties
        met = torch.isfinite(d2.min(dim=1).values).float()
        peer_batches = _take(batches, peer)    # j's data
    else:
        peer_batches, met, _ = _ring_nearest_peer(pos, area, active, batches,
                                                  radius=radius, ring=ring)

    # peer j trains i's model on j's data (exchange-train), then
    # (exchange back - aggregate)
    if keys is None:
        keys = split(key, m, pos.device)
    trained = torch.func.vmap(train_fn)(models, peer_batches, keys)
    return batched_mix(models, trained, gamma * met)
