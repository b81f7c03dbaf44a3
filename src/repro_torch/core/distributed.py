"""Bucketing of the population for the ring of ranks.

A rank holds one equal block of the population, and the ring
(``repro_torch.baselines.gossip.ring_encounter_mix``) can skip a hop only
when the two blocks share no area. Ordering the mules by area at build time
makes the blocks area-contiguous, which is what lets the pruning bite:
interleaved areas leave every area on every rank and nothing to prune.

``bucket_mule_order`` gives the permutation, ``reorder_colocation`` and
``reorder_mule_state`` apply it to the schedule and to the population (the
same simulation with the mules renumbered), and
``bucket_locality_fraction`` measures how much of the encounter work the
local hop serves. The schedule helpers are numpy, as the schedules are.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def bucket_mule_order(area) -> np.ndarray:
    """Area ids -> [M] permutation grouping mules by spatial bucket.

    Takes the static [M] areas or a time-varying [T, M] trace, of which it
    uses the t = 0 row. A stable sort, so the order within a bucket (and
    the identity when every mule shares one area) is kept.
    """
    a = np.asarray(area)
    if a.ndim == 2:
        a = a[0]
    return np.argsort(a, kind="stable")


def reorder_colocation(colocation: Dict[str, Any],
                       order: np.ndarray) -> Dict[str, Any]:
    """Apply a mule permutation to every per-mule colocation column.

    Values that are [T, M, ...] (fixed_id, exchange, active, a time-varying
    area, pos [T, M, 2]) or [M] (static area, init_space) follow ``order``
    on the axis whose length matches it; anything else passes through.
    """
    order = np.asarray(order)

    def one(v):
        a = np.asarray(v)
        if a.ndim >= 2 and a.shape[1] == order.shape[0]:
            return a[:, order]
        if a.ndim >= 1 and a.shape[0] == order.shape[0]:
            return a[order]
        return a
    return {k: one(v) for k, v in colocation.items()}


def _rows(tree: Any, order: np.ndarray) -> Any:
    if isinstance(tree, dict):
        return {k: _rows(v, order) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rows(v, order) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree[torch.as_tensor(order, device=tree.device)]
    return np.asarray(tree)[order]


def reorder_mule_state(state: Dict[str, Any], order) -> Dict[str, Any]:
    """Apply a mule permutation to the per-mule state.

    Every ``mule*`` entry (models, timestamps, freshness carry; tensors or
    numpy arrays) has its rows follow their colocation columns
    (``reorder_colocation``), so a bucket-ordered run is the same
    simulation with the mules renumbered; other entries pass through.
    """
    order = np.asarray(order, dtype=np.int64)
    return {k: (_rows(v, order) if k.startswith("mule") and v is not None
                else v)
            for k, v in state.items()}


def bucket_locality_fraction(area, n_shards: int) -> float:
    """Fraction of same-area ordered mule pairs that are rank-local under
    the equal-block layout of ``area`` over ``n_shards`` ranks.

    Same-area pairs are the candidate encounters the ring must cover, so
    this is the share of encounter work the local hop can serve; 1.0 when
    there are no same-area pairs. Blocks are ``np.array_split``'s, so a
    population that does not divide ``n_shards`` counts its ragged tail.
    """
    a = np.asarray(area)
    if a.ndim == 2:
        a = a[0]
    local = total = 0
    blocks = np.array_split(a, n_shards)
    for u in np.unique(a):
        c = int((a == u).sum())
        total += c * (c - 1)
        for blk in blocks:
            ck = int((blk == u).sum())
            local += ck * (ck - 1)
    return float(local) / float(total) if total else 1.0
