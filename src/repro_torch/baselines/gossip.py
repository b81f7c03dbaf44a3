"""Gossip Learning (Hegedűs et al. 2019).

Per encounter: exchange-aggregate-train. Mobile devices within ``radius``
of each other in the same area exchange models, average with all
neighbors (masked row-normalized mixing), then train one local step.

The neighbor average is the fused ``encounter_mix`` op
(``repro_torch.kernels.encounter_mix``): models flatten once to an [M, D]
float32 matrix and one pass computes the distance-tested, row-normalized
mix — on a CUDA tensor the hand-written kernel. The former dense path
(``encounter_matrix`` + per-leaf ``masked_group_mean``) survives below only
as the baseline it was replaced by.

The port runs the single-host step; the reference's sharded ring
(``RingSpec``, ``ring_encounter_mix``) arrives with ROADMAP §1 item 13.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.core.aggregation import batched_mix, masked_group_mean
from repro_torch.core.seeds import split
from repro_torch.kernels.encounter_mix import (encounter_gate, encounter_mix,
                                               encounter_mix_reference)
from repro_torch.kernels.encounter_mix.ref import radius_sq

Params = Dict[str, torch.Tensor]
# sorted leaf keys, per-leaf shapes (without the population axis), dtypes
FlatSpec = Tuple[List[str], List[torch.Size], List[torch.dtype]]


def flatten_population(models: Params) -> Tuple[torch.Tensor, FlatSpec]:
    """Stacked dict [M, ...] -> (f32 [M, D] matrix, unflatten spec).

    Columns follow the sorted dotted keys, which is ``jax.tree.flatten``'s
    leaf order of the reference's nested pytree.
    """
    keys = sorted(models)
    m = models[keys[0]].shape[0]
    flat = torch.cat([models[k].reshape(m, -1).float() for k in keys], dim=1)
    return flat, (keys, [models[k].shape[1:] for k in keys],
                  [models[k].dtype for k in keys])


def unflatten_population(flat: torch.Tensor, spec: FlatSpec) -> Params:
    keys, shapes, dtypes = spec
    out, off = {}, 0
    for k, s, dt in zip(keys, shapes, dtypes):
        n = math.prod(s)
        out[k] = flat[:, off:off + n].reshape((flat.shape[0],) + s).to(dt)
        off += n
    return out


def encounter_matrix(pos: torch.Tensor, area: torch.Tensor, radius: float,
                     active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """pos [M,2], area [M] -> symmetric bool [M,M] (no self).

    The retired dense path. ``active`` ([M] bool, optional) drops
    switched-off mules from both sides of every encounter.
    """
    d2, gate = encounter_gate(pos, area, active, 0, pos, area, active, 0)
    return (d2 <= radius_sq(radius).to(pos.device)) & gate


def _neighbor_mix(flat, pos, area, active, radius, backend):
    if backend == "auto":
        return encounter_mix(pos, area, active, flat, radius=radius)
    if backend == "ref":
        return encounter_mix_reference(pos, area, active, flat, radius=radius)
    raise ValueError(f"unknown encounter backend {backend!r}; expected "
                     "'auto' or 'ref'")


def gossip_step(models: Params, pos: torch.Tensor, area: torch.Tensor,
                batches: Any, train_fn: Callable, key: int, *,
                radius: float = 0.15, gamma: float = 0.5,
                active: Optional[torch.Tensor] = None,
                backend: str = "auto") -> Params:
    """One gossip exchange-aggregate-train step over the population.

    ``backend="auto"`` mixes with ``encounter_mix`` (the CUDA kernel on a
    CUDA tensor, the plain version on a CPU tensor); ``"ref"`` always runs
    the plain version. Each mule trains with its own seed of
    ``split(key, M)``; only mules that met a peer take the result.
    """
    flat, spec = flatten_population(models)
    mixed, mass = _neighbor_mix(flat, pos, area, active, radius, backend)
    neigh_mean = unflatten_population(mixed, spec)
    met = (mass > 0).float()
    models = batched_mix(models, neigh_mean, gamma * met)           # aggregate
    keys = split(key, mass.shape[0], mass.device)
    trained = torch.func.vmap(train_fn)(models, batches, keys)      # train
    return batched_mix(models, trained, met)                # only on encounter


def gossip_step_dense(models: Params, pos: torch.Tensor, area: torch.Tensor,
                      batches: Any, train_fn: Callable, key: int, *,
                      radius: float = 0.15, gamma: float = 0.5,
                      active: Optional[torch.Tensor] = None) -> Params:
    """The retired dense gossip step: [M, M] matrix + per-leaf group mean.

    A baseline only; it normalizes the encounter matrix *before* the
    per-leaf matmuls, so it differs from ``gossip_step`` in float rounding,
    not semantics.
    """
    enc = encounter_matrix(pos, area, radius, active).float()
    neigh_mean, mass = masked_group_mean(models, enc, backend="ref")
    met = (mass > 0).float()
    models = batched_mix(models, neigh_mean, gamma * met)
    keys = split(key, mass.shape[0], mass.device)
    trained = torch.func.vmap(train_fn)(models, batches, keys)
    return batched_mix(models, trained, met)
