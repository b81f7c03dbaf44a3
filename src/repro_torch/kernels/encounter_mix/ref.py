"""Plain versions of the fused peer-encounter mix — and the one block math.

``encounter_block`` is the single definition of the peer-encounter partial
update: distance test, area isolation, activity gating and self-exclusion
of one (row block x visiting block) pair, returning the unnormalized
neighbor sums and per-row neighbor counts. ``encounter_mix_reference`` is
one call with the whole population as both blocks, row-normalized.

These run on any device. The CPU path of ``ops.encounter_mix`` is
``encounter_mix_reference``, and that of ``ops.encounter_block_hop`` (one
ring hop) is ``encounter_block``; on the card they are the yardsticks the
CUDA kernels (``csrc/encounter_mix.cu``) are held to.

The gate is bitwise the kernel's: ``d2 = dx*dx + dy*dy`` in float32 with no
fused multiply-add (eager PyTorch runs each op on its own), compared with
``radius**2`` rounded once to float32, and ``area`` compared as integers.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def radius_sq(radius: float) -> torch.Tensor:
    """``radius**2`` rounded once to float32, as JAX rounds the Python
    scalar it compares a float32 array with."""
    return torch.tensor(radius ** 2, dtype=torch.float32)


def encounter_gate(pos_r: torch.Tensor, area_r: torch.Tensor,
                   act_r: Optional[torch.Tensor], row0: int,
                   pos_v: torch.Tensor, area_v: torch.Tensor,
                   act_v: Optional[torch.Tensor], col0: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pairwise squared distances and every non-distance encounter gate of
    one (row block x visiting block) pair.

    pos_r [R, 2], area_r [R], act_r [R] bool (None == all active), row0 the
    rows' global population offset; ``*_v``/``col0`` likewise for the
    visiting block. Returns (d2 [R, V] f32, gate [R, V] bool) where
    ``gate`` ANDs area isolation, both-sides activity and self-exclusion.
    """
    dx = pos_r[:, None, 0] - pos_v[None, :, 0]
    dy = pos_r[:, None, 1] - pos_v[None, :, 1]
    d2 = dx * dx + dy * dy
    gate = area_r[:, None] == area_v[None, :]
    if act_r is not None:
        gate = gate & act_r[:, None]
    if act_v is not None:
        gate = gate & act_v[None, :]
    dev = pos_r.device
    ridx = row0 + torch.arange(pos_r.shape[0], device=dev)
    cidx = col0 + torch.arange(pos_v.shape[0], device=dev)
    gate = gate & (ridx[:, None] != cidx[None, :])      # no self-encounter
    return d2, gate


def encounter_block(pos_r: torch.Tensor, area_r: torch.Tensor,
                    act_r: Optional[torch.Tensor], row0: int,
                    pos_v: torch.Tensor, area_v: torch.Tensor,
                    act_v: Optional[torch.Tensor], col0: int,
                    weights_v: torch.Tensor, radius: float
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Partial encounter mix of a row block against a visiting block.

    ``encounter_gate`` arguments plus weights_v [V, D]. Returns (acc [R, D]
    f32 unnormalized neighbor sums, mass [R] f32 counts).
    """
    d2, gate = encounter_gate(pos_r, area_r, act_r, row0,
                              pos_v, area_v, act_v, col0)
    e = ((d2 <= radius_sq(radius).to(d2.device)) & gate).float()
    return e @ weights_v.float(), e.sum(1)


def normalize_mix(acc: torch.Tensor, mass: torch.Tensor) -> torch.Tensor:
    """Row-normalize accumulated neighbor sums (zero rows stay zero)."""
    return acc / torch.clamp(mass, min=1e-12)[:, None]


def encounter_mix_reference(pos: torch.Tensor, area: torch.Tensor,
                            active: Optional[torch.Tensor],
                            weights: torch.Tensor, *, radius: float
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """pos [M, 2] x area [M] x weights [M, D] -> (mixed [M, D] f32, mass [M]).

    mixed[i] = mean of weights[j] over encountered peers j (same area,
    within ``radius``, both active, j != i); rows with no peer are zero and
    callers gate on ``mass``. Builds the dense [M, M] strip.
    """
    acc, mass = encounter_block(pos, area, active, 0, pos, area, active, 0,
                                weights, radius)
    return normalize_mix(acc, mass), mass
