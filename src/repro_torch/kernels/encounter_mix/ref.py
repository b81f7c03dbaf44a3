"""Plain versions of the fused peer-encounter mix — and the one block math.

``encounter_block`` is the single definition of the peer-encounter partial
update: distance test, area isolation, activity gating and self-exclusion
of one (row block x visiting block) pair, returning the unnormalized
neighbor sums and per-row neighbor counts. ``encounter_mix_reference`` is
one call with the whole population as both blocks, row-normalized.

``encounter_pairs_reference`` is the pairs of one block pair as the CUDA
pairs kernel writes them: each row's meet mask in 32-bit words, bit ``b``
of word ``w`` for visiting mule ``32 w + b`` (so the set bits list the met
mules in ascending order), and the count. ``unpack_pairs`` turns the words
back into the [R, V] gate.

These run on any device. The CPU path of ``ops.encounter_mix`` is
``encounter_mix_reference``, that of ``ops.encounter_block_hop`` (one ring
hop) is ``encounter_block``, and that of ``ops.encounter_pairs`` is
``encounter_pairs_reference``; on the card they are the yardsticks the CUDA
kernels (``csrc/encounter_mix.cu``) are held to.

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


def n_words(v: int) -> int:
    """32-bit mask words a row of ``v`` visiting mules takes (at least
    one)."""
    return max(1, (v + 31) // 32)


def encounter_pairs_reference(pos_r: torch.Tensor, area_r: torch.Tensor,
                              act_r: Optional[torch.Tensor], row0: int,
                              pos_v: torch.Tensor, area_v: torch.Tensor,
                              act_v: Optional[torch.Tensor], col0: int,
                              radius: float
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``encounter_gate`` arguments plus radius -> (words [R, n_words(V)]
    int32, mass [R] f32): bit b of words[i, w] is e[i, 32 w + b] (bits past
    V are 0), mass[i] the number of set bits."""
    d2, gate = encounter_gate(pos_r, area_r, act_r, row0,
                              pos_v, area_v, act_v, col0)
    e = (d2 <= radius_sq(radius).to(d2.device)) & gate
    r, v = e.shape
    nw = n_words(v)
    bits = torch.zeros((r, nw * 32), dtype=torch.int64, device=e.device)
    bits[:, :v] = e.to(torch.int64)
    shift = torch.arange(32, dtype=torch.int64, device=e.device)
    words = (bits.view(r, nw, 32) << shift).sum(-1)    # in [0, 2**32)
    words = torch.where(words >= 2 ** 31, words - 2 ** 32, words)
    return words.to(torch.int32), e.sum(1).to(torch.float32)


def unpack_pairs(words: torch.Tensor, v: int) -> torch.Tensor:
    """words [R, n_words(v)] int32 -> the gate e [R, v] bool; raises if a
    bit past ``v`` is set."""
    shift = torch.arange(32, dtype=torch.int64, device=words.device)
    bits = (words.to(torch.int64)[..., None] >> shift) & 1
    bits = bits.reshape(words.shape[0], -1)
    if bits[:, v:].any():
        raise ValueError("a pair mask has a bit set past the visiting block")
    return bits[:, :v].bool()


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


def encounter_mix_lanes_reference(pos: torch.Tensor, area: torch.Tensor,
                                  active: Optional[torch.Tensor],
                                  weights: torch.Tensor, *, radius: float
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``encounter_mix_reference`` with a leading lane axis on every
    argument: pos [S, M, 2], area [S, M], active [S, M] (or None), weights
    [S, M, D] -> (mixed [S, M, D] f32, mass [S, M]); the [S, M, M] gate
    times W as one batched matmul. Written out rather than vmapped: the
    custom op's vmap rule calls it, and a transform inside that rule is
    refused."""
    dx = pos[:, :, None, 0] - pos[:, None, :, 0]
    dy = pos[:, :, None, 1] - pos[:, None, :, 1]
    d2 = dx * dx + dy * dy
    gate = area[:, :, None] == area[:, None, :]
    if active is not None:
        gate = gate & active[:, :, None] & active[:, None, :]
    m = pos.shape[1]
    gate = gate & ~torch.eye(m, dtype=torch.bool, device=pos.device)
    e = ((d2 <= radius_sq(radius).to(d2.device)) & gate).float()
    mass = e.sum(2)
    acc = torch.matmul(e, weights.float())
    return acc / torch.clamp(mass, min=1e-12)[:, :, None], mass


def encounter_block_lanes_reference(pos_r: torch.Tensor,
                                    area_r: torch.Tensor,
                                    act_r: Optional[torch.Tensor], row0: int,
                                    pos_v: torch.Tensor,
                                    area_v: torch.Tensor,
                                    act_v: Optional[torch.Tensor], col0: int,
                                    weights_v: torch.Tensor, radius: float
                                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``encounter_block`` with a leading lane axis on every tensor: pos_r
    [S, R, 2], area_r / act_r [S, R], pos_v [S, V, 2], area_v / act_v [S,
    V], weights_v [S, V, D] -> (acc [S, R, D] f32, mass [S, R]); every lane
    shares ``row0`` and ``col0``. Written out, as
    ``encounter_mix_lanes_reference`` is, for the hop op's vmap rule."""
    dx = pos_r[:, :, None, 0] - pos_v[:, None, :, 0]
    dy = pos_r[:, :, None, 1] - pos_v[:, None, :, 1]
    d2 = dx * dx + dy * dy
    gate = area_r[:, :, None] == area_v[:, None, :]
    if act_r is not None:
        gate = gate & act_r[:, :, None]
    if act_v is not None:
        gate = gate & act_v[:, None, :]
    dev = pos_r.device
    ridx = row0 + torch.arange(pos_r.shape[1], device=dev)
    cidx = col0 + torch.arange(pos_v.shape[1], device=dev)
    gate = gate & (ridx[:, None] != cidx[None, :])
    e = ((d2 <= radius_sq(radius).to(d2.device)) & gate).float()
    return torch.matmul(e, weights_v.float()), e.sum(2)
