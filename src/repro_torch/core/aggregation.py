"""Model aggregation primitives over stacked populations.

A population of P models is a dict of tensors whose leaves have a leading P
axis. ``masked_group_mean`` is ML Mule's aggregation hot spot: every fixed
device averages the (freshness-filtered, dwell-weighted) models delivered
by its co-located mules — an [F, M] x [M, D] reduce over every parameter,
carried on the card by the hand-written ``mule_agg`` kernel.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from repro_torch.kernels.mule_agg import mule_agg_op

Params = Dict[str, torch.Tensor]


def _lead(g: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """[P] -> [P, 1, ...] broadcastable against ``x``."""
    return g.reshape((-1,) + (1,) * (x.dim() - 1))


def weighted_average(models: Params, weights: torch.Tensor) -> Params:
    """models: stacked [P, ...]; weights: [P] (need not sum to 1)."""
    w = weights / torch.clamp(weights.sum(), min=1e-12)
    return {k: (v * _lead(w, v)).sum(0) for k, v in models.items()}


def pairwise_mix(a: Params, b: Params, gamma) -> Params:
    """a <- (1-gamma) a + gamma b; gamma scalar or broadcastable per-leaf."""
    return {k: (1.0 - gamma) * a[k] + gamma * b[k] for k in a}


def batched_mix(a: Params, b: Params, gamma: torch.Tensor) -> Params:
    """Stacked [P,...] mix with per-member gamma [P]."""
    def mix(x, y):
        g = _lead(gamma, x)
        return (1.0 - g) * x + g * y
    return {k: mix(a[k], b[k]) for k in a}


def prox_mix(local: Params, incoming: Params, gamma, mu: float = 0.1) -> Params:
    """FedProx-style aggregation: mixing with an effective rate
    gamma' = gamma / (1 + mu), which damps drift from stale mules."""
    return pairwise_mix(local, incoming, gamma / (1.0 + mu))


def quality_weights(losses: torch.Tensor, temperature: float = 1.0
                    ) -> torch.Tensor:
    """Softmax of negative validation losses — better snapshots count more."""
    return torch.softmax(-losses / max(temperature, 1e-6), dim=-1)


def masked_group_mean(models: Params, assign: torch.Tensor, *,
                      backend: str = "auto") -> Tuple[Params, torch.Tensor]:
    """Weighted group means: out[f] = sum_m A[f,m] models[m] / sum_m A[f,m].

    models: stacked [M, ...]; assign: [F, M] non-negative weights (zero = not
    delivering to that fixed device). Rows with zero mass return zeros —
    callers mask on ``row_mass``. Returns (grouped [F, ...], row_mass [F]).

    ``backend="auto"`` flattens the leaves (sorted keys, the reference's
    leaf order) into one [M, D] float32 matrix and hands it to ``mule_agg``
    (as the custom op ``mule_agg_op``, so that under ``torch.func.vmap`` the
    lanes go to one ``mule_agg_lanes`` launch), which launches the CUDA
    kernel for CUDA tensors and takes its plain version for CPU tensors.
    ``backend="ref"`` is the plain per-leaf matmul.
    """
    mass = assign.sum(1)                                   # [F]
    norm = assign / torch.clamp(mass, min=1e-12)[:, None]  # [F, M]
    n_f, n_m = assign.shape

    if backend == "auto":
        keys = sorted(models)
        flat = torch.cat([models[k].reshape(n_m, -1).float() for k in keys],
                         dim=1)
        out = mule_agg_op(norm.float().contiguous(), flat)
        grouped, off = {}, 0
        for k in keys:
            leaf = models[k]
            n = math.prod(leaf.shape[1:])
            grouped[k] = out[:, off:off + n].reshape(
                (n_f,) + leaf.shape[1:]).to(leaf.dtype)
            off += n
        return grouped, mass
    if backend != "ref":
        raise ValueError(f"unknown aggregation backend {backend!r}; "
                         "expected 'auto' or 'ref'")

    def agg(leaf):
        out = norm.float() @ leaf.reshape(n_m, -1).float()
        return out.reshape((n_f,) + leaf.shape[1:]).to(leaf.dtype)

    return {k: agg(v) for k, v in models.items()}, mass
