"""Plain version of the fused population-aggregation kernel.

out[f, d] = sum_m A[f, m] * W[m, d]

A is the (freshness-filtered, dwell-normalized) assignment matrix
[n_fixed, n_mules]; W is the population's flattened parameters
[n_mules, n_params]. Memory-bound: every byte of W is read once.
"""
from __future__ import annotations

import torch


def mule_agg_plain(assign: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    return (assign.float() @ weights.float()).to(weights.dtype)
