"""The ML Mule In-House cycles for a single (mule, fixed-device) pair.

These mirror the paper's numbered step lists (Sec 3.1) one-to-one and are
the reference semantics for the vectorized ``population_step`` (tests
assert the two agree). ``population_step`` is what simulations use.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.core.aggregation import pairwise_mix


class DeviceState(NamedTuple):
    model: Any
    ts: torch.Tensor         # last-update time of the carried model


def fixed_device_training_cycle(mule: DeviceState, fixed: DeviceState,
                                threshold: torch.Tensor, t: torch.Tensor,
                                train_fixed: Callable[[Any], Any],
                                gamma: float = 0.5):
    """share → filter → aggregate → train(f) → share → aggregate (Fig. 2a).

    Returns (new_mule, new_fixed, accepted: bool tensor).
    """
    # (1) send(m, f, w); (2) freshness filter
    age = t - mule.ts
    accepted = age <= threshold
    # (3) f aggregates accepted model with its own
    g = torch.where(accepted, gamma, 0.0)
    f_model = pairwise_mix(fixed.model, mule.model, g)
    # (4) f trains on local data
    f_model = train_fixed(f_model)
    # (5) send(f, m, w); (6) m aggregates
    m_model = pairwise_mix(mule.model, f_model, gamma)
    return (DeviceState(m_model, t), DeviceState(f_model, t), accepted)


def mobile_device_training_cycle(mule: DeviceState, fixed: DeviceState,
                                 threshold: torch.Tensor, t: torch.Tensor,
                                 train_mule: Callable[[Any], Any],
                                 gamma: float = 0.5):
    """share → filter → aggregate → share → aggregate → train(m) (Fig. 2b)."""
    age = t - mule.ts
    accepted = age <= threshold
    g = torch.where(accepted, gamma, 0.0)
    # (2-3) f filters + aggregates — the mule "leaves a record of its visit"
    f_model = pairwise_mix(fixed.model, mule.model, g)
    # (4-5) f sends the aggregate back; m aggregates
    m_model = pairwise_mix(mule.model, f_model, gamma)
    # (6) m trains on its local data
    m_model = train_mule(m_model)
    return (DeviceState(m_model, t), DeviceState(f_model, t), accepted)
