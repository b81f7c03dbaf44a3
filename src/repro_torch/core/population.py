"""Vectorized ML Mule population engine.

The whole device population is simulated as stacked dicts of tensors:
mule models [M, ...], fixed-device models [F, ...]. One ``population_step``
executes the paper's In-House cycles for every concurrent co-location in a
single masked batched update:

fixed-device training (share-aggregate-train-share, Fig. 2a):
  1. mules with a completed exchange deliver snapshots to their fixed device
  2. freshness filter (dynamic threshold) drops stale snapshots
  3. each fixed device folds the dwell-weighted mean of accepted snapshots
     into its model (masked_group_mean — the ``mule_agg`` kernel)
  4. fixed devices that received anything train one step on local data
  5. mules receive the updated model back and fold it into their own

mobile-device training (share-aggregate-share-train, Fig. 2b):
  steps 1–3 identical;
  4'. mules receive the aggregated model back and fold it in
  5'. mules train one step on their own data

Population churn: ``info["active"]`` ([M] bool, optional) marks which mules
are switched on this step. An inactive mule neither trains, delivers nor
receives: the mask folds into the delivery mask, which gates every
per-mule effect of the cycle.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.core.aggregation import batched_mix, masked_group_mean
from repro_torch.core.freshness import (FreshnessConfig, accept_mask,
                                        init_freshness, push_and_update)
from repro_torch.core.seeds import split
from repro_torch.device import resolve_device

Params = Dict[str, torch.Tensor]
# (params, batch, key) -> params; key is a per-device int64 seed
TrainFn = Callable[[Params, Any, torch.Tensor], Params]

# The five methods of the paper's mobile-device experiments (Figs 6-9).
METHODS_MOBILE = ("mlmule", "gossip", "oppcl", "local", "mlmule+gossip")


@dataclasses.dataclass(frozen=True)
class PopulationConfig:
    mode: str = "fixed"            # "fixed" | "mobile" — which side trains
    n_fixed: int = 8
    n_mules: int = 20
    gamma: float = 0.5             # aggregation mixing weight
    freshness: FreshnessConfig = FreshnessConfig()
    agg_backend: str = "auto"      # auto (mule_agg kernel on CUDA) | ref
    enc_backend: str = "auto"      # auto (encounter_mix kernel on CUDA) | ref
    aggregation: str = "weighted"  # weighted | prox (FedProx-style damping)
    prox_mu: float = 0.1


def _stack(models) -> Params:
    return {k: torch.stack([m[k] for m in models]) for k in models[0]}


def init_population(cfg: PopulationConfig,
                    init_fn: Optional[Callable[[torch.Generator], Params]] = None,
                    generator: Optional[torch.Generator] = None, *,
                    weights: Optional[Dict[str, Params]] = None,
                    device="cuda") -> Dict[str, Any]:
    """Population state on ``device``.

    Either ``init_fn(generator) -> params`` draws every model from
    ``generator`` (which must live on ``device``), or ``weights`` gives
    ready-made stacked ``{"mule_models": ..., "fixed_models": ...}``.
    """
    dev = resolve_device(device)
    if weights is not None:
        if init_fn is not None:
            raise ValueError("pass init_fn and generator, or weights, not both")
        mule = {k: v.to(dev) for k, v in weights["mule_models"].items()}
        fixed = {k: v.to(dev) for k, v in weights["fixed_models"].items()}
    else:
        if init_fn is None or generator is None:
            raise ValueError("init_population needs init_fn and generator, "
                             "or weights")
        if generator.device.type != dev.type:
            raise ValueError(f"generator on {generator.device}, population "
                             f"on {dev}")
        mule = _stack([init_fn(generator) for _ in range(cfg.n_mules)])
        fixed = _stack([init_fn(generator) for _ in range(cfg.n_fixed)])
    return {
        "mule_models": mule,
        "fixed_models": fixed,
        "mule_ts": torch.zeros((cfg.n_mules,), dtype=torch.float32,
                               device=dev),
        "fresh": init_freshness(cfg.n_fixed, cfg.freshness, dev),
        "t": torch.zeros((), dtype=torch.float32, device=dev),
    }


def apply_activity_mask(active: Optional[torch.Tensor], new: Params,
                        old: Params) -> Params:
    """Per-leaf select: lane ``m`` takes ``new`` where ``active[m]``.

    ``active=None`` means no churn and returns ``new`` unchanged.
    """
    if active is None:
        return new
    return {k: torch.where(active.reshape((-1,) + (1,) * (v.dim() - 1)),
                           v, old[k])
            for k, v in new.items()}


def population_step(state: Dict[str, Any], info: Dict[str, Any],
                    batches: Dict[str, Any], train_fn: TrainFn,
                    cfg: PopulationConfig, key: int) -> Dict[str, Any]:
    """One simulation time step.

    info:    {"fixed_id": [M] int (-1 = corridor), "exchange": [M] bool,
              "active": [M] bool (optional; absent == all active)}
    batches: {"fixed": [F, B, ...], "mule": [M, B, ...]} (per mode; a mode
             only reads the side that trains).
    key:     integer seed; each training device gets its own from it.
    """
    t = state["t"]
    fid = info["fixed_id"]
    dev = fid.device
    deliver = info["exchange"] & (fid >= 0)
    if info.get("active") is not None:
        deliver = deliver & info["active"]

    # -- 1–2: deliver + freshness filter ------------------------------------
    ages = t - state["mule_ts"]
    fresh_ok = accept_mask(state["fresh"], fid, ages, cfg.freshness) & deliver

    # -- 3: dwell-weighted aggregation at fixed devices ----------------------
    onehot = (fid.clamp(min=0)[None, :]
              == torch.arange(cfg.n_fixed, device=dev)[:, None])   # [F, M]
    assign = onehot.float() * fresh_ok[None, :].float()
    agg, mass = masked_group_mean(state["mule_models"], assign,
                                  backend=cfg.agg_backend)
    has = (mass > 0).float()
    gamma = (cfg.gamma / (1.0 + cfg.prox_mu) if cfg.aggregation == "prox"
             else cfg.gamma)
    fixed_models = batched_mix(state["fixed_models"], agg, gamma * has)

    fresh = push_and_update(state["fresh"], fid, ages, deliver, cfg.freshness)

    # -- 4: training ----------------------------------------------------------
    if cfg.mode == "fixed":
        keys = split(key, cfg.n_fixed, dev)
        trained = torch.func.vmap(train_fn)(fixed_models, batches["fixed"],
                                            keys)
        fixed_models = batched_mix(fixed_models, trained, has)
    # -- 5: send back to mules ------------------------------------------------
    back = fid.clamp(min=0)
    per_mule_fixed = {k: v[back] for k, v in fixed_models.items()}
    mule_models = batched_mix(state["mule_models"], per_mule_fixed,
                              cfg.gamma * deliver.float())

    if cfg.mode == "mobile":
        keys = split(key, cfg.n_mules, dev)
        trained = torch.func.vmap(train_fn)(mule_models, batches["mule"], keys)
        mule_models = batched_mix(mule_models, trained, deliver.float())

    return {
        "mule_models": mule_models,
        "fixed_models": fixed_models,
        "mule_ts": torch.where(deliver, t, state["mule_ts"]),
        "fresh": fresh,
        "t": t + 1.0,
    }


def eval_population(models: Params, eval_fn: Callable[[Params, Any], Any],
                    test_data: Any) -> torch.Tensor:
    """models: stacked [P, ...]; test_data: stacked [P, N, ...] -> metric [P]."""
    return torch.func.vmap(eval_fn)(models, test_data)
