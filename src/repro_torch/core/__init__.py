"""ML Mule core in PyTorch.

- ``aggregation``    — dwell-weighted model averaging (the ``mule_agg``
                       CUDA kernel underneath).
- ``freshness``      — the dynamic staleness threshold
                       T <- (1-a)T + a(median(L) + b*MAD(L)), exact ring.
- ``protocol``       — the In-House phase cycles of one (mule, fixed
                       device) pair (fixed-device training:
                       share-aggregate-train-share; mobile-device
                       training: share-aggregate-share-train).
- ``population``     — vectorized multi-device step (stacked dicts of
                       tensors, ``torch.func.vmap`` training).
- ``method_program`` — the method table the engine dispatches on.
"""
from repro_torch.core.aggregation import (  # noqa: F401
    batched_mix, masked_group_mean, pairwise_mix, weighted_average)
from repro_torch.core.freshness import (  # noqa: F401
    FreshnessConfig, init_freshness, push_and_update)
from repro_torch.core.population import (  # noqa: F401
    METHODS_MOBILE, PopulationConfig, apply_activity_mask, init_population,
    population_step)
