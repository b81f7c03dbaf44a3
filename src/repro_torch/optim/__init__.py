"""Optimizers and schedules on dicts of tensors (port of ``repro.optim``)."""
from repro_torch.optim.optimizers import (  # noqa: F401
    Optimizer, adam, adamw, clip_by_global_norm, cosine_schedule,
    linear_schedule, sgd)
