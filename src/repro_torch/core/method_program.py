"""One method table: every mobile-protocol method as a declarative program.

A method declares its per-step pieces once and ``compile_step`` lowers the
declaration to the engine's step, executed in this order:

- ``space_exchange`` — the ML Mule space-mediated cycle (deliver ->
  freshness filter -> dwell-weighted aggregation at fixed devices -> train
  -> send back): ``population_step``.
- ``local_train``    — one local step on the training side (per
  ``cfg.mode``), no communication; inactive mules keep their models.

The port has ``mlmule`` and ``local``. The peer-exchange methods of the
reference (``gossip``, ``oppcl``, ``mlmule+gossip``) need the
``encounter_mix`` kernel and arrive with ROADMAP §1 item 9.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict

from repro_torch.baselines.local_only import local_step
from repro_torch.core.population import (METHODS_MOBILE, PopulationConfig,
                                         TrainFn, apply_activity_mask,
                                         population_step)


@dataclasses.dataclass(frozen=True)
class MethodProgram:
    """Declarative per-step pieces of one mobile-protocol method."""
    name: str
    space_exchange: bool = False        # ML Mule share-aggregate cycle
    local_train: bool = False           # per-device local step, no comms


METHOD_PROGRAMS: Dict[str, MethodProgram] = {
    "mlmule": MethodProgram("mlmule", space_exchange=True),
    "local": MethodProgram("local", local_train=True),
}


def get_program(method: str) -> MethodProgram:
    if method in METHOD_PROGRAMS:
        return METHOD_PROGRAMS[method]
    if method in METHODS_MOBILE:
        raise NotImplementedError(
            f"method {method!r} is not ported yet; it arrives with ROADMAP "
            "§1 item 9 (peer baselines and the method table)")
    raise ValueError(f"unknown method {method!r}; expected one of "
                     f"{METHODS_MOBILE}")


def compile_step(program: MethodProgram, train_fn: TrainFn,
                 cfg: PopulationConfig) -> Callable:
    """Lower a program to the engine's step.

    Uniform signature ``step(state, info, batches, key) -> state`` with
    ``info`` carrying ``fixed_id``/``exchange``/``pos``/``area``/``t`` and
    optionally ``active``.
    """
    if cfg.mode == "fixed":
        local_side, local_bkey = "fixed_models", "fixed"
    else:
        local_side, local_bkey = "mule_models", "mule"

    def step(st, info, batches, key):
        if program.space_exchange:
            st = population_step(st, info, batches, train_fn, cfg, key)
        if program.local_train:
            trained = local_step(st[local_side], batches[local_bkey],
                                 train_fn, key)
            if local_side == "mule_models":
                trained = apply_activity_mask(info.get("active"), trained,
                                              st[local_side])
            st = {**st, local_side: trained}
        return st

    return step
