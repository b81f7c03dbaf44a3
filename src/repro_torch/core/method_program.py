"""One method table: every mobile-protocol method as a declarative program.

A method declares its per-step pieces once and ``compile_step`` lowers the
declaration to the engine's step, executed in this order:

- ``space_exchange`` — the ML Mule space-mediated cycle (deliver ->
  freshness filter -> dwell-weighted aggregation at fixed devices -> train
  -> send back): ``population_step``.
- ``local_train``    — one local step on the training side (per
  ``cfg.mode``), no communication; inactive mules keep their models.
- ``peer_exchange``  — a device-to-device encounter op (``"gossip"`` |
  ``"oppcl"``), fired at the ``peer_every`` cadence (paper Sec 4.3.1: a
  peer hand-off costs 3 steps), seeded with ``fold_in(key, peer_key_fold)``
  when riding alongside a space exchange. It runs over the full population
  (``gossip`` through the ``encounter_mix`` kernel); inactive mules drop
  out of both sides of the encounter test and ``apply_activity_mask``
  carries their models unchanged.

A hybrid like ``mlmule+gossip`` is ``space_exchange=True,
peer_exchange="gossip", peer_key_fold=1``; a new exchange op plugs in by
extending ``_PEER_STEPS`` with a function of the ``gossip_step`` signature.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

from repro_torch.baselines.gossip import gossip_step
from repro_torch.baselines.local_only import local_step
from repro_torch.baselines.oppcl import oppcl_step
from repro_torch.core.population import (METHODS_MOBILE, PopulationConfig,
                                         TrainFn, apply_activity_mask,
                                         population_step)
from repro_torch.core.seeds import fold_in


@dataclasses.dataclass(frozen=True)
class MethodProgram:
    """Declarative per-step pieces of one mobile-protocol method."""
    name: str
    space_exchange: bool = False        # ML Mule share-aggregate cycle
    peer_exchange: Optional[str] = None  # None | "gossip" | "oppcl"
    peer_every: int = 3                  # cadence: fires at t % k == k - 1
    peer_key_fold: Optional[int] = None  # fold_in(key, n) for the peer draw
    local_train: bool = False            # per-device local step, no comms


METHOD_PROGRAMS: Dict[str, MethodProgram] = {
    "mlmule": MethodProgram("mlmule", space_exchange=True),
    "gossip": MethodProgram("gossip", peer_exchange="gossip"),
    "oppcl": MethodProgram("oppcl", peer_exchange="oppcl"),
    "local": MethodProgram("local", local_train=True),
    "mlmule+gossip": MethodProgram("mlmule+gossip", space_exchange=True,
                                   peer_exchange="gossip", peer_key_fold=1),
}

_PEER_STEPS: Dict[str, Callable] = {"gossip": gossip_step, "oppcl": oppcl_step}


def get_program(method: str) -> MethodProgram:
    if method not in METHOD_PROGRAMS:
        raise ValueError(f"unknown method {method!r}; expected one of "
                         f"{METHODS_MOBILE}")
    return METHOD_PROGRAMS[method]


def compile_step(program: MethodProgram, train_fn: TrainFn,
                 cfg: PopulationConfig) -> Callable:
    """Lower a program to the engine's step.

    Uniform signature ``step(state, info, batches, key) -> state`` with
    ``info`` carrying ``fixed_id``/``exchange``/``pos``/``area`` (this
    step's row) and the integer step index ``t``, and optionally
    ``active``. The peer cadence is a Python test on ``t``, so nothing is
    read back from the device.
    """
    peer_fn = (_PEER_STEPS[program.peer_exchange]
               if program.peer_exchange else None)
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
        k = program.peer_every
        if peer_fn is not None and info["t"] % k == k - 1:
            kp = (key if program.peer_key_fold is None
                  else fold_in(key, program.peer_key_fold))
            act = info.get("active")
            new = peer_fn(st["mule_models"], info["pos"], info["area"],
                          batches["mule"], train_fn, kp, active=act,
                          backend=cfg.enc_backend)
            st = {**st, "mule_models": apply_activity_mask(
                act, new, st["mule_models"])}
        return st

    return step
