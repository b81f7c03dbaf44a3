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

``compile_step`` lowers a program for one host; ``compile_distributed_step``
lowers the same program for a rank of the mule-sharded engine, so the two
cannot drift apart: the space exchange becomes the fused reduce with one
``ordered_psum`` a step, and the peer exchange streams each rank's block
around the data axis's ring of ranks (``RingSpec``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional

import torch

from repro_torch.baselines.gossip import (N_AREA_BITS, RingSpec,
                                          flatten_population, gossip_step)
from repro_torch.baselines.local_only import local_step
from repro_torch.baselines.oppcl import oppcl_step
from repro_torch.core.population import (METHODS_MOBILE, PopulationConfig,
                                         TrainFn, apply_activity_mask,
                                         population_step)
from repro_torch.core.freshness import (age_bin_onehot,
                                        sketch_push_and_update)
from repro_torch.core.seeds import fold_in, split
from repro_torch.interop import tree_map
from repro_torch.kernels.mule_agg.ops import mule_agg_op


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


# ---------------------------------------------------------------------------
# the rank-local lowering (distributed engine)
# ---------------------------------------------------------------------------


def _local_block(mesh, dcfg, leaf, m_loc: int):
    """This rank's mule rows of a replicated [M, ...] array; an array that
    already has ``m_loc`` rows is this rank's block and passes through."""
    if leaf is None or leaf.shape[0] == m_loc:
        return leaf
    j = mesh.coords[dcfg.data_axis]
    return leaf[j * m_loc:(j + 1) * m_loc]


def _mule_train_keys(mesh, dcfg, key, m_loc: int, device):
    """The global split's slice: a rank's per-mule seeds are single
    host's."""
    return _local_block(mesh, dcfg, split(key, dcfg.pop.n_mules, device),
                        m_loc)


def compile_distributed_step(program: MethodProgram, train_fn: Callable,
                             dcfg, mesh) -> Callable:
    """Lower a program to the rank-local step of the distributed engine.

    The signature of ``compile_step``, but every mule array (state,
    ``info`` columns) is this rank's block on ``mesh``'s data axis, and
    ``fixed_models`` / ``fresh`` / ``t`` are replicated. Mule batches may
    come whole ([M, ...]: each rank takes its rows) or as the rank's block.
    ``dcfg.ring_prune`` and ``dcfg.ring_bits`` configure the peer ring, and
    ``dcfg.pop.enc_backend`` / ``agg_backend`` pick the kernels as on one
    host. Fixed-device training splits the replicated seed over
    ``n_fixed``; every per-mule draw splits it over the global ``n_mules``
    and takes the rank's slice, so a run equals single host row for row
    however the population is cut.
    """
    cfg = dcfg.pop
    space_step = (_space_exchange_distributed(train_fn, dcfg, mesh)
                  if program.space_exchange else None)
    peer_fn = (_PEER_STEPS[program.peer_exchange]
               if program.peer_exchange else None)
    ring = RingSpec(mesh.shape[dcfg.data_axis],
                    group=mesh.group(dcfg.data_axis),
                    prune=dcfg.ring_prune,
                    n_bits=dcfg.ring_bits or N_AREA_BITS)

    def step(st, info, batches, key):
        dev = info["fixed_id"].device
        m_loc = info["fixed_id"].shape[0]
        if space_step is not None:
            st = space_step(st, info, batches, key)
        if program.local_train:
            if cfg.mode == "fixed":
                keys = split(key, cfg.n_fixed, dev)
                trained = torch.func.vmap(train_fn)(
                    st["fixed_models"], batches["fixed"], keys)
                st = {**st, "fixed_models": trained}
            else:
                mb = tree_map(lambda l: _local_block(mesh, dcfg, l, m_loc),
                              batches["mule"])
                keys = _mule_train_keys(mesh, dcfg, key, m_loc, dev)
                trained = torch.func.vmap(train_fn)(st["mule_models"], mb,
                                                    keys)
                trained = apply_activity_mask(info.get("active"), trained,
                                              st["mule_models"])
                st = {**st, "mule_models": trained}
        k = program.peer_every
        if peer_fn is not None and info["t"] % k == k - 1:
            kp = (key if program.peer_key_fold is None
                  else fold_in(key, program.peer_key_fold))
            act = info.get("active")
            mb = tree_map(lambda l: _local_block(mesh, dcfg, l, m_loc),
                          batches["mule"])
            keys = _mule_train_keys(mesh, dcfg, kp, m_loc, dev)
            new = peer_fn(st["mule_models"], info["pos"], info["area"], mb,
                          train_fn, kp, active=act, backend=cfg.enc_backend,
                          ring=ring, keys=keys)
            st = {**st, "mule_models": apply_activity_mask(
                act, new, st["mule_models"])}
        return st

    return step


def _fused_models(a_loc: torch.Tensor, flat: torch.Tensor,
                  backend: str) -> torch.Tensor:
    """``a_loc [F, M_loc] @ flat [M_loc, D]``, the model columns of the
    fused reduce: the ``mule_agg`` kernel (``"auto"``, through the custom
    op, so a seed sweep's lanes launch it once; any non-negative A) or the
    plain matmul (``"ref"``)."""
    if backend == "auto":
        return mule_agg_op(a_loc.contiguous(), flat)
    if backend == "ref":
        return a_loc @ flat
    raise ValueError(f"unknown aggregation backend {backend!r}; expected "
                     "'auto' or 'ref'")


def _space_exchange_distributed(train_fn: Callable, dcfg, mesh) -> Callable:
    """The ML Mule cycle with every reduction of the step in one collective.

    The model sums of every fixed device, the receipt counts and the
    freshness statistic (the sketch's histogram and delivery counts, or
    the age moments) go into the columns of one ``[F, D+1+B+1]`` payload,
    summed over the ranks by one ``ordered_psum``. The model columns come
    from ``mule_agg`` on the rank's flattened block (``_fused_models``), the
    count and statistic columns from a small plain product.
    """
    from repro_torch.core.distributed import _tree_mix, ordered_psum
    cfg = dcfg.pop
    fcfg = cfg.freshness
    axes = ((dcfg.pod_axis, dcfg.data_axis) if dcfg.pod_axis
            else (dcfg.data_axis,))
    reduce_axes = axes if dcfg.cross_pod else (dcfg.data_axis,)
    if fcfg.stat not in ("median", "meanstd"):
        raise ValueError(f"unknown freshness stat {fcfg.stat!r}; expected "
                         "'median' or 'meanstd'")

    def step(st, info, batches, key):
        t = st["t"]
        fid = info["fixed_id"]
        dev = fid.device
        m_loc = fid.shape[0]
        deliver = info["exchange"] & (fid >= 0)
        if info.get("active") is not None:
            # churn folds into the delivery mask, so an inactive mule is in
            # no column of the payload
            deliver = deliver & info["active"]
        ages = t - st["mule_ts"]
        fresh = st["fresh"]
        fc = fid.clamp(min=0).long()
        thr = fresh["threshold"][fc]
        if fcfg.stat == "median":
            warm = fresh["count"][fc] < fcfg.warmup
            fresh_ok = deliver & (warm | (ages <= thr))
        else:
            # meanstd keeps no receipt counts, so warmup does not apply
            fresh_ok = deliver & (ages <= thr)

        # -- the fused reduce and its one collective -----------------------
        onehot = (fc[None, :] == torch.arange(cfg.n_fixed, device=dev)
                  [:, None]).float()                              # [F, M_loc]
        a_loc = onehot * fresh_ok[None, :].float()
        flat, spec = flatten_population(st["mule_models"])
        cols = [_fused_models(a_loc, flat, cfg.agg_backend),
                a_loc.sum(1, keepdim=True)]                       # | counts
        if fcfg.stat == "meanstd":
            cols.append(a_loc @ torch.stack([ages, ages ** 2], dim=1))
        else:
            d_loc = onehot * deliver[None, :].float()
            bins = age_bin_onehot(ages, fcfg)                     # [M_loc, B]
            cols.append(d_loc @ torch.cat(
                [bins, torch.ones((m_loc, 1), device=dev)], dim=1))
        fused = ordered_psum(torch.cat(cols, dim=1), mesh, reduce_axes)

        keys_, shapes, dtypes = spec
        d_total = sum(math.prod(s) for s in shapes)
        counts = fused[:, d_total]
        has = (counts > 0).float()
        norm = fused[:, :d_total] / torch.clamp(counts, min=1.0)[:, None]
        agg, off = {}, 0
        for k, s, dt in zip(keys_, shapes, dtypes):
            n = math.prod(s)
            agg[k] = norm[:, off:off + n].reshape((cfg.n_fixed,) + s).to(dt)
            off += n
        gamma = (cfg.gamma / (1.0 + cfg.prox_mu)
                 if cfg.aggregation == "prox" else cfg.gamma)
        fixed_models = _tree_mix(st["fixed_models"], agg, gamma * has)

        # -- freshness threshold ---------------------------------------------
        if fcfg.stat == "median":
            # every delivered age is pushed, accepted or not. Under
            # cross_pod each pod adds its copy of the mules, so the
            # histogram and counts are divided back by the pod count
            n_rep = (mesh.shape[dcfg.pod_axis]
                     if dcfg.pod_axis and dcfg.cross_pod else 1)
            step_hist = fused[:, d_total + 1:-1] / n_rep
            step_cnt = fused[:, -1] / n_rep
            fresh = sketch_push_and_update(fresh, step_hist, step_cnt, fcfg)
        else:
            age_sum, age_sq = fused[:, -2], fused[:, -1]
            mean_age = age_sum / torch.clamp(counts, min=1.0)
            var_age = torch.clamp(
                age_sq / torch.clamp(counts, min=1.0) - mean_age ** 2,
                min=0.0)
            target = mean_age + fcfg.beta * torch.sqrt(var_age)
            fresh = {"threshold": torch.where(
                counts > 0,
                (1 - fcfg.alpha) * fresh["threshold"] + fcfg.alpha * target,
                fresh["threshold"])}

        # -- training and send-back -------------------------------------------
        if cfg.mode == "fixed":
            keys = split(key, cfg.n_fixed, dev)
            trained = torch.func.vmap(train_fn)(fixed_models,
                                                batches["fixed"], keys)
            fixed_models = _tree_mix(fixed_models, trained, has)
        per_mule_fixed = {k: v[fc] for k, v in fixed_models.items()}
        mule_models = _tree_mix(st["mule_models"], per_mule_fixed,
                                cfg.gamma * deliver.float())
        if cfg.mode == "mobile":
            mb = tree_map(lambda l: _local_block(mesh, dcfg, l, m_loc),
                          batches["mule"])
            keys = _mule_train_keys(mesh, dcfg, key, m_loc, dev)
            trained = torch.func.vmap(train_fn)(mule_models, mb, keys)
            mule_models = _tree_mix(mule_models, trained, deliver.float())

        return {
            "mule_models": mule_models,
            "fixed_models": fixed_models,
            "mule_ts": torch.where(deliver, t, st["mule_ts"]),
            "fresh": fresh,
            "t": t + 1.0,
        }

    return step
