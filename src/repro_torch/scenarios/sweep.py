"""Seed sweeps: S seeds of a method replayed as one run of S lanes.

The paper's headline results (Figs 6-9) are seed-averaged curves. The
reference vmaps its compiled replay over a stacked seed axis; here
``run_sweep`` applies ``torch.func.vmap`` to the engine's own step
(``core.method_program.compile_step``, unchanged) at every step, over
lane-stacked ``[S, ...]`` states, schedule rows, batches and seeds. The two
kernels of the step are custom ops with vmap rules
(``kernels.mule_agg.ops.mule_agg_op``,
``kernels.encounter_mix.ops.encounter_mix_op``), so a step launches
``mule_agg`` and ``encounter_mix`` once for all S lanes, through their
lane-batched entries; the rest of the step runs as batched PyTorch ops.

What stays per lane, on the host, so that lane ``i`` sees the seeds of the
sequential ``run_population`` with key ``keys[i]``:

- the seeds: step ``t`` of lane ``i`` folds ``k = fold_in(keys[i], t)`` as
  ``run_population`` does, and the vmapped step gets each lane's training
  seed as one int64 tensor ``[S]`` (``core.seeds`` folds int64 tensors to
  the same bits);
- a callable ``batches(seed, t[, context])`` is called once per lane with
  that lane's seed and ``context`` slice, and the lanes are stacked;
- ``eval_fn(state, last_fid[, context])`` runs per lane on its slice.

The step index ``t`` is shared by every lane and stays a Python int (the
peer cadence ``t % 3`` is a Python test). Methods run one after another,
each over all lanes.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core.method_program import compile_step, get_program
from repro_torch.core.population import PopulationConfig, TrainFn
from repro_torch.core.seeds import fold_in
from repro_torch.device import resolve_device
from repro_torch.scenarios.engine import (_check_state_on, _colocation_tensors,
                                          _tree_map, _tree_stack)

SweepResult = Tuple[Dict[str, Any], Dict[str, Any]]
_KEYS = ("fixed_id", "exchange", "pos", "area", "active")


def stack_trees(trees: Sequence[Any]) -> Any:
    """Stack same-structure trees of tensors (dicts, tuples, lists; ``None``
    leaves stay ``None``) along a new leading axis."""
    return _tree_stack(list(trees))


def stack_colocations(cos: Sequence[Dict[str, Any]], device="cuda"
                      ) -> Dict[str, torch.Tensor]:
    """Stack per-seed colocation dicts into ``[S, T, M]`` tensors on
    ``device`` (``pos`` ``[S, T, M, 2]``, ``area`` ``[S, M]`` or
    ``[S, T, M]``). Seeds without an ``"active"`` mask stack as all-ones
    lanes, so dense and churned seeds can share a sweep."""
    dev = resolve_device(device)
    per = [_colocation_tensors(co, dev) for co in cos]
    return {k: torch.stack([p[i] for p in per]) for i, k in enumerate(_KEYS)}


def _lane_schedule(colocations: Dict[str, Any], n_lanes: int,
                   dev: torch.device) -> Tuple[torch.Tensor, ...]:
    """(fid, exch, pos, area, act) with a leading lane axis: a stacked
    schedule as it is, a shared ``[T, M]`` one broadcast to every lane."""
    tensors = _colocation_tensors(colocations, dev)
    if tensors[0].dim() == 2:
        return tuple(x.expand((n_lanes,) + x.shape) for x in tensors)
    if tensors[0].shape[0] != n_lanes:
        raise ValueError(f"the schedule has {tensors[0].shape[0]} lanes, "
                         f"keys {n_lanes}")
    return tensors


def _lane(tree: Any, i: int) -> Any:
    return _tree_map(lambda l: l[i], tree)


def _step_at(step_fn: Callable, t: int, st, info, batches, key):
    """The engine's step at the shared step index ``t`` (one lane)."""
    return step_fn(st, {**info, "t": t}, batches, key)


def _sweep(make_step: Callable, states: Dict[str, Any], schedule,
           batches: Any, keys: Sequence[int], *, eval_every, eval_fn,
           methods, context, dev: torch.device):
    """The walk of ``run_sweep`` and ``run_sweep_distributed``: each step
    ``torch.func.vmap`` of ``make_step(method)``'s step over the lanes of
    the state, the schedule ``(fid, exch, pos, area, act)`` [S, T, m, ...],
    the batches and the seeds."""
    n_lanes = len(keys)
    fid, exch, pos, area, act = schedule
    n_steps, n_mules = fid.shape[1], fid.shape[2]
    dynamic = callable(batches)
    n_ev = n_steps // eval_every if (eval_fn is not None and eval_every) else 0
    eval_steps = ((np.arange(n_ev) + 1) * eval_every - 1 if n_ev else
                  np.zeros((0,), int))
    lane_ctx = [None if context is None else _lane(context, i)
                for i in range(n_lanes)]

    def lane_batches(kb, t, i):
        return (batches(kb, t) if context is None else
                batches(kb, t, lane_ctx[i]))

    def lane_eval(state, last, i):
        st = _lane(state, i)
        return (eval_fn(st, last[i]) if context is None else
                eval_fn(st, last[i], lane_ctx[i]))

    def one(method: str) -> SweepResult:
        step_fn = make_step(method)
        state = states
        last = torch.zeros((n_lanes, n_mules), dtype=torch.int64, device=dev)
        evals = [[] for _ in range(n_lanes)]
        for t in range(n_steps):
            k_t = [fold_in(k, t) for k in keys]
            if dynamic:
                bt = stack_trees([lane_batches(fold_in(k, 0), t, i)
                                  for i, k in enumerate(k_t)])
                ks = [fold_in(k, 1) for k in k_t]
            else:
                bt, ks = _tree_map(lambda l: l[:, t], batches), k_t
            info = {"fixed_id": fid[:, t], "exchange": exch[:, t],
                    "pos": pos[:, t],
                    "area": area[:, t] if area.dim() == 3 else area,
                    "active": act[:, t]}
            state = torch.func.vmap(
                functools.partial(_step_at, step_fn, t),
                in_dims=(0, 0, _tree_map(lambda _: 0, bt), 0))(
                state, info, bt,
                torch.tensor(ks, dtype=torch.int64, device=dev))
            last = torch.where((fid[:, t] >= 0) & act[:, t], fid[:, t], last)
            if n_ev and t < n_ev * eval_every and (t + 1) % eval_every == 0:
                for i in range(n_lanes):
                    evals[i].append(lane_eval(state, last, i))
        return state, {"last_fid": last, "eval_steps": eval_steps,
                       "evals": (stack_trees([stack_trees(e) for e in evals])
                                 if n_ev else None)}

    if isinstance(methods, str):
        return one(methods)
    return {m: one(m) for m in methods}


def _keys(keys) -> list:
    return [int(k) for k in (keys.tolist() if isinstance(keys, torch.Tensor)
                             else keys)]


def run_sweep(states: Dict[str, Any], colocations: Dict[str, Any],
              batches: Any, train_fn: TrainFn, cfg: PopulationConfig,
              keys: Sequence[int], *, eval_every: Optional[int] = None,
              eval_fn: Optional[Callable] = None,
              methods: Union[str, Sequence[str]] = "mlmule",
              context: Any = None, device="cuda"
              ) -> Union[SweepResult, Dict[str, SweepResult]]:
    """Replay S seeds (x several methods), the lanes vmapped step by step.

    states:      population states stacked ``[S, ...]`` (``stack_trees``
                 over per-seed ``init_population`` results) on ``device``.
    colocations: a schedule stacked ``[S, T, M]`` (``stack_colocations``),
                 or one ``[T, M]`` schedule shared by every seed.
    batches:     callable ``(seed, t[, context]) -> batches-dict``, called
                 per lane, or a tree of stacked ``[S, T, ...]`` tensors.
    keys:        one integer key per lane (a sequence or an int tensor).
    context:     optional tree stacked ``[S, ...]``: lane ``i``'s slice goes
                 to ``batches`` and ``eval_fn`` as a trailing argument.
    methods:     one of ``METHODS_MOBILE``, or a sequence of them.

    Returns ``(final_states, aux)`` with a leading ``[S]`` axis on every
    tensor, ``aux = {"last_fid": [S, M], "eval_steps": np [E], "evals":
    [S, E, ...] or None}``; for a sequence of methods a ``{method:
    (final_states, aux)}`` dict. Lane ``i`` replays what ``run_population``
    with key ``keys[i]`` and lane ``i``'s inputs replays.
    """
    dev = resolve_device(device)
    _check_state_on(states, dev)
    keys = _keys(keys)
    schedule = _lane_schedule(colocations, len(keys), dev)
    return _sweep(lambda m: compile_step(get_program(m), train_fn, cfg),
                  states, schedule, batches, keys, eval_every=eval_every,
                  eval_fn=eval_fn, methods=methods, context=context, dev=dev)


def run_sweep_distributed(states: Dict[str, Any],
                          colocations: Dict[str, Any], batches: Any,
                          train_fn: TrainFn, dcfg, mesh, keys: Sequence[int],
                          *, eval_every: Optional[int] = None,
                          eval_fn: Optional[Callable] = None,
                          methods: Union[str, Sequence[str]] = "mlmule",
                          context: Any = None, device="cuda"
                          ) -> Union[SweepResult, Dict[str, SweepResult]]:
    """``run_sweep`` on the mule-sharded engine, in every rank of the world.

    The stacking contract of ``run_sweep`` (a leading ``[S]`` seed axis on
    states, schedule, stacked batches, keys and context), with ``dcfg`` and
    ``mesh`` of ``run_population_distributed``; the states follow the
    ``to_distributed_state`` layout, stacked, the whole population on every
    rank. Each rank takes its block of the mule axis (axis 1 of a state's
    ``mule*`` entries, the schedule's last axis, axis 2 of the ``"mule"``
    leaves of stacked batches), and every step vmaps the rank-local step
    (``make_distributed_method_step``) over the lanes: the seed lanes run
    inside each rank's block. The step's collectives and kernels are custom
    ops whose vmap rules move all lanes at once: one ``ordered_psum`` a
    ``mlmule`` step, one transfer a tensor a ring hop (the hops any lane
    needs), one ``mule_agg`` and one ``encounter_hop`` launch for every
    lane. The collectives, the aggregation and the hops give each lane
    the bits of the ``i``-th sequential ``run_population_distributed``
    call; so does training on the CPU, where lane ``i`` is bitwise that
    call. On a CUDA card ``train_fn`` vmapped over lanes and mules runs
    other kernels than over mules alone (convolutions with S times the
    groups, batched products), and each lane's training rounds apart
    from its sequential run's, with cuDNN and without. ``methods``: any of the five
    ``METHODS_MOBILE``.

    The sweep does not re-bucket (``dcfg.rebucket_every`` must be 0): the
    lanes share one layout of the ranks.

    Returns ``run_sweep``'s results, every mule array the rank's block
    (``last_fid`` ``[S, m_loc]``; ``launch.multiprocess.gather_global``
    along axis 1 assembles the population).
    """
    from repro_torch.core.distributed import make_distributed_method_step
    from repro_torch.launch.multiprocess import put_global, put_global_tree
    from repro_torch.scenarios.engine import (_auto_mesh,
                                              _check_mule_sharding,
                                              _resolve_ring_bits)
    if dcfg.rebucket_every > 0:
        raise ValueError(
            f"run_sweep_distributed does not re-bucket (rebucket_every="
            f"{dcfg.rebucket_every}): the lanes share one layout of the ranks")
    dev = resolve_device(device)
    _check_state_on(states, dev)
    keys = _keys(keys)
    fid, exch, pos, area, act = _lane_schedule(colocations, len(keys), dev)
    n_mules = fid.shape[2]
    first = methods if isinstance(methods, str) else methods[0]
    dcfg = _resolve_ring_bits(dcfg, int(area.max()) if area.numel() else 0)
    if mesh is None:
        mesh = _auto_mesh(first, n_mules, dcfg)
    _check_mule_sharding(n_mules, mesh, dcfg)
    ax = dcfg.data_axis
    states = put_global_tree(
        states, mesh, {k: (1 if k.startswith("mule") else None)
                       for k in states}, ax)
    if not callable(batches):
        batches = put_global_tree(
            batches, mesh, {k: (2 if k == "mule" else None)
                            for k in batches}, ax)
    schedule = (put_global(fid, mesh, 2, ax), put_global(exch, mesh, 2, ax),
                put_global(pos, mesh, 2, ax),
                put_global(area, mesh, area.dim() - 1, ax),
                put_global(act, mesh, 2, ax))
    return _sweep(lambda m: make_distributed_method_step(m, train_fn, dcfg,
                                                         mesh),
                  states, schedule, batches, keys, eval_every=eval_every,
                  eval_fn=eval_fn, methods=methods, context=context, dev=dev)
