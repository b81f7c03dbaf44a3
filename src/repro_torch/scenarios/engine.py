"""Scenario engine: replay one method over a precomputed co-location schedule.

``run_population`` walks the ``[T, M]`` schedule step by step (the
reference compiles the same walk into one ``lax.scan``), running the
method's step from the ``repro_torch.core.method_program`` table and, every
``eval_every`` steps, an evaluation hook. PyTorch runs eagerly, so the walk
is a Python loop; every step stays on the device and the loop reads nothing
back to the host.

Seed discipline (the counterpart of the reference's key discipline):

- step ``t`` uses ``k_t = fold_in(key, t)``;
- if ``batches`` is a callable ``(seed, t[, context]) -> batches-dict``, the
  step calls it with ``fold_in(k_t, 0)`` and trains with ``fold_in(k_t, 1)``;
- if ``batches`` is a pytree of stacked ``[T, ...]`` tensors, step ``t``
  consumes slice ``t`` and trains with ``k_t``.

Population churn: an optional ``"active"`` ``[T, M]`` bool mask in the
colocation dict switches mules off per step; an inactive mule neither
trains nor exchanges, and records no ``last_fid`` visit. The ``"area"``
column is ``[M]``, or ``[T, M]`` when mules migrate between areas; step
``t`` hands the method its current row as ``info["area"]``.

Streamed replay: ``run_population_streamed`` takes a chunk generator
(``repro_torch.mobility.streaming``) in place of the ``[T, M]`` schedule
and expands ``chunk_len`` steps at a time on the device, so the schedule
costs O(chunk * M) whatever the horizon. Both engines walk a window of the
schedule with the same ``_walk`` and key every step off its global index,
so a streamed replay is bitwise ``run_population`` over
``materialize_generator(generator)``, chunk boundaries included.

Distributed replay: ``run_population_distributed`` runs inside every rank
of a ``torch.distributed`` world (SPMD). Each rank keeps its block of the
mules (``launch.mesh.make_mule_mesh``'s data axis) and replays the rank-local
step of ``core.distributed.make_distributed_method_step``; the replicated
state stays bitwise equal on every rank. With ``dcfg`` the streamed engine
is distributed too: each rank expands only its own mule columns, and with
``dcfg.rebucket_every`` it re-buckets the population between chunks.
Entry points take the global state, schedule and batches on every rank
and return the rank's block of every mule array (``gather_global``
assembles the population).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.method_program import compile_step, get_program
from repro_torch.core.population import PopulationConfig, TrainFn
from repro_torch.core.seeds import fold_in
from repro_torch.device import resolve_device
from repro_torch.launch.multiprocess import (gather_global, host_replicated,
                                             put_global)


def _on(x, dtype, dev: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(dev, dtype)
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)


def _colocation_tensors(colocation: Dict[str, Any], dev: torch.device):
    """Normalize a colocation dict to (fid, exch, pos, area, act) tensors.

    ``act`` defaults to all-ones (the dense population), ``pos`` and
    ``area`` (one per mule) to zeros. A lane-stacked ``[S, T, M]`` schedule
    gets the same defaults for each lane.
    """
    fid = _on(colocation["fixed_id"], torch.int64, dev)
    exch = _on(colocation["exchange"], torch.bool, dev)
    pos = colocation.get("pos")
    pos = (torch.zeros(fid.shape + (2,), device=dev) if pos is None
           else _on(pos, torch.float32, dev))
    area = colocation.get("area")
    area = (torch.zeros(fid.shape[:-2] + fid.shape[-1:], dtype=torch.int64,
                        device=dev)
            if area is None else _on(area, torch.int64, dev))
    act = colocation.get("active")
    act = (torch.ones(fid.shape, dtype=torch.bool, device=dev) if act is None
           else _on(act, torch.bool, dev))
    return fid, exch, pos, area, act


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return None if tree is None else fn(tree)


def _tree_stack(trees):
    first = trees[0]
    if first is None:
        return None
    if isinstance(first, dict):
        return {k: _tree_stack([t[k] for t in trees]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(_tree_stack(list(xs)) for xs in zip(*trees))
    return torch.stack(trees)


def _check_state_on(state: Dict[str, Any], dev: torch.device) -> None:
    wrong = []
    _tree_map(lambda x: wrong.append(x.device)
              if x.device.type != dev.type else None, state)
    if wrong:
        raise ValueError(f"population state lies on {wrong[0]}, the run on "
                         f"{dev}; build it with init_population(..., "
                         f"device={str(dev)!r})")


def _eval_count(n_steps: int, eval_every: Optional[int],
                eval_fn: Optional[Callable]) -> int:
    return n_steps // eval_every if (eval_fn is not None and eval_every) \
        else 0


def _walk(state, last, window, t0: int, batches, step_fn, key, *, n_ev: int,
          eval_every: Optional[int], eval_fn: Optional[Callable],
          context: Any, evals: list):
    """Steps ``t0 .. t0 + c`` of a schedule window ``window = (fid, exch,
    pos, area, act)``, each ``[c, ...]`` (``area`` [n] or [c, n]); global
    step indices key every draw, and an eval after global step ``t`` with
    ``(t + 1) % eval_every == 0`` is appended to ``evals``. Returns
    ``(state, last)``."""
    fid, exch, pos, area, act = window
    dynamic = callable(batches)
    for i in range(fid.shape[0]):
        t = t0 + i
        k_t = fold_in(key, t)
        if dynamic:
            kb, ks = fold_in(k_t, 0), fold_in(k_t, 1)
            bt = (batches(kb, t) if context is None else
                  batches(kb, t, context))
        else:
            bt, ks = _tree_map(lambda l: l[t], batches), k_t
        state = step_fn(state, {
            "fixed_id": fid[i], "exchange": exch[i], "pos": pos[i],
            "area": area[i] if area.dim() == 2 else area,
            "active": act[i], "t": t}, bt, ks)
        last = torch.where((fid[i] >= 0) & act[i], fid[i], last)
        if n_ev and t < n_ev * eval_every and (t + 1) % eval_every == 0:
            evals.append(eval_fn(state, last) if context is None else
                         eval_fn(state, last, context))
    return state, last


def _aux(last, n_steps: int, n_ev: int, eval_every, evals: list) -> dict:
    steps = (np.arange(n_ev) + 1) * eval_every - 1 if n_ev else \
        np.zeros((0,), int)
    return {"last_fid": last, "eval_steps": steps,
            "evals": _tree_stack(evals) if evals else None}


def run_population(state: Dict[str, Any], colocation: Dict[str, Any],
                   batches: Any, train_fn: TrainFn, cfg: PopulationConfig,
                   key: int, *, eval_every: Optional[int] = None,
                   eval_fn: Optional[Callable] = None,
                   method: str = "mlmule", context: Any = None,
                   device="cuda") -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Replay one method over a precomputed co-location schedule.

    state:      population state from ``init_population`` on ``device``.
    colocation: {"fixed_id": [T, M] int (-1 = corridor),
                 "exchange": [T, M] bool}; optional "pos" [T, M, 2],
                 "area" [M] or [T, M], and "active" [T, M] bool churn mask
                 (numpy arrays or tensors; moved to ``device``).
    batches:    callable ``(seed, t[, context]) -> {"fixed": ..., "mule":
                ...}``, or a pytree of stacked ``[T, ...]`` tensors on
                ``device``.
    key:        integer seed of the run.
    method:     any of ``METHODS_MOBILE``: ``"mlmule"``, ``"gossip"``,
                ``"oppcl"``, ``"local"`` or ``"mlmule+gossip"`` (see
                ``method_program``). The peer-encounter methods read "pos"
                and "area" and fire at ``t % 3 == 2``.
    eval_fn:    optional ``(state, last_fid [M][, context]) -> metric`` run
                after every ``eval_every`` steps (``last_fid`` is each
                mule's most recent fixed device, 0 before any visit). A
                trailing partial chunk of fewer than ``eval_every`` steps
                runs unevaluated.
    context:    optional data handed to ``batches`` and ``eval_fn`` as a
                trailing argument (under ``run_sweep``, each seed's own);
                without it both take their two-argument forms.

    Returns ``(final_state, aux)`` with
    ``aux = {"last_fid": [M], "eval_steps": np [E], "evals": stacked/None}``
    where eval ``i`` is taken after step ``(i+1)*eval_every - 1``.
    """
    dev = resolve_device(device)
    _check_state_on(state, dev)
    window = _colocation_tensors(colocation, dev)
    n_steps, n_mules = window[0].shape
    step_fn = compile_step(get_program(method), train_fn, cfg)
    n_ev = _eval_count(n_steps, eval_every, eval_fn)
    last = torch.zeros((n_mules,), dtype=torch.int64, device=dev)
    evals: list = []
    state, last = _walk(state, last, window, 0, batches, step_fn, key,
                        n_ev=n_ev, eval_every=eval_every, eval_fn=eval_fn,
                        context=context, evals=evals)
    return state, _aux(last, n_steps, n_ev, eval_every, evals)


# ---------------------------------------------------------------------------
# the streamed replay
# ---------------------------------------------------------------------------


def _window(co: Dict[str, Any], dev: torch.device):
    """A generator's chunk as the engine's (fid, exch, pos, area, act)."""
    return (co["fixed_id"].to(dev, torch.int64), co["exchange"].to(dev),
            co["pos"].to(dev, torch.float32),
            co["area"].to(dev, torch.int64), co["active"].to(dev))


def _mule_axes(state: Dict[str, Any]) -> Dict[str, Any]:
    """put_global_tree's axes of a population state: every ``mule*``
    entry runs over the mules along axis 0, the rest is replicated."""
    return {k: (0 if k.startswith("mule") else None) for k in state}


def _batch_axes(batches: Any) -> Any:
    """Stacked [T, ...] batches: the ``"mule"`` leaves run over the mules
    along axis 1."""
    return {k: (1 if k == "mule" else None) for k in batches}


def _on_ranks(state, batches, train_fn, dcfg, mesh, method: str,
              n_mules: int, max_area: int):
    """The distributed engines' set-up on this rank: the ring's width, the
    mesh (``_auto_mesh`` when None), this rank's block of the state's and
    stacked batches' mule rows, and the rank-local step. Returns ``(dcfg,
    mesh, state, batches, step_fn)``."""
    from repro_torch.core.distributed import make_distributed_method_step
    from repro_torch.launch.multiprocess import put_global_tree
    dcfg = _resolve_ring_bits(dcfg, max_area)
    if mesh is None:
        mesh = _auto_mesh(method, n_mules, dcfg)
    _check_mule_sharding(n_mules, mesh, dcfg)
    ax = dcfg.data_axis
    state = put_global_tree(state, mesh, _mule_axes(state), ax)
    if not callable(batches):
        batches = put_global_tree(batches, mesh, _batch_axes(batches), ax)
    return dcfg, mesh, state, batches, make_distributed_method_step(
        method, train_fn, dcfg, mesh)


def _permuted(x: torch.Tensor, order: torch.Tensor, axis: int, mesh,
              axis_name: str) -> torch.Tensor:
    """This rank's block of the population-wide ``x`` put in ``order``
    along ``axis``: every block gathered, reordered, this rank's taken."""
    full = gather_global(x, mesh, axis, axis_name)
    return put_global(full.index_select(axis, order.to(full.device)), mesh,
                      axis, axis_name)


def run_population_streamed(state: Dict[str, Any], generator, batches: Any,
                            train_fn: TrainFn, cfg: PopulationConfig,
                            key: int, *, n_steps: Optional[int] = None,
                            chunk_len: int = 64,
                            eval_every: Optional[int] = None,
                            eval_fn: Optional[Callable] = None,
                            method: str = "mlmule", context: Any = None,
                            mesh=None, dcfg=None, device="cuda"
                            ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """``run_population`` with the schedule generated chunk by chunk.

    generator: a chunk generator (``repro_torch.mobility.streaming``):
               ``compact_colocation(...)`` streams any scenario's schedule
               from per-mule run-length segments, ``commuter_stream(...)``
               is procedural (O(M) memory at any horizon). The schedule
               costs O(chunk_len * M) plus the generator's arrays.
    n_steps:   the horizon; ``generator.n_steps`` by default.
    chunk_len: steps expanded at a time. A multiple of ``eval_every`` when
               ``eval_fn`` is set, so evals land on the materialized
               engine's steps.
    mesh/dcfg: run on the ranks of ``mesh`` (``launch.mesh.make_mule_mesh``;
               with ``mesh=None`` ``_auto_mesh`` picks one) with the
               ``DistributedConfig`` ``dcfg``, whose ``pop`` replaces
               ``cfg``: each rank slices the generator's mule arrays to its
               own block and expands only its own columns, so no rank ever
               holds the population's schedule. ``state`` is then the
               ``to_distributed_state`` layout, and the run returns the
               rank's block of every mule array.

    Mid-run re-bucketing (``dcfg.rebucket_every > 0``, a multiple of
    ``chunk_len`` so that it falls between chunks): every
    ``rebucket_every`` steps the share of mules whose area at the chunk's
    end differs from their bucket's is read through ``ordered_pmean``, the
    same on every rank. Past ``dcfg.rebucket_threshold`` the ranks put the
    population in a new bucket order (``global_bucket_order``) and move
    every ``mule*`` entry of the state, ``last_fid``, the generator's mule
    arrays and stacked mule batches to it, so the ring's hop pruning keeps
    working as the mules migrate. ``aux["rebucket"]`` is ``{"checks",
    "swaps", "drift", "order"}``; ``order`` is the cumulative permutation:
    entry ``p`` is the original index of the mule now in slot ``p``. A
    swap renumbers the slots, so batches and per-mule seeds follow the
    slot, as bucketing at build time does; the trigger reads the area
    schedule alone, so it never depends on pruning or on the models.

    Everything else (batches, evals, methods, context, the returned
    ``(final_state, aux)``) is ``run_population``'s, and so are the results:
    bitwise those over ``materialize_generator(generator)``.
    """
    if mesh is not None and dcfg is None:
        raise ValueError("run_population_streamed: mesh requires dcfg")
    pcfg = dcfg.pop if dcfg is not None else cfg
    n_steps = int(generator.n_steps if n_steps is None else n_steps)
    n_mules = int(generator.n_mules)
    if chunk_len <= 0:
        raise ValueError(f"chunk_len={chunk_len} must be positive")
    if eval_fn is not None and eval_every and chunk_len % eval_every:
        raise ValueError(
            f"chunk_len={chunk_len} must be a multiple of "
            f"eval_every={eval_every} so streamed evals land on the same "
            f"global steps as the materialized engine")
    rb = int(dcfg.rebucket_every) if dcfg is not None else 0
    if rb > 0 and rb % chunk_len:
        raise ValueError(
            f"rebucket_every={rb} must be a multiple of "
            f"chunk_len={chunk_len} so re-bucketing lands on chunk "
            "boundaries (the streamed engine swaps state between chunks)")
    dev = resolve_device(device)
    _check_state_on(state, dev)
    gen_arrays = {k: v.to(dev) for k, v in generator.arrays().items()}
    specs = generator.specs()
    if dcfg is not None:
        dcfg, mesh, state, batches, step_fn = _on_ranks(
            state, batches, train_fn, dcfg, mesh, method, n_mules,
            getattr(generator, "max_area", 0))
        ax = dcfg.data_axis
        gen_arrays = {k: (v if specs[k] is None else
                          put_global(v, mesh, specs[k], ax))
                      for k, v in gen_arrays.items()}
        m_loc = n_mules // mesh.shape[ax]
    else:
        step_fn = compile_step(get_program(method), train_fn, pcfg)
        m_loc = n_mules
    n_ev = _eval_count(n_steps, eval_every, eval_fn)
    last = torch.zeros((m_loc,), dtype=torch.int64, device=dev)
    evals: list = []
    rb_aux = None
    if rb > 0:
        from repro_torch.core.distributed import (global_bucket_order,
                                                  ordered_pmean)
        from repro_torch.mobility.streaming import reorder_generator_arrays
        a0 = generator.expand(gen_arrays, None, 0, 1)["area"]
        bucket_area = (a0[0] if a0.dim() == 2 else a0).to(torch.int64)
        threshold = float(dcfg.rebucket_threshold)
        rb_aux = {"checks": 0, "swaps": 0, "drift": [],
                  "order": np.arange(n_mules)}
    for t0 in range(0, n_steps, chunk_len):
        cl = min(chunk_len, n_steps - t0)
        window = _window(generator.expand(gen_arrays, None, t0, cl), dev)
        state, last = _walk(state, last, window, t0, batches, step_fn, key,
                            n_ev=n_ev, eval_every=eval_every,
                            eval_fn=eval_fn, context=context, evals=evals)
        t_end = t0 + cl
        if not (rb > 0 and t_end % rb == 0 and t_end < n_steps):
            continue
        area = window[3]
        area_end = area[-1] if area.dim() == 2 else area
        drift = ordered_pmean((area_end != bucket_area).float().mean()
                              .reshape(1), mesh, dcfg.data_axis)
        d = float(host_replicated(drift)[0])
        rb_aux["checks"] += 1
        rb_aux["drift"].append(d)
        if d <= threshold:
            continue
        order, area_now = global_bucket_order(area_end, mesh,
                                              dcfg.data_axis)
        if not torch.equal(order.cpu(), torch.arange(n_mules)):
            ax = dcfg.data_axis
            state = {k: (_permuted_rows(v, order, mesh, ax)
                         if k.startswith("mule") and v is not None else v)
                     for k, v in state.items()}
            last = _permuted(last, order, 0, mesh, ax)
            full_arrays = {k: (v if specs[k] is None else
                               gather_global(v, mesh, specs[k], ax))
                           for k, v in gen_arrays.items()}
            gen_arrays = {k: (v if specs[k] is None else
                              put_global(v, mesh, specs[k], ax))
                          for k, v in reorder_generator_arrays(
                              generator, full_arrays, order.cpu()).items()}
            if not callable(batches):
                batches = {k: (_tree_map(lambda l: _permuted(
                    l, order, 1, mesh, ax), v) if k == "mule" else v)
                    for k, v in batches.items()}
            rb_aux["order"] = rb_aux["order"][order.cpu().numpy()]
            rb_aux["swaps"] += 1
        # the current areas in the (new) layout: the next check's baseline
        bucket_area = put_global(area_now.to(torch.int64)[order], mesh, 0,
                                 dcfg.data_axis)
    aux = _aux(last, n_steps, n_ev, eval_every, evals)
    if rb_aux is not None:
        aux["rebucket"] = rb_aux
    return state, aux


def _permuted_rows(tree: Any, order: torch.Tensor, mesh, axis_name: str):
    """Every tensor of ``tree`` (this rank's rows) put in the population's
    ``order`` across the ranks."""
    return _tree_map(lambda l: _permuted(l, order, 0, mesh, axis_name), tree)


# ---------------------------------------------------------------------------
# the distributed replay
# ---------------------------------------------------------------------------


def _resolve_ring_bits(dcfg, max_area: int):
    """The ring's bitmask width when ``dcfg.ring_bits`` is 0 (auto): 32,
    or 64 once an area id reaches 32 (a 32-bit mask folds areas % 32 and
    quietly stops pruning). Pruning is exact, so the width moves the prune
    rate, never the results."""
    import dataclasses
    if dcfg.ring_bits:
        return dcfg
    return dataclasses.replace(dcfg,
                               ring_bits=64 if int(max_area) >= 32 else 32)


def _check_mule_sharding(n_mules: int, mesh, dcfg) -> None:
    shards = mesh.shape[dcfg.data_axis]
    if n_mules % shards:
        raise ValueError(
            f"n_mules={n_mules} must divide evenly over the "
            f"{dcfg.data_axis!r} mesh axis (size {shards})")


def _auto_mesh(method: str, n_mules: int, dcfg):
    """The mesh of ``run_population_distributed(mesh=None)``.

    The widest data axis that divides both ``n_mules`` and the world size,
    the remaining ranks as pods (which hold copies of the blocks). The
    reference first consults a roofline-ranked suggestion from its
    autotune cache (``suggest_mesh_shape``); the port has no autotune yet
    (ROADMAP item 15), so this is its fallback rule alone. Every rank must
    sit in the mesh, so a world that needs pods needs ``dcfg.pod_axis``.
    """
    from repro_torch.launch.mesh import make_mule_mesh
    import torch.distributed as dist
    world = dist.get_world_size() if dist.is_initialized() else 1
    data = max(d for d in range(1, world + 1)
               if n_mules % d == 0 and world % d == 0)
    pod = world // data
    if pod > 1 and not dcfg.pod_axis:
        raise ValueError(f"n_mules={n_mules} over {world} ranks needs "
                         f"{pod} pods, and the config has no pod axis")
    return make_mule_mesh(pod, data, pod_axis=dcfg.pod_axis,
                          data_axis=dcfg.data_axis)


def run_population_distributed(state: Dict[str, Any],
                               colocation: Dict[str, Any], batches: Any,
                               train_fn: TrainFn, dcfg, mesh=None, key=None,
                               *, eval_every: Optional[int] = None,
                               eval_fn: Optional[Callable] = None,
                               method: str = "mlmule", context: Any = None,
                               device="cuda"
                               ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """``run_population`` with the population cut over the ranks.

    Runs in every rank of the world (SPMD): each rank takes its block of
    the mule columns of ``state``, ``colocation`` and stacked batches and
    replays the rank-local step of ``make_distributed_method_step``; the
    fixed-device models, the freshness sketch and the clock are replicated
    and come out bitwise equal on every rank.

    state:   ``to_distributed_state(init_population(...), dcfg)``, the
             whole population, on every rank.
    dcfg:    ``repro_torch.core.distributed.DistributedConfig``: the
             collective schedule (``cross_pod``), the axis names, the ring
             (``ring_prune``, ``ring_bits``) and re-bucketing; the
             freshness statistic is ``dcfg.pop.freshness.stat``.
    mesh:    ``launch.mesh.make_mule_mesh(pod, data)`` over the world;
             ``n_mules`` must divide ``data``. ``None``: ``_auto_mesh``.
    batches: ``run_population``'s contract. A callable runs on every rank
             with the same seed, so it must be deterministic in its
             arguments; whole [n_mules, ...] mule batches are cut to the
             rank's rows by the step. Stacked batches have their ``"mule"``
             leaves cut along axis 1.
    eval_fn: runs on the rank's state and ``last_fid`` block.
    method:  any of ``METHODS_MOBILE``; the peer methods search encounters
             around the data axis's ring.

    With ``dcfg.rebucket_every > 0`` the run is the streamed engine's over
    ``compact_colocation(colocation)`` with one chunk per re-bucketing
    window (streamed equals materialized bitwise, so it is the same replay
    with swaps between chunks), as the reference hands over.

    Returns ``(final_state, aux)`` like ``run_population``, every mule
    array (``mule_models``, ``mule_ts``, ``last_fid``) the rank's block.
    """
    if key is None:
        raise TypeError("run_population_distributed() missing required "
                        "argument: 'key'")
    dev = resolve_device(device)
    window = _colocation_tensors(colocation, dev)
    n_steps, n_mules = window[0].shape
    if dcfg.rebucket_every > 0:
        rb = int(dcfg.rebucket_every)
        if eval_fn is not None and eval_every and rb % eval_every:
            raise ValueError(
                f"rebucket_every={rb} must be a multiple of "
                f"eval_every={eval_every} so drift checks land on eval "
                "boundaries")
        from repro_torch.mobility.streaming import compact_colocation
        return run_population_streamed(
            state, compact_colocation(colocation, device=dev), batches,
            train_fn, dcfg.pop, key, n_steps=n_steps, chunk_len=rb,
            eval_every=eval_every, eval_fn=eval_fn, method=method,
            context=context, mesh=mesh, dcfg=dcfg, device=dev)
    _check_state_on(state, dev)
    fid, exch, pos, area, act = window
    dcfg, mesh, state, batches, step_fn = _on_ranks(
        state, batches, train_fn, dcfg, mesh, method, n_mules,
        int(area.max()) if area.numel() else 0)
    ax = dcfg.data_axis
    window = (put_global(fid, mesh, 1, ax), put_global(exch, mesh, 1, ax),
              put_global(pos, mesh, 1, ax),
              put_global(area, mesh, area.dim() - 1, ax),
              put_global(act, mesh, 1, ax))
    n_ev = _eval_count(n_steps, eval_every, eval_fn)
    last = torch.zeros((n_mules // mesh.shape[ax],), dtype=torch.int64,
                       device=dev)
    evals: list = []
    state, last = _walk(state, last, window, 0, batches, step_fn, key,
                        n_ev=n_ev, eval_every=eval_every, eval_fn=eval_fn,
                        context=context, evals=evals)
    return state, _aux(last, n_steps, n_ev, eval_every, evals)
