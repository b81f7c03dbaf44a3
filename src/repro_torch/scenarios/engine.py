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
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.method_program import compile_step, get_program
from repro_torch.core.population import PopulationConfig, TrainFn
from repro_torch.core.seeds import fold_in
from repro_torch.device import resolve_device


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
    fid, exch, pos, area, act = _colocation_tensors(colocation, dev)
    n_steps, n_mules = fid.shape
    step_fn = compile_step(get_program(method), train_fn, cfg)
    dynamic = callable(batches)
    n_ev = n_steps // eval_every if (eval_fn is not None and eval_every) else 0

    last = torch.zeros((n_mules,), dtype=torch.int64, device=dev)
    evals = []
    for t in range(n_steps):
        k_t = fold_in(key, t)
        if dynamic:
            kb, ks = fold_in(k_t, 0), fold_in(k_t, 1)
            bt = (batches(kb, t) if context is None else
                  batches(kb, t, context))
        else:
            bt, ks = _tree_map(lambda l: l[t], batches), k_t
        state = step_fn(state, {
            "fixed_id": fid[t], "exchange": exch[t], "pos": pos[t],
            "area": area[t] if area.dim() == 2 else area,
            "active": act[t], "t": t}, bt, ks)
        last = torch.where((fid[t] >= 0) & act[t], fid[t], last)
        if n_ev and t < n_ev * eval_every and (t + 1) % eval_every == 0:
            evals.append(eval_fn(state, last) if context is None else
                         eval_fn(state, last, context))

    steps = (np.arange(n_ev) + 1) * eval_every - 1 if n_ev else \
        np.zeros((0,), int)
    return state, {"last_fid": last, "eval_steps": steps,
                   "evals": _tree_stack(evals) if evals else None}
