"""Trace-driven mobility: synthetic Foursquare-like visit logs (numpy).

The paper's '4Q' condition replays real Foursquare check-ins (user, place,
enter-time, dwell). That dataset is not available offline; this generator
reproduces the properties the paper relies on:

- **subgroup structure** (the ICA clusters of Fig. 3): each user belongs to a
  latent affinity group that concentrates its visits on a subset of places;
- **sparsity**: many users appear briefly and then disappear (heavy-tailed
  participation), which the paper notes makes 4Q slightly harder than the
  dense simulated patterns;
- **no detailed movement** between visits — only (user, place, t_in, t_out).

Bitwise-equal to ``repro.mobility.trace`` for the same seed.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np


def synth_foursquare_trace(seed: int, n_users: int = 40, n_places: int = 8,
                           n_steps: int = 2000, n_groups: int = 2,
                           sparsity: float = 0.5) -> np.ndarray:
    """Returns visits array [n_visits, 4]: (user, place, t_in, t_out).

    Users in group g prefer places assigned to group g (zipf-weighted);
    a `sparsity` fraction of users are transient (few visits).
    """
    rng = np.random.default_rng(seed)
    group_of = rng.integers(0, n_groups, size=n_users)
    place_group = np.arange(n_places) % n_groups
    transient = rng.random(n_users) < sparsity

    visits: List[Tuple[int, int, int, int]] = []
    for u in range(n_users):
        n_visits = rng.integers(2, 6) if transient[u] else rng.integers(15, 40)
        # place preference: own-group places get 10x weight, zipf within group
        w = np.where(place_group == group_of[u], 10.0, 0.2)
        w = w * (1.0 / (1.0 + np.arange(n_places) % (n_places // n_groups)))
        w = w / w.sum()
        t = int(rng.integers(0, max(n_steps // 8, 1)))
        for _ in range(n_visits):
            place = int(rng.choice(n_places, p=w))
            dwell = int(rng.integers(6, 40))
            if t + dwell >= n_steps:
                break
            visits.append((u, place, t, t + dwell))
            t += dwell + int(rng.integers(
                5, max(n_steps // max(n_visits, 1), 1) + 5))
    arr = np.array(sorted(visits, key=lambda v: v[2]), dtype=np.int64)
    return arr


def trace_to_colocation(visits: np.ndarray, n_users: int, n_steps: int,
                        exchange_steps=3) -> Tuple[np.ndarray, np.ndarray]:
    """Expand visits into per-step arrays.

    Returns (fixed_id [T, M] int32 with -1 when not co-located,
             exchange [T, M] bool — True every `exchange_steps`-th
             consecutive step of a visit).

    ``exchange_steps`` may also be an int array indexed by place id —
    heterogeneous exchange tempos per space. Visits stay in t_in order, so
    a later visit overwrites an overlapping earlier one.
    """
    fixed_id = -np.ones((n_steps, n_users), np.int32)
    if len(visits):
        u, place, t_in, t_out = (np.asarray(visits[:, i]) for i in range(4))
        t_in = np.clip(t_in, 0, n_steps)
        t_out = np.clip(t_out, 0, n_steps)
        lens = np.maximum(t_out - t_in, 0)
        # concatenated aranges: [t_in0..t_out0), [t_in1..t_out1), ...
        offs = np.arange(lens.sum()) - np.repeat(np.cumsum(lens) - lens, lens)
        rows = np.repeat(t_in, lens) + offs
        fixed_id[rows, np.repeat(u, lens)] = np.repeat(place, lens)

    return fixed_id, dwell_exchange_flags(fixed_id, exchange_steps)


def dwell_exchange_flags(fixed_id: np.ndarray, exchange_steps=3) -> np.ndarray:
    """Completed-exchange flags from a filled ``[T, M]`` co-location grid.

    A visit completes an exchange on every ``exchange_steps``-th
    consecutive dwell step; ``exchange_steps`` may be a per-place array
    (heterogeneous space tempos).
    """
    n_steps, n_users = fixed_id.shape
    present = fixed_id >= 0
    prev = np.vstack([-np.ones((1, n_users), np.int32), fixed_id[:-1]])
    run_start = present & ((fixed_id != prev) | (prev < 0))
    t_grid = np.arange(n_steps, dtype=np.int64)[:, None]
    start_t = np.where(run_start, t_grid, -1)
    last_start = np.maximum.accumulate(start_t, axis=0)
    dwell = np.where(present, t_grid - last_start + 1, 0)
    steps = _cadence_of(fixed_id, exchange_steps)
    return present & (dwell % steps == 0)


def _cadence_of(fixed_id: np.ndarray, exchange_steps) -> np.ndarray:
    """Per-cell exchange cadence: scalar, or looked up by space id.

    Only the -1 corridor sentinel is clamped; a place id past the end of
    the per-place array is a misconfiguration and raises.
    """
    if np.ndim(exchange_steps) == 0:
        return np.asarray(exchange_steps, np.int64)
    per_place = np.asarray(exchange_steps, np.int64)
    top = int(fixed_id.max(initial=-1))
    if top >= len(per_place):
        raise ValueError(
            f"place id {top} has no cadence: exchange_steps covers only "
            f"{len(per_place)} places")
    return per_place[np.maximum(fixed_id, 0)]
