"""Structured mobility patterns and churn masks (numpy).

All trace generators return the visit format of ``synth_foursquare_trace``
— ``[n_visits, 4] int64`` rows of ``(user, place, t_in, t_out)`` sorted by
``t_in`` — so ``trace_to_colocation`` expands any of them into the
``[T, M]`` tensors the engine consumes.

- ``commuter_trace``     — home/work oscillation on a daily period.
- ``shift_worker_trace`` — crews occupy their workplace during their shift
  window and rotate workplaces daily.
- ``event_crowd_trace``  — sparse background visits plus scheduled events
  that pull a large user fraction into one venue simultaneously.
- ``multi_area_trace``   — N near-isolated cities with rare travellers.

The ``*_mask`` generators produce ``[T, M]`` bool activity masks
(``colocation["active"]``):

- ``markov_churn_mask`` — each device is an independent on/off Markov chain.
- ``flash_churn_mask``  — a small always-on core plus flash windows where
  most devices join at once and mass-exit at the end.
- ``duty_cycle_mask``   — a periodic per-device duty cycle.

Every generator is deterministic per seed, bitwise-equal to
``repro.mobility.patterns`` for the same seed, and every mask keeps at
least one mule active per step.
"""
from __future__ import annotations

import numpy as np


def _ensure_one_active(mask: np.ndarray) -> np.ndarray:
    """Force >= 1 active mule per step (deterministic: rotate over mules)."""
    dead = ~mask.any(axis=1)
    if dead.any():
        t = np.nonzero(dead)[0]
        mask[t, t % mask.shape[1]] = True
    return mask


def markov_churn_mask(seed: int, n_steps: int, n_mules: int,
                      p_leave: float = 0.03, p_join: float = 0.12,
                      p_init: float = 0.8) -> np.ndarray:
    """Independent on/off Markov chain per device -> [T, M] bool.

    An active device goes to sleep with ``p_leave`` per step; a sleeping
    one wakes with ``p_join``.
    """
    rng = np.random.default_rng(seed)
    mask = np.zeros((n_steps, n_mules), bool)
    state = rng.random(n_mules) < p_init
    for t in range(n_steps):
        mask[t] = state
        flip = rng.random(n_mules)
        state = np.where(state, flip >= p_leave, flip < p_join)
    return _ensure_one_active(mask)


def flash_churn_mask(seed: int, n_steps: int, n_mules: int,
                     n_flashes: int = 4, flash_len: int = 40,
                     join_frac: float = 0.9,
                     base_frac: float = 0.25) -> np.ndarray:
    """Flash joins / mass exits -> [T, M] bool.

    A ``base_frac`` core of devices stays on throughout; at each of
    ``n_flashes`` evenly spaced windows a ``join_frac`` sample of the
    population switches on (staggered arrivals over the first few steps)
    and everyone outside the core mass-exits when the window closes.
    """
    rng = np.random.default_rng(seed)
    core = rng.random(n_mules) < base_frac
    if not core.any():
        core[int(rng.integers(0, n_mules))] = True
    mask = np.tile(core, (n_steps, 1))
    gap = max(n_steps // max(n_flashes, 1), flash_len + 1)
    for e in range(n_flashes):
        t0 = min(e * gap + int(rng.integers(0, max(gap - flash_len, 1))),
                 max(n_steps - flash_len, 0))
        joiners = rng.random(n_mules) < join_frac
        for u in np.nonzero(joiners)[0]:
            off = int(rng.integers(0, 5))          # staggered arrivals
            mask[t0 + off: t0 + flash_len, u] = True   # mass exit at close
    return _ensure_one_active(mask)


def duty_cycle_mask(seed: int, n_steps: int, n_mules: int,
                    period: int = 120, on_frac: float = 0.55,
                    jitter: int = 15) -> np.ndarray:
    """Periodic per-device duty cycle -> [T, M] bool.

    Device ``m`` is on for ``on_frac * period`` steps of every period,
    phase-shifted by a per-device jitter: commuter devices that sleep
    off-shift, with staggered shift starts.
    """
    rng = np.random.default_rng(seed)
    phase = rng.integers(0, max(jitter, 1) + 1, n_mules)
    on_len = max(int(on_frac * period), 1)
    t = np.arange(n_steps)[:, None]
    mask = ((t + phase[None, :]) % period) < on_len
    return _ensure_one_active(mask)


def _sorted_visits(visits) -> np.ndarray:
    if not visits:
        return np.zeros((0, 4), np.int64)
    arr = np.array(visits, np.int64)
    return arr[np.argsort(arr[:, 2], kind="stable")]


def multi_area_trace(seed: int, n_users: int = 30, n_places: int = 12,
                     n_steps: int = 2000, n_areas: int = 3,
                     p_travel: float = 0.01, min_visits: int = 6,
                     max_visits: int = 18) -> np.ndarray:
    """N near-isolated cities (paper Sec 4.1 generalized past 2 areas).

    Places split into ``n_areas`` contiguous blocks of ``n_places //
    n_areas`` spaces (area = place // block, as ``trace_colocation``
    derives it). Each user lives in one home area and draws
    foursquare-style visits from it; with probability ``p_travel`` a visit
    crosses into another city, the paper's rare inter-area traveller
    (0.715% in the Foursquare data).
    """
    if n_places != 4 * n_areas:
        raise ValueError(
            f"n_places={n_places} must be 4 * n_areas={n_areas}: the "
            "colocation expansion derives area = place // 4 and space = "
            "place % 4 (4 spaces per area throughout the harness)")
    rng = np.random.default_rng(seed)
    block = n_places // n_areas
    home = rng.integers(0, n_areas, n_users)
    visits = []
    for u in range(n_users):
        t = int(rng.integers(0, max(n_steps // 8, 1)))
        for _ in range(int(rng.integers(min_visits, max_visits + 1))):
            area = int(home[u])
            if rng.random() < p_travel:
                area = int(rng.integers(0, n_areas))
            place = area * block + int(rng.integers(0, block))
            dwell = int(rng.integers(6, 30))
            if t + dwell >= n_steps:
                break
            visits.append((u, place, t, t + dwell))
            t += dwell + int(rng.integers(5, 40))
    return _sorted_visits(visits)


def commuter_trace(seed: int, n_users: int = 20, n_places: int = 8,
                   n_steps: int = 2000, period: int = 200,
                   work_frac: float = 0.45, commute: int = 5,
                   jitter: int = 8) -> np.ndarray:
    """Daily home->work->home cycle per user.

    Each user gets a home and a distinct work place; every `period` steps it
    dwells at home, commutes (`commute` steps off-grid), works for
    ``work_frac * period`` steps (start jittered per user/day), and returns
    home.
    """
    rng = np.random.default_rng(seed)
    home = rng.integers(0, n_places, n_users)
    work = (home + rng.integers(1, n_places, n_users)) % n_places
    work_len = max(int(work_frac * period), 1)
    visits = []
    for u in range(n_users):
        for day in range(max(n_steps // period, 1)):
            base = day * period
            w0 = base + commute + int(rng.integers(0, jitter + 1))
            w1 = w0 + work_len
            h1 = min(base + period, n_steps)
            if base < w0 - commute:
                visits.append((u, home[u], base, min(w0 - commute, n_steps)))
            if w0 < n_steps:
                visits.append((u, work[u], w0, min(w1, n_steps)))
            if w1 + commute < h1:
                visits.append((u, home[u], w1 + commute, h1))
    return _sorted_visits(visits)


def shift_worker_trace(seed: int, n_users: int = 24, n_places: int = 8,
                       n_steps: int = 2000, n_shifts: int = 3,
                       period: int = 240, jitter: int = 6) -> np.ndarray:
    """Round-the-clock crews: user u works shift ``u % n_shifts``.

    A day of `period` steps splits into `n_shifts` equal windows; crew s is
    at its workplace only during window s and rotates workplace daily.
    """
    rng = np.random.default_rng(seed)
    shift_of = np.arange(n_users) % n_shifts
    crew_base = rng.integers(0, n_places, n_shifts)
    win = period // n_shifts
    visits = []
    for u in range(n_users):
        s = shift_of[u]
        for day in range(max(n_steps // period, 1)):
            t0 = day * period + s * win + int(rng.integers(0, jitter + 1))
            t1 = min(day * period + (s + 1) * win, n_steps)
            place = (crew_base[s] + day) % n_places
            if t0 < t1:
                visits.append((u, place, t0, t1))
    return _sorted_visits(visits)


def event_crowd_trace(seed: int, n_users: int = 30, n_places: int = 8,
                      n_steps: int = 2000, n_events: int = 6,
                      event_len: int = 60, attend: float = 0.7,
                      background_visits: int = 3) -> np.ndarray:
    """Sparse background check-ins punctuated by mass events.

    Events are evenly spaced (start jittered); each picks one venue and an
    ``attend`` fraction of users who all dwell there for ``event_len`` steps
    — many simultaneous deliveries to a single fixed device.
    """
    rng = np.random.default_rng(seed)
    visits = []
    for u in range(n_users):                       # thin background traffic
        for _ in range(int(rng.integers(1, background_visits + 1))):
            t0 = int(rng.integers(0, max(n_steps - 10, 1)))
            dwell = int(rng.integers(4, 20))
            visits.append((u, int(rng.integers(0, n_places)), t0,
                           min(t0 + dwell, n_steps)))
    gap = max(n_steps // max(n_events, 1), event_len + 1)
    for e in range(n_events):
        t0 = min(e * gap + int(rng.integers(0, max(gap - event_len, 1))),
                 max(n_steps - event_len, 0))
        venue = int(rng.integers(0, n_places))
        goers = rng.random(n_users) < attend
        for u in np.nonzero(goers)[0]:
            off = int(rng.integers(0, 5))          # staggered arrivals
            visits.append((int(u), venue, t0 + off,
                           min(t0 + event_len, n_steps)))
    return _sorted_visits(visits)
