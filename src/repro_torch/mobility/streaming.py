"""Streamed colocation: the schedule never materializes as [T, M].

``run_population`` replays a precomputed ``[T, M]`` schedule; at
M = 10^6 that schedule alone outweighs the population state. The
generators here emit it chunk by chunk instead, from compact per-mule
arrays on the device (``repro_torch.scenarios.run_population_streamed``),
so schedule memory is O(chunk * M) plus the compact arrays, never
O(T * M).

The generator contract
----------------------
A chunk generator has

- ``n_mules`` / ``n_steps``: population size and nominal horizon;
- ``arrays()``: a dict of tensors (the compact schedule or per-mule
  parameters), on the device the generator was built for;
- ``specs()``: for each array, the axis along which it runs over the mules
  (``None`` for a replicated array). A rank of the distributed engine
  slices those arrays to its own block of mules and expands only its own
  columns;
- ``static_token()``: a hashable tuple of the generator's configuration
  (periods, cadences, flags), everything but the arrays and the horizon;
- ``expand(arrays, key, t0, chunk_len)``: the schedule of global steps
  ``t0 .. t0 + chunk_len`` from ``arrays``: ``{"fixed_id": [c, n] int32,
  "exchange": [c, n] bool, "pos": [c, n, 2] f32, "area": [n] int32 (or
  [c, n] when areas move), "active": [c, n] bool}``. ``key`` is accepted
  for the reference's signature and ignored: the builders fix their draws
  when they are built, which is what makes a streamed replay bitwise equal
  to the materialized one. ``generate_chunk(key, t0, chunk_len)`` is
  ``expand`` on the generator's own arrays.

Two families:

- ``compact_colocation`` compacts any materialized colocation dict into
  per-mule run-length segments and expands them exactly, chunk boundaries
  included; every registered scenario streams this way. Exchange flags
  are re-derived from run starts and the dwell cadence where that
  reproduces the input exactly (every trace and walk scenario), and kept
  as a run-length code of their own otherwise.
- ``commuter_stream`` is procedural: O(M) per-mule parameters drawn once
  from a ``torch.Generator``, the schedule of each ``(t, mule)`` in closed
  form. Its memory does not depend on T.

``materialize_generator`` expands any generator back into the numpy
colocation dict, the O(T * M) reference a streamed replay is held to.

The compact arrays keep the reference's dtypes (int32 starts and values,
bool exchange), so they are bitwise the reference's; the engine casts
what it expands to its own int64.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.mobility.trace import dwell_exchange_flags

# padding of the run starts: later than any step a run reaches, and far
# enough below the int32 limit that t0 + chunk offsets never overflow
_PAD_T = np.iinfo(np.int32).max // 2


def _rle_columns(arr: np.ndarray, pad_val) -> Tuple[np.ndarray, np.ndarray]:
    """Per-column run-length code of a ``[T, M]`` array.

    Returns ``(starts [M, S] int32, values [M, S])``: column ``m`` holds
    ``values[m, i]`` from step ``starts[m, i]`` to the next start. ``S`` is
    the most runs of any column; shorter columns pad with ``(_PAD_T,
    pad_val)``, which no step in range selects.
    """
    t_len, m = arr.shape
    change = np.ones((t_len, m), bool)
    change[1:] = arr[1:] != arr[:-1]
    counts = change.sum(axis=0)
    s = int(counts.max()) if m else 1
    cols, rows = np.nonzero(change.T)          # by column, then by step
    slot = np.arange(len(rows)) - np.repeat(np.cumsum(counts) - counts,
                                            counts)
    starts = np.full((m, s), _PAD_T, np.int32)
    values = np.full((m, s), pad_val, arr.dtype)
    starts[cols, slot] = rows
    values[cols, slot] = arr[rows, cols]
    return starts, values


def _expand_rle(starts: torch.Tensor, values: torch.Tensor,
                ts: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-mule step functions at steps ``ts``.

    ``starts`` / ``values``: ``[n, S]``; ``ts``: ``[c]`` int32. Returns
    ``(vals [c, n], run_start [c, n])``: each step's run value and the step
    its run began (for the dwell cadence).
    """
    n = starts.shape[0]
    idx = torch.searchsorted(starts, ts[None, :].expand(n, -1).contiguous(),
                             right=True) - 1                      # [n, c]
    vals = values.gather(1, idx)
    run_start = starts.gather(1, idx)
    return vals.t(), run_start.t()


def _to(arrays: Dict[str, Any], dev: torch.device) -> Dict[str, Any]:
    return {k: torch.as_tensor(v).to(dev) for k, v in arrays.items()}


class CompactColocation:
    """Exact compact form of a materialized colocation dict.

    Per-mule run-length segments of ``fixed_id`` (and of the churn mask and
    a moving area column, where present), the closed-form dwell cadence for
    ``exchange`` (or its own run-length code), and ``pos`` as zeros or as
    the dense array. ``expand`` gives back the source arrays bitwise at
    any chunk boundary: the run-length expansion is exact, and the cadence
    formula is used only where the build checked that it reproduces the
    input.
    """

    def __init__(self, n_mules: int, n_steps: int, arrays: Dict[str, Any],
                 *, cadence_scalar: Optional[int], has_active: bool,
                 has_exchange_rle: bool, has_dense_pos: bool,
                 has_area_rle: bool = False, max_area: int = 0):
        self.n_mules = int(n_mules)
        self.n_steps = int(n_steps)
        self.max_area = int(max_area)
        self._arrays = arrays
        self._cadence_scalar = cadence_scalar
        self._has_active = has_active
        self._has_exchange_rle = has_exchange_rle
        self._has_dense_pos = has_dense_pos
        self._has_area_rle = has_area_rle

    def arrays(self) -> Dict[str, Any]:
        return self._arrays

    def specs(self) -> Dict[str, Optional[int]]:
        """The mule axis of each array (None: replicated)."""
        axis = {"fid_starts": 0, "fid_vals": 0, "act_starts": 0,
                "act_vals": 0, "exc_starts": 0, "exc_vals": 0,
                "area_starts": 0, "area_vals": 0, "area": 0,
                "cadence": None, "pos": 1}
        return {k: axis[k] for k in self._arrays}

    def static_token(self) -> Tuple:
        return ("compact", self._cadence_scalar, self._has_active,
                self._has_exchange_rle, self._has_dense_pos,
                self._has_area_rle)

    def schedule_bytes(self) -> int:
        """Bytes of the compact schedule (O(M * segments))."""
        return sum(v.numel() * v.element_size()
                   for v in self._arrays.values())

    def expand(self, arrays: Dict[str, Any], key, t0,
               chunk_len: int) -> Dict[str, Any]:
        del key                                  # fixed when built
        dev = arrays["fid_starts"].device
        ts = int(t0) + torch.arange(chunk_len, dtype=torch.int32, device=dev)
        fid, run_start = _expand_rle(arrays["fid_starts"],
                                     arrays["fid_vals"], ts)
        present = fid >= 0
        if self._has_exchange_rle:
            exch, _ = _expand_rle(arrays["exc_starts"], arrays["exc_vals"],
                                  ts)
        else:
            dwell = ts[:, None] - run_start + 1
            if self._cadence_scalar is not None:
                steps = self._cadence_scalar
            else:
                steps = arrays["cadence"][fid.clamp(min=0).long()]
            exch = present & (torch.remainder(dwell, steps) == 0)
        if self._has_active:
            act, _ = _expand_rle(arrays["act_starts"], arrays["act_vals"],
                                 ts)
        else:
            act = torch.ones(fid.shape, dtype=torch.bool, device=dev)
        n = fid.shape[1]
        if self._has_dense_pos:
            pos = arrays["pos"][int(t0):int(t0) + chunk_len]
        else:
            pos = torch.zeros((chunk_len, n, 2), dtype=torch.float32,
                              device=dev)
        if self._has_area_rle:
            area, _ = _expand_rle(arrays["area_starts"],
                                  arrays["area_vals"], ts)
        else:
            area = arrays["area"]
        return {"fixed_id": fid, "exchange": exch, "pos": pos,
                "area": area, "active": act}

    def generate_chunk(self, key, t0, chunk_len: int) -> Dict[str, Any]:
        return self.expand(self._arrays, key, t0, chunk_len)


def compact_colocation(colocation: Dict[str, Any], cadence=3,
                       device="cuda") -> CompactColocation:
    """Compact a materialized colocation dict into a chunk generator whose
    arrays live on ``device``.

    ``cadence`` is the dwell exchange tempo the schedule was built with (a
    scalar, or the per-place array of a ``SpaceSpec`` scenario). The
    closed-form cadence is checked against the input's exchange flags here
    on the host; a schedule whose flags it does not reproduce (or whose
    cadence was guessed wrong) keeps a run-length code of its exchange
    columns instead: less compact, never wrong.
    """
    dev = resolve_device(device)
    fid = np.asarray(colocation["fixed_id"], np.int32)
    exch = np.asarray(colocation["exchange"], bool)
    n_steps, n_mules = fid.shape
    arrays: Dict[str, Any] = {}

    arrays["fid_starts"], arrays["fid_vals"] = _rle_columns(fid,
                                                            np.int32(-1))
    cadence_scalar: Optional[int] = None
    has_exchange_rle = not np.array_equal(
        dwell_exchange_flags(fid, cadence), exch)
    if has_exchange_rle:
        arrays["exc_starts"], arrays["exc_vals"] = _rle_columns(exch, False)
    elif np.ndim(cadence) == 0:
        cadence_scalar = int(cadence)
    else:
        arrays["cadence"] = np.asarray(cadence).astype(np.int32)

    active = colocation.get("active")
    has_active = active is not None
    if has_active:
        arrays["act_starts"], arrays["act_vals"] = _rle_columns(
            np.asarray(active, bool), False)

    pos = colocation.get("pos")
    has_dense_pos = pos is not None and bool(np.asarray(pos).any())
    if has_dense_pos:
        arrays["pos"] = np.asarray(pos, np.float32)

    area = colocation.get("area")
    area = (np.zeros((n_mules,), np.int32) if area is None
            else np.asarray(area, np.int32))
    has_area_rle = area.ndim == 2
    if has_area_rle:
        arrays["area_starts"], arrays["area_vals"] = _rle_columns(
            area, np.int32(0))
    else:
        arrays["area"] = area

    return CompactColocation(n_mules, n_steps, _to(arrays, dev),
                             cadence_scalar=cadence_scalar,
                             has_active=has_active,
                             has_exchange_rle=has_exchange_rle,
                             has_dense_pos=has_dense_pos,
                             has_area_rle=has_area_rle,
                             max_area=int(area.max(initial=0)))


class CommuterStream:
    """Procedural commuter schedule: O(M) memory at any horizon.

    Each mule's home and work place, jitter phase and (odd) day stride are
    drawn once when the stream is built, from a CPU ``torch.Generator``
    seeded with ``seed`` (or given as ``arrays``); each step's place then
    follows from ``(t, mule)`` in int32 arithmetic. Day ``d`` of mule ``m``
    is::

        [home   j) [commute) [work  work_len) [commute) [home   period)

    with ``j = (phase + d * stride) % (jitter + 1)``, a jitter per (mule,
    day) that does not depend on which mules a rank holds, so a rank
    expanding only its own columns gets exactly the single-host columns.
    Exchange flags follow the dwell cadence; an evening at home that
    reaches midnight continues into the next morning (the run start
    reaches back across the day), so the flags are bitwise
    ``dwell_exchange_flags`` over the materialized grid.

    Optional duty-cycle churn (``duty_period > 0``): mule ``m`` is active
    while ``(t + aphase[m]) % duty_period < duty_on``, and mule
    ``t % n_mules`` always, so no step goes dark.

    ``arrays`` (``home``, ``work``, ``phase``, ``stride``, ``ids`` and, with
    churn, ``aphase``; int32 [M]) replaces the draws: the tests hand in the
    reference's, whose ``jax.random`` bits torch cannot reproduce.
    """

    def __init__(self, seed: int, n_mules: int, n_steps: int, *,
                 n_places: int = 8, period: int = 192,
                 work_frac: float = 0.45, commute: int = 6, jitter: int = 8,
                 exchange_steps: int = 3, duty_period: int = 0,
                 duty_on_frac: float = 0.6,
                 arrays: Optional[Dict[str, Any]] = None, device="cuda"):
        work_len = max(int(work_frac * period), 1)
        if jitter + 2 * commute + work_len >= period:
            raise ValueError(
                f"period={period} too short for jitter={jitter} + "
                f"2*commute={2 * commute} + work_len={work_len}")
        self.n_mules = int(n_mules)
        self.n_steps = int(n_steps)
        self.n_places = int(n_places)
        self.period = int(period)
        self.work_len = work_len
        self.commute = int(commute)
        self.jitter = int(jitter)
        self.exchange_steps = int(exchange_steps)
        self.max_area = (int(n_places) - 1) // 4
        self.duty_period = int(duty_period)
        self.duty_on = max(int(duty_on_frac * duty_period), 1) \
            if duty_period else 0

        dev = resolve_device(device)
        if arrays is None:
            arrays = self._draw(seed)
        want = {"home", "work", "phase", "stride", "ids"} | (
            {"aphase"} if duty_period else set())
        if set(arrays) != want:
            raise ValueError(f"CommuterStream arrays {sorted(arrays)}, "
                             f"expected {sorted(want)}")
        self._arrays = {k: torch.as_tensor(np.array(v), dtype=torch.int32)
                        .to(dev) for k, v in arrays.items()}

    def _draw(self, seed: int) -> Dict[str, torch.Tensor]:
        g = torch.Generator(device="cpu")
        g.manual_seed(seed)
        m, i32 = self.n_mules, torch.int32

        def randint(lo, hi):
            return torch.randint(lo, hi, (m,), generator=g, dtype=i32)

        home = randint(0, self.n_places)
        work = (home + randint(1, self.n_places)) % self.n_places
        out = {"home": home, "work": work,
               "phase": randint(0, self.jitter + 1),
               "stride": 2 * randint(0, 1 << 15) + 1,
               "ids": torch.arange(m, dtype=i32)}
        if self.duty_period:
            out["aphase"] = randint(0, self.duty_period)
        return out

    def arrays(self) -> Dict[str, Any]:
        return self._arrays

    def specs(self) -> Dict[str, Optional[int]]:
        return {k: 0 for k in self._arrays}

    def static_token(self) -> Tuple:
        return ("commuter_stream", self.n_mules, self.n_places, self.period,
                self.work_len, self.commute, self.jitter,
                self.exchange_steps, self.duty_period, self.duty_on)

    def schedule_bytes(self) -> int:
        return sum(v.numel() * v.element_size()
                   for v in self._arrays.values())

    def _day_jitter(self, day: torch.Tensor, phase: torch.Tensor,
                    stride: torch.Tensor) -> torch.Tensor:
        # int32 throughout, so day * stride wraps where the reference's
        # does; % is the floor modulo (day - 1 is -1 on day 0)
        return torch.remainder(phase[None, :] + day[:, None] * stride[None, :],
                               self.jitter + 1)

    def expand(self, arrays: Dict[str, Any], key, t0,
               chunk_len: int) -> Dict[str, Any]:
        del key                                  # fixed when built
        p = self.period
        dev = arrays["home"].device
        ts = int(t0) + torch.arange(chunk_len, dtype=torch.int32, device=dev)
        day = torch.div(ts, p, rounding_mode="floor")
        w = torch.remainder(ts, p)                          # [c]
        phase, stride = arrays["phase"], arrays["stride"]
        j = self._day_jitter(day, phase, stride)            # [c, n]
        w0 = j + self.commute                               # work starts
        w1 = w0 + self.work_len
        we = w1 + self.commute                              # evening starts
        wb = w[:, None]
        morning, at_work, evening = wb < j, (wb >= w0) & (wb < w1), wb >= we
        minus1 = torch.full((), -1, dtype=torch.int32, device=dev)
        fid = torch.where(morning | evening, arrays["home"][None, :],
                          torch.where(at_work, arrays["work"][None, :],
                                      minus1))

        # run starts (absolute steps). The morning at home continues the
        # previous evening's run when that evening existed (we < period),
        # as the dwell of the materialized grid does.
        j_prev = self._day_jitter(day - 1, phase, stride)
        we_prev = j_prev + 2 * self.commute + self.work_len
        day_base = (day * p)[:, None]
        morning_start = torch.where((day[:, None] > 0) & (we_prev < p),
                                    day_base - p + we_prev, day_base)
        run_start = torch.where(morning, morning_start,
                                torch.where(at_work, day_base + w0,
                                            day_base + we))
        dwell = ts[:, None] - run_start + 1
        exch = (fid >= 0) & (torch.remainder(dwell, self.exchange_steps)
                             == 0)

        if self.duty_period:
            act = torch.remainder(ts[:, None] + arrays["aphase"][None, :],
                                  self.duty_period) < self.duty_on
            act = act | (arrays["ids"][None, :]
                         == torch.remainder(ts, self.n_mules)[:, None])
        else:
            act = torch.ones(fid.shape, dtype=torch.bool, device=dev)
        pos = torch.zeros((chunk_len, fid.shape[1], 2), dtype=torch.float32,
                          device=dev)
        return {"fixed_id": fid.to(torch.int32), "exchange": exch,
                "pos": pos,
                "area": torch.div(arrays["home"], 4, rounding_mode="floor"),
                "active": act}

    def generate_chunk(self, key, t0, chunk_len: int) -> Dict[str, Any]:
        return self.expand(self._arrays, key, t0, chunk_len)

    def init_fields(self) -> Dict[str, np.ndarray]:
        """init_space / init_area for the data partitions (from home)."""
        home = self._arrays["home"].cpu().numpy()
        return {"init_space": (home % 4).astype(np.int64),
                "init_area": (home // 4).astype(np.int64)}


def commuter_stream(seed: int, n_mules: int, n_steps: int,
                    **kw) -> CommuterStream:
    """The procedural commuter generator (see ``CommuterStream``)."""
    return CommuterStream(seed, n_mules, n_steps, **kw)


def reorder_generator_arrays(generator, arrays: Dict[str, Any],
                             order) -> Dict[str, Any]:
    """Permute a generator's mule columns into a new order.

    Arrays that run over the mules (``generator.specs()``) take
    ``order`` along that axis (entry ``p`` names the column of the mule
    now in slot ``p``); replicated arrays pass through. The streamed
    engine's mid-run re-bucketing applies this at a swap, so every later
    ``expand`` emits its columns in the new layout.
    """
    specs = generator.specs()

    def one(name, leaf):
        axis = specs[name]
        if axis is None:
            return leaf
        idx = torch.as_tensor(np.asarray(order), dtype=torch.int64,
                              device=leaf.device)
        return leaf.index_select(axis, idx)

    return {k: one(k, v) for k, v in arrays.items()}


def materialize_generator(gen, n_steps: Optional[int] = None,
                          chunk_len: int = 256) -> Dict[str, np.ndarray]:
    """Expand a chunk generator into the numpy colocation dict.

    The O(T * M) reference: a streamed replay is bitwise equal to
    ``run_population`` over this dict. Includes ``init_space`` /
    ``init_area`` where the generator gives them.
    """
    n_steps = int(gen.n_steps if n_steps is None else n_steps)
    chunks = []
    for t0 in range(0, n_steps, chunk_len):
        c = gen.generate_chunk(None, t0, min(chunk_len, n_steps - t0))
        chunks.append({k: v.cpu().numpy() for k, v in c.items()})
    co = {k: np.concatenate([c[k] for c in chunks], axis=0)
          for k in ("fixed_id", "exchange", "pos", "active")}
    if chunks and chunks[0]["area"].ndim == 2:
        co["area"] = np.concatenate([c["area"] for c in chunks], axis=0)
    else:
        co["area"] = chunks[0]["area"] if chunks else np.zeros(
            (gen.n_mules,), np.int32)
    if hasattr(gen, "init_fields"):
        co.update(gen.init_fields())
    return co
