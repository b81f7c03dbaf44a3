"""Scenario registry: name -> (mobility generator x protocol mode x data
partition).

A scenario bundles everything the harness needs to replay one workload:
how mules move (a co-location schedule function), which side trains
(``mode``), and how data lands on devices (``dist``/``task``).

Co-location functions return numpy arrays:
  fixed_id  [T, M] int32   co-located fixed device per mule (-1 = none)
  exchange  [T, M] bool    completed-exchange flags
  pos       [T, M, 2] f32  positions (zeros for check-in traces)
  area      [M] int32      each mule's area
  active    [T, M] bool    churn mask (optional; absent == dense)
  init_space/init_area [M] initial space/area (seeds the data partition)

Churn and heterogeneous spaces are declarative: a ``ChurnSpec`` picks one
of the mask generators (``register`` folds the mask into every build), and
a tuple of ``SpaceSpec`` gives each space its own exchange tempo.

The port registers the trace-built scenarios of ``repro.scenarios.registry``
and builds bitwise the same arrays for the same seed; the paper's
``random_walk``; and ``streaming_commuter``, whose native form is a chunk
generator (``ScenarioSpec.generator``, ``mobility.streaming``). The walk and
the commuter stream draw from a ``torch.Generator``: the reference's
``jax.random`` bits cannot be reproduced, and fed the same draws both give
the reference's schedule. ``scenario_generator`` streams any scenario.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.mobility import (MobilityConfig, area_over_time,
                                  commuter_stream, commuter_trace,
                                  compact_colocation, duty_cycle_mask,
                                  dwell_exchange_flags, event_crowd_trace,
                                  flash_churn_mask, init_mobility,
                                  markov_churn_mask, materialize_generator,
                                  multi_area_trace,
                                  sample_walk_draws, shift_worker_trace,
                                  simulate_trajectories, space_of,
                                  synth_foursquare_trace,
                                  trace_to_colocation)

Colocation = Dict[str, np.ndarray]

_CHURN_GENERATORS = {
    "markov": markov_churn_mask,
    "flash": flash_churn_mask,
    "duty_cycle": duty_cycle_mask,
}

@dataclasses.dataclass(frozen=True)
class ChurnSpec:
    """Declarative population churn: which mask generator, with what knobs.

    ``kind`` selects a generator (markov | flash | duty_cycle); ``params``
    are its keyword arguments. ``seed_offset`` decorrelates the mask draw
    from the mobility draw of the same scenario seed.
    """
    kind: str = "markov"
    params: Tuple[Tuple[str, float], ...] = ()
    seed_offset: int = 7919

    def mask(self, seed: int, n_steps: int, n_mules: int) -> np.ndarray:
        if self.kind not in _CHURN_GENERATORS:
            raise ValueError(f"unknown churn kind {self.kind!r}; expected "
                             f"one of {sorted(_CHURN_GENERATORS)}")
        return _CHURN_GENERATORS[self.kind](seed + self.seed_offset, n_steps,
                                            n_mules, **dict(self.params))


@dataclasses.dataclass(frozen=True)
class SpaceSpec:
    """Per-space knobs folded into the colocation build.

    ``exchange_steps`` is this space's exchange tempo — how many
    consecutive dwell steps complete one model hand-off.
    """
    exchange_steps: int = 3


def _cadence(spaces: Tuple[SpaceSpec, ...]):
    """Per-place exchange_steps array for ``trace_colocation`` (or 3)."""
    if not spaces:
        return 3
    return np.array([sp.exchange_steps for sp in spaces], np.int64)


@dataclasses.dataclass(frozen=True)
class ScenarioSpec:
    name: str
    colocation: Callable[..., Colocation]   # (seed, n_mules, n_steps) -> dict
    mode: str = "mobile"                    # which side trains (fixed|mobile)
    dist: str = "shards"                    # data partition selector
    task: str = "image"                     # image | har
    n_fixed: int = 8                        # spaces (= valid fixed ids)
    churn: Optional[ChurnSpec] = None       # device join/leave mask
    spaces: Tuple[SpaceSpec, ...] = ()      # per-space exchange tempos
    description: str = ""
    # native chunk generator (seed, n_mules, n_steps, device=) -> generator;
    # None: the scenario streams through compact_colocation
    generator: Optional[Callable[..., object]] = None


SCENARIOS: Dict[str, ScenarioSpec] = {}


def _folded(build: Callable[..., Colocation], churn: Optional[ChurnSpec],
            spaces: Tuple[SpaceSpec, ...]) -> Callable[..., Colocation]:
    """Wrap a schedule function so the spec's churn/space declarations
    take effect."""
    def with_spec(seed: int, n_mules: int, n_steps: int) -> Colocation:
        co = build(seed, n_mules, n_steps)
        if spaces:
            co["exchange"] = dwell_exchange_flags(
                np.asarray(co["fixed_id"]), _cadence(spaces))
        if churn is not None:
            co["active"] = churn.mask(seed, n_steps, n_mules)
        return co
    return with_spec


def register(spec: ScenarioSpec) -> ScenarioSpec:
    """Add a scenario; declared ``churn``/``spaces`` fold into every build."""
    if spec.churn is not None or spec.spaces:
        spec = dataclasses.replace(
            spec, colocation=_folded(spec.colocation, spec.churn,
                                     spec.spaces))
    SCENARIOS[spec.name] = spec
    return spec


def get_scenario(name: str) -> ScenarioSpec:
    if name not in SCENARIOS:
        raise ValueError(f"unknown scenario {name!r}; available: "
                         f"{', '.join(list_scenarios())}")
    return SCENARIOS[name]


def list_scenarios():
    return sorted(SCENARIOS)


def scenario_generator(name_or_spec, seed: int, n_mules: int, n_steps: int,
                       colocation: Optional[Colocation] = None,
                       device="cuda"):
    """Chunk generator of a scenario, native or compacted, on ``device``.

    A spec with a native ``generator`` (procedural, O(M) memory at any
    horizon) builds it. Every other scenario streams through
    ``compact_colocation`` of its materialized schedule (``colocation``
    when given, else built here), with the spec's per-space tempos as the
    dwell cadence, so the expansion is bitwise the schedule.
    """
    spec = name_or_spec if isinstance(name_or_spec, ScenarioSpec) \
        else get_scenario(name_or_spec)
    if spec.generator is not None:
        return spec.generator(seed, n_mules, n_steps, device=device)
    if colocation is None:
        colocation = spec.colocation(seed, n_mules, n_steps)
    return compact_colocation(colocation, cadence=_cadence(spec.spaces),
                              device=device)


# ---------------------------------------------------------------------------
# co-location functions
# ---------------------------------------------------------------------------


def walk_colocation(seed: int, n_mules: int, n_steps: int,
                    p_cross: float = 0.1) -> Colocation:
    """Unroll the random-walk mobility model into [T, M] arrays.

    The draws come from a CPU ``torch.Generator`` seeded with ``seed``;
    like every schedule builder this one returns host (numpy) data.
    """
    mcfg = MobilityConfig(n_mules=n_mules, p_cross=p_cross)
    gen = torch.Generator(device="cpu")
    gen.manual_seed(seed)
    draws = sample_walk_draws(mcfg, n_steps, gen)
    start = init_mobility(mcfg, draws.sid, draws.u)
    infos = simulate_trajectories(mcfg, draws)
    area = start["area"].numpy()                         # int32
    return {
        "fixed_id": infos["fixed_id"].numpy(),              # int32
        "exchange": infos["exchange"].numpy(),
        "pos": infos["pos"].numpy(),                        # float32
        "area": area,
        "init_space": space_of(start["pos"], mcfg.space_size)
        .numpy().clip(0),
        "init_area": area.copy(),
    }


def trace_colocation(visits: np.ndarray, n_mules: int,
                     n_steps: int) -> Colocation:
    """Expand a (user, place, t_in, t_out) visit log into engine tensors.

    Heterogeneous space tempos are a *scenario* declaration: ``register``
    re-derives the exchange flags from the spec's ``SpaceSpec`` tuple, so
    the expansion here always uses the homogeneous default cadence.
    """
    fid, exch = trace_to_colocation(visits, n_mules, n_steps)
    present = fid >= 0
    any_visit = present.any(axis=0)
    first_t = present.argmax(axis=0)
    first = np.where(any_visit, fid[first_t, np.arange(n_mules)], 0)
    return {
        "fixed_id": fid,
        "exchange": exch,
        "pos": np.zeros((n_steps, n_mules, 2), np.float32),
        "area": (fid.max(axis=0).clip(0) // 4).astype(np.int32),
        "init_space": (first % 4).astype(np.int64),
        "init_area": (first // 4).astype(np.int64),
    }


def _from_trace(gen: Callable[..., np.ndarray], n_places: int = 8, **gen_kw):
    def build(seed: int, n_mules: int, n_steps: int) -> Colocation:
        visits = gen(seed, n_users=n_mules, n_places=n_places,
                     n_steps=n_steps, **gen_kw)
        return trace_colocation(visits, n_mules, n_steps)
    return build


# ---------------------------------------------------------------------------
# built-in scenarios
# ---------------------------------------------------------------------------

register(ScenarioSpec(
    name="random_walk", colocation=walk_colocation,
    mode="fixed", dist="dir0.01",
    description="Paper Sec 4.1/4.2: random walk with P_cross=0.1, smart-space "
                "devices train on Dirichlet(0.01) partitions (Table 1)."))

register(ScenarioSpec(
    name="foursquare_sparse",
    colocation=_from_trace(synth_foursquare_trace),
    mode="mobile", dist="shards",
    description="Paper '4Q' condition: sparse Foursquare-style check-ins, "
                "mules train on shard data of their home space (Fig 6-7)."))

register(ScenarioSpec(
    name="commuter", colocation=_from_trace(commuter_trace),
    mode="mobile", dist="shards",
    description="Daily home/work oscillation — dense periodic co-location."))

register(ScenarioSpec(
    name="shift_worker", colocation=_from_trace(shift_worker_trace),
    mode="mobile", dist="shards",
    description="Rotating crews hand models across workplaces shift by shift."))

register(ScenarioSpec(
    name="event_crowd", colocation=_from_trace(event_crowd_trace),
    mode="mobile", dist="shards",
    description="Sparse background plus mass events: bursts of simultaneous "
                "deliveries stress freshness filtering and aggregation."))

register(ScenarioSpec(
    name="commuter_churn", colocation=_from_trace(commuter_trace),
    mode="mobile", dist="shards",
    churn=ChurnSpec(kind="markov",
                    params=(("p_leave", 0.04), ("p_join", 0.10))),
    description="Commuter mobility with on/off churn: devices drop off and "
                "rejoin after geometric on/off periods (Markov chain)."))

register(ScenarioSpec(
    name="event_crowd_flash", colocation=_from_trace(event_crowd_trace),
    mode="mobile", dist="shards",
    churn=ChurnSpec(kind="flash",
                    params=(("n_flashes", 4), ("flash_len", 40),
                            ("base_frac", 0.25), ("join_frac", 0.9))),
    description="Event crowds whose devices are only awake around events: "
                "flash joins at each venue window, mass exits when it "
                "closes, a small always-on core in between."))

register(ScenarioSpec(
    name="mixed_cadence",
    colocation=_from_trace(commuter_trace),
    mode="mobile", dist="shards",
    spaces=tuple(SpaceSpec(exchange_steps=s)
                 for s in (1, 2, 4, 8, 3, 6, 2, 5)),
    description="Heterogeneous exchange tempos: each space completes a "
                "hand-off in its own number of dwell steps (1..8)."))

# -- HAR task variants -------------------------------------------------------
# Same mobility as the image-task trace scenarios; the harness binds the
# paper's LSTM-CNN HAR stack (task="har" selects the IMU dataset and the
# ``configs.mule_lstm_cnn`` model, Fig 8/9's) instead of the CNN.

register(ScenarioSpec(
    name="multi_area_3city",
    colocation=_from_trace(multi_area_trace, n_places=12, n_areas=3),
    mode="mobile", dist="shards", n_fixed=12,
    description="Three near-isolated cities (12 spaces, 3 areas) with rare "
                "cross-city travelers: affinity groups must form per city "
                "without cross-area leakage."))


def _migratory_colocation(seed: int, n_mules: int, n_steps: int) -> Colocation:
    """3-city trace with heavy travel and a *time-varying* area column.

    ``p_travel=0.25`` makes relocation the norm, and ``area_over_time``
    replaces the static per-mule area with the ``[T, M]`` trace of each
    mule's current city.
    """
    co = _from_trace(multi_area_trace, n_places=12, n_areas=3,
                     p_travel=0.25)(seed, n_mules, n_steps)
    co["area"] = area_over_time(co["fixed_id"], co["init_area"])
    return co


register(ScenarioSpec(
    name="multi_area_migratory",
    colocation=_migratory_colocation,
    mode="mobile", dist="shards", n_fixed=12,
    description="Three cities with heavy migration (p_travel=0.25) and a "
                "time-varying [T, M] area column: mules relocate for good."))

register(ScenarioSpec(
    name="har_commuter", colocation=_from_trace(commuter_trace),
    mode="mobile", dist="shards", task="har",
    description="Fig 8's IMU HAR task under commuter mobility: LSTM-CNN "
                "models hand across home/work spaces each day."))

register(ScenarioSpec(
    name="har_shift_worker", colocation=_from_trace(shift_worker_trace),
    mode="mobile", dist="shards", task="har",
    description="IMU HAR with rotating crews: LSTM-CNN models relay "
                "between workplaces shift by shift."))


# -- streaming-native scenarios ----------------------------------------------

def _streaming_commuter_colocation(seed: int, n_mules: int,
                                   n_steps: int) -> Colocation:
    """The materialized schedule of the procedural commuter stream (drawn
    and expanded on the CPU): the stream is the source, so every
    materialized path sees the schedule a streamed replay generates."""
    return materialize_generator(commuter_stream(seed, n_mules, n_steps,
                                                 device="cpu"))


register(ScenarioSpec(
    name="streaming_commuter",
    colocation=_streaming_commuter_colocation,
    mode="mobile", dist="shards",
    generator=commuter_stream,
    description="Procedural commuter schedule generated chunk by chunk on "
                "the device (per-mule home/work/jitter parameters, O(M) "
                "memory at any horizon): the native workload of "
                "run_population_streamed and the M=10^5+ scale runs."))
