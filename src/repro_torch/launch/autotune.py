"""Tuned launches for the hand kernels, and the engine's roofline.

Port of ``repro.launch.autotune``, in its three halves:

**The cache, which needs no card.** ``load_tuning_cache`` reads
``tuning_cache.json`` beside this module (committed, written on the H100
by ``run_roofline``); ``REPRO_TORCH_TUNE_CACHE`` points the lookup at
another file, and an empty value disables it. A missing or malformed cache
reads as none, and then every launch is the hand pick of the kernel's
source. The kernel wrappers ask, at call time:

- ``tuned_mule_agg_waves(f, m, d)``: ``mule_agg``'s grid, in persistent
  waves (a wave is the instance's resident blocks an SM times the SMs);
- ``tuned_encounter_launch(m, d)`` and ``tuned_hop_launch(r, d)``: the sums
  kernel's shape (``"small"`` or ``"big"``) and its dense switch
  (``dense_min``, met pairs a row of a 32-mule strip);

each the entry of the nearest tuned shape (the least summed |log ratio|),
or ``None`` for the hand pick. The lookups are memoized on the host, so a
call under ``torch.func.vmap`` or inside CUDA-graph capture reads no file
and touches no device. ``suggest_mesh_shape`` ranks the cache's mesh rows
as the reference does.

**The kernels, on the card.** ``tune_mule_agg`` and ``tune_encounter_mix``
/ ``tune_encounter_hop`` time every candidate with CUDA events after a
warm-up and take the argmin. The candidates are launch choices the kernels
already have: ``mule_agg``'s grid at ½, 1, 2 or 4 waves (capped at its
4-column groups; its bits do not depend on the grid), and the sums
kernel's two shapes times ``dense_min`` in {4, 8, 16, 32} (each row sums
its met rows in ascending order in either mode and shape). A candidate
whose output is not bitwise the default's is no candidate: it is left out
and listed under ``excluded``. A kernel that fails to build or launch
raises.

**The engine.** ``analyze_engine_step(method, n_mules, steps, mesh)`` runs
the port's engine under ``cost_analysis.CostCounter`` on the reference's
tiny linear-regression workload (its data may be injected as numpy) and
prices it with ``roofline``. With a mesh it runs inside each rank of a
gloo world on one card (``engine_step_rank``), and ``analyze_engine_step``
spawns that world and sums the ranks: the terms are the whole world's
work against one card's peaks, since the ranks share its HBM and its host
link. ``roofline_sweep`` covers the reference's grid, and ``run_roofline``
writes the cache: the grid, the tuned entries and
``tuned_speedup_vs_default`` (the geometric mean of the speedups).

Departures from the reference: the knobs are the CUDA kernels' (the
reference tunes Pallas block sizes on its interpret path); the cache lives
in the package, not under ``benchmarks/``; every tuned entry records the
card's name and power limit, the default's time and the pick's.

    python -m repro_torch.launch.autotune            # tune, sweep, write
    python -m repro_torch.launch.autotune --no-sweep # the kernels only
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

# ---------------------------------------------------------------------------
# the cache: the runtime half
# ---------------------------------------------------------------------------

_CACHE_PATH_ENV = "REPRO_TORCH_TUNE_CACHE"
DEFAULT_CACHE_PATH = Path(__file__).resolve().with_name("tuning_cache.json")

_UNSET = object()
_cache_memo: Any = _UNSET
_lookup_memo: Dict[Tuple, Any] = {}

MULE_AGG_WAVES = (0.5, 1.0, 2.0, 4.0)
MULE_AGG_DEFAULT_WAVES = 1.0
ENCOUNTER_SHAPES = ("small", "big")
ENCOUNTER_DENSE_MINS = (4, 8, 16, 32)
ENCOUNTER_DEFAULT_DENSE_MIN = 8
SMALL_ROWS = 64          # the hand rule: SmallShape for R <= 64 rows

# the path shapes the committed cache is tuned at
MULE_AGG_SHAPES = ((8, 256, 546_484), (12, 256, 546_484), (8, 256, 44_580),
                   (8, 1_000_000, 8))
ENCOUNTER_SHAPES_TUNED = ((256, 546_484, "walk"), (256, 44_580, "dense"))
HOP_SHAPES = ((64, 546_484),)


def default_shape(rows: int) -> str:
    """The sums kernel's hand pick for ``rows`` rows."""
    return "small" if rows <= SMALL_ROWS else "big"


def tuning_cache_clear() -> None:
    """Drop the memoized cache and lookups (after repointing the env)."""
    global _cache_memo
    _cache_memo = _UNSET
    _lookup_memo.clear()


def load_tuning_cache(path: Optional[str] = None) -> Optional[Dict]:
    """The parsed cache, or ``None`` when there is none.

    ``path``, else ``REPRO_TORCH_TUNE_CACHE`` (empty: none), else the
    committed ``tuning_cache.json``. The default resolution is memoized; a
    missing or malformed file reads as no cache, so a cache can never break
    a kernel call.
    """
    global _cache_memo
    if path is None and _cache_memo is not _UNSET:
        return _cache_memo
    resolved = path
    if resolved is None:
        resolved = os.environ.get(_CACHE_PATH_ENV)
        if resolved == "":
            _cache_memo = None
            return None
        if resolved is None:
            resolved = str(DEFAULT_CACHE_PATH)
    try:
        with open(resolved) as f:
            cache = json.load(f)
        if not isinstance(cache, dict) or not isinstance(cache.get("tuned"),
                                                         dict):
            cache = None
    except (OSError, ValueError):
        cache = None
    if path is None:
        _cache_memo = cache
    return cache


def _nearest(entries: List[Dict], query: Dict[str, int]) -> Optional[Dict]:
    """Entry minimizing the summed |log shape ratio| over the query dims."""
    best, best_cost = None, None
    for e in entries:
        try:
            cost = sum(abs(math.log(max(int(e[k]), 1) / max(int(v), 1)))
                       for k, v in query.items())
        except (KeyError, TypeError, ValueError):
            continue
        if best_cost is None or cost < best_cost:
            best, best_cost = e, cost
    return best


def _lookup(kernel: str, query: Dict[str, int]) -> Optional[Dict]:
    key = (kernel,) + tuple(sorted(query.items()))
    if key not in _lookup_memo:
        cache = load_tuning_cache()
        entries = cache["tuned"].get(kernel, []) if cache else []
        _lookup_memo[key] = _nearest(entries if isinstance(entries, list)
                                     else [], query)
    return _lookup_memo[key]


def tuned_mule_agg_waves(f: int, m: int, d: int) -> Optional[float]:
    """``mule_agg``'s tuned grid in waves, or ``None`` (one wave)."""
    e = _lookup("mule_agg", {"f": f, "m": m, "d": d})
    w = e.get("waves") if e else None
    return float(w) if isinstance(w, (int, float)) and w > 0 else None


def _launch_of(e: Optional[Dict]) -> Tuple[Optional[str], Optional[int]]:
    if not e:
        return None, None
    shape, dense = e.get("shape"), e.get("dense_min")
    return (shape if shape in ENCOUNTER_SHAPES else None,
            dense if isinstance(dense, int) and dense >= 0 else None)


def tuned_encounter_launch(m: int, d: int
                           ) -> Tuple[Optional[str], Optional[int]]:
    """The mix's tuned (shape, dense_min), each ``None`` for the hand
    pick."""
    return _launch_of(_lookup("encounter_mix", {"m": m, "d": d}))


def tuned_hop_launch(r: int, d: int) -> Tuple[Optional[str], Optional[int]]:
    """A ring hop's tuned (shape, dense_min), each ``None`` for the hand
    pick."""
    return _launch_of(_lookup("encounter_hop", {"r": r, "d": d}))


def suggest_mesh_shape(method: str, n_mules: int,
                       path: Optional[str] = None
                       ) -> Optional[Tuple[int, int]]:
    """(pod, data) mesh shape minimizing collective + memory seconds.

    The reference's rule: of the cache's mesh rows (``roofline`` entries
    with an ``AxB`` mesh), those of ``method`` when any exist (else all),
    each shape's nearest-``n_mules`` row, and the shape whose per-step
    ``t_collective + t_memory`` is least. ``None`` without a usable cache:
    callers keep their own fallback.
    """
    cache = load_tuning_cache(path)
    if not cache:
        return None
    rows = [r for r in cache.get("roofline", [])
            if isinstance(r, dict) and isinstance(r.get("mesh"), str)
            and "x" in r["mesh"]]
    mine = [r for r in rows if r.get("method") == method] or rows
    by_shape: Dict[str, List[Dict]] = {}
    for r in mine:
        by_shape.setdefault(r["mesh"], []).append(r)
    best, best_cost = None, None
    for shape, entries in by_shape.items():
        e = _nearest(entries, {"n_mules": n_mules})
        if e is None:
            continue
        try:
            cost = (float(e["t_collective_us_per_step"])
                    + float(e["t_memory_us_per_step"]))
            dims = tuple(int(x) for x in shape.split("x"))
        except (KeyError, TypeError, ValueError):
            continue
        if len(dims) != 2 or any(x < 1 for x in dims):
            continue
        if best_cost is None or cost < best_cost:
            best, best_cost = dims, cost
    return best


# ---------------------------------------------------------------------------
# the kernels: measured on the card
# ---------------------------------------------------------------------------

COLD_BYTES = 150e6       # copies of W rotate past the 50 MB L2


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of the card."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True,
                         timeout=60)
    return out.stdout.strip().splitlines()[0]


def _median_ms(fn, reps: int, warm: int = 3) -> float:
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


@contextlib.contextmanager
def forced(module, **values):
    """Set launch knobs of a kernel's ops module (``GRID_WAVES``,
    ``SUMS_SHAPE``, ``DENSE_MIN``) for the block, over the cache."""
    old = {k: getattr(module, k) for k in values}
    try:
        for k, v in values.items():
            setattr(module, k, v)
        yield
    finally:
        for k, v in old.items():
            setattr(module, k, v)


def _pick(label: str, cands: Dict[str, Dict], run, default: str,
          reps: int, timed=None) -> Dict:
    """Run every candidate (a dict of knob values) once against the
    default's output, time those with its bits (``timed``, else ``run``)
    and pick the fastest."""
    timed = run if timed is None else timed
    want = run(cands[default])
    torch.cuda.synchronize()
    times, excluded = {}, []
    for name, knobs in cands.items():
        got = run(knobs)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(got, want))
        del got
        if not same:
            excluded.append({"kernel": label, "candidate": name,
                             "why": "output not bitwise the default's"})
            continue
        times[name] = _median_ms(lambda k=knobs: timed(k), reps)
    best = min(times, key=times.get)
    return {"times": times, "best": best, "excluded": excluded,
            "default_ms": times[default], "ms": times[best],
            "speedup_vs_default": times[default] / times[best]}


def mule_agg_candidates(f: int, d: int) -> Dict[str, Dict]:
    """``mule_agg``'s grid candidates in waves; those past its 4-column
    groups are dropped (they launch the cap's grid)."""
    from repro_torch.kernels.mule_agg import ops
    n_vec = -(-d // 4)
    wave = ops.wave_blocks(f, torch.float32, torch.device("cuda"))
    return {f"{w:g} waves": {"GRID_WAVES": w} for w in MULE_AGG_WAVES
            if w <= MULE_AGG_DEFAULT_WAVES or round(w * wave) <= n_vec}


def tune_mule_agg(f: int, m: int, d: int, *, reps: int = 10,
                  seed: int = 0) -> Dict:
    """Every grid candidate of ``mule_agg`` at (F, M, D) f32, W cold
    (copies rotate past the L2)."""
    from repro_torch.kernels.mule_agg import mule_agg, ops
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    copies = max(1, math.ceil(COLD_BYTES / (4 * m * d)))
    inputs = []
    for _ in range(copies):
        a = torch.rand(f, m, device="cuda", generator=g)
        inputs.append((a / a.sum(1, keepdim=True),
                       torch.randn(m, d, device="cuda", generator=g)))
    turn = [0]

    def run(knobs, k=0):
        with forced(ops, **knobs):
            return (mule_agg(*inputs[k]),)

    def timed(knobs):
        turn[0] += 1
        return run(knobs, turn[0] % copies)

    cands = mule_agg_candidates(f, d)
    res = _pick("mule_agg", cands, run, f"{MULE_AGG_DEFAULT_WAVES:g} waves",
                reps, timed)
    return {"f": f, "m": m, "d": d,
            "waves": cands[res["best"]]["GRID_WAVES"],
            "w_copies": copies, "candidates_ms": res["times"],
            "default_ms": res["default_ms"], "ms": res["ms"],
            "speedup_vs_default": res["speedup_vs_default"],
            "excluded": res["excluded"], "card": card_line()}


def encounter_geometry(m: int, geometry: str, seed: int = 0):
    """(pos, area, active) on the card: the walk's first exchange (Fig 6's
    P_cross 0.1, radius 0.15) or a dense strip (pos 0, two areas, as the
    trace scenarios give the peer step)."""
    from repro_torch.scenarios import walk_colocation
    if geometry == "walk":
        co = walk_colocation(seed, m, 3, p_cross=0.1)
        pos = torch.as_tensor(np.asarray(co["pos"][2]), dtype=torch.float32)
        area = torch.as_tensor(np.asarray(co["area"]), dtype=torch.int64)
        pos, area = pos.cuda(), area.cuda()
    elif geometry == "dense":
        g = torch.Generator(device="cuda")
        g.manual_seed(seed)
        pos = torch.zeros(m, 2, device="cuda")
        area = torch.randint(0, 2, (m,), device="cuda", generator=g)
    else:
        raise ValueError(f"unknown geometry {geometry!r}")
    return pos, area, torch.ones(m, dtype=torch.bool, device="cuda")


def encounter_candidates(rows: int) -> Dict[str, Dict]:
    cands = {}
    for shape in ENCOUNTER_SHAPES:
        for dense in ENCOUNTER_DENSE_MINS:
            cands[f"{shape}/{dense}"] = {"SUMS_SHAPE": shape,
                                         "DENSE_MIN": dense}
    return cands


def _encounter_default(rows: int) -> str:
    return f"{default_shape(rows)}/{ENCOUNTER_DEFAULT_DENSE_MIN}"


def tune_encounter_mix(m: int, d: int, geometry: str = "walk", *,
                       radius: float = 0.15, reps: int = 10,
                       seed: int = 0) -> Dict:
    """Every (shape, dense_min) of the mix at [M, D] f32."""
    from repro_torch.kernels.encounter_mix import encounter_mix, ops
    pos, area, act = encounter_geometry(m, geometry, seed)
    g = torch.Generator(device="cuda")
    g.manual_seed(seed + 1)
    w = torch.randn(m, d, device="cuda", generator=g)

    def run(knobs):
        with forced(ops, **knobs):
            return encounter_mix(pos, area, act, w, radius=radius)

    res = _pick("encounter_mix", encounter_candidates(m), run,
                _encounter_default(m), reps)
    shape, dense = res["best"].split("/")
    nnz = int(run(encounter_candidates(m)[res["best"]])[1].sum().item())
    return {"m": m, "d": d, "geometry": geometry, "met_pairs": nnz,
            "shape": shape, "dense_min": int(dense),
            "candidates_ms": res["times"], "default_ms": res["default_ms"],
            "ms": res["ms"], "speedup_vs_default": res["speedup_vs_default"],
            "excluded": res["excluded"], "card": card_line()}


def hop_inputs(r: int, d: int, seed: int = 0):
    """(the hop's arguments on the card, its met pairs): the busiest hop
    between blocks of ``r`` mules of the walk's first exchange (4 blocks),
    rows against visiting mules of another block."""
    from repro_torch.kernels.encounter_mix import encounter_pairs_reference
    pos, area, _ = encounter_geometry(4 * r, "walk", seed)
    g = torch.Generator(device="cuda")
    g.manual_seed(seed + 2)
    w = torch.randn(4 * r, d, device="cuda", generator=g)
    best = None
    for i in range(4):
        for j in range(4):
            if i == j:
                continue
            rows, vis = slice(i * r, (i + 1) * r), slice(j * r, (j + 1) * r)
            args = (pos[rows], area[rows], None, i * r, pos[vis], area[vis],
                    None, j * r)
            nnz = int(encounter_pairs_reference(*args, 0.15)[1].sum())
            if best is None or nnz > best[1]:
                best = (args + (w[vis], 0.15), nnz)
    return best


def tune_encounter_hop(r: int, d: int, *, reps: int = 10,
                       seed: int = 0) -> Dict:
    """Every (shape, dense_min) of one ring hop at R = V = r, f32."""
    from repro_torch.kernels.encounter_mix import encounter_block_hop, ops
    args, nnz = hop_inputs(r, d, seed)

    def run(knobs):
        with forced(ops, **knobs):
            return encounter_block_hop(*args)

    res = _pick("encounter_hop", encounter_candidates(r), run,
                _encounter_default(r), reps)
    shape, dense = res["best"].split("/")
    return {"r": r, "d": d, "met_pairs": nnz, "shape": shape,
            "dense_min": int(dense), "candidates_ms": res["times"],
            "default_ms": res["default_ms"], "ms": res["ms"],
            "speedup_vs_default": res["speedup_vs_default"],
            "excluded": res["excluded"], "card": card_line()}


# ---------------------------------------------------------------------------
# the engine's roofline
# ---------------------------------------------------------------------------


def engine_workload(n_mules: int, steps: int, seed: int = 0,
                    data: Optional[Dict[str, np.ndarray]] = None,
                    device="cuda"):
    """The reference's tiny mobile linear-regression population: X [M, 12,
    5], Y [M, 12], 4 samples a mule a step, one SGD step at lr 0.05, 4 fixed
    devices, the walk. ``data`` injects numpy arrays by name (``X``, ``Y``,
    ``idx`` [T, M, 4], ``mule_w`` [M, 5], ``fixed_w`` [4, 5], and the
    ``colocation`` dict); the rest is drawn from ``seed``."""
    from repro_torch.core.population import PopulationConfig, init_population
    from repro_torch.scenarios import walk_colocation
    data = dict(data or {})
    rng = np.random.default_rng(seed)
    x = data.get("X", rng.normal(size=(n_mules, 12, 5)).astype(np.float32))
    y = data.get("Y", rng.normal(size=(n_mules, 12)).astype(np.float32))
    idx = data.get("idx", rng.integers(0, 12, (steps, n_mules, 4)))
    dev = torch.device(device)
    xt, yt = (torch.as_tensor(np.array(v), device=dev) for v in (x, y))
    it = torch.as_tensor(np.asarray(idx), dtype=torch.int64, device=dev)
    rows = torch.arange(n_mules, device=dev)[None, :, None]
    batches = {"fixed": None, "mule": (xt[rows, it], yt[rows, it])}

    def train_fn(params, batch, key):
        xb, yb = batch
        g = torch.func.grad(
            lambda p: torch.mean((xb @ p["w"] - yb) ** 2))(params)
        return {"w": params["w"] - 0.05 * g["w"]}

    pcfg = PopulationConfig(mode="mobile", n_fixed=4, n_mules=n_mules)
    weights = {"mule_models": {"w": torch.as_tensor(np.asarray(data.get(
                   "mule_w", rng.normal(size=(n_mules, 5)).astype(
                       np.float32))))},
               "fixed_models": {"w": torch.as_tensor(np.asarray(data.get(
                   "fixed_w", rng.normal(size=(4, 5)).astype(
                       np.float32))))}}
    pop = init_population(pcfg, weights=weights, device=dev)
    co = dict(data.get("colocation") or walk_colocation(seed, n_mules, steps))
    # the walk has 8 spaces and the workload 4 fixed devices; JAX drops the
    # reference's out-of-range ids, which the port reads as no visit (-1)
    fid = np.asarray(co["fixed_id"])
    co["fixed_id"] = np.where(fid < pcfg.n_fixed, fid, -1)
    # the schedule on the device, as the engine takes it: its copy there is
    # set-up, not the step's
    dtypes = {"fixed_id": torch.int64, "exchange": torch.bool,
              "pos": torch.float32, "area": torch.int64,
              "active": torch.bool}
    co = {k: torch.as_tensor(np.asarray(v), dtype=dtypes[k], device=dev)
          if k in dtypes else v for k, v in co.items()}
    return pop, co, batches, train_fn, pcfg


def engine_row(method: str, n_mules: int, steps: int, mesh_name: str,
                chips: int, counter) -> Dict:
    from repro_torch.launch import roofline
    t_c = roofline.compute_seconds(counter.flops_by)
    t_m = counter.bytes / roofline.HBM_BYTES_PER_S
    t_x = counter.coll_bytes / roofline.HOST_LINK_BYTES_PER_S
    terms = {"compute": t_c, "memory": t_m, "collective": t_x}
    return {
        "method": method, "n_mules": n_mules, "steps": steps,
        "mesh": mesh_name, "chips": chips,
        "flops_per_device": counter.flops,
        "flops_by": dict(counter.flops_by),
        "bytes_per_device": counter.bytes,
        "coll_bytes_per_device": counter.coll_bytes,
        "coll_breakdown": {k: v for k, v in counter.coll.items() if v},
        "kernels": dict(counter.kernels),
        "t_compute_s": t_c, "t_memory_s": t_m, "t_collective_s": t_x,
        "t_compute_us_per_step": t_c / steps * 1e6,
        "t_memory_us_per_step": t_m / steps * 1e6,
        "t_collective_us_per_step": t_x / steps * 1e6,
        "dominant": max(terms, key=terms.get),
    }


class RankSums:
    """A counter's totals, summed over ranks."""

    def __init__(self, parts: List[Dict]):
        self.flops_by: Dict[str, float] = {}
        self.coll: Dict[str, float] = {}
        self.kernels: Dict[str, int] = {}
        self.bytes = 0.0
        for p in parts:
            for mine, theirs in ((self.flops_by, p["flops_by"]),
                                 (self.coll, p["coll"]),
                                 (self.kernels, p["kernels"])):
                for k, v in theirs.items():
                    mine[k] = mine.get(k, 0) + v
            self.bytes += p["bytes"]

    @property
    def flops(self) -> float:
        return float(sum(self.flops_by.values()))

    @property
    def coll_bytes(self) -> float:
        return float(sum(self.coll.values()))


def engine_step_rank(method: str, n_mules: int, steps: int,
                     pod: int, data_axis: int, device="cuda",
                     data=None) -> Dict:
    """Inside one rank of a world of ``pod * data_axis`` ranks: the
    distributed engine under a count. Returns the rank's totals."""
    from repro_torch.core.distributed import (DistributedConfig,
                                              to_distributed_state)
    from repro_torch.launch.cost_analysis import CostCounter
    from repro_torch.launch.mesh import make_mule_mesh
    from repro_torch.scenarios import run_population_distributed
    pop, co, batches, train_fn, pcfg = engine_workload(
        n_mules, steps, data=data, device=device)
    dcfg = DistributedConfig(pop=pcfg)
    state = to_distributed_state(pop, dcfg)
    mesh = make_mule_mesh(pod, data_axis)
    with CostCounter() as cc:
        run_population_distributed(state, co, batches, train_fn, dcfg,
                                   mesh=mesh, key=7, method=method,
                                   device=device)
    return {"flops_by": cc.flops_by, "bytes": cc.bytes, "coll": cc.coll,
            "kernels": cc.kernels}


def analyze_engine_step(method: str, n_mules: int = 32, steps: int = 24,
                        mesh: Optional[Tuple[int, int]] = None, *,
                        device="cuda", data=None,
                        timeout: float = 900) -> Dict:
    """One (method x M x mesh) row: the FLOPs, bytes and collective bytes
    of the whole ``steps``-long replay, its three terms against one card's
    peaks, per step too, and the dominant term. ``mesh=None`` runs
    ``run_population`` here; a ``(pod, data)`` mesh spawns that many gloo
    ranks running ``engine_step_rank`` and sums them."""
    from repro_torch.device import resolve_device
    from repro_torch.launch.cost_analysis import CostCounter
    from repro_torch.scenarios import run_population
    dev = resolve_device(device)
    if mesh is None:
        pop, co, batches, train_fn, pcfg = engine_workload(
            n_mules, steps, data=data, device=dev)
        with CostCounter() as cc:
            run_population(pop, co, batches, train_fn, pcfg, 7,
                           method=method, device=dev)
        return engine_row(method, n_mules, steps, "1", 1, cc)
    pod, data_axis = mesh
    parts = _spawn_ranks(method, n_mules, steps, pod, data_axis, str(dev),
                         data, timeout)
    return engine_row(method, n_mules, steps, f"{pod}x{data_axis}",
                       pod * data_axis, RankSums(parts))


def _spawn_ranks(method, n_mules, steps, pod, data_axis, device, data,
                 timeout) -> List[Dict]:
    import pickle
    import tempfile
    from repro_torch.launch.multiprocess import spawn_local_cluster
    n = pod * data_axis
    src = str(Path(__file__).resolve().parents[2])
    env = dict(os.environ)
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    with tempfile.TemporaryDirectory() as tmp:
        spec = Path(tmp) / "spec.pkl"
        with open(spec, "wb") as f:
            pickle.dump({"method": method, "n_mules": n_mules,
                         "steps": steps, "pod": pod, "data_axis": data_axis,
                         "device": device, "data": data}, f)
        spawn_local_cluster(
            [sys.executable, "-m", "repro_torch.launch.autotune",
             "--rank-spec", str(spec)], n, base_env=env,
            coordinator=f"file://{tmp}/store", timeout=timeout)
        parts = []
        for r in range(n):
            with open(Path(tmp) / f"rank{r}.json") as f:
                parts.append(json.load(f))
    return parts


def _rank_main(spec_path: str) -> None:
    import pickle
    import torch.distributed as dist
    from repro_torch.launch.multiprocess import initialize_from_env
    initialize_from_env()
    with open(spec_path, "rb") as f:      # written by _spawn_ranks
        spec = pickle.load(f)
    out = engine_step_rank(spec["method"], spec["n_mules"], spec["steps"],
                           spec["pod"], spec["data_axis"], spec["device"],
                           spec["data"])
    rank = dist.get_rank() if dist.is_initialized() else 0
    with open(Path(spec_path).parent / f"rank{rank}.json", "w") as f:
        json.dump(out, f)
    if dist.is_initialized():
        dist.destroy_process_group()


METHODS_MOBILE = ("mlmule", "gossip", "oppcl", "local", "mlmule+gossip")
MESHES = ((1, 4), (2, 2), (4, 1))


def roofline_sweep(steps: int = 24, device="cuda") -> List[Dict]:
    """The reference's grid: every mobile method at M 32 and 128 on one
    device, then ``mlmule`` and ``gossip`` at M 64 on every mesh of
    ``MESHES``."""
    rows = [analyze_engine_step(m, n, steps, device=device)
            for m in METHODS_MOBILE for n in (32, 128)]
    for mesh in MESHES:
        rows += [analyze_engine_step(m, 64, steps, mesh, device=device)
                 for m in ("mlmule", "gossip")]
    return rows


def geomean(xs: Sequence[float]) -> float:
    xs = [max(x, 1e-12) for x in xs]
    return math.exp(sum(math.log(x) for x in xs) / len(xs)) if xs else 1.0


def run_tunes(reps: int = 10) -> Dict[str, List[Dict]]:
    """Tune every kernel at the paths' shapes (the card's)."""
    return {
        "mule_agg": [tune_mule_agg(f, m, d, reps=reps)
                     for f, m, d in MULE_AGG_SHAPES],
        "encounter_mix": [tune_encounter_mix(m, d, geo, reps=reps)
                          for m, d, geo in ENCOUNTER_SHAPES_TUNED],
        "encounter_hop": [tune_encounter_hop(r, d, reps=reps)
                          for r, d in HOP_SHAPES],
    }


def run_roofline(out_path: Optional[str] = None, *, reps: int = 10,
                 steps: int = 24, sweep: bool = True) -> Dict:
    """The whole artifact: the roofline grid, the tuned entries and the
    headline ``tuned_speedup_vs_default``; written to ``out_path`` (the
    committed cache by default)."""
    tuned = run_tunes(reps)
    rows = roofline_sweep(steps=steps) if sweep else []
    entries = [e for es in tuned.values() for e in es]
    payload = {
        "bench": "repro_torch.launch.autotune.run_roofline",
        "card": card_line(),
        "config": {"reps": reps, "steps": steps,
                   "meshes": ["x".join(map(str, m)) for m in MESHES]
                   if sweep else [],
                   "torch": torch.__version__, "cuda": torch.version.cuda},
        "roofline": rows,
        "tuned": tuned,
        "excluded": [x for e in entries for x in e.get("excluded", [])],
        "tuned_speedup_vs_default": geomean([e["speedup_vs_default"]
                                              for e in entries]),
    }
    with open(out_path or DEFAULT_CACHE_PATH, "w") as f:
        json.dump(payload, f, indent=1)
        f.write("\n")
    return payload


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None,
                    help="where to write the cache (default: the package's)")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--steps", type=int, default=24)
    ap.add_argument("--no-sweep", action="store_true",
                    help="tune the kernels only, no engine grid")
    ap.add_argument("--rank-spec", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank_spec:
        _rank_main(args.rank_spec)
        return 0
    payload = run_roofline(args.out, reps=args.reps, steps=args.steps,
                           sweep=not args.no_sweep)
    for kernel, es in payload["tuned"].items():
        for e in es:
            print(f"{kernel} {e}")
    print(f"tuned_speedup_vs_default {payload['tuned_speedup_vs_default']} "
          f"[{payload['card']}]")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
